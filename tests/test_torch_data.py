"""The port's problems, straggler models and projections against the JAX
package's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.optim import projections as jproj
from repro_torch.core.straggler import BernoulliStragglers, FixedCountStragglers
from repro_torch.data import synthetic as tsyn
from repro_torch.device import resolve_device
from repro_torch.optim import projections as tproj


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("m,k,noise,seed", [(256, 80, 0.0, 0), (100, 40, 0.1, 3),
                                            (64, 128, 0.0, 7)])
def test_make_linear_problem_bit_identical(m, k, noise, seed):
    a = jsyn.make_linear_problem(m, k, noise=noise, seed=seed)
    b = tsyn.make_linear_problem(m, k, noise=noise, seed=seed, device="cpu")
    for f in ("X", "y", "theta_star"):
        assert getattr(b, f).dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), _np(getattr(b, f)))
    assert a.lr == b.lr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsyn.make_linear_problem(8, 4)


@pytest.mark.parametrize("s,w", [(0, 40), (10, 40), (40, 40), (512, 2048)])
def test_fixed_count_erases_exactly_s(s, w):
    g = torch.Generator().manual_seed(s)
    counts = [int(FixedCountStragglers(s).sample(g, w, device="cpu").sum())
              for _ in range(20)]
    assert counts == [s] * 20


def test_fixed_count_is_uniform_over_workers():
    # 4000 draws of 10 of 40: each worker's hit count ~ Binomial(4000, 1/4);
    # std 27, so a 6-sigma band around 1000 has no false alarms in practice.
    g = torch.Generator().manual_seed(0)
    hits = sum(FixedCountStragglers(10).sample(g, 40, device="cpu").long()
               for _ in range(4000))
    assert hits.min() > 1000 - 165 and hits.max() < 1000 + 165


def test_bernoulli_rate():
    # 200 x 1000 Bernoulli(0.2) draws: mean within 5 sigma (sigma ~ 9e-4).
    g = torch.Generator().manual_seed(1)
    masks = torch.stack([BernoulliStragglers(0.2).sample(g, 1000, device="cpu")
                         for _ in range(200)])
    assert masks.dtype == torch.bool
    assert abs(masks.float().mean().item() - 0.2) < 5 * 9e-4


THETAS = [np.random.default_rng(s).standard_normal(n).astype(np.float32)
          for s, n in ((0, 7), (1, 50), (2, 200))]
PROJECTIONS = [("identity", lambda m: m.identity),
               ("l2_ball", lambda m: m.l2_ball(1.5)),
               ("l2_ball_inside", lambda m: m.l2_ball(1e3)),
               ("l1_ball", lambda m: m.l1_ball(2.0)),
               ("l1_ball_inside", lambda m: m.l1_ball(1e4)),
               ("hard_threshold", lambda m: m.hard_threshold(5)),
               ("hard_threshold_all", lambda m: m.hard_threshold(10_000)),
               ("box", lambda m: m.box(-0.5, 0.25))]


@pytest.mark.parametrize("name,make", PROJECTIONS, ids=[p[0] for p in PROJECTIONS])
@pytest.mark.parametrize("i", range(len(THETAS)))
def test_projection_matches_jax(name, make, i):
    theta = THETAS[i]
    want = np.asarray(make(jproj)(jnp.asarray(theta)))
    got = _np(make(tproj)(torch.from_numpy(theta)))
    # f32: norms and cumulative sums are reduced in a different order, so
    # allow a few ulps of the magnitudes involved.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
