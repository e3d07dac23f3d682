"""The port's Scheme 1 (exact recovery by least squares) against the JAX
package's, on the CPU.

Both sides start from the same numpy data: JAX builds its ``Scheme1`` and
draws its straggler masks inside ``run_pgd``; the port's ``Scheme1`` is
built from JAX's encoded blocks and code (``repro_torch.convert``) and
driven by ``run_pgd(masks=)`` on the very masks JAX drew, on the (40, 20)
code with k = 80 (four blocks).  Two straggler counts:

* 10, where every step's surviving rows have full column rank K = 20 (the
  test checks it): the recovered M θ is exact up to f32 rounding;
* 22, which leaves 18 rows for K = 20 unknowns: every step is
  rank-deficient and both sides take the minimum-norm solution.

Errors and iterates are held to ``4·max(|port − port64|, |JAX − port64|)
+ 8·2⁻²³·max|JAX|``, with ``port64`` the port's own run in float64 on the
same masks (float64 moments, float64 encode and solve): the anchor is how
far f32 strays from exact arithmetic on this run, never a fixed fraction.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coded_step as jcs
from repro.core import encoding as jenc
from repro.core import ldpc as jldpc
from repro.core.straggler import FixedCountStragglers as JaxFixedCount
from repro.data import make_linear_problem as jax_problem
from repro_torch import convert
from repro_torch.core import coded_step as tcs
from repro_torch.core.encoding import second_moment

STEPS = 10


@functools.cache
def _setup():
    prob = jax_problem(256, 80, seed=0)
    code = jldpc.make_regular_ldpc(20, l=3, r=6, seed=0)
    return prob, code, jenc.second_moment(prob.X, prob.y)


@functools.cache
def _jax_run(S):
    prob, code, mom = _setup()
    scheme = jcs.Scheme1.build(code, mom, lr=prob.lr)
    res = jcs.run_pgd(scheme, jnp.zeros(80), JaxFixedCount(S), STEPS,
                      key=jax.random.PRNGKey(1), theta_star=prob.theta_star)
    keys = jax.random.split(jax.random.PRNGKey(1), STEPS)
    masks = np.array(jax.vmap(lambda k: JaxFixedCount(S).sample(k, 40))(keys))
    return scheme, res, masks


def _held(got, want, exact):
    got, want, exact = (np.asarray(x, np.float64) for x in (got, want, exact))
    anchor = max(np.abs(got - exact).max(), np.abs(want - exact).max())
    assert np.abs(got - want).max() <= 4 * anchor + 8 * 2.0 ** -23 * np.abs(want).max()


@pytest.mark.parametrize("S,full_rank", [(10, True), (22, False)])
def test_scheme1_run_pgd_matches_jax(S, full_rank):
    prob, code, _ = _setup()
    jscheme, want, masks = _jax_run(S)
    tcode = convert.code_from(code)
    port = tcs.Scheme1(code=tcode, C_blocks=convert.tensor(jscheme.C_blocks, "cpu"),
                       b=convert.tensor(jscheme.b, "cpu"), lr=jscheme.lr)
    star = convert.tensor(prob.theta_star, "cpu")
    tmasks = torch.from_numpy(masks)
    got = tcs.run_pgd(port, torch.zeros(80), None, STEPS, masks=tmasks, theta_star=star)
    X, y = (torch.from_numpy(np.array(a, np.float64)) for a in (prob.X, prob.y))
    exact = tcs.Scheme1.build(tcode, second_moment(X, y), lr=jscheme.lr)
    ref = tcs.run_pgd(exact, torch.zeros(80, dtype=torch.float64), None, STEPS, masks=tmasks,
                      theta_star=star.double())
    ranks = [int(exact.solve(exact.worker_products(ref.theta), m)[1]) for m in tmasks]
    assert all(r == 20 for r in ranks) if full_rank else all(r < 20 for r in ranks)
    assert int(got.unresolved.sum()) == 0
    _held(got.errors, want.errors, ref.errors)
    _held(got.theta, want.theta, ref.theta)
    _held(got.theta_bar, want.theta_bar, ref.theta_bar)
    assert float(got.errors[-1]) < float(got.errors[0])


@pytest.mark.parametrize("n,K,rank", [(30, 20, 20), (18, 20, 18), (40, 20, 12)])
def test_lstsq_min_norm_matches_jnp_lstsq(n, K, rank):
    rng = np.random.default_rng(n + K + rank)
    A = (rng.standard_normal((n, rank)) @ rng.standard_normal((rank, K))).astype(np.float32)
    A[rng.random(n) < 0.2] = 0.0                 # straggler rows
    Bm = rng.standard_normal((n, 4)).astype(np.float32)
    want = np.stack([np.asarray(jnp.linalg.lstsq(jnp.asarray(A), jnp.asarray(Bm[:, i]))[0])
                     for i in range(4)], axis=1)
    got, kept = tcs.lstsq_min_norm(torch.from_numpy(A), torch.from_numpy(Bm))
    exact, _ = tcs.lstsq_min_norm(torch.from_numpy(A).double(), torch.from_numpy(Bm).double())
    assert int(kept.sum()) == int(jnp.linalg.matrix_rank(jnp.asarray(A)))
    _held(got.numpy(), want, exact.numpy())


def test_full_rank_recovery_is_exact_in_float64():
    prob, code, _ = _setup()
    _, _, masks = _jax_run(10)
    X, y = (torch.from_numpy(np.array(a, np.float64)) for a in (prob.X, prob.y))
    mom = second_moment(X, y)
    scheme = tcs.Scheme1.build(convert.code_from(code), mom, lr=0.1)
    theta = torch.from_numpy(np.random.default_rng(0).standard_normal(80))
    Mtheta, rank = scheme.solve(scheme.worker_products(theta), torch.from_numpy(masks[0]))
    assert int(rank) == 20
    assert float((Mtheta - mom.M @ theta).abs().max()) <= 1e-9 * float((mom.M @ theta).abs().max())
    assert scheme.w == 40


def test_scheme1_shares_the_blocked_encode():
    prob, code, mom = _setup()
    tcode = convert.code_from(code)
    tmom = second_moment(convert.tensor(prob.X, "cpu"), convert.tensor(prob.y, "cpu"))
    s1 = tcs.Scheme1.build(tcode, tmom, lr=0.1)
    s2 = tcs.Scheme2Blocked.build(tcode, tmom, lr=0.1)
    assert torch.equal(s1.C_blocks, s2.C_blocks) and s1.C_blocks.shape == (4, 40, 80)
