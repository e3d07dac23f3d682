"""The port's Scheme 2 coded gradient step against the JAX package's.

Both sides compute from the very same code, encoded moment and straggler
masks: the port's objects are built through ``repro_torch.convert`` from the
JAX side's arrays, and the masks are the ones JAX ``run_pgd`` draws.
``unresolved`` (a function of the code and the masks alone) must match
exactly.  Iterates and errors must agree to 1e-4 relative: each step's
gradient differs only in f32 summation order (about 1e-5 relative at this
size), and ten steps of a contraction do not grow that.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coded_step as jcs
from repro.core import encoding as jenc
from repro.core import engine as jeng
from repro.core import ldpc as jldpc
from repro.core import schemes as jschemes
from repro.core.straggler import FixedCountStragglers as JaxFixedCount
from repro.data import make_linear_problem as jax_problem
from repro_torch import convert
from repro_torch.core import coded_step as tcs
from repro_torch.core import encoding as tenc
from repro_torch.core import engine as teng
from repro_torch.core import schemes as tschemes
from repro_torch.data import make_linear_problem as torch_problem

STEPS, S, D = 10, 10, 12
BACKENDS = [("pallas", "cuda"), ("dense", "dense")]


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


@functools.cache
def _setup():
    prob = jax_problem(256, 80, seed=0)
    code = jldpc.make_regular_ldpc(20, l=3, r=6, seed=0)
    return prob, code, jenc.second_moment(prob.X, prob.y)


@functools.cache
def _masks(seed=1):
    keys = jax.random.split(jax.random.PRNGKey(seed), STEPS)
    return np.array(jax.vmap(lambda k: JaxFixedCount(S).sample(k, 40))(keys))


@functools.cache
def _jax_run(backend):
    prob, code, mom = _setup()
    scheme = jcs.Scheme2Blocked.build(code, mom, lr=prob.lr, decode_iters=D,
                                      decode_backend=backend)
    res = jcs.run_pgd(scheme, jnp.zeros(80), JaxFixedCount(S), STEPS,
                      key=jax.random.PRNGKey(1), theta_star=prob.theta_star)
    return scheme, res


@pytest.mark.parametrize("jax_backend,torch_backend", BACKENDS)
def test_run_pgd_blocked_matches_jax(jax_backend, torch_backend):
    prob, code, _ = _setup()
    scheme, want = _jax_run(jax_backend)
    port = convert.scheme2_blocked_from_arrays(
        convert.code_from(code), scheme.C_blocks, scheme.b, scheme.lr, D,
        device="cpu", decode_backend=torch_backend)
    got = tcs.run_pgd(port, torch.zeros(80), None, STEPS,
                      masks=torch.from_numpy(_masks()),
                      theta_star=convert.tensor(prob.theta_star, "cpu"))
    np.testing.assert_array_equal(_np(got.unresolved), np.asarray(want.unresolved))
    assert np.asarray(want.unresolved).sum() > 0      # the decode had work
    _close(_np(got.errors), want.errors)
    _close(_np(got.theta), want.theta)
    _close(_np(got.theta_bar), want.theta_bar)
    assert float(got.errors[-1]) < float(got.errors[0])


def test_masks_are_the_ones_jax_run_pgd_draws():
    # run_pgd's per-step unresolved counts are a function of the masks
    # alone; re-deriving them from the vmapped masks reproduces them.
    prob, code, mom = _setup()
    scheme, want = _jax_run("dense")
    theta = jnp.zeros(80)
    for t, mask in enumerate(_masks()):
        theta, unres = scheme.step(theta, jnp.asarray(mask))
        assert int(unres) == int(want.unresolved[t])
    assert (_masks().sum(axis=1) == S).all()


@pytest.mark.parametrize("jax_backend,torch_backend", BACKENDS)
def test_scheme2_step_matches_jax(jax_backend, torch_backend):
    jprob = jax_problem(256, 20, seed=1)
    code = jldpc.make_regular_ldpc(20, l=3, r=6, seed=2)
    mom = jenc.second_moment(jprob.X, jprob.y)
    scheme = jcs.Scheme2.build(code, mom, lr=jprob.lr, decode_iters=D,
                               decode_backend=jax_backend)
    theta = np.random.default_rng(0).standard_normal(20).astype(np.float32)
    mask = _masks(seed=3)[0]
    want_theta, want_unres = scheme.step(jnp.asarray(theta), jnp.asarray(mask))
    port = convert.scheme2_from_arrays(convert.code_from(code), scheme.C,
                                       scheme.b, scheme.lr, D, device="cpu",
                                       decode_backend=torch_backend)
    got_theta, got_unres = port.step(torch.from_numpy(theta), torch.from_numpy(mask))
    assert int(got_unres) == int(want_unres)
    _close(_np(got_theta), want_theta)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blocked_epilogue_matches_jax(seed):
    rng = np.random.default_rng(seed)
    N, K, nb = 40, 20, 4
    values = rng.standard_normal((N, nb)).astype(np.float32)
    erased = rng.random(N) < 0.3
    b = rng.standard_normal(K * nb).astype(np.float32)
    wg, wu = jeng.blocked_epilogue(jnp.asarray(values), jnp.asarray(erased),
                                   jnp.asarray(b), K=K, nb=nb)
    gg, gu = teng.blocked_epilogue(torch.from_numpy(values),
                                   torch.from_numpy(erased),
                                   torch.from_numpy(b), K=K, nb=nb)
    np.testing.assert_array_equal(_np(gg), np.asarray(wg))   # selects only
    np.testing.assert_array_equal(_np(gu), np.asarray(wu))


@pytest.mark.parametrize("jax_backend,torch_backend", BACKENDS)
def test_engine_recover_matches_jax(jax_backend, torch_backend):
    _, code, _ = _setup()
    rng = np.random.default_rng(5)
    msg = rng.standard_normal((20, 3)).astype(np.float32)
    mask = _masks()[4]
    jeng_ = jeng.CodedComputeEngine(code, decode_iters=D, backend=jax_backend)
    teng_ = teng.CodedComputeEngine(convert.code_from(code), decode_iters=D,
                                    backend=torch_backend)
    symbols = jeng_.encode(jnp.asarray(msg))
    _close(_np(teng_.encode(torch.from_numpy(msg))), symbols, rtol=1e-6)
    wv, wu = jeng_.recover(symbols, jnp.asarray(mask))
    gv, gu = teng_.recover(convert.tensor(symbols, "cpu"), torch.from_numpy(mask))
    np.testing.assert_array_equal(_np(gu), np.asarray(wu))
    _close(_np(gv), wv)


def test_encoding_matches_jax():
    prob, code, mom = _setup()
    tprob = torch_problem(256, 80, seed=0, device="cpu")
    tmom = tenc.second_moment(tprob.X, tprob.y)
    # one f32 matrix product each; the two libraries sum in other orders
    _close(_np(tmom.M), mom.M, rtol=1e-5)
    _close(_np(tmom.b), mom.b, rtol=1e-5)
    tcode = convert.code_from(code)
    M = convert.tensor(mom.M, "cpu")
    _close(_np(tenc.encode_moment_blocks(tcode, M)),
           jenc.encode_moment_blocks(code, mom.M), rtol=1e-5)
    code80 = jldpc.make_regular_ldpc(80, seed=0)
    _close(_np(tenc.encode_moment(convert.code_from(code80), M)),
           jenc.encode_moment(code80, mom.M), rtol=1e-5)
    with pytest.raises(ValueError):
        tenc.encode_moment(tcode, M)


def test_uncoded_step_matches_jax():
    prob, _, _ = _setup()
    mask = _masks()[0]
    theta = np.random.default_rng(1).standard_normal(80).astype(np.float32)
    want, wa = jschemes.Uncoded(prob.X, prob.y, w=40, lr=prob.lr).step(
        jnp.asarray(theta), jnp.asarray(mask))
    port = tschemes.Uncoded(convert.tensor(prob.X, "cpu"),
                            convert.tensor(prob.y, "cpu"), w=40, lr=prob.lr)
    got, ga = port.step(torch.from_numpy(theta), torch.from_numpy(mask))
    assert int(ga) == int(wa) == S
    _close(_np(got), want)


def test_run_pgd_rejects_masks_of_the_wrong_shape():
    prob, code, _ = _setup()
    scheme, _ = _jax_run("dense")
    port = convert.scheme2_blocked_from_arrays(
        convert.code_from(code), scheme.C_blocks, scheme.b, scheme.lr, D,
        device="cpu")
    with pytest.raises(ValueError, match="masks"):
        tcs.run_pgd(port, torch.zeros(80), None, STEPS,
                    masks=torch.zeros((STEPS, 39), dtype=torch.bool))
