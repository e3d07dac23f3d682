"""The port's seeded decodes against the JAX package's, contract by contract.

``backend="cuda_seeded"`` (on CPU tensors: the seeded kernel's plain
versions, ``ref.decode_seeded_*_ref``, which regenerate every check row from
the seed and build no H) against JAX ``backend="pallas_seeded"`` run in
interpret mode on the CPU, in both of its TPU round layouts
(``seeded_mode`` "dense_tile" and "gather"), and against JAX ``"sparse"``
over the materialized code's neighbour table.  The codes are
``make_seeded_ldpc`` (4, 8) codes at N = 512 and 2048.

Inputs are made with numpy from a seed: codewords of the code (random
vectors of H's null space), erasure fractions 0, 0.25 (below the (4, 8)
threshold: everything resolves) and 0.45 (above it: the decode stalls and
leaves coordinates unresolved), and large garbage in the erased entries.
Masks and round counts must match exactly.  Values must agree, per slot
over the resolved coordinates, within the anchored bound of
tests/test_torch_decode_batch.py::

    |port − ref| ≤ 1e-4·max|c| + 4·max(|ref − c|, |dec64 − c|)

with ``dec64`` the port's decode of the same f32 inputs in float64: JAX's
two layouts sum each check in other orders than the port's ascending
column order (and "sparse" keeps the highest resolving row, the port the
lowest), so only the trajectory is exact.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decoder as jdec
from repro.core import ldpc as jldpc
from repro_torch.convert import code_from
from repro_torch.core import decoder as tdec
from repro_torch.kernels.ldpc_peel import ref

KS = (256, 1024)                     # N = 512 and 2048
VS = (1, 2)
FRACTIONS = (0.0, 0.25, 0.45)
JAX = [("pallas_seeded", "dense_tile"), ("pallas_seeded", "gather"), ("sparse", None)]
JAX_IDS = ["dense_tile", "gather", "sparse"]
B = 4
GRID = [(K, V, f) for K in KS for V in VS for f in FRACTIONS]


@functools.cache
def _codes(K):
    jc = jldpc.make_seeded_ldpc(K, seed=0)
    return jc, code_from(jc)


@functools.cache
def _null_space(K):
    jc, _ = _codes(K)
    _, sv, vt = np.linalg.svd(jc.H.astype(np.float64))
    rank = int((sv > 1e-9 * sv[0]).sum())
    return vt[rank:].T                                   # (N, N - rank)


def _inputs(K, V, f, batch, salt=0):
    """``(values (B, N, V), erased (B, N), truth (B, N, V))``."""
    basis = _null_space(K)
    rng = np.random.default_rng([K, V, int(f * 100), batch, salt])
    N = basis.shape[0]
    erased = rng.random((batch, N)) < f
    coef = rng.standard_normal((batch, basis.shape[1], V))
    truth = np.einsum("nk,bkv->bnv", basis, coef)
    truth = (truth / np.abs(truth).max()).astype(np.float32)
    garbage = (1e3 * rng.standard_normal((batch, N, V))).astype(np.float32)
    return np.where(erased[..., None], garbage, truth), erased, truth


def _jax_kw(backend, mode):
    return {"backend": backend} | ({"seeded_mode": mode} if mode else {})


def _assert_agree(values, erased, truth, got, want, dec64):
    """Batched ``(values (B, N, V), erased (B, N))`` pairs, slot by slot."""
    (gv, ge), (wv, we) = got, want
    np.testing.assert_array_equal(ge, we)           # trajectories: exact
    unresolved = ~(erased & ~we)
    np.testing.assert_array_equal(gv[unresolved], values[unresolved])
    np.testing.assert_array_equal(wv[unresolved], values[unresolved])
    for b in range(values.shape[0]):
        resolved = ~unresolved[b]
        if not resolved.any():
            continue
        scale = float(np.abs(truth[b]).max())
        anchor = max(float(np.abs(wv[b] - truth[b])[resolved].max()),
                     float(np.abs(dec64[b] - truth[b])[resolved].max()))
        diff = float(np.abs(gv[b] - wv[b]).max())
        assert diff <= 1e-4 * scale + 4 * anchor, (b, diff, scale, anchor)


def _f64(contract, tc, values, erased, arg):
    """The port's seeded decode of the same inputs in float64 (numpy)."""
    st = tdec.seeded_spec(tc)
    v, e = torch.from_numpy(values).double(), torch.from_numpy(erased)
    fn = {"fixed": ref.decode_seeded_ref, "batch": ref.decode_seeded_batch_ref,
          "adaptive": ref.decode_seeded_adaptive_ref,
          "batch_adaptive": ref.decode_seeded_batch_adaptive_ref}[contract]
    return fn(st, v, e, arg)[0].numpy()


def _np(res):
    return np.asarray(res.values), np.asarray(res.erased)


def _torch(res):
    return res.values.numpy(), res.erased.numpy()


@pytest.mark.parametrize("backend,mode", JAX, ids=JAX_IDS)
@pytest.mark.parametrize("D", [0, 1, 8])
@pytest.mark.parametrize("K,V,f", GRID)
def test_fixed_matches_jax(K, V, f, D, backend, mode):
    jc, tc = _codes(K)
    values, erased, truth = _inputs(K, V, f, 1)
    want = jdec.peel_decode(jc, jnp.asarray(values[0]), jnp.asarray(erased[0]), D,
                            **_jax_kw(backend, mode))
    got = tdec.peel_decode(tc, torch.from_numpy(values[0]),
                           torch.from_numpy(erased[0]), D)
    assert got.rounds_used == D
    gv, ge = _torch(got)
    wv, we = _np(want)
    d64 = _f64("fixed", tc, values[0], erased[0], D)
    _assert_agree(values, erased, truth, (gv[None], ge[None]), (wv[None], we[None]),
                  d64[None])


@pytest.mark.parametrize("backend,mode", JAX, ids=JAX_IDS)
@pytest.mark.parametrize("D", [0, 1, 8])
@pytest.mark.parametrize("K,V,f", GRID)
def test_batch_matches_jax(K, V, f, D, backend, mode):
    jc, tc = _codes(K)
    values, erased, truth = _inputs(K, V, f, B, salt=1)
    want = jdec.peel_decode_batch(jc, jnp.asarray(values), jnp.asarray(erased), D,
                                  **_jax_kw(backend, mode))
    got = tdec.peel_decode_batch(tc, torch.from_numpy(values),
                                 torch.from_numpy(erased), D, backend="cuda_seeded")
    assert got.rounds_used == D
    _assert_agree(values, erased, truth, _torch(got), _np(want),
                  _f64("batch", tc, values, erased, D))


@pytest.mark.parametrize("backend,mode", JAX, ids=JAX_IDS)
@pytest.mark.parametrize("budget", [0, 1, 8, "N"])
@pytest.mark.parametrize("K,V,f", GRID)
def test_adaptive_matches_jax(K, V, f, budget, backend, mode):
    jc, tc = _codes(K)
    max_iters = jc.N if budget == "N" else budget
    values, erased, truth = _inputs(K, V, f, 1, salt=2)
    want = jdec.peel_decode_adaptive(jc, jnp.asarray(values[0]),
                                     jnp.asarray(erased[0]), max_iters,
                                     **_jax_kw(backend, mode))
    got = tdec.peel_decode_adaptive(tc, torch.from_numpy(values[0]),
                                    torch.from_numpy(erased[0]), max_iters)
    assert got.rounds_used.dtype == torch.int32 and got.rounds_used.ndim == 0
    assert int(got.rounds_used) == int(want.rounds_used)
    gv, ge = _torch(got)
    wv, we = _np(want)
    d64 = _f64("adaptive", tc, values[0], erased[0], max_iters)
    _assert_agree(values, erased, truth, (gv[None], ge[None]), (wv[None], we[None]),
                  d64[None])


@pytest.mark.parametrize("backend,mode", JAX, ids=JAX_IDS)
@pytest.mark.parametrize("budgets", ["mixed", "reversed"])
@pytest.mark.parametrize("K,V,f", GRID)
def test_batch_adaptive_matches_jax(K, V, f, budgets, backend, mode):
    jc, tc = _codes(K)
    values, erased, truth = _inputs(K, V, f, B, salt=3)
    bud = np.array({"mixed": [0, 1, 8, jc.N], "reversed": [jc.N, 8, 1, 0]}[budgets],
                   np.int32)
    want = jdec.peel_decode_batch_adaptive(jc, jnp.asarray(values), jnp.asarray(erased),
                                           budgets=jnp.asarray(bud),
                                           **_jax_kw(backend, mode))
    got = tdec.peel_decode_batch_adaptive(tc, torch.from_numpy(values),
                                          torch.from_numpy(erased),
                                          budgets=torch.from_numpy(bud))
    assert got.rounds_used.dtype == torch.int32
    np.testing.assert_array_equal(got.rounds_used.numpy(), np.asarray(want.rounds_used))
    _assert_agree(values, erased, truth, _torch(got), _np(want),
                  _f64("batch_adaptive", tc, values, erased, torch.from_numpy(bud)))


def test_the_grid_reaches_both_ends():
    # q = 0.25 resolves every erasure within 8 rounds and q = 0.45 stalls
    # with coordinates left unresolved, so both paths are exercised.
    jc, tc = _codes(1024)
    for f, stalls in ((0.25, False), (0.45, True)):
        values, erased, _ = _inputs(1024, 1, f, 1)
        got = tdec.peel_decode(tc, torch.from_numpy(values[0]),
                               torch.from_numpy(erased[0]), 8)
        assert bool(got.erased.any()) is stalls
        assert bool((torch.from_numpy(erased[0]) & ~got.erased).any())


# ---------------------------------------------- past the kernels' old caps
# A (20, 24) code: 20 layers and row weight 24, both past the 16 that the
# seeded kernels once took (N = 384).  q = 0.15 resolves every erasure
# within 8 rounds, q = 0.3 stalls.

@functools.cache
def _wide_code():
    jc = jldpc.make_seeded_ldpc(64, l=20, r=24, seed=0)
    assert jldpc.seeded_structure_of(jc).layers == 20
    _, sv, vt = np.linalg.svd(jc.H.astype(np.float64))
    basis = vt[int((sv > 1e-9 * sv[0]).sum()):].T
    return jc, code_from(jc), basis


def _wide_inputs(f, batch):
    jc, _, basis = _wide_code()
    rng = np.random.default_rng([int(f * 100), batch])
    erased = rng.random((batch, jc.N)) < f
    truth = np.einsum("nk,bkv->bnv", basis,
                      rng.standard_normal((batch, basis.shape[1], 2)))
    truth = (truth / np.abs(truth).max()).astype(np.float32)
    garbage = (1e3 * rng.standard_normal((batch, jc.N, 2))).astype(np.float32)
    return np.where(erased[..., None], garbage, truth), erased, truth


@pytest.mark.parametrize("backend,mode", JAX, ids=JAX_IDS)
@pytest.mark.parametrize("contract", ["fixed", "batch_adaptive"])
def test_past_the_old_caps_matches_jax(contract, backend, mode):
    jc, tc, _ = _wide_code()
    stalls = []
    for f in (0.15, 0.3):
        if contract == "fixed":
            values, erased, truth = _wide_inputs(f, 1)
            want = jdec.peel_decode(jc, jnp.asarray(values[0]), jnp.asarray(erased[0]),
                                    8, **_jax_kw(backend, mode))
            got = tdec.peel_decode(tc, torch.from_numpy(values[0]),
                                   torch.from_numpy(erased[0]), 8, backend="cuda_seeded")
            want = tuple(a[None] for a in _np(want))
            got = tuple(a[None] for a in _torch(got))
            d64 = _f64("fixed", tc, values[0], erased[0], 8)[None]
        else:
            values, erased, truth = _wide_inputs(f, B)
            bud = np.array([0, 1, 8, jc.N], np.int32)
            want = jdec.peel_decode_batch_adaptive(
                jc, jnp.asarray(values), jnp.asarray(erased), budgets=jnp.asarray(bud),
                **_jax_kw(backend, mode))
            got = tdec.peel_decode_batch_adaptive(
                tc, torch.from_numpy(values), torch.from_numpy(erased),
                budgets=torch.from_numpy(bud), backend="cuda_seeded")
            np.testing.assert_array_equal(got.rounds_used.numpy(),
                                          np.asarray(want.rounds_used))
            want, got = _np(want), _torch(got)
            d64 = _f64("batch_adaptive", tc, values, erased, torch.from_numpy(bud))
        _assert_agree(values, erased, truth, got, want, d64)
        stalls.append(bool(got[1][-1].any()))
    assert stalls == [False, True]
