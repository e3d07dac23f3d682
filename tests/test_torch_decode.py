"""The port's peeling decodes against the JAX package's, case by case.

* ``ref.decode_fused_ref`` (what the CUDA kernel is held against) against
  JAX ``peel_decode(backend="pallas")``, run in interpret mode on the CPU:
  both keep the LOWEST check row where several checks resolve a coordinate.
* The port's ``dense`` against JAX ``dense``: both keep the HIGHEST row.

Inputs are made with numpy from a seed.  Two kinds of code:

* ``pm1`` (±1 edge weights) with small-integer payloads that are NOT
  codewords.  Every sum and quotient is then an exact integer in f32, so
  the two packages must agree BIT FOR BIT whatever their summation order;
  and since the checks propose inconsistent values, a wrong tie-break or a
  wrong neighbour changes the result.
* ``gaussian`` (the paper's code) with codeword payloads.  Values agree up
  to f32 rounding, which a peeling chain amplifies wherever it divides by a
  small coefficient.  The bound is therefore anchored to the reference's
  own error against the true codeword on the same case: ``|port − ref| ≤
  1e-4·max|c| + 4·max|ref − c|``.  The 1e-4 term is f32 summation order
  (about 1e-5 relative in practice); the second term admits the port's
  independent rounding along the same chain, up to three times the
  reference's.  A wrong value is O(max|c|) and fails it.

Erased inputs hold large garbage: an implementation that reads them fails.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ldpc as jldpc
from repro.core.decoder import peel_decode as jax_peel_decode
from repro_torch.convert import code_from
from repro_torch.core import decoder as tdec
from repro_torch.kernels.ldpc_peel import (CodeTables, decode_fused_ref,
                                           dense_h, ops, peel_decode_cuda)

WEIGHTS = ("gaussian", "pm1")
KS = (20, 64)                    # the (40, 20) code and N = 128
VS = (1, 3, 8)
FRACTIONS = (0.0, 0.2, 0.4, 0.55)
DS = (0, 1, 4, 12)
CASES = [(w, K, V, f, D) for w in WEIGHTS for K in KS for V in VS
         for f in FRACTIONS for D in DS]


@functools.cache
def _codes(weights, K):
    jc = jldpc.make_regular_ldpc(K, l=3, r=6, seed=0, values=weights)
    return jc, code_from(jc)


def _inputs(weights, K, V, f, D):
    jc, _ = _codes(weights, K)
    rng = np.random.default_rng([K, V, int(f * 100), D, len(weights)])
    erased = rng.random(jc.N) < f
    if weights == "gaussian":
        truth = (jc.G @ rng.standard_normal((K, V))).astype(np.float32)
    else:
        truth = rng.integers(-8, 9, (jc.N, V)).astype(np.float32)
    garbage = (1e3 * rng.standard_normal((jc.N, V))).astype(np.float32)
    values = np.where(erased[:, None], garbage, truth)
    return values, erased, truth


def _jax(weights, K, V, f, D, backend):
    jc, _ = _codes(weights, K)
    values, erased, _ = _inputs(weights, K, V, f, D)
    res = jax_peel_decode(jc, jnp.asarray(values), jnp.asarray(erased), D,
                          backend=backend)
    return np.asarray(res.values), np.asarray(res.erased)


def _assert_agree(weights, values, erased, truth, got, want):
    (gv, ge), (wv, we) = got, want
    np.testing.assert_array_equal(ge, we)           # trajectories: exact
    unresolved = ~(erased & ~we)
    np.testing.assert_array_equal(gv[unresolved], values[unresolved])
    np.testing.assert_array_equal(wv[unresolved], values[unresolved])
    if weights == "pm1":
        np.testing.assert_array_equal(gv, wv)
        return
    resolved = ~unresolved
    if not resolved.any():
        return
    scale = float(np.abs(truth).max())
    ref_err = float(np.abs(wv - truth)[resolved].max())
    diff = float(np.abs(gv - wv).max())
    assert diff <= 1e-4 * scale + 4 * ref_err, (diff, scale, ref_err)


@pytest.mark.parametrize("weights,K,V,f,D", CASES)
def test_ref_matches_jax_pallas(weights, K, V, f, D):
    _, tc = _codes(weights, K)
    values, erased, truth = _inputs(weights, K, V, f, D)
    H = dense_h(torch.from_numpy(tc.check_idx), torch.from_numpy(tc.check_coeff),
                tc.N)
    v, e = decode_fused_ref(H, torch.from_numpy(values),
                            torch.from_numpy(erased), D)
    _assert_agree(weights, values, erased, truth, (v.numpy(), e.numpy()),
                  _jax(weights, K, V, f, D, "pallas"))


@pytest.mark.parametrize("weights,K,V,f,D", CASES)
def test_dense_matches_jax_dense(weights, K, V, f, D):
    _, tc = _codes(weights, K)
    values, erased, truth = _inputs(weights, K, V, f, D)
    res = tdec.peel_decode(tc, torch.from_numpy(values),
                           torch.from_numpy(erased), D, backend="dense")
    assert res.rounds_used == D
    _assert_agree(weights, values, erased, truth,
                  (res.values.numpy(), res.erased.numpy()),
                  _jax(weights, K, V, f, D, "dense"))


@pytest.mark.parametrize("backend", ["cuda", "auto"])
def test_cuda_backend_on_cpu_runs_the_plain_version(backend):
    _, tc = _codes("pm1", 64)
    values, erased, _ = _inputs("pm1", 64, 3, 0.4, 12)
    before = peel_decode_cuda.launches
    res = tdec.peel_decode(tc, torch.from_numpy(values),
                           torch.from_numpy(erased), 12, backend=backend)
    assert peel_decode_cuda.launches == before == 0
    H = dense_h(torch.from_numpy(tc.check_idx), torch.from_numpy(tc.check_coeff),
                tc.N)
    v, e = decode_fused_ref(H, torch.from_numpy(values), torch.from_numpy(erased), 12)
    torch.testing.assert_close(res.values, v, rtol=0, atol=0)
    assert torch.equal(res.erased, e)


def test_scalar_payload_squeezes():
    _, tc = _codes("gaussian", 20)
    values, erased, _ = _inputs("gaussian", 20, 1, 0.2, 4)
    res = tdec.peel_decode(tc, torch.from_numpy(values[:, 0]),
                           torch.from_numpy(erased), 4)
    want = tdec.peel_decode(tc, torch.from_numpy(values),
                            torch.from_numpy(erased), 4)
    assert res.values.shape == (tc.N,)
    assert torch.equal(res.values, want.values[:, 0])


def test_erased_entries_are_never_read():
    _, tc = _codes("gaussian", 64)
    values, erased, _ = _inputs("gaussian", 64, 3, 0.4, 12)
    outs = []
    for fill in (0.0, float("nan"), float("inf")):
        v = np.where(erased[:, None], np.float32(fill), values)
        res = tdec.peel_decode(tc, torch.from_numpy(v), torch.from_numpy(erased),
                               12, backend="cuda")
        outs.append(res)
    resolved = torch.from_numpy(erased) & ~outs[0].erased
    assert resolved.any()
    for res in outs[1:]:
        assert torch.equal(res.erased, outs[0].erased)
        assert torch.equal(res.values[resolved], outs[0].values[resolved])


def test_dense_h_rebuilds_h():
    jc, tc = _codes("gaussian", 64)
    H = dense_h(torch.from_numpy(tc.check_idx), torch.from_numpy(tc.check_coeff),
                tc.N)
    np.testing.assert_array_equal(H.numpy(), jc.H.astype(np.float32))


def test_code_tables_are_cached_per_device():
    _, tc = _codes("gaussian", 20)
    a = tdec.code_tables(tc, "cpu")
    assert tdec.code_tables(tc, torch.device("cpu")) is a
    assert a.check_idx.dtype == torch.int32 and a.check_coeff.dtype == torch.float32
    np.testing.assert_array_equal(a.check_idx.numpy(), tc.check_idx)


def test_resolve_backend():
    assert tdec.resolve_backend("auto") == "cuda"
    assert tdec.resolve_backend("cuda") == "cuda"
    assert tdec.resolve_backend("dense") == "dense"
    with pytest.raises(ValueError, match="unknown"):
        tdec.resolve_backend("pallas")


def test_dense_matrices_are_cached_per_device_and_dtype():
    jc, tc = _codes("pm1", 20)
    values, erased, _ = _inputs("pm1", 20, 3, 0.4, 12)
    tdec.peel_decode(tc, torch.from_numpy(values), torch.from_numpy(erased), 12,
                     backend="dense")
    H, Hb = tc.device_cache["dense", torch.device("cpu"), torch.float32]
    np.testing.assert_array_equal(H.numpy(), jc.H.astype(np.float32))
    assert torch.equal(Hb, H != 0)
    tdec.peel_decode(tc, torch.from_numpy(values), torch.from_numpy(erased), 12,
                     backend="dense")
    assert tc.device_cache["dense", torch.device("cpu"), torch.float32][0] is H


def _tables():
    _, tc = _codes("gaussian", 20)
    return CodeTables(torch.from_numpy(tc.check_idx),
                      torch.from_numpy(tc.check_coeff), tc.N)


@pytest.mark.parametrize("bad", ["dtype", "erased_dtype", "shape",
                                 "noncontiguous", "iters", "table_dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    t = _tables()
    v = torch.zeros((t.N, 4))
    e = torch.zeros(t.N, dtype=torch.bool)
    iters = 3
    if bad == "dtype":
        v = v.double()
    elif bad == "erased_dtype":
        e = e.to(torch.uint8)
    elif bad == "shape":
        v = torch.zeros((t.N + 1, 4))
    elif bad == "noncontiguous":
        v = torch.zeros((4, t.N)).T
    elif bad == "iters":
        iters = -1
    elif bad == "table_dtype":
        t = t._replace(check_idx=t.check_idx.long())
    with pytest.raises(ValueError):
        peel_decode_cuda(t, v, e, iters)


def test_wrapper_rejects_codes_past_shared_memory():
    # Past the shared memory a block may hold the wrapper used to reject
    # the code.  The kernel now keeps its state in device memory there, so
    # the wrapper takes any N: the (40, 20) code's table spread over the
    # fewest columns whose state is past shared memory (N from the state's
    # size, about 890,000 at two bits a coordinate) decodes as the code
    # itself does.
    t = _tables()
    p, r = t.check_idx.shape
    stride = 1
    while ops._smem_bytes(t.N * stride, p, r) <= ops.MAX_SMEM_BYTES:
        stride += 1
    N = t.N * stride
    assert ops._smem_bytes(N, p, r) > ops.MAX_SMEM_BYTES
    assert not ops.table_layout(t._replace(N=N), 1, 2)[1]
    values, erased, _ = _inputs("gaussian", 20, 2, 0.3, 6)
    wide = t._replace(check_idx=t.check_idx * stride, N=N)
    v = torch.zeros((N, 2))
    e = torch.zeros(N, dtype=torch.bool)
    v[::stride], e[::stride] = torch.from_numpy(values), torch.from_numpy(erased)
    gv, ge = peel_decode_cuda(wide, v, e, 6)
    wv, we = peel_decode_cuda(t, torch.from_numpy(values), torch.from_numpy(erased), 6)
    assert torch.equal(ge[::stride], we) and not ge[1::stride].any()
    assert torch.equal(gv[::stride], wv) and not gv[1::stride].any()
