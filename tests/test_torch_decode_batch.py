"""The port's batched and adaptive peeling decodes against the JAX package's.

Three contracts: ``peel_decode_batch`` (B patterns, fixed D),
``peel_decode_adaptive`` (one pattern, early exit) and
``peel_decode_batch_adaptive`` (B patterns, per-slot early exit under
per-slot budgets).  For each:

* the kernel's plain version (``ref.decode_fused_*_ref``, what the CUDA
  kernel is held against on the card; it is what ``backend="cuda"`` runs
  on CPU tensors) against JAX ``backend="pallas"``, run in interpret mode on
  the CPU: both keep the LOWEST check row where several checks resolve one
  coordinate;
* the port's ``dense`` against JAX ``dense``: both keep the HIGHEST row.

Inputs are made with numpy from a seed and handed to both packages.
Masks and round counts must match exactly (solvability is an integer
count).  Values: on ``pm1`` codes (±1 weights) with small-integer payloads
that are NOT codewords, every sum and quotient is an exact integer in f32,
so the packages must agree bit for bit and a wrong tie-break shows.  On
``gaussian`` codes with codeword payloads, per slot, over the resolved
coordinates::

    |port − ref| ≤ 1e-4·max|c| + 4·max(|ref − c|, |dec64 − c|)

The 1e-4 term is f32 summation order.  The second admits the port's own
rounding along a peeling chain, which divides by small Gaussian
coefficients and amplifies one rounding step a thousandfold or more.  It
is anchored to how far such a chain amplifies rounding on this very case,
measured twice: by the reference's own error against the true codeword
``c``, and by ``dec64``, the port's decode of the same f32 inputs under
the same tie-break in float64 (the plain version on a float64 H, or the
dense backend), whose error against ``c`` is the f32 rounding of the inputs
carried along the chains.  The second measure is needed because a single
f32 decode can be lucky: a sum of a few terms is often exact, and then its
error is far below the chain's usual one (on one adaptive case of this grid
the port differs from the reference by 10.3× the reference's own error,
but by at most 3.73× the larger measure).  A wrong value is O(max|c|).

Erased inputs hold large garbage: an implementation that reads them fails.
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
from repro_torch.kernels.ldpc_peel import (CodeTables, peel_decode_adaptive_cuda,
                                           peel_decode_batch_adaptive_cuda,
                                           peel_decode_batch_cuda)

WEIGHTS = ("gaussian", "pm1")
KS = (20, 64)                    # the (40, 20) code and N = 128
VS = (1, 3)
FRACTIONS = (0.0, 0.08, 0.3, 0.42)
B = 4
GRID = [(w, K, V, f) for w in WEIGHTS for K in KS for V in VS
        for f in FRACTIONS]


@functools.cache
def _codes(weights, K):
    jc = jldpc.make_regular_ldpc(K, l=3, r=6, seed=0, values=weights)
    return jc, code_from(jc)


def _inputs(weights, K, V, f, batch, salt=0):
    """``(values (B, N, V), erased (B, N), truth (B, N, V))``."""
    jc, _ = _codes(weights, K)
    rng = np.random.default_rng([K, V, int(f * 100), batch, len(weights), salt])
    erased = rng.random((batch, jc.N)) < f
    if weights == "gaussian":
        truth = np.einsum("nk,bkv->bnv", jc.G,
                          rng.standard_normal((batch, K, V))).astype(np.float32)
    else:
        truth = rng.integers(-8, 9, (batch, jc.N, V)).astype(np.float32)
    garbage = (1e3 * rng.standard_normal((batch, jc.N, V))).astype(np.float32)
    return np.where(erased[..., None], garbage, truth), erased, truth


def _budgets(kind, N):
    return np.array({"mixed": [0, 1, 3, N], "reversed": [N, 3, 1, 0],
                     "full": [N] * B}[kind], np.int32)


def _assert_agree(weights, values, erased, truth, got, want, dec64=None):
    """Batched ``(values (B, N, V), erased (B, N))`` pairs, slot by slot;
    ``dec64`` is the float64 decode of the same case (Gaussian codes)."""
    (gv, ge), (wv, we) = got, want
    np.testing.assert_array_equal(ge, we)           # trajectories: exact
    unresolved = ~(erased & ~we)
    np.testing.assert_array_equal(gv[unresolved], values[unresolved])
    np.testing.assert_array_equal(wv[unresolved], values[unresolved])
    if weights == "pm1":
        np.testing.assert_array_equal(gv, wv)
        return
    for b in range(values.shape[0]):
        resolved = ~unresolved[b]
        if not resolved.any():
            continue
        scale = float(np.abs(truth[b]).max())
        anchor = max(float(np.abs(wv[b] - truth[b])[resolved].max()),
                     float(np.abs(dec64[b] - truth[b])[resolved].max()))
        diff = float(np.abs(gv[b] - wv[b]).max())
        assert diff <= 1e-4 * scale + 4 * anchor, (b, diff, scale, anchor)


def _f64(contract, backend, tc, values, erased, arg):
    """The same decode of the same inputs in float64 under the same
    tie-break (``backend`` "cuda": the plain "lo" version on a float64 H;
    "dense": the dense backend), as numpy.  ``arg`` is the contract's D,
    max_iters or budgets."""
    v, e = torch.from_numpy(values).double(), torch.from_numpy(erased)
    if backend == "cuda":
        H = torch.from_numpy(tc.H).double()
        fn = {"batch": ref.decode_fused_batch_ref,
              "adaptive": ref.decode_fused_adaptive_ref,
              "batch_adaptive": ref.decode_fused_batch_adaptive_ref}[contract]
        return fn(H, v, e, arg)[0].numpy()
    if contract == "batch":
        res = tdec.peel_decode_batch(tc, v, e, arg, backend="dense")
    elif contract == "adaptive":
        res = tdec.peel_decode_adaptive(tc, v, e, arg, backend="dense")
    else:
        res = tdec.peel_decode_batch_adaptive(tc, v, e, backend="dense", budgets=arg)
    return res.values.numpy()


def _np(res):
    return np.asarray(res.values), np.asarray(res.erased)


def _torch(res):
    return res.values.numpy(), res.erased.numpy()


# ------------------------------------------------------ fixed D, B patterns

@pytest.mark.parametrize("jax_backend,torch_backend",
                         [("pallas", "cuda"), ("dense", "dense")])
@pytest.mark.parametrize("D", [1, 6])
@pytest.mark.parametrize("weights,K,V,f", GRID)
def test_batch_matches_jax(weights, K, V, f, D, jax_backend, torch_backend):
    jc, tc = _codes(weights, K)
    values, erased, truth = _inputs(weights, K, V, f, B)
    want = jdec.peel_decode_batch(jc, jnp.asarray(values), jnp.asarray(erased),
                                  D, backend=jax_backend)
    got = tdec.peel_decode_batch(tc, torch.from_numpy(values),
                                 torch.from_numpy(erased), D,
                                 backend=torch_backend)
    assert got.rounds_used == D
    _assert_agree(weights, values, erased, truth, _torch(got), _np(want),
                  _f64("batch", torch_backend, tc, values, erased, D))


# --------------------------------------------- early exit, one pattern

@pytest.mark.parametrize("jax_backend,torch_backend",
                         [("pallas", "cuda"), ("dense", "dense")])
@pytest.mark.parametrize("budget", [0, 1, 3, "N"])
@pytest.mark.parametrize("weights,K,V,f", GRID)
def test_adaptive_matches_jax(weights, K, V, f, budget, jax_backend,
                              torch_backend):
    jc, tc = _codes(weights, K)
    max_iters = jc.N if budget == "N" else budget
    values, erased, truth = _inputs(weights, K, V, f, 1)
    want = jdec.peel_decode_adaptive(jc, jnp.asarray(values[0]),
                                     jnp.asarray(erased[0]), max_iters,
                                     backend=jax_backend)
    got = tdec.peel_decode_adaptive(tc, torch.from_numpy(values[0]),
                                    torch.from_numpy(erased[0]), max_iters,
                                    backend=torch_backend)
    assert got.rounds_used.dtype == torch.int32 and got.rounds_used.ndim == 0
    assert int(got.rounds_used) == int(want.rounds_used)
    gv, ge = _torch(got)
    wv, we = _np(want)
    d64 = _f64("adaptive", torch_backend, tc, values[0], erased[0], max_iters)
    _assert_agree(weights, values, erased, truth, (gv[None], ge[None]),
                  (wv[None], we[None]), d64[None])


# ------------------------------------- per-slot early exit, B patterns

@pytest.mark.parametrize("jax_backend,torch_backend",
                         [("pallas", "cuda"), ("dense", "dense")])
@pytest.mark.parametrize("budgets", ["mixed", "reversed", "full"])
@pytest.mark.parametrize("weights,K,V,f", GRID)
def test_batch_adaptive_matches_jax(weights, K, V, f, budgets, jax_backend,
                                    torch_backend):
    jc, tc = _codes(weights, K)
    values, erased, truth = _inputs(weights, K, V, f, B)
    bud = _budgets(budgets, jc.N)
    want = jdec.peel_decode_batch_adaptive(
        jc, jnp.asarray(values), jnp.asarray(erased), backend=jax_backend,
        budgets=jnp.asarray(bud))
    got = tdec.peel_decode_batch_adaptive(
        tc, torch.from_numpy(values), torch.from_numpy(erased),
        backend=torch_backend, budgets=torch.from_numpy(bud))
    assert got.rounds_used.dtype == torch.int32
    np.testing.assert_array_equal(got.rounds_used.numpy(),
                                  np.asarray(want.rounds_used))
    _assert_agree(weights, values, erased, truth, _torch(got), _np(want),
                  _f64("batch_adaptive", torch_backend, tc, values, erased,
                       torch.from_numpy(bud)))


@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_scalar_payloads_squeeze(backend):
    _, tc = _codes("gaussian", 20)
    values, erased, _ = _inputs("gaussian", 20, 1, 0.3, B)
    v, e = torch.from_numpy(values), torch.from_numpy(erased)
    for fn, kw in ((tdec.peel_decode_batch, {"iters": 4}),
                   (tdec.peel_decode_batch_adaptive, {})):
        res = fn(tc, v[..., 0], e, backend=backend, **kw)
        want = fn(tc, v, e, backend=backend, **kw)
        assert res.values.shape == (B, tc.N)
        assert torch.equal(res.values, want.values[..., 0])
    one = tdec.peel_decode_adaptive(tc, v[0, :, 0], e[0], backend=backend)
    assert one.values.shape == (tc.N,)


# ------------------------------------------------------------ hazards

def _tables(tc):
    return tdec.code_tables(tc, "cpu")


@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_slots_stop_on_their_own(backend):
    # Each slot of one batched launch, under its own budget, equals the
    # single-pattern adaptive decode of that slot: slots that disagree on
    # when to stop do not hold each other up or get cut short.
    _, tc = _codes("pm1", 64)
    values, erased, _ = _inputs("pm1", 64, 3, 0.42, 8)
    erased[5] = False                       # one slot with nothing erased
    bud = np.array([0, 1, 2, 3, 5, 7, tc.N, tc.N], np.int32)
    res = tdec.peel_decode_batch_adaptive(
        tc, torch.from_numpy(values), torch.from_numpy(erased),
        backend=backend, budgets=torch.from_numpy(bud))
    rounds = res.rounds_used.tolist()
    for b in range(8):
        one = tdec.peel_decode_adaptive(tc, torch.from_numpy(values[b]),
                                        torch.from_numpy(erased[b]),
                                        int(bud[b]), backend=backend)
        assert int(one.rounds_used) == rounds[b], b
        assert torch.equal(one.erased, res.erased[b])
        assert torch.equal(one.values, res.values[b])
    assert rounds[0] == 0 and rounds[5] == 0
    assert len(set(rounds[1:5] + rounds[6:])) > 2       # they disagree


@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_budget_zero_beside_busy_slots_is_untouched(backend):
    _, tc = _codes("gaussian", 64)
    values, erased, _ = _inputs("gaussian", 64, 3, 0.3, B)
    bud = torch.tensor([tc.N, 0, tc.N, 0], dtype=torch.int32)
    res = tdec.peel_decode_batch_adaptive(
        tc, torch.from_numpy(values), torch.from_numpy(erased),
        backend=backend, budgets=bud)
    for b in (1, 3):
        assert int(res.rounds_used[b]) == 0
        assert torch.equal(res.values[b], torch.from_numpy(values[b]))
        assert torch.equal(res.erased[b], torch.from_numpy(erased[b]))
    assert (res.rounds_used[[0, 2]] > 0).all()


@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_budget_ending_mid_peel_equals_fixed_rounds(backend):
    # A budget that runs out while the slot still peels leaves it where D =
    # budget fixed rounds would: rounds == budget, the same mask and values.
    _, tc = _codes("pm1", 64)
    values, erased, _ = _inputs("pm1", 64, 3, 0.42, B, salt=1)
    full = tdec.peel_decode_batch_adaptive(
        tc, torch.from_numpy(values), torch.from_numpy(erased), backend=backend)
    cut = max(1, int(full.rounds_used.min()) - 2)
    assert int(full.rounds_used.min()) > cut
    res = tdec.peel_decode_batch_adaptive(
        tc, torch.from_numpy(values), torch.from_numpy(erased), backend=backend,
        budgets=torch.full((B,), cut, dtype=torch.int32))
    fixed = tdec.peel_decode_batch(tc, torch.from_numpy(values),
                                   torch.from_numpy(erased), cut,
                                   backend=backend)
    assert res.rounds_used.tolist() == [cut] * B
    assert torch.equal(res.erased, fixed.erased)
    assert torch.equal(res.values, fixed.values)
    assert (res.erased.sum(dim=1) > full.erased.sum(dim=1)).all()


@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_probe_round_at_chunk_boundary(backend):
    # A pattern that gets stuck after R productive rounds costs R + 1 rounds
    # (the no-progress probe).  Decoded in chunks of exactly R, the first
    # launch spends R rounds without noticing the fixpoint; the next one
    # spends the probe round alone.  Together: R + 1, as in one decode.
    _, tc = _codes("pm1", 64)
    for salt in range(50):
        values, erased, _ = _inputs("pm1", 64, 1, 0.42, 1, salt=salt)
        v, e = torch.from_numpy(values), torch.from_numpy(erased)
        one = tdec.peel_decode_batch_adaptive(tc, v, e, backend=backend)
        if bool(one.erased.any()) and int(one.rounds_used[0]) >= 3:
            break
    else:
        pytest.fail("no stuck pattern among the seeds")
    R = int(one.rounds_used[0]) - 1
    first = tdec.peel_decode_batch_adaptive(
        tc, v, e, backend=backend, budgets=torch.tensor([R], dtype=torch.int32))
    assert int(first.rounds_used[0]) == R
    second = tdec.peel_decode_batch_adaptive(
        tc, first.values, first.erased, backend=backend,
        budgets=torch.tensor([R], dtype=torch.int32))
    assert int(second.rounds_used[0]) == 1
    assert torch.equal(second.erased, one.erased)
    assert torch.equal(second.values, one.values)


@pytest.mark.parametrize("contract", ["batch", "adaptive", "batch_adaptive"])
def test_erased_entries_are_never_read(contract):
    _, tc = _codes("gaussian", 64)
    values, erased, _ = _inputs("gaussian", 64, 3, 0.42, B)
    outs = []
    for fill in (0.0, float("nan"), float("inf"), -float("inf")):
        v = torch.from_numpy(np.where(erased[..., None], np.float32(fill), values))
        e = torch.from_numpy(erased)
        if contract == "batch":
            outs.append(tdec.peel_decode_batch(tc, v, e, 12, backend="cuda"))
        elif contract == "adaptive":
            outs.append(tdec.peel_decode_adaptive(tc, v[0], e[0], backend="cuda"))
        else:
            outs.append(tdec.peel_decode_batch_adaptive(tc, v, e, backend="cuda"))
    base = outs[0]
    resolved = torch.from_numpy(erased if contract != "adaptive" else erased[0]) \
        & ~base.erased
    assert resolved.any()
    for res in outs[1:]:
        assert torch.equal(res.erased, base.erased)
        assert torch.equal(res.values[resolved], base.values[resolved])
        if contract != "batch":
            assert torch.equal(res.rounds_used, base.rounds_used)


def test_budgets_must_match_the_batch():
    _, tc = _codes("gaussian", 20)
    values, erased, _ = _inputs("gaussian", 20, 1, 0.3, B)
    with pytest.raises(ValueError, match="budgets"):
        tdec.peel_decode_batch_adaptive(tc, torch.from_numpy(values),
                                        torch.from_numpy(erased),
                                        budgets=[1, 2, 3])
    with pytest.raises(ValueError, match="batched values"):
        tdec.peel_decode_batch(tc, torch.from_numpy(values[0, :, 0]),
                               torch.from_numpy(erased[0]), 3)


@pytest.mark.parametrize("bad", ["values_ndim", "erased_shape", "budget_dtype",
                                 "budget_shape", "noncontiguous", "iters"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    _, tc = _codes("gaussian", 20)
    t = _tables(tc)
    v = torch.zeros((B, t.N, 2))
    e = torch.zeros((B, t.N), dtype=torch.bool)
    bud = torch.zeros(B, dtype=torch.int32)
    iters = 3
    if bad == "values_ndim":
        v = v[0]
    elif bad == "erased_shape":
        e = e[:, :-1]
    elif bad == "budget_dtype":
        bud = bud.long()
    elif bad == "budget_shape":
        bud = bud[:-1]
    elif bad == "noncontiguous":
        v = torch.zeros((B, 2, t.N)).transpose(1, 2)
    elif bad == "iters":
        iters = -1
    with pytest.raises(ValueError):
        if bad.startswith("budget"):
            peel_decode_batch_adaptive_cuda(t, v, e, bud)
        else:
            peel_decode_batch_cuda(t, v, e, iters)
    if bad in ("values_ndim", "erased_shape"):
        with pytest.raises(ValueError):
            peel_decode_batch_adaptive_cuda(t, v, e, bud)
    if bad == "iters":
        with pytest.raises(ValueError):
            peel_decode_adaptive_cuda(t, v[0], e[0], iters)


def test_wrappers_on_cpu_run_the_plain_versions_and_count_nothing():
    _, tc = _codes("pm1", 20)
    t = CodeTables(*_tables(tc))
    values, erased, _ = _inputs("pm1", 20, 2, 0.3, B)
    v, e = torch.from_numpy(values), torch.from_numpy(erased)
    before = [w.launches for w in (peel_decode_batch_cuda, peel_decode_adaptive_cuda,
                                   peel_decode_batch_adaptive_cuda)]
    peel_decode_batch_cuda(t, v, e, 3)
    peel_decode_adaptive_cuda(t, v[0], e[0], 3)
    peel_decode_batch_adaptive_cuda(t, v, e, torch.full((B,), 3, dtype=torch.int32))
    after = [w.launches for w in (peel_decode_batch_cuda, peel_decode_adaptive_cuda,
                                  peel_decode_batch_adaptive_cuda)]
    assert after == before == [0, 0, 0]
