"""The CUDA kernels against their plain PyTorch versions, on the card: the
table decode's four contracts (fixed D and early exit, one pattern and a
batch), with its state in shared or in device memory; the seeded decode's
four; the seeded encode; and the schedule replay.

These tests need a CUDA card and skip without one (the decision is taken
inside the fixture, at run time).  They import no JAX, so they run on a
machine with the card alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: on ±1-weight codes with small-integer payloads every sum and
quotient is an exact integer in f32, so kernel and plain version agree bit
for bit.  On Gaussian codes with codeword payloads they agree to
``1e-4·max|c| + 4·max|plain − c|`` (f32 summation order, amplified along
peeling chains as the plain version's own error against the codeword
shows; see tests/test_torch_decode.py).  The seeded kernels sum in the
plain versions' order, so they are held bit for bit: the seeded decode
against its plain version and against the table kernel on the same code,
the seeded encode against its plain version (compared as bit patterns).
The replay kernel computes its plain version's Neumaier chain op for op,
so it is held bit for bit too, with every NaN compared by position only
(erased entries hold NaN and inf, which the replay multiplies by zero, and
IEEE 754 leaves which input NaN an operation on two returns to the
implementation).
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core import decoder, encoding
from repro_torch.core.ldpc import (SeededLDPC, make_parity_only_ldpc, make_regular_ldpc,
                                   make_seeded_ldgm, make_seeded_ldpc)
from repro_torch.kernels.ldpc_peel import (decode_fused_adaptive_ref,
                                           decode_fused_batch_adaptive_ref,
                                           decode_fused_batch_ref, decode_fused_ref,
                                           decode_seeded_adaptive_ref,
                                           decode_seeded_batch_adaptive_ref,
                                           decode_seeded_batch_ref, decode_seeded_ref,
                                           dense_h, encode_seeded_fused_cuda,
                                           encode_seeded_ref, ops,
                                           peel_decode_adaptive_cuda,
                                           peel_decode_adaptive_seeded_cuda,
                                           peel_decode_batch_adaptive_cuda,
                                           peel_decode_batch_adaptive_seeded_cuda,
                                           peel_decode_batch_cuda,
                                           peel_decode_batch_seeded_cuda,
                                           peel_decode_cuda, peel_decode_replay_cuda,
                                           peel_decode_seeded_cuda, replay_ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(code, V, f, D, seed, weights):
    rng = np.random.default_rng([code.N, V, int(f * 100), D, seed])
    erased = rng.random(code.N) < f
    if weights == "gaussian":
        truth = (code.G @ rng.standard_normal((code.K, V))).astype(np.float32)
    else:
        truth = rng.integers(-8, 9, (code.N, V)).astype(np.float32)
    garbage = (1e3 * rng.standard_normal((code.N, V))).astype(np.float32)
    return np.where(erased[:, None], garbage, truth), erased, truth


def _run_both(code, values, erased, D, dev):
    tables = decoder.code_tables(code, dev)
    v = torch.from_numpy(values).to(dev)
    e = torch.from_numpy(erased).to(dev)
    kv, ke = peel_decode_cuda(tables, v, e, D)
    pv, pe = decode_fused_ref(dense_h(tables.check_idx, tables.check_coeff, code.N),
                              v, e, D)
    torch.cuda.synchronize()
    return [t.cpu().numpy() for t in (kv, ke, pv, pe)]


CODES = {}


def _code(kind, K):
    if (kind, K) not in CODES:
        CODES[kind, K] = (make_regular_ldpc(K, seed=0) if kind == "gaussian"
                          else make_parity_only_ldpc(K, seed=0, values="pm1"))
    return CODES[kind, K]


@pytest.mark.parametrize("weights", ["gaussian", "pm1"])
@pytest.mark.parametrize("K", [20, 256])
@pytest.mark.parametrize("V", [1, 5, 32])
@pytest.mark.parametrize("f,D", [(0.0, 4), (0.25, 1), (0.45, 8), (0.55, 12)])
def test_kernel_matches_plain(cuda, weights, K, V, f, D):
    code = _code(weights, K)
    values, erased, truth = _case(code, V, f, D, 0, weights)
    kv, ke, pv, pe = _run_both(code, values, erased, D, cuda)
    np.testing.assert_array_equal(ke, pe)
    unresolved = ~(erased & ~pe)
    np.testing.assert_array_equal(kv[unresolved], values[unresolved])
    if weights == "pm1":
        np.testing.assert_array_equal(kv, pv)
    elif (~unresolved).any():
        scale = np.abs(truth).max()
        err = np.abs(pv - truth)[~unresolved].max()
        assert np.abs(kv - pv).max() <= 1e-4 * scale + 4 * err


def test_kernel_past_48k_shared_memory(cuda):
    # N = 16384 needs 80 KiB of shared memory: the opt-in launch path.
    code = make_parity_only_ldpc(8192, seed=1, values="pm1")
    values, erased, _ = _case(code, 3, 0.4, 6, 1, "pm1")
    kv, ke, pv, pe = _run_both(code, values, erased, 6, cuda)
    np.testing.assert_array_equal(ke, pe)
    np.testing.assert_array_equal(kv, pv)


def test_launch_counter_counts_kernel_launches(cuda):
    code = _code("pm1", 20)
    values, erased, _ = _case(code, 2, 0.3, 3, 2, "pm1")
    v, e = torch.from_numpy(values).to(cuda), torch.from_numpy(erased).to(cuda)
    before = peel_decode_cuda.launches
    decoder.peel_decode(code, v, e, 3)
    decoder.peel_decode(code, v, e, 3, backend="dense")
    decoder.peel_decode(code, v.cpu(), e.cpu(), 3, backend="cuda")
    assert peel_decode_cuda.launches == before + 1


def test_wrapper_rejects_mixed_devices(cuda):
    code = _code("pm1", 20)
    tables = decoder.code_tables(code, cuda)
    with pytest.raises(ValueError, match="device|on"):
        peel_decode_cuda(tables, torch.zeros((code.N, 1)),
                         torch.zeros(code.N, dtype=torch.bool), 1)


# ------------------------------------------ batched and early-exit contracts

def _batch_case(code, B, V, f, seed, weights):
    cases = [_case(code, V, f, 0, seed * 100 + b, weights) for b in range(B)]
    return [np.stack(x) for x in zip(*cases)]          # values, erased, truth


def _check_values(weights, values, erased, truth, kv, ke, pv, pe):
    np.testing.assert_array_equal(ke, pe)
    unresolved = ~(erased & ~pe)
    np.testing.assert_array_equal(kv[unresolved], values[unresolved])
    if weights == "pm1":
        np.testing.assert_array_equal(kv, pv)
        return
    for b in range(values.shape[0]):
        res = ~unresolved[b]
        if res.any():
            scale = np.abs(truth[b]).max()
            err = np.abs(pv[b] - truth[b])[res].max()
            assert np.abs(kv[b] - pv[b]).max() <= 1e-4 * scale + 4 * err


def _np(*ts):
    return [t.cpu().numpy() for t in ts]


@pytest.mark.parametrize("weights", ["gaussian", "pm1"])
@pytest.mark.parametrize("K", [20, 256])
@pytest.mark.parametrize("B,V", [(1, 1), (6, 1), (6, 5), (33, 3)])
@pytest.mark.parametrize("f,D", [(0.0, 4), (0.25, 1), (0.45, 8)])
def test_batch_kernel_matches_plain(cuda, weights, K, B, V, f, D):
    code = _code(weights, K)
    values, erased, truth = _batch_case(code, B, V, f, 1, weights)
    tables = decoder.code_tables(code, cuda)
    v, e = torch.from_numpy(values).to(cuda), torch.from_numpy(erased).to(cuda)
    kv, ke = peel_decode_batch_cuda(tables, v, e, D)
    pv, pe = decode_fused_batch_ref(dense_h(tables.check_idx, tables.check_coeff,
                                            code.N), v, e, D)
    torch.cuda.synchronize()
    _check_values(weights, values, erased, truth, *_np(kv, ke, pv, pe))
    # each slot exactly as the single-pattern kernel decodes it alone
    for b in range(B):
        sv, se = peel_decode_cuda(tables, v[b], e[b], D)
        assert torch.equal(sv, kv[b]) and torch.equal(se, ke[b])


@pytest.mark.parametrize("weights", ["gaussian", "pm1"])
@pytest.mark.parametrize("K", [20, 256])
@pytest.mark.parametrize("V", [1, 5])
@pytest.mark.parametrize("f", [0.0, 0.25, 0.45])
@pytest.mark.parametrize("budget", [0, 2, "N"])
def test_adaptive_kernel_matches_plain(cuda, weights, K, V, f, budget):
    code = _code(weights, K)
    max_iters = code.N if budget == "N" else budget
    values, erased, truth = _batch_case(code, 1, V, f, 2, weights)
    tables = decoder.code_tables(code, cuda)
    v, e = torch.from_numpy(values[0]).to(cuda), torch.from_numpy(erased[0]).to(cuda)
    kv, ke, kd = peel_decode_adaptive_cuda(tables, v, e, max_iters)
    pv, pe, pd = decode_fused_adaptive_ref(
        dense_h(tables.check_idx, tables.check_coeff, code.N), v, e, max_iters)
    torch.cuda.synchronize()
    assert kd.ndim == 0 and kd.dtype == torch.int32 and kd.device.type == "cuda"
    assert int(kd) == int(pd)
    _check_values(weights, values, erased, truth,
                  *[x[None] for x in _np(kv, ke, pv, pe)])


@pytest.mark.parametrize("weights", ["gaussian", "pm1"])
@pytest.mark.parametrize("K", [20, 256])
@pytest.mark.parametrize("B,V", [(1, 1), (8, 1), (8, 5), (64, 2)])
@pytest.mark.parametrize("f", [0.0, 0.25, 0.45])
def test_batch_adaptive_kernel_matches_plain(cuda, weights, K, B, V, f):
    code = _code(weights, K)
    values, erased, truth = _batch_case(code, B, V, f, 3, weights)
    rng = np.random.default_rng([B, V, int(f * 100)])
    budgets = rng.choice([0, 1, 2, 3, 8, code.N], size=B).astype(np.int32)
    tables = decoder.code_tables(code, cuda)
    v, e = torch.from_numpy(values).to(cuda), torch.from_numpy(erased).to(cuda)
    bud = torch.from_numpy(budgets).to(cuda)
    kv, ke, kd = peel_decode_batch_adaptive_cuda(tables, v, e, bud)
    pv, pe, pd = decode_fused_batch_adaptive_ref(
        dense_h(tables.check_idx, tables.check_coeff, code.N), v, e, bud)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd)
    _check_values(weights, values, erased, truth, *_np(kv, ke, pv, pe))


def test_budget_zero_and_nothing_erased_pass_through(cuda):
    code = _code("gaussian", 256)
    values, erased, _ = _batch_case(code, 4, 3, 0.4, 4, "gaussian")
    erased[2] = False
    tables = decoder.code_tables(code, cuda)
    v, e = torch.from_numpy(values).to(cuda), torch.from_numpy(erased).to(cuda)
    bud = torch.tensor([code.N, 0, code.N, code.N], dtype=torch.int32, device=cuda)
    kv, ke, kd = peel_decode_batch_adaptive_cuda(tables, v, e, bud)
    torch.cuda.synchronize()
    assert kd.tolist()[1:3] == [0, 0] and kd[0] > 0 and kd[3] > 0
    for b in (1, 2):
        assert torch.equal(kv[b], v[b]) and torch.equal(ke[b], e[b])


@pytest.mark.parametrize("contract", ["fixed", "batch", "adaptive", "batch_adaptive"])
def test_erased_entries_are_never_read(cuda, contract):
    code = _code("gaussian", 256)
    values, erased, _ = _batch_case(code, 4, 3, 0.4, 5, "gaussian")
    tables = decoder.code_tables(code, cuda)
    e = torch.from_numpy(erased).to(cuda)
    bud = torch.full((4,), code.N, dtype=torch.int32, device=cuda)
    outs = []
    for fill in (0.0, float("nan"), float("inf")):
        v = torch.from_numpy(np.where(erased[..., None], np.float32(fill),
                                      values)).to(cuda)
        if contract == "fixed":
            outs.append(peel_decode_cuda(tables, v[0], e[0], 8))
        elif contract == "batch":
            outs.append(peel_decode_batch_cuda(tables, v, e, 8))
        elif contract == "adaptive":
            outs.append(peel_decode_adaptive_cuda(tables, v[0], e[0], code.N))
        else:
            outs.append(peel_decode_batch_adaptive_cuda(tables, v, e, bud))
    torch.cuda.synchronize()
    e0 = e[0] if contract in ("fixed", "adaptive") else e
    resolved = e0 & ~outs[0][1]
    assert bool(resolved.any())
    for out in outs[1:]:
        assert torch.equal(out[1], outs[0][1])
        assert torch.equal(out[0][resolved], outs[0][0][resolved])
        if len(out) == 3:
            assert torch.equal(out[2], outs[0][2])


def test_each_wrapper_counts_its_own_launches(cuda):
    code = _code("pm1", 20)
    values, erased, _ = _batch_case(code, 3, 2, 0.3, 6, "pm1")
    v, e = torch.from_numpy(values).to(cuda), torch.from_numpy(erased).to(cuda)
    wrappers = (peel_decode_cuda, peel_decode_batch_cuda, peel_decode_adaptive_cuda,
                peel_decode_batch_adaptive_cuda)
    before = [w.launches for w in wrappers]
    decoder.peel_decode_batch(code, v, e, 3)
    decoder.peel_decode_batch_adaptive(code, v, e, budgets=[1, 2, 3])
    decoder.peel_decode_batch_adaptive(code, v, e, budgets=[1, 2, 3])
    decoder.peel_decode_adaptive(code, v[0], e[0], 5)
    decoder.peel_decode_batch(code, v, e, 3, backend="dense")
    decoder.peel_decode_adaptive(code, v[0], e[0], backend="dense")
    decoder.peel_decode_batch_adaptive(code, v.cpu(), e.cpu(), backend="cuda")
    assert [w.launches - b for w, b in zip(wrappers, before)] == [0, 1, 1, 2]


def test_budgets_are_read_on_the_device(cuda):
    # Budgets given as a device tensor go to the kernel as they are; the
    # result equals the one with budgets given from the host.
    code = _code("pm1", 256)
    values, erased, _ = _batch_case(code, 4, 1, 0.45, 7, "pm1")
    v, e = torch.from_numpy(values).to(cuda), torch.from_numpy(erased).to(cuda)
    a = decoder.peel_decode_batch_adaptive(
        code, v, e, budgets=torch.tensor([0, 2, 5, 9], dtype=torch.int32, device=cuda))
    b = decoder.peel_decode_batch_adaptive(code, v, e, budgets=[0, 2, 5, 9])
    assert a.rounds_used.device.type == "cuda"
    assert torch.equal(a.rounds_used, b.rounds_used)
    assert torch.equal(a.values, b.values) and torch.equal(a.erased, b.erased)


# --------------------------------------------------------- seeded kernels

SEEDED = {}


def _seeded(K):
    if K not in SEEDED:
        SEEDED[K] = make_seeded_ldpc(K, seed=0)
    return SEEDED[K]


def _seeded_inputs(N, B, V, f, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    e = torch.rand((B, N), generator=g, device=dev) < f
    v = torch.randn((B, N, V), generator=g, device=dev)
    return torch.where(e[..., None], 1e3 * v, v).contiguous(), e


def _same(a, b):
    """Bit for bit (NaN patterns and signed zeros included)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("K", [256, 1024])
@pytest.mark.parametrize("B,V", [(1, 1), (1, 2), (4, 1), (8, 5)])
@pytest.mark.parametrize("f", [0.0, 0.25, 0.45])
def test_seeded_kernels_match_plain_and_table_kernel(cuda, K, B, V, f):
    code = _seeded(K)
    st = decoder.seeded_spec(code)
    tables = decoder.code_tables(code, cuda)
    v, e = _seeded_inputs(code.N, B, V, f, K + B + V, cuda)
    budgets = torch.tensor([0, 1, 3, code.N] * 2, dtype=torch.int32, device=cuda)[:B]
    runs = [
        (lambda: peel_decode_batch_seeded_cuda(st, v, e, 8),
         lambda: decode_seeded_batch_ref(st, v, e, 8),
         lambda: peel_decode_batch_cuda(tables, v, e, 8)),
        (lambda: peel_decode_batch_adaptive_seeded_cuda(st, v, e, budgets),
         lambda: decode_seeded_batch_adaptive_ref(st, v, e, budgets),
         lambda: peel_decode_batch_adaptive_cuda(tables, v, e, budgets)),
        (lambda: peel_decode_seeded_cuda(st, v[0], e[0], 8),
         lambda: decode_seeded_ref(st, v[0], e[0], 8),
         lambda: peel_decode_cuda(tables, v[0], e[0], 8)),
        (lambda: peel_decode_adaptive_seeded_cuda(st, v[0], e[0], code.N),
         lambda: decode_seeded_adaptive_ref(st, v[0], e[0], code.N),
         lambda: peel_decode_adaptive_cuda(tables, v[0], e[0], code.N)),
    ]
    for kern, plain, table in runs:
        kout, pout, tout = kern(), plain(), table()
        torch.cuda.synchronize()
        for k, p, t in zip(kout, pout, tout):
            assert torch.equal(k, p) and torch.equal(k, t)
        assert _same(kout[0], pout[0]) and _same(kout[0], tout[0])


@pytest.mark.parametrize("V", [1, 6])
def test_seeded_state_in_device_memory_equals_shared(cuda, monkeypatch, V):
    code = _seeded(1024)
    st = decoder.seeded_spec(code)
    v, e = _seeded_inputs(code.N, 3, V, 0.42, 11, cuda)
    budgets = torch.tensor([2, 0, code.N], dtype=torch.int32, device=cuda)
    shared = peel_decode_batch_adaptive_seeded_cuda(st, v, e, budgets)
    monkeypatch.setattr(ops, "MAX_SMEM_BYTES", 0)      # forces the scratch state
    scratch = peel_decode_batch_adaptive_seeded_cuda(st, v, e, budgets)
    torch.cuda.synchronize()
    for a, b in zip(shared, scratch):
        assert torch.equal(a, b)


def test_structure_only_code_past_shared_memory(cuda):
    code = SeededLDPC(N=65536, K=32768, l=4, r=8, seed=5)
    st = decoder.seeded_spec(code)
    v, e = _seeded_inputs(code.N, 1, 1, 0.3, 12, cuda)
    kv, ke = peel_decode_seeded_cuda(st, v[0], e[0], 6)
    pv, pe = decode_seeded_ref(st, v[0], e[0], 6)
    torch.cuda.synchronize()
    assert torch.equal(ke, pe) and _same(kv, pv)
    assert bool((e[0] & ~ke).any())


@pytest.mark.parametrize("V", [1, 3])
@pytest.mark.parametrize("row0,n_out", [(0, None), (200, 300), (700, 200), (1000, 7)])
def test_seeded_encode_matches_plain(cuda, V, row0, n_out):
    code = make_seeded_ldgm(512, 256, seed=3)             # N = 768
    st = encoding.generator_structure_of(code)
    y = torch.randn((code.K, V), generator=torch.Generator(device=cuda).manual_seed(V),
                    device=cuda)
    y[0, 0] = -0.0
    n = code.N if n_out is None else n_out
    got = encode_seeded_fused_cuda(st, y, row0, n_out)
    want = encode_seeded_ref(st, y, row0, n)
    torch.cuda.synchronize()
    assert _same(got, want)
    idx, coeff = encoding.generator_gather_tables(code, cuda)
    rows = slice(min(row0, code.N), min(row0 + n, code.N))
    assert _same(got[:rows.stop - rows.start], encoding.gather_encode(idx[rows], coeff[rows], y))


def test_seeded_encode_keeps_the_pad_terms(cuda):
    # 0 * y[0] turns an inf in y[0] into NaN in every systematic row, as
    # the table gather does.
    code = make_seeded_ldgm(64, 32, seed=1)
    st = encoding.generator_structure_of(code)
    y = torch.ones((code.K, 1), device=cuda)
    y[0] = float("inf")
    got = encode_seeded_fused_cuda(st, y)
    want = encode_seeded_ref(st, y, 0, code.N)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[1:code.K]).all())
    assert _same(got, want)


def test_seeded_wrappers_count_their_own_launches(cuda):
    code = _seeded(256)
    v, e = _seeded_inputs(code.N, 2, 1, 0.3, 13, cuda)
    wrappers = (peel_decode_seeded_cuda, peel_decode_batch_seeded_cuda,
                peel_decode_adaptive_seeded_cuda, peel_decode_batch_adaptive_seeded_cuda,
                peel_decode_cuda)
    before = [w.launches for w in wrappers]
    decoder.peel_decode(code, v[0], e[0], 3)                 # auto: seeded
    decoder.peel_decode_batch(code, v, e, 3)
    decoder.peel_decode_adaptive(code, v[0], e[0], 4)
    decoder.peel_decode_batch_adaptive(code, v, e, budgets=[1, 2])
    decoder.peel_decode_batch_adaptive(code, v, e, budgets=[1, 2])
    decoder.peel_decode(code, v[0], e[0], 3, backend="cuda")
    decoder.peel_decode(code, v[0].cpu(), e[0].cpu(), 3)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 1, 1, 2, 1]
    ldgm = make_seeded_ldgm(64, 32, seed=1)
    n = encode_seeded_fused_cuda.launches
    encoding.encode_seeded(ldgm, torch.ones(64, device=cuda))
    encoding.encode_seeded(ldgm, torch.ones(64))
    assert encode_seeded_fused_cuda.launches == n + 1


def test_table_state_in_device_memory_equals_shared(cuda, monkeypatch):
    code = _code("gaussian", 256)
    tables = decoder.code_tables(code, cuda)
    for V in (1, 6):
        v, e = _seeded_inputs(code.N, 3, V, 0.42, 21 + V, cuda)
        budgets = torch.tensor([2, 0, code.N], dtype=torch.int32, device=cuda)
        runs = (lambda: peel_decode_batch_adaptive_cuda(tables, v, e, budgets),
                lambda: peel_decode_batch_cuda(tables, v, e, 5),
                lambda: peel_decode_cuda(tables, v[0], e[0], 5),
                lambda: peel_decode_adaptive_cuda(tables, v[2], e[2], code.N))
        shared = [run() for run in runs]
        with monkeypatch.context() as m:
            m.setattr(ops, "MAX_SMEM_BYTES", 0)           # forces the scratch state
            scratch = [run() for run in runs]
        torch.cuda.synchronize()
        for a, b in zip(shared, scratch):
            assert all(_same(x, y) if x.dtype == torch.float32 else torch.equal(x, y)
                       for x, y in zip(a, b))


def test_table_kernel_past_shared_memory(cuda):
    # The (3, 6) code at K = 256 spread over N = 50,000 columns: the state
    # no longer fits in shared memory, and the decode equals its plain
    # version and the code's own decode.
    code = _code("pm1", 256)
    tables = decoder.code_tables(code, cuda)
    N, stride = 50_000, 97
    wide = tables._replace(check_idx=(tables.check_idx * stride).contiguous(), N=N)
    assert ops._smem_bytes(N) > ops.MAX_SMEM_BYTES
    values, erased, _ = _case(code, 3, 0.4, 6, 3, "pm1")
    v = torch.zeros((N, 3), device=cuda)
    e = torch.zeros(N, dtype=torch.bool, device=cuda)
    v[::stride][:code.N] = torch.from_numpy(values).to(cuda)
    e[::stride][:code.N] = torch.from_numpy(erased).to(cuda)
    kv, ke, kd = peel_decode_adaptive_cuda(wide, v, e, 40)
    pv, pe, pd = ops.ref.decode_table_adaptive_ref(wide.check_idx, wide.check_coeff,
                                                   v, e, 40)
    sv, se, sd = peel_decode_adaptive_cuda(tables, v[::stride][:code.N].contiguous(),
                                           e[::stride][:code.N].contiguous(), 40)
    torch.cuda.synchronize()
    assert torch.equal(ke, pe) and _same(kv, pv) and int(kd) == int(pd) == int(sd)
    assert torch.equal(ke[::stride][:code.N], se) and _same(kv[::stride][:code.N], sv)


def _same_nan(a, b):
    """Bit for bit, every NaN compared by position only."""
    return (a.shape == b.shape and torch.equal(torch.isnan(a), torch.isnan(b))
            and _same(torch.where(torch.isnan(a), 0.0, a), torch.where(torch.isnan(b), 0.0, b)))


def _replay_inputs(code, B, V, f, seed, dev):
    v, e = _seeded_inputs(code.N, B, V, f, seed, dev)
    pos = torch.nonzero(e[0])[:2, 0]
    v[0, pos] = torch.tensor([float("nan"), float("inf")], device=dev)[:len(pos), None]
    return v, e


@pytest.mark.parametrize("kind,K", [("gaussian", 20), ("gaussian", 256), ("pm1", 256)])
@pytest.mark.parametrize("B,V", [(1, 1), (8, 5), (64, 1)])
@pytest.mark.parametrize("f", [0.0, 0.25, 0.45])
def test_replay_kernel_matches_plain(cuda, kind, K, B, V, f):
    code = _code(kind, K)
    v, e = _replay_inputs(code, B, V, f, K + B + V, cuda)
    scheds = [decoder.compile_peel_schedule(code, e[b]) for b in range(B)]
    budgets = torch.tensor([0, 1, 3, 8, code.N] * 13, dtype=torch.int32, device=cuda)[:B]
    for rule in ("hi", "lo"):
        pack = decoder.replay_operands(scheds, rule, cuda)
        for bud in (budgets, 3, code.N):
            kout = peel_decode_replay_cuda(pack, v, e, bud)
            pout = replay_ref(*pack, v, e, bud)
            torch.cuda.synchronize()
            assert _same_nan(kout[0], pout[0])
            assert torch.equal(kout[1], pout[1]) and torch.equal(kout[2], pout[2])
    # the "lo" replay resolves exactly what the flooding kernel resolves,
    # and counts the same rounds
    tables = decoder.code_tables(code, cuda)
    kout = peel_decode_replay_cuda(decoder.replay_operands(scheds, "lo", cuda), v, e,
                                   budgets)
    fout = peel_decode_batch_adaptive_cuda(tables, v, e, budgets)
    torch.cuda.synchronize()
    assert torch.equal(kout[1], fout[1]) and torch.equal(kout[2], fout[2])


def test_replay_entry_points_launch_the_kernel(cuda):
    from repro_torch.core import ScheduleCache
    from repro_torch.core.engine import CodedComputeEngine
    code = _code("gaussian", 256)
    v, e = _replay_inputs(code, 4, 2, 0.3, 31, cuda)
    before = peel_decode_replay_cuda.launches
    decoder.peel_decode(code, v[0], e[0], 4, backend="replay")
    decoder.peel_decode_batch(code, v, e, 4, backend="replay")
    decoder.peel_decode_adaptive(code, v[0], e[0], 9, backend="replay")
    res = decoder.peel_decode_batch_adaptive(code, v, e, backend="replay",
                                             budgets=[1, 0, 3, 40])
    decoder.peel_decode(code, v[0].cpu(), e[0].cpu(), 4, backend="replay")
    cache = ScheduleCache()
    eng = CodedComputeEngine(code, decode_iters=40, backend="replay", adaptive=True,
                             schedule_cache=cache)
    for _ in range(3):
        eng.decode_batch(v, e)
    assert peel_decode_replay_cuda.launches - before == 7
    assert (cache.misses, cache.hits) == (4, 8)
    assert res.rounds_used.device.type == "cuda" and res.rounds_used.dtype == torch.int32


# ------------------------------------------ seeded kernels past the old caps
# Row weight and layer count were once capped at 16.  Each network width
# (16, 32, 64) and the selection path past 64 are held bit for bit.

WIDE_LDPC = {"l20_r24": (64, 20, 24), "l20_r40": (160, 20, 40), "l8_r80": (720, 8, 80)}
WIDE_LDGM = {"r24": (192, 96, 24), "layers20": (64, 160, 8), "r64": (128, 64, 64),
             "r80": (160, 40, 80)}


@pytest.mark.parametrize("name", list(WIDE_LDPC))
def test_seeded_decode_past_the_old_caps(cuda, name):
    K, l, r = WIDE_LDPC[name]
    code = make_seeded_ldpc(K, l=l, r=r, seed=1)
    st = decoder.seeded_spec(code)
    assert (st.row_weight, st.layers) == (r, l)
    tables = decoder.code_tables(code, cuda)
    resolved = False
    for f in (0.02, 0.1, 0.3):
        v, e = _seeded_inputs(code.N, 4, 2, f, K + r, cuda)
        budgets = torch.tensor([0, 1, 3, code.N], dtype=torch.int32, device=cuda)
        for kern, plain, table in (
                (lambda: peel_decode_batch_seeded_cuda(st, v, e, 8),
                 lambda: decode_seeded_batch_ref(st, v, e, 8),
                 lambda: peel_decode_batch_cuda(tables, v, e, 8)),
                (lambda: peel_decode_batch_adaptive_seeded_cuda(st, v, e, budgets),
                 lambda: decode_seeded_batch_adaptive_ref(st, v, e, budgets),
                 lambda: peel_decode_batch_adaptive_cuda(tables, v, e, budgets))):
            kout, pout, tout = kern(), plain(), table()
            torch.cuda.synchronize()
            for k, p, t in zip(kout, pout, tout):
                assert torch.equal(k, p) and torch.equal(k, t)
            assert _same(kout[0], pout[0]) and _same(kout[0], tout[0])
            resolved |= bool((e & ~kout[1]).any())
    assert resolved


@pytest.mark.parametrize("name", list(WIDE_LDGM))
def test_seeded_encode_past_the_old_caps(cuda, name):
    K, p, rw = WIDE_LDGM[name]
    code = make_seeded_ldgm(K, p, row_weight=rw, seed=2)
    st = encoding.generator_structure_of(code)
    assert st.row_weight == rw and st.layers == p * rw // K
    y = torch.randn((K, 3), generator=torch.Generator(device=cuda).manual_seed(rw),
                    device=cuda)
    y[0, 0] = -0.0
    for row0, n in ((0, code.N), (K - 5, 40), (code.N - 3, 9)):
        got = encode_seeded_fused_cuda(st, y, row0, n)
        want = encode_seeded_ref(st, y, row0, n)
        torch.cuda.synchronize()
        assert _same(got, want)


# ------------------------------------------------------ flash attention
# The kernel against its plain version (kernels/flash_attention/ref.py),
# on the same inputs.  Both compute in f32 from the same rounded inputs; the
# kernel's online softmax and the plain version's full softmax sum in other
# orders, so f32 outputs agree to FLASH_F32_ULPS units of 2⁻²³·max|v|, and
# bf16 outputs, each rounded once from f32, to one bf16 ulp of the output
# beyond that f32 bound.

from repro_torch.kernels.flash_attention import attention_ref, flash_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (forced_splits, kernel_path,  # noqa: E402
                                                     sm_count, split_count, tile_count)
from repro_torch.kernels.flash_attention.ref import bf16_ulp, tiles_visited  # noqa: E402

FLASH_F32_ULPS = 4


def _flash_inputs(B, Sq, T, KV, G, Dh, dtype, seed, dev, Dv=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Sq, KV, G, Dh), generator=g, device=dev).to(dtype)
    k = torch.randn((B, T, KV, Dh), generator=g, device=dev).to(dtype)
    v = torch.randn((B, T, KV, Dh if Dv is None else Dv), generator=g, device=dev).to(dtype)
    return q, k, v


def _flash_within(got, want, v):
    # per output: the f32 bound, and one bf16 ulp of the output beyond it (bf16)
    err = (got.float() - want.float()).abs()
    f32_tol = FLASH_F32_ULPS * 2.0 ** -23 * float(v.float().abs().max())
    if v.dtype == torch.bfloat16:
        return err <= bf16_ulp(torch.maximum(got.float().abs(), want.float().abs())) + f32_tol
    return err <= f32_tol


def _flash_close(got, want, v):
    assert got.dtype == want.dtype == v.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert bool(_flash_within(got, want, v).all())


def _flash_anchored(got, want, q, k, v, q_pos, kv_pos, **kw):
    # Past the old head-dimension cap the scores' f32 rounding grows with
    # Dh: the kernel within twice the plain version's distance from the
    # float64 run of the plain version on the same inputs, plus
    # FLASH_F32_ULPS units of 2⁻²³·max|v| (and one bf16 ulp for bf16).
    assert got.dtype == want.dtype == v.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    exact = attention_ref(q.double(), k.double(), v.double(), q_pos, kv_pos, **kw)
    tol = (2 * float((want.double() - exact).abs().max())
           + FLASH_F32_ULPS * 2.0 ** -23 * float(v.float().abs().max()))
    err = (got.double() - exact).abs()
    if v.dtype == torch.bfloat16:
        assert bool((err <= bf16_ulp(got.float()).double() + tol).all())
    else:
        assert float(err.max()) <= tol


_FLASH_PATHS = ("tensor", "decode", "simt")


def _flash_paths():
    return tuple(getattr(flash_attention_cuda, f"launches_{p}") for p in _FLASH_PATHS)


def _flash_path_ran(before, path):
    # the wrapper's counts by path: one launch, on `path`
    assert tuple(a - b for a, b in zip(_flash_paths(), before)) == \
        tuple(int(p == path) for p in _FLASH_PATHS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("S", [17, 100, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_prefill_matches_plain(cuda, dtype, G, Dh, S, causal):
    # bf16 with S·G >= 64 takes the tensor-core kernel, the rest the SIMT one
    q, k, v = _flash_inputs(2, S, S, 2, G, Dh, dtype, S + G + Dh, cuda)
    pos = torch.arange(S, dtype=torch.int32, device=cuda)
    path = "tensor" if dtype == torch.bfloat16 and S * G >= 64 else "simt"
    assert kernel_path(q, k, v) == path
    before = _flash_paths()
    with tile_count(cuda) as tiles:
        got = flash_attention_cuda(q, k, v, pos, pos, causal=causal)
    want = attention_ref(q, k, v, pos, pos, causal=causal)
    torch.cuda.synchronize()
    _flash_close(got, want, v)
    _flash_path_ran(before, path)
    assert int(tiles) == tiles_visited(pos, pos, B=2, KV=2, G=G, Dh=Dh, Dv=Dh, path=path,
                                       causal=causal)
    if path == "tensor":
        # The control: p rounded once to bf16 (one p·v product, as
        # scaled_dot_product_attention takes it) must fail the comparison that
        # holds the kernel's three bf16 terms of p.
        one = attention_ref(q, k, v, pos, pos, causal=causal, p_terms=1)
        assert not bool(_flash_within(one, want, v).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [1, 33, 2080])
def test_flash_decode_and_ring_match_plain(cuda, dtype, T):
    # the decode kernel, at the split count of its rule and forced to 1, 3 and
    # more splits than tiles; two runs bit for bit
    q, k, v = _flash_inputs(3, 1, T, 4, 2, 128, dtype, T, cuda)
    assert kernel_path(q, k, v) == "decode"
    p = T - 1
    kv_pos = torch.arange(T, dtype=torch.int32, device=cuda)
    cases = [(kv_pos, kv_pos <= p)]
    if T > 8:            # a wrapped ring: slots hold p-T+1..p, two of them empty
        ring = (torch.arange(T, device=cuda) + (p - T + 1)).to(torch.int32)
        ring = torch.roll(ring, 5)
        ring[T // 2] = torch.iinfo(torch.int32).max
        ring[T // 3] = torch.iinfo(torch.int32).max
        cases.append((ring, ring <= p))
    q_pos = torch.full((1,), p, dtype=torch.int32, device=cuda)
    n_tiles = -(-T // 32)
    for kvp, valid in cases:
        for splits in (None, 1, 3, n_tiles + 2):
            before = _flash_paths()
            with forced_splits(splits) if splits else contextlib.nullcontext():
                with tile_count(cuda) as tiles:
                    got = flash_attention_cuda(q, k, v, q_pos, kvp, causal=True, kv_valid=valid)
                again = flash_attention_cuda(q, k, v, q_pos, kvp, causal=True, kv_valid=valid)
            want = attention_ref(q, k, v, q_pos, kvp, causal=True, kv_valid=valid)
            torch.cuda.synchronize()
            _flash_close(got, want, v)
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            assert torch.equal(got.view(bits), again.view(bits))
            n = splits or split_count(T, 3, 4, sm_count(q.device))
            assert int(tiles) == tiles_visited(q_pos, kvp, B=3, KV=4, G=2, Dh=128, Dv=128,
                                               path="decode", kv_valid=valid, splits=n)
            assert tuple(a - b for a, b in zip(_flash_paths(), before)) == (0, 2, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_decode_offset_positions_and_flags_go_to_simt(cuda, dtype):
    # the decode kernel copies kv_pos and kv_valid by TMA, which needs 16-byte
    # boundaries: views off them are computed by the SIMT kernel, as JAX's
    # sdpa_chunked takes them
    T = 300
    q, k, v = _flash_inputs(2, 1, T, 2, 2, 128, dtype, 11, cuda)
    pos = torch.arange(-1, T, dtype=torch.int32, device=cuda)
    flags = torch.ones(T + 3, dtype=torch.bool, device=cuda)
    flags[T // 2] = False
    q_pos = torch.full((1,), T - 1, dtype=torch.int32, device=cuda)
    cases = ((pos[1:], flags[:T], "simt"), (pos[1:], None, "simt"),
             (pos[1:].clone(), flags[3:], "simt"), (pos[1:].clone(), flags[3:].clone(), "decode"))
    for kv_pos, valid, path in cases:
        assert kernel_path(q, k, v, kv_pos, valid) == path
        before = _flash_paths()
        got = flash_attention_cuda(q, k, v, q_pos, kv_pos, causal=True, kv_valid=valid)
        want = attention_ref(q, k, v, q_pos, kv_pos, causal=True, kv_valid=valid)
        torch.cuda.synchronize()
        _flash_close(got, want, v)
        _flash_path_ran(before, path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Dh,Dv", [(192, 128), (48, 32), (96, 96), (40, 24), (64, 200),
                                   (559, 64), (576, 64), (576, 512), (1024, 64), (1024, 512)])
@pytest.mark.parametrize("G", [1, 2])
def test_flash_any_head_dims_match_plain(cuda, dtype, Dh, Dv, G):
    # the generic path: q·k 64 columns at a time, v 64 columns a block.
    # 559 was the largest Dh before; 576 (MLA's absorbed q·k width) and 1024
    # lie past it and are held to the float64 anchor.
    for Sq, T in ((37, 37), (1, 300)):
        q, k, v = _flash_inputs(2, Sq, T, 2, G, Dh, dtype, Dh + Dv + G, cuda, Dv=Dv)
        q_pos = torch.arange(T - Sq, T, dtype=torch.int32, device=cuda)
        kv_pos = torch.arange(T, dtype=torch.int32, device=cuda)
        with tile_count(cuda) as tiles:
            got = flash_attention_cuda(q, k, v, q_pos, kv_pos, causal=True)
        want = attention_ref(q, k, v, q_pos, kv_pos, causal=True)
        torch.cuda.synchronize()
        assert got.shape == (2, Sq, 2, G, Dv)
        if Dh > 559:
            _flash_anchored(got, want, q, k, v, q_pos, kv_pos, causal=True)
        else:
            _flash_close(got, want, v)
        assert int(tiles) == tiles_visited(q_pos, kv_pos, B=2, KV=2, G=G, Dh=Dh, Dv=Dv,
                                           path=kernel_path(q, k, v))


def test_flash_rows_with_every_key_masked_stay_finite(cuda):
    # Queries at positions before every key: no key is visible.  The finite
    # mask value makes each such row the mean of v, as a full softmax does.
    q, k, v = _flash_inputs(1, 5, 70, 1, 2, 64, torch.float32, 3, cuda)
    q_pos = torch.tensor([-3, -2, -1, 40, 69], dtype=torch.int32, device=cuda)
    kv_pos = torch.arange(70, dtype=torch.int32, device=cuda)
    got = flash_attention_cuda(q, k, v, q_pos, kv_pos, causal=True)
    want = attention_ref(q, k, v, q_pos, kv_pos, causal=True)
    torch.cuda.synchronize()
    _flash_close(got, want, v)
    assert torch.allclose(got[0, 0, 0, 0], v[0, :, 0].mean(0), atol=1e-5)


@pytest.mark.parametrize("G", [1, 8])
def test_flash_tensor_path_rows_with_every_key_masked_are_the_mean_of_v(cuda, G):
    # The same on the tensor-core kernel: 70 queries, the first three before
    # every key, over 200 keys (a partial last tile).
    Sq, T = 70, 200
    q, k, v = _flash_inputs(1, Sq, T, 2, G, 128, torch.bfloat16, 5 + G, cuda)
    q_pos = torch.arange(-3, Sq - 3, dtype=torch.int32, device=cuda) * 3
    kv_pos = torch.arange(T, dtype=torch.int32, device=cuda)
    assert kernel_path(q, k, v) == "tensor"
    got = flash_attention_cuda(q, k, v, q_pos, kv_pos, causal=True)
    want = attention_ref(q, k, v, q_pos, kv_pos, causal=True)
    torch.cuda.synchronize()
    _flash_close(got, want, v)
    mean = v.float().mean(1)                                  # (1, KV, Dv)
    for i in range(3):
        for g in range(G):
            assert torch.allclose(got[0, i, :, g].float(), mean[0],
                                  atol=float(bf16_ulp(mean).max()))


def test_flash_wrapper_counts_and_rejects(cuda):
    q, k, v = _flash_inputs(1, 4, 4, 1, 2, 64, torch.float32, 4, cuda)
    pos = torch.arange(4, dtype=torch.int32, device=cuda)
    before = flash_attention_cuda.launches
    counts = _flash_paths()
    flash_attention_cuda(q, k, v, pos, pos)              # 4 queries x 2 heads: decode
    flash_attention_cuda(q.cpu(), k.cpu(), v.cpu(), pos.cpu(), pos.cpu())
    assert flash_attention_cuda.launches - before == 1
    _flash_path_ran(counts, "decode")
    # Dh = 560, one past the old cap, now computes
    wide_q, wide_k = _flash_inputs(1, 4, 4, 1, 2, 560, torch.float32, 5, cuda)[:2]
    got = flash_attention_cuda(wide_q, wide_k, v, pos, pos)
    want = attention_ref(wide_q, wide_k, v, pos, pos)
    torch.cuda.synchronize()
    _flash_anchored(got, want, wide_q, wide_k, v, pos, pos)
    for bad in (lambda: flash_attention_cuda(q.half(), k.half(), v.half(), pos, pos),
                lambda: flash_attention_cuda(q.double(), k.double(), v.double(), pos, pos),
                lambda: flash_attention_cuda(q, k, v, pos.long(), pos),
                lambda: flash_attention_cuda(q, k.cpu(), v, pos, pos)):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(ValueError):
        with forced_splits(0):
            pass
    # forced splits are the decode kernel's: the SIMT kernel computes as before
    with forced_splits(2):
        assert torch.equal(flash_attention_cuda(wide_q, wide_k, v, pos, pos), got)


def test_reduced_model_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config("qwen3-1.7b").reduced()
    cpu = Model(cfg, attn_chunk=8, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = Model(cfg, attn_chunk=8, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 11), generator=torch.Generator().manual_seed(1))
    caches = [m.init_cache(2, 20) for m in (cpu, gpu)]
    before = flash_attention_cuda.launches
    (lc, _), (lg, _) = (m.prefill({"tokens": toks}, c) for m, c in zip((cpu, gpu), caches))
    tok = lc[:, -1].argmax(-1)[:, None]
    for i in range(3):
        assert float((lg.cpu() - lc).abs().max()) <= 1e-4 * float(lc.abs().max())
        (lc, _), (lg, _) = (m.decode_step(tok, 11 + i, c) for m, c in zip((cpu, gpu), caches))
        tok = lc[:, -1].argmax(-1)[:, None]
    assert flash_attention_cuda.launches - before == cfg.n_layers * 4
    for c_cpu, c_gpu in zip(*caches):
        assert torch.equal(c_cpu["pos"], c_gpu["pos"].cpu())


# ---------------------------------------------------------- block matmul
# The product (the split pass, then the tensor-core product kernel) against
# its plain version (torch.matmul in f32) and against float64: within
# K·2⁻²⁴·(|A|·|B|) of float64 entry by entry, and no more than twice
# torch.matmul's own distance from float64 (plus 1e-30); two runs bit for
# bit.  The split pass against its plain version bit for bit.

from repro_torch.kernels.block_matmul import block_matmul, coded_matvec, encode_gm  # noqa: E402
from repro_torch.kernels.block_matmul.ref import block_matmul_ref  # noqa: E402


def _mm_held(got, A, B):
    A64, B64 = A.double(), B.double()
    exact = torch.matmul(A64, B64)
    bound = A.shape[-1] * 2.0 ** -24 * torch.matmul(A64.abs(), B64.abs())
    err = (got.double() - exact).abs()
    assert bool((err <= bound).all())
    lib = (block_matmul_ref(A, B).double() - exact).abs()
    assert float(err.max()) <= 2 * float(lib.max()) + 1e-30


@pytest.mark.parametrize("M,K,N", [(8, 8, 8), (128, 128, 128), (100, 37, 65),
                                   (256, 512, 128), (40, 200, 1), (1, 1, 1), (300, 1029, 257)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_block_matmul_matches_plain_and_float64(cuda, M, K, N, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(M * K + N)
    A = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    B = torch.randn((K, N), generator=g, device=cuda).to(dtype)
    got = block_matmul(A, B)
    again = block_matmul(A, B)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _mm_held(got, A, B)


def test_block_matmul_batch_shared_a_mixed_and_float64(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    G = torch.randn((70, 33), generator=g, device=cuda)
    Mb = torch.randn((5, 33, 90), generator=g, device=cuda)
    out = encode_gm(G, Mb)
    torch.cuda.synchronize()
    assert out.shape == (5, 70, 90)
    for i in range(5):                        # each block is the 2-D product, bit for bit
        assert torch.equal(out[i], block_matmul(G, Mb[i]))
    _mm_held(out, G.expand(5, 70, 33), Mb)
    mixed = block_matmul(G.to(torch.bfloat16), Mb[0])
    _mm_held(mixed, G.to(torch.bfloat16), Mb[0])
    with pytest.raises(ValueError):          # float64 runs the plain version, on the CPU only
        block_matmul(G.double(), Mb.double())
    theta = torch.randn(90, generator=g, device=cuda)
    assert torch.equal(coded_matvec(Mb[0], theta), block_matmul(Mb[0], theta[:, None])[:, 0])


def test_block_matmul_counts_its_launches_and_rejects(cuda):
    A = torch.randn((16, 8), device=cuda)
    before = block_matmul.launches
    block_matmul(A, A.T.contiguous())
    coded_matvec(A, torch.randn(8, device=cuda))
    block_matmul(A.cpu(), A.T.cpu())
    assert block_matmul.launches - before == 2
    for bad in (lambda: block_matmul(A.half(), A.T.half()),
                lambda: block_matmul(A, A),
                lambda: block_matmul(A.double(), A.T),
                lambda: block_matmul(A, A.T.cpu())):
        with pytest.raises(ValueError):
            bad()


def test_encode_runs_the_kernel(cuda):
    code = make_regular_ldpc(64, seed=0)
    g = torch.Generator(device=cuda).manual_seed(0)
    M = torch.randn((128, 128), generator=g, device=cuda)
    before = block_matmul.launches
    C = encoding.encode_moment_blocks(code, M)
    C2 = encoding.encode_moment(code, M[:64, :64].contiguous())
    torch.cuda.synchronize()
    assert block_matmul.launches - before == 2
    Gt = torch.as_tensor(code.G, dtype=torch.float32, device=cuda)
    _mm_held(C, Gt.expand(2, *Gt.shape), M.reshape(2, 64, 128))
    _mm_held(C2, Gt, M[:64, :64])


# The new tiling's edges and TMA alignment: K in {17, 1029} (one partial
# stage of 64 columns, and 16 stages and a partial one), N in {1, 3, 257}
# and M in {1, 65} (rows of a 16-byte TMA stride only after the split
# pass's padding), f32, bf16 and mixed inputs, under the same gates.

from repro_torch.kernels.block_matmul import products_of_terms, split_terms  # noqa: E402
from repro_torch.kernels.block_matmul.ref import split_terms_ref  # noqa: E402

_MIXED = {"f32": (torch.float32, torch.float32), "bf16": (torch.bfloat16, torch.bfloat16),
          "bf16_f32": (torch.bfloat16, torch.float32), "f32_bf16": (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("M", [1, 65])
@pytest.mark.parametrize("N", [1, 3, 257])
@pytest.mark.parametrize("K", [17, 1029])
@pytest.mark.parametrize("dtypes", list(_MIXED))
def test_block_matmul_edges_match_plain_and_float64(cuda, M, K, N, dtypes):
    da, db = _MIXED[dtypes]
    g = torch.Generator(device=cuda).manual_seed(M * K + N)
    A = torch.randn((M, K), generator=g, device=cuda).to(da)
    B = torch.randn((K, N), generator=g, device=cuda).to(db)
    got = block_matmul(A, B)
    again = block_matmul(A, B)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _mm_held(got, A, B)


# The 2x gate over 40 seeds at short K, where the fold's first chunk holds
# the whole sum: a wgmma step cuts its sum toward zero (up to 1 ulp of it),
# which on one to three outputs can meet a torch.matmul that rounded well.
@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (1, 17, 3)])
def test_block_matmul_short_k_over_40_seeds(cuda, M, K, N):
    torch.backends.cuda.matmul.allow_tf32 = False
    failed = {}
    for sd in range(40):
        g = torch.Generator(device=cuda).manual_seed(1000 * sd + M * K + N)
        A = torch.randn((M, K), generator=g, device=cuda)
        B = torch.randn((K, N), generator=g, device=cuda)
        A64, B64 = A.double(), B.double()
        exact = torch.matmul(A64, B64)
        err = (block_matmul(A, B).double() - exact).abs()
        lib = float((block_matmul_ref(A, B).double() - exact).abs().max())
        bound = K * 2.0 ** -24 * torch.matmul(A64.abs(), B64.abs())
        if not bool((err <= bound).all()) or float(err.max()) > 2 * lib + 1e-30:
            failed[sd] = float(err.max()) / max(lib, 1e-30)
    assert not failed, f"seeds failing a gate (kernel's distance over torch.matmul's): {failed}"


@pytest.mark.parametrize("shared", ["A", "B"])
def test_block_matmul_shared_operand_over_a_batch(cuda, shared):
    g = torch.Generator(device=cuda).manual_seed(7)
    if shared == "A":                         # G over blocks of M, as the encode
        A = torch.randn((65, 1029), generator=g, device=cuda)
        B = torch.randn((3, 1029, 257), generator=g, device=cuda)
    else:
        A = torch.randn((3, 65, 17), generator=g, device=cuda)
        B = torch.randn((17, 3), generator=g, device=cuda)
    before = split_terms.launches
    out = block_matmul(A, B)
    torch.cuda.synchronize()
    assert split_terms.launches - before == 2    # the shared operand split once
    for i in range(3):
        Ai = A if A.ndim == 2 else A[i]
        Bi = B if B.ndim == 2 else B[i]
        assert torch.equal(out[i].view(torch.int32), block_matmul(Ai, Bi).view(torch.int32))
    _mm_held(out, A.expand(3, *A.shape) if A.ndim == 2 else A,
             B.expand(3, *B.shape) if B.ndim == 2 else B)


@pytest.mark.parametrize("shape", [(1, 1), (37, 65), (300, 1029), (3, 70, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("transpose", [False, True], ids=["rows", "cols"])
def test_split_terms_matches_plain_bit_for_bit(cuda, shape, dtype, transpose):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=cuda) * torch.exp2(
        torch.randint(-140, 128, shape, generator=g, device=cuda).float())
    specials = torch.tensor([3.4028235e38, -3.4028235e38, 3.39e38, float("inf"),
                             -float("inf"), float("nan"), -0.0, 1e-45, 2.0 ** -126,
                             2.0 ** -111 + 2.0 ** -134], device=cuda)
    n = min(specials.numel(), x.numel())
    x.view(-1)[:n] = specials[:n]
    x = x.to(dtype)
    got = split_terms(x, transpose)
    want = split_terms_ref(x, transpose)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("dtypes", ["f32", "bf16", "f32_bf16"])
def test_block_matmul_nonfinite_where_matmul_puts_them(cuda, dtypes):
    da, db = _MIXED[dtypes]
    g = torch.Generator(device=cuda).manual_seed(11)
    A = torch.randn((70, 40), generator=g, device=cuda)
    B = torch.randn((40, 90), generator=g, device=cuda)
    A[3, 5], A[10, 7], A[30, 7], A[20, 9] = float("inf"), float("nan"), -float("inf"), 0.0
    B[5, 2], B[9, 11], B[7, 50], B[30, 60] = 0.0, -float("inf"), float("inf"), float("nan")
    A, B = A.to(da), B.to(db)
    got = block_matmul(A, B)
    want = torch.matmul(A.float(), B.float())
    for pick in (torch.isnan, lambda t: t == float("inf"), lambda t: t == -float("inf")):
        assert torch.equal(pick(got), pick(want))
    finite = torch.isfinite(want)
    assert bool(torch.isnan(want).any()) and bool(torch.isinf(want).any()) and bool(finite.any())
    exact = torch.matmul(A.double(), B.double())
    bound = A.shape[-1] * 2.0 ** -24 * torch.matmul(A.double().abs(), B.double().abs())
    assert bool(((got.double() - exact).abs() <= bound)[finite].all())


def test_block_matmul_counts_launches_by_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    A = torch.randn((65, 17), generator=g, device=cuda)
    Bb = torch.randn((2, 17, 3), generator=g, device=cuda)
    counts = lambda: (split_terms.launches, block_matmul.launches)   # noqa: E731
    before = counts()
    block_matmul(A, Bb)                      # A shared: two splits, one product launch
    coded_matvec(A, torch.randn(17, generator=g, device=cuda))
    ta, tb = split_terms(A), split_terms(Bb[0], transpose=True)
    out = products_of_terms(ta, tb)
    block_matmul(A.cpu(), Bb.cpu())          # the plain version: no launch
    torch.cuda.synchronize()
    after = counts()
    assert (after[0] - before[0], after[1] - before[1]) == (6, 3)
    assert torch.equal(out[0], block_matmul(A, Bb[0]))


# ------------------------------------------------------------ check pass
# The kernel sums in its plain version's order, so all four outputs agree
# bit for bit (NaNs by position).

from repro_torch.kernels.ldpc_peel import check_pass_cuda, check_pass_ref, peel_round_cuda  # noqa: E402


@pytest.mark.parametrize("p,N,V", [(8, 16, 1), (32, 64, 4), (128, 256, 128), (130, 260, 7),
                                   (64, 128, 200), (1024, 2048, 32)])
@pytest.mark.parametrize("bad", [None, "nan", "inf"])
def test_check_pass_matches_plain(cuda, p, N, V, bad):
    rng = np.random.default_rng([p, N, V])
    H = rng.standard_normal((p, N)).astype(np.float32)
    H[rng.random((p, N)) < 0.8] = 0.0
    vals = rng.standard_normal((N, V)).astype(np.float32)
    erased = rng.random(N) < 0.3
    if bad is not None:
        vals[np.flatnonzero(erased)[0]] = np.nan if bad == "nan" else np.inf
    Ht, vt, et = (torch.from_numpy(a).to(cuda) for a in (H, vals, erased))
    got = check_pass_cuda(Ht, vt, et)
    want = check_pass_ref(Ht, vt, et.float()[:, None])
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        nan = torch.isnan(b)
        assert torch.equal(torch.isnan(a), nan)
        assert torch.equal(torch.where(nan, 0, a), torch.where(nan, 0, b))
    assert bad is None or bool(torch.isnan(got[0]).all())


def test_peel_round_matches_the_cpu_and_counts(cuda):
    code = make_regular_ldpc(100, seed=1)
    rng = np.random.default_rng(0)
    cw = code.encode(rng.standard_normal((100, 8))).astype(np.float32)
    erased = rng.random(code.N) < 0.3
    rx = np.where(erased[:, None], 0.0, cw).astype(np.float32)
    H = torch.from_numpy(np.ascontiguousarray(code.H, np.float32))
    before = check_pass_cuda.launches
    gv, ge = peel_round_cuda(H.to(cuda), torch.from_numpy(rx).to(cuda),
                             torch.from_numpy(erased).to(cuda))
    cv, ce = peel_round_cuda(H, torch.from_numpy(rx), torch.from_numpy(erased))
    assert check_pass_cuda.launches - before == 1
    assert torch.equal(ge.cpu(), ce) and bool((erased & ~ce.numpy()).any())
    assert torch.equal(gv.cpu(), cv)
