"""The CUDA decode kernel against its plain PyTorch version, on the card.

These tests need a CUDA card and skip without one (the decision is taken
inside the fixture, at run time).  They import no JAX, so they run on a
machine with the card alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: on ±1-weight codes with small-integer payloads every sum and
quotient is an exact integer in f32, so kernel and plain version agree bit
for bit.  On Gaussian codes with codeword payloads they agree to
``1e-4·max|c| + 4·max|plain − c|`` (f32 summation order, amplified along
peeling chains as the plain version's own error against the codeword
shows; see tests/test_torch_decode.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import decoder
from repro_torch.core.ldpc import make_parity_only_ldpc, make_regular_ldpc
from repro_torch.kernels.ldpc_peel import decode_fused_ref, dense_h, peel_decode_cuda


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
