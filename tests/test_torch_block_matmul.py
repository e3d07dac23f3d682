"""The port's tiled matrix product and moment encode against the JAX
package's, on the CPU.

On CPU tensors ``repro_torch.kernels.block_matmul.block_matmul`` (and
``coded_matvec``, ``encode_gm``, which launch through it) runs the kernel's
plain version, ``torch.matmul`` in f32 of the f32-cast inputs.  It is held
here against the JAX Pallas ``block_matmul``, ``coded_matvec`` and
``encode_gm`` in interpret mode, on tests/test_kernels.py's shapes and
dtypes, with that file's tolerances (f32: 1e-5 relative and 1e-5·K
absolute; bf16 inputs: 3e-2 and 3e-2·K, the same bf16 values on both
sides, products summed in f32 in other orders).  ``encode_moment`` and
``encode_moment_blocks`` (the encode of Scheme 2 and of the blocked
schemes, Scheme 1 included) are held against JAX's within 1e-5·(|G|·|M|)
entry by entry (f32 sums in other orders), and float64 moments encode
in float64.  The card tests (tests/test_torch_cuda.py) hold the kernel
against its plain version and float64.

The card's design has plain versions of its own, held here: the split
pass (``ref.split_terms_ref``: each f32 value as three bf16 terms) sums
back to every finite f32 exactly for |x| >= 2^-110 and within 2^-134
below, keeps inf and NaN as its first term, and splits a bf16 value into
two terms of 4 bits; the product kernel's arithmetic (``ref.products_ref``: the
terms' products but the smallest, in float64) is held against JAX's
interpret-mode ``block_matmul`` and ``encode_moment_blocks`` (the
tolerances above) and against float64 under the card's two gates: within
K·2⁻²⁴·(|A|·|B|) entry by entry, and at most twice ``torch.matmul``'s
distance in f32 (plus 1e-30).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core.ldpc import make_regular_ldpc
from repro.kernels.block_matmul import block_matmul as jax_block_matmul
from repro.kernels.block_matmul import coded_matvec as jax_coded_matvec
from repro.kernels.block_matmul import encode_gm as jax_encode_gm
from repro_torch import convert
from repro_torch.core import encoding as tenc
from repro_torch.kernels.block_matmul import (block_matmul, block_matmul_ref, coded_matvec,
                                              encode_gm, products_of_terms, products_ref,
                                              split_terms, split_terms_ref)
from repro_torch.kernels.block_matmul.ref import BOTTOM_ERROR, EXACT_ABOVE, split3


def _pair(a, dtype):
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return j, t


@pytest.mark.parametrize("M,K,N", [(8, 8, 8), (128, 128, 128), (100, 37, 65),
                                   (256, 512, 128), (40, 200, 1)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_block_matmul_matches_jax(M, K, N, dtype):
    rng = np.random.default_rng(M * K + N)
    (jA, tA), (jB, tB) = (_pair(rng.standard_normal(s), dtype) for s in ((M, K), (K, N)))
    want = np.asarray(jax_block_matmul(jA, jB, interpret=True))
    got = block_matmul(tA, tB)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    tol = 1e-5 if dtype == jnp.float32 else 3e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * K)


def test_coded_matvec_and_encode_gm_match_jax():
    code = make_regular_ldpc(64, l=3, r=6, seed=0)
    rng = np.random.default_rng(2)
    M = rng.standard_normal((64, 64)).astype(np.float32)
    theta = rng.standard_normal(64).astype(np.float32)
    G = code.G.astype(np.float32)
    jC = np.asarray(jax_encode_gm(jnp.asarray(G), jnp.asarray(M), interpret=True))
    C = encode_gm(torch.from_numpy(G), torch.from_numpy(M))
    np.testing.assert_allclose(C.numpy(), jC, rtol=1e-4, atol=1e-4)
    z = coded_matvec(C, torch.from_numpy(theta))
    jz = np.asarray(jax_coded_matvec(jnp.asarray(jC), jnp.asarray(theta), interpret=True))
    assert z.shape == (code.N,)
    np.testing.assert_allclose(z.numpy(), jz, rtol=1e-4, atol=1e-4)


def test_batch_is_the_products_of_its_blocks():
    rng = np.random.default_rng(4)
    G = torch.from_numpy(rng.standard_normal((30, 7)).astype(np.float32))
    Mb = torch.from_numpy(rng.standard_normal((3, 7, 11)).astype(np.float32))
    out = encode_gm(G, Mb)
    assert out.shape == (3, 30, 11)
    for i in range(3):
        np.testing.assert_allclose(out[i].numpy(), (G @ Mb[i]).numpy(), rtol=1e-6, atol=1e-6)
    both = block_matmul(G.expand(3, 30, 7).contiguous(), Mb)
    assert torch.equal(both, out)


def test_float64_in_float64_out_and_cpu_counts_nothing():
    rng = np.random.default_rng(5)
    A, B = (torch.from_numpy(rng.standard_normal(s)) for s in ((9, 4), (4, 6)))
    before = block_matmul.launches
    out = block_matmul(A, B)
    assert block_matmul.launches == before
    assert out.dtype == torch.float64 and torch.equal(out, A @ B)
    assert torch.equal(block_matmul(A.float(), B.float()), block_matmul_ref(A.float(), B.float()))


@pytest.mark.parametrize("which", ["half", "f64_with_f32", "inner", "batch", "rank",
                                   "empty", "devices"])
def test_wrapper_rejects_what_the_kernel_does_not_take(which):
    A, B = torch.ones(4, 3), torch.ones(3, 5)
    if which == "half":
        A, B = A.half(), B.half()
    elif which == "f64_with_f32":
        A = A.double()
    elif which == "inner":
        B = torch.ones(4, 5)
    elif which == "batch":
        A, B = torch.ones(2, 4, 3), torch.ones(3, 3, 5)
    elif which == "rank":
        A = torch.ones(3)
    elif which == "empty":
        A, B = torch.ones(0, 3), torch.ones(3, 5)
    else:
        A = torch.ones(4, 3, device="meta")
    with pytest.raises(ValueError):
        block_matmul(A, B)


@pytest.mark.parametrize("K,k", [(20, 20), (20, 80), (64, 128)])
def test_encode_moment_matches_jax(K, k):
    code = make_regular_ldpc(K, l=3, r=6, seed=K + k)
    rng = np.random.default_rng(K + k)
    X = rng.standard_normal((3 * k, k)).astype(np.float32)
    M = (X.T @ X).astype(np.float32)
    tcode = convert.code_from(code)
    tM = torch.from_numpy(M)
    G64 = np.abs(code.G.astype(np.float64))
    if K == k:
        want = np.asarray(jenc.encode_moment(code, jnp.asarray(M)))
        got = tenc.encode_moment(tcode, tM)
        scale = G64 @ np.abs(M)
    else:
        want = np.asarray(jenc.encode_moment_blocks(code, jnp.asarray(M)))
        got = tenc.encode_moment_blocks(tcode, tM)
        scale = np.einsum("nk,bkj->bnj", G64, np.abs(M).reshape(k // K, K, k))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert (np.abs(got.numpy() - want) <= 1e-5 * scale + 1e-30).all()
    exact = tenc.encode_moment_blocks(tcode, tM.double())
    assert exact.dtype == torch.float64
    G = torch.from_numpy(code.G.astype(np.float64))
    assert torch.equal(exact, torch.matmul(G, tM.double().reshape(k // K, K, k)))


# ------------------------------------------------------------- the split pass

def _f32(bits) -> torch.Tensor:
    return torch.from_numpy(np.asarray(bits, dtype=np.uint32).view(np.float32).copy())


_SPLIT_VALUES = {
    # every exponent: random bit patterns (NaN and inf among them)
    "random_bits": lambda: _f32(np.random.default_rng(0).integers(0, 2**32, 400_000)),
    # bf16's overflow edge: every f32 from bf16's largest finite value up to
    # f32's, both signs (to nearest these round to inf)
    "overflow_edge": lambda: _f32(np.concatenate([np.arange(0x7F7F0000, 0x7F800000),
                                                  np.arange(0xFF7F0000, 0xFF800000)])),
    # the subnormal end: every f32 subnormal in steps, both signs, and the
    # normals around 2^-110 where the third term leaves bf16's normal range
    "subnormal_end": lambda: _f32(np.concatenate([
        np.arange(0, 0x00800000, 97), np.arange(0x80000000, 0x80800000, 89),
        np.arange(0x08000000, 0x09800000, 101), np.arange(0x88000000, 0x89800000, 103)])),
}


@pytest.mark.parametrize("values", list(_SPLIT_VALUES))
def test_split_sums_back_exactly(values):
    x = _SPLIT_VALUES[values]()
    t1, t2, t3 = split3(x)
    fin = torch.isfinite(x)
    x64 = x.double()[fin]
    total = (t1.double() + t2.double() + t3.double())[fin]
    assert bool(torch.isfinite(t1[fin]).all())         # never rounded past bf16's range
    above = x64.abs() >= EXACT_ABOVE
    assert bool(above.any()) or values == "subnormal_end"
    assert torch.equal(total[above], x64[above])
    assert bool(((total - x64).abs() <= BOTTOM_ERROR).all())
    assert bool((~above).any()) or values != "subnormal_end"
    # the magnitudes the products' orders rest on
    ax = x64.abs()
    assert bool((t2.double()[fin].abs() <= 2.0 ** -8 * ax * (1 + 2.0 ** -8)).all())
    assert bool((t3.double()[fin].abs()[above] <= 2.0 ** -16 * ax[above]).all())


@pytest.mark.parametrize("value,bits", [(float("inf"), 0x7F80), (-float("inf"), -0x80),
                                        (float("nan"), 0x7FC0), (-float("nan"), 0x7FC0)])
def test_split_keeps_inf_and_nan_as_the_first_term(value, bits):
    t1, t2, t3 = split3(torch.tensor([value, 1.5]))
    assert int(t1.view(torch.int16)[0]) == bits
    assert int(t2.view(torch.int16)[0]) == 0 and int(t3.view(torch.int16)[0]) == 0
    assert float(t1[1]) == 1.5 and float(t2[1]) == 0.0


@pytest.mark.parametrize("transpose", [False, True], ids=["rows", "cols"])
def test_split_of_bf16_is_two_exact_terms(transpose):
    rng = np.random.default_rng(3)
    bits = rng.integers(-32768, 32768, (3, 37, 65)).astype(np.int16)
    bits[0, 0, :4] = [0x7FC1, 0x7F80, -0x7F, 0x0003]     # a NaN payload, inf, a NaN, a subnormal
    x = torch.from_numpy(bits).view(torch.bfloat16)
    out = split_terms(x, transpose)                       # CPU: the plain version
    want = x.transpose(1, 2) if transpose else x
    inner = want.shape[-1]
    assert out.shape == (3, 2, want.shape[1], -(-inner // 8) * 8)
    t1, t2 = out[:, 0, :, :inner], out[:, 1, :, :inner]
    fin = torch.isfinite(want)
    assert torch.equal((t1.double() + t2.double())[fin], want.double()[fin])
    # x1 keeps the sign, the exponent and the first 3 fraction bits; x2 the last 4
    assert torch.equal(t1.view(torch.int16)[fin] & 0x000F,
                       torch.zeros_like(t1.view(torch.int16)[fin]))
    normal = fin & (want.double().abs() >= 2.0 ** -126)
    assert bool((t2.double().abs() < t1.double().abs() / 8)[normal].all())
    assert torch.equal(t1.view(torch.int16)[~fin], want.view(torch.int16)[~fin])
    assert not bool(t2[~fin].view(torch.int16).any())
    assert not bool(out[..., inner:].view(torch.int16).any())


@pytest.mark.parametrize("shape", [(1, 1), (37, 65), (2, 17, 3)])
def test_split_layout_is_the_terms_padded(shape):
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(shape).astype(np.float32))
    for transpose in (False, True):
        out = split_terms_ref(x, transpose)
        X = x if x.ndim == 3 else x[None]
        X = X.transpose(1, 2) if transpose else X
        assert out.shape[:3] == (X.shape[0], 3, X.shape[1]) and out.shape[3] % 8 == 0
        assert 0 <= out.shape[3] - X.shape[2] < 8
        assert torch.equal(out[..., :X.shape[2]].double().sum(1), X.double())
        assert not bool(out[..., X.shape[2]:].view(torch.int16).any())


# ------------------------------------------- the product kernel's arithmetic

def _gates(P, A, B):
    """Within K·2⁻²⁴·(|A|·|B|) of float64 entry by entry, and no more than
    twice torch.matmul's f32 distance from float64 (plus 1e-30)."""
    A64, B64 = A.double(), B.double()
    exact = torch.matmul(A64, B64)
    err = (P.double() - exact).abs()
    assert bool((err <= A.shape[-1] * 2.0 ** -24 * torch.matmul(A64.abs(), B64.abs())).all())
    lib = float((block_matmul_ref(A, B).double() - exact).abs().max())
    assert float(err.max()) <= 2 * lib + 1e-30


_DTYPES = {"f32": (jnp.float32, jnp.float32), "bf16": (jnp.bfloat16, jnp.bfloat16),
           "bf16_f32": (jnp.bfloat16, jnp.float32)}


@pytest.mark.parametrize("M,K,N", [(8, 8, 8), (128, 128, 128), (100, 37, 65), (256, 512, 128),
                                   (40, 200, 1), (1, 1, 1), (300, 1029, 257), (1, 17, 3),
                                   (65, 1029, 257)])
@pytest.mark.parametrize("dtypes", list(_DTYPES))
def test_products_ref_held_to_jax_and_float64(M, K, N, dtypes):
    da, db = _DTYPES[dtypes]
    rng = np.random.default_rng(M * K + N)
    (jA, tA), (jB, tB) = (_pair(rng.standard_normal(shape), dt)
                          for shape, dt in (((M, K), da), ((K, N), db)))
    P = products_ref(tA, tB)
    assert P.dtype == torch.float64 and P.shape == (M, N)
    want = np.asarray(jax_block_matmul(jA, jB, interpret=True))
    tol = 1e-5 if dtypes == "f32" else 3e-2
    np.testing.assert_allclose(P.numpy(), want, rtol=tol, atol=tol * K)
    _gates(P, tA, tB)
    # the CPU path of the product kernel's wrapper: the same sum, rounded once
    ta, tb = split_terms(tA), split_terms(tB, transpose=True)
    assert torch.equal(products_of_terms(ta, tb)[0], P.float())


def test_products_ref_of_an_encode_held_to_jax_and_float64():
    code = make_regular_ldpc(64, l=3, r=6, seed=64)
    rng = np.random.default_rng(128)
    X = rng.standard_normal((3 * 128, 128)).astype(np.float32)
    M = (X.T @ X).astype(np.float32)
    want = np.asarray(jenc.encode_moment_blocks(code, jnp.asarray(M)))
    G, Mb = torch.from_numpy(code.G.astype(np.float32)), torch.from_numpy(M).reshape(2, 64, 128)
    P = products_ref(G, Mb)
    assert P.shape == want.shape == (2, code.N, 128)
    scale = np.einsum("nk,bkj->bnj", np.abs(code.G.astype(np.float64)), np.abs(Mb.numpy()))
    assert (np.abs(P.numpy() - want) <= 1e-5 * scale + 1e-30).all()
    _gates(P, G.expand(2, *G.shape), Mb)
