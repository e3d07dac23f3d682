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
                                              encode_gm)


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
