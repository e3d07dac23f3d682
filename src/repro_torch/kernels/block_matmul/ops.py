"""The wrappers of the CUDA tiled matrix-product kernel.

:func:`block_matmul`, :func:`coded_matvec` and :func:`encode_gm` keep the
contracts of the JAX package's wrappers (``block_matmul/ops.py:20-39``):
A and B f32 or bf16, any shape, no padding by the caller, the product
accumulated in f32 and returned as f32 ``(M, N)``.  Beyond them, a batch
of products in one launch (A ``(M, K)`` or ``(b, M, K)``, B ``(K, N)`` or
``(b, K, N)``).  They replace the TPU kernel
``matmul_kernel_call`` (``src/repro/kernels/block_matmul/kernel.py:36``);
``core/encoding`` runs the moment encode through :func:`encode_gm`.

For tensors on a CUDA device :func:`block_matmul` launches
``csrc/block_matmul.cu`` or raises; for tensors on the CPU it runs the
plain version (:func:`.ref.block_matmul_ref`, ``torch.matmul``), which
also takes float64 (the port's float64 reference runs); the kernel takes
f32 and bf16 only, and a float64 CUDA tensor is refused.  There is no
other path: a failed build or launch is an error, never a fallback.
``block_matmul.launches`` counts the kernel's launches and nothing else;
the other two wrappers launch through it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.block_matmul import ref

__all__ = ["block_matmul", "coded_matvec", "encode_gm"]

_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("block_matmul")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.block_matmul_launch.argtypes = [ptr, i32, ptr, i32, ptr, i32, i32, i32, i32,
                                        i64, i64, i64, ptr]
    lib.block_matmul_launch.restype = ctypes.c_int
    lib.block_matmul_error_string.argtypes = [ctypes.c_int]
    lib.block_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _check(A: torch.Tensor, B: torch.Tensor) -> None:
    if A.device != B.device:
        raise ValueError(f"A is on {A.device}, B on {B.device}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no matrix product for device {A.device}")
    for name, t in (("A", A), ("B", B)):
        if t.dtype not in _CODES and not (t.dtype == torch.float64 and t.device.type == "cpu"):
            raise ValueError(f"{name} must be float32 or bfloat16 (float64 on the CPU); "
                             f"got {t.dtype} on {t.device}")
        if t.ndim not in (2, 3):
            raise ValueError(f"{name} must be 2-D or 3-D; got {tuple(t.shape)}")
    if (A.dtype == torch.float64) != (B.dtype == torch.float64):
        raise ValueError(f"float64 takes float64: A is {A.dtype}, B {B.dtype}")
    if A.shape[-1] != B.shape[-2]:
        raise ValueError(f"inner dimensions differ: A {tuple(A.shape)}, B {tuple(B.shape)}")
    if A.ndim == B.ndim == 3 and A.shape[0] != B.shape[0]:
        raise ValueError(f"batches differ: A {tuple(A.shape)}, B {tuple(B.shape)}")
    if min(A.shape) < 1 or min(B.shape) < 1:
        raise ValueError(f"empty product: A {tuple(A.shape)}, B {tuple(B.shape)}")


def block_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B``: A ``(M, K)`` or ``(b, M, K)``, B ``(K, N)`` or ``(b, K,
    N)`` (a 2-D operand is shared by every product of the batch); f32 or
    bf16 in, f32 ``([b,] M, N)`` out (on the CPU also float64 in and out,
    by the plain version).  Each entry
    is the ascending, Kahan-compensated sum of partial sums over 8
    columns of A at a time, each partial a chain of full-precision FMAs
    (no TF32), the same bits from run to run.  One launch for the whole
    batch."""
    _check(A, B)
    if A.device.type == "cpu":
        return ref.block_matmul_ref(A, B)
    lib = _lib()
    A, B = A.contiguous(), B.contiguous()
    M, K = A.shape[-2:]
    N = B.shape[-1]
    batch = A.shape[0] if A.ndim == 3 else B.shape[0] if B.ndim == 3 else 1
    out_shape = (M, N) if A.ndim == B.ndim == 2 else (batch, M, N)
    out = torch.empty(out_shape, dtype=torch.float32, device=A.device)
    sA = M * K if A.ndim == 3 else 0
    sB = K * N if B.ndim == 3 else 0
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.block_matmul_launch(A.data_ptr(), _CODES[A.dtype], B.data_ptr(),
                                     _CODES[B.dtype], out.data_ptr(), M, N, K, batch, sA,
                                     sB, M * N, stream)
    if rc != 0:
        msg = lib.block_matmul_error_string(rc).decode()
        raise RuntimeError(f"block_matmul kernel launch failed: CUDA error {rc} ({msg})")
    block_matmul.launches += 1
    return out


block_matmul.launches = 0


def coded_matvec(C: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Worker-side ``z = C @ θ`` (``(rows, k) @ (k,)``), as the JAX
    ``coded_matvec``: the product with ``θ`` as one column."""
    return block_matmul(C, theta[:, None])[:, 0]


def encode_gm(G: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Moment encode ``C = G @ M``; ``M`` may be a batch of blocks ``(b, K,
    k)``, encoded in one launch."""
    return block_matmul(G, M)
