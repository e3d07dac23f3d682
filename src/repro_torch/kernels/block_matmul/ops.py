"""The wrappers of the CUDA matrix-product kernels (``csrc/block_matmul.cu``).

:func:`block_matmul`, :func:`coded_matvec` and :func:`encode_gm` keep the
contracts of the JAX package's wrappers (``block_matmul/ops.py:20-39``):
A and B f32 or bf16, any shape, no padding by the caller, the product
accumulated in f32 accuracy and returned as f32 ``(M, N)``.  Beyond them, a
batch of products in one launch (A ``(M, K)`` or ``(b, M, K)``, B ``(K, N)``
or ``(b, K, N)``).  They replace the TPU kernel ``matmul_kernel_call``
(``src/repro/kernels/block_matmul/kernel.py:36``); ``core/encoding`` runs
the moment encode through :func:`encode_gm`.

For tensors on a CUDA device :func:`block_matmul` launches two kernels or
raises: the split pass (:func:`split_terms`, once for A and once for B),
which writes each f32 value as four bf16 terms that sum to it (a bf16
value as two), the first on a grid shared by 64 values along k, then the
products of the terms on the tensor cores (:func:`products_of_terms`,
``gemm_kernel``), folded into f32 sums outside them.  For tensors on the CPU it runs the plain version
(:func:`.ref.block_matmul_ref`, ``torch.matmul``), which also takes
float64 (the port's float64 reference runs); the kernels take f32 and
bf16 only, and a float64 CUDA tensor is refused.  There is no other path:
a failed build or launch is an error, never a fallback.
``block_matmul.launches`` counts the product kernel's launches (made by
:func:`products_of_terms`) and ``split_terms.launches`` the split pass's,
and nothing else; :func:`coded_matvec` and :func:`encode_gm` launch
through :func:`block_matmul`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.block_matmul import ref

__all__ = ["block_matmul", "coded_matvec", "encode_gm", "split_terms", "products_of_terms"]

_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("block_matmul")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.split_terms_launch.argtypes = [ptr, i32, ptr, i32, i32, i32, i32, ptr]
    lib.split_terms_launch.restype = ctypes.c_int
    lib.block_matmul_launch.argtypes = [ptr, i32, i32, ptr, i32, i32, ptr, i32, i32, i32, i32,
                                        ptr]
    lib.block_matmul_launch.restype = ctypes.c_int
    lib.block_matmul_error_string.argtypes = [ctypes.c_int]
    lib.block_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().block_matmul_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


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


def split_terms(x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """The split pass: ``x`` ``(R, C)`` or ``(nb, R, C)``, f32 or bf16, as
    ``(nb, terms, R, Cp)`` bf16, or with ``transpose`` ``(nb, terms, C,
    Rp)``, the inner axis (k) padded with zeros to a multiple of 8.  In
    chunks of 64 along k, an f32 value has four terms that sum to it, a
    lead on the chunk's grid and three of the rest (:func:`.ref.split4`),
    a bf16 value two (:func:`.ref.split2`).  On the card one launch of the
    split kernel; on the CPU the plain version
    (:func:`.ref.split_terms_ref`), bit for bit the same."""
    if x.dtype not in _CODES or x.ndim not in (2, 3) or min(x.shape) < 1:
        raise ValueError(f"split_terms takes a non-empty 2-D or 3-D float32 or bfloat16 "
                         f"tensor; got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.split_terms_ref(x, transpose)
    if x.device.type != "cuda":
        raise ValueError(f"no split pass for device {x.device}")
    x = x.contiguous()
    nb, R, C = x.shape if x.ndim == 3 else (1, *x.shape)
    rows, inner = (C, R) if transpose else (R, C)
    out = torch.empty((nb, 4 if x.dtype == torch.float32 else 2, rows, -(-inner // 8) * 8),
                      dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.split_terms_launch(x.data_ptr(), _CODES[x.dtype], out.data_ptr(), nb, R, C,
                                    int(transpose), stream)
    _raise_on(rc, "split_terms")
    split_terms.launches += 1
    return out


split_terms.launches = 0


def products_of_terms(ta: torch.Tensor, tb: torch.Tensor) -> torch.Tensor:
    """The product kernel: from the terms of A ``ta`` ``(nbA, terms, M,
    Kp)`` and of B, transposed, ``tb`` ``(nbB, terms, N, Kp)`` (the split
    pass's outputs; a batch of 1 is shared by the other's batch), the f32
    products ``(batch, M, N)``.  Each entry is the sum of the terms'
    products in :func:`.ref.product_pairs` (ten of two f32 operands): the
    leads' product, exact within a chunk of 64 columns, and the rest summed
    on the tensor cores in two accumulators over those chunks, each chunk
    added to the entry's sum in ascending order by error-free TwoSums whose
    errors start the next chunk's small accumulator; the result rounded
    once, and NaN or inf where ``torch.matmul``'s IEEE sum has them.  On the
    card one launch, counted on
    ``block_matmul.launches``; on the CPU the plain version
    (:func:`.ref.terms_product_ref`, rounded once to f32)."""
    if (ta.dtype != torch.bfloat16 or tb.dtype != torch.bfloat16 or ta.ndim != 4
            or tb.ndim != 4 or ta.device != tb.device or ta.shape[-1] != tb.shape[-1]
            or ta.shape[-1] % 8 != 0 or ta.shape[1] not in (2, 4) or tb.shape[1] not in (2, 4)
            or (ta.shape[0] != tb.shape[0] and 1 not in (ta.shape[0], tb.shape[0]))):
        raise ValueError(f"products_of_terms takes the split pass's bf16 terms; got "
                         f"{ta.dtype} {tuple(ta.shape)} and {tb.dtype} {tuple(tb.shape)}")
    if ta.device.type == "cpu":
        return ref.terms_product_ref(ta, tb).float()
    if ta.device.type != "cuda":
        raise ValueError(f"no product kernel for device {ta.device}")
    lib = _lib()
    ta, tb = ta.contiguous(), tb.contiguous()
    batch = max(ta.shape[0], tb.shape[0])
    M, N = ta.shape[2], tb.shape[2]
    out = torch.empty((batch, M, N), dtype=torch.float32, device=ta.device)
    with torch.cuda.device(ta.device):
        stream = torch.cuda.current_stream(ta.device).cuda_stream
        rc = lib.block_matmul_launch(ta.data_ptr(), ta.shape[1], int(ta.shape[0] > 1),
                                     tb.data_ptr(), tb.shape[1], int(tb.shape[0] > 1),
                                     out.data_ptr(), M, N, ta.shape[-1], batch, stream)
    _raise_on(rc, "block_matmul")
    block_matmul.launches += 1
    return out


def block_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B``: A ``(M, K)`` or ``(b, M, K)``, B ``(K, N)`` or ``(b, K,
    N)`` (a 2-D operand is shared by every product of the batch); f32 or
    bf16 in, f32 ``([b,] M, N)`` out (on the CPU also float64 in and out,
    by the plain version).  On the card the split pass writes the terms of
    A and of B (:func:`split_terms`, a shared operand once) and the product
    kernel sums their products (:func:`products_of_terms`): f32 accuracy,
    never TF32, the same bits from run to run, NaN and inf where
    ``torch.matmul`` puts them.  One launch of the product kernel for the
    whole batch."""
    _check(A, B)
    if A.device.type == "cpu":
        return ref.block_matmul_ref(A, B)
    out = products_of_terms(split_terms(A), split_terms(B, transpose=True))
    return out[0] if A.ndim == B.ndim == 2 else out


block_matmul.launches = 0


def coded_matvec(C: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Worker-side ``z = C @ θ`` (``(rows, k) @ (k,)``), as the JAX
    ``coded_matvec``: the product with ``θ`` as one column."""
    return block_matmul(C, theta[:, None])[:, 0]


def encode_gm(G: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Moment encode ``C = G @ M``; ``M`` may be a batch of blocks ``(b, K,
    k)``, encoded in one launch."""
    return block_matmul(G, M)
