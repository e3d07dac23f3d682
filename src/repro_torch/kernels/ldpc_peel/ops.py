"""Wrapper of the CUDA fixed-D flooding peeling decode.

:func:`peel_decode_cuda` is what ``repro_torch.core.decoder.peel_decode``
calls for ``backend="cuda"``.  For tensors on a CUDA device it launches the
hand-written kernel (``csrc/peel_decode.cu``) or raises; for tensors on the
CPU it runs the plain PyTorch version (:mod:`.ref`).  There is no other
path: a failed build or launch is an error, never a fallback.

``peel_decode_cuda.launches`` counts the kernel's launches (and nothing
else), so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ldpc_peel import ref

__all__ = ["CodeTables", "peel_decode_cuda", "MAX_SMEM_BYTES"]

# Dynamic shared memory a block may use on sm_90 (H100, H200).
MAX_SMEM_BYTES = 232_448


class CodeTables(NamedTuple):
    """A code's neighbour table on one device: ``check_idx (p, r)`` int32
    columns (padding slots hold the sentinel ``N``) and ``check_coeff
    (p, r)`` float32 edge weights."""

    check_idx: torch.Tensor
    check_coeff: torch.Tensor
    N: int


def _smem_bytes(N: int) -> int:
    return ((N + 15) & ~15) + 4 * N        # as peel_decode_smem_bytes()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("peel_decode")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.peel_decode_launch.argtypes = [ptr, ptr, i32, i32, ptr, ptr, ptr, ptr,
                                       ptr, i32, i32, i32, ptr]
    lib.peel_decode_launch.restype = ctypes.c_int
    lib.peel_decode_error_string.argtypes = [ctypes.c_int]
    lib.peel_decode_error_string.restype = ctypes.c_char_p
    return lib


def _check(tables: CodeTables, values: torch.Tensor, erased: torch.Tensor,
           iters: int) -> None:
    idx, coeff, N = tables
    dev = values.device
    for name, t, dtype, ndim in (("check_idx", idx, torch.int32, 2),
                                 ("check_coeff", coeff, torch.float32, 2),
                                 ("values", values, torch.float32, 2),
                                 ("erased", erased, torch.bool, 1)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, values on {dev}")
        if t.dtype != dtype or t.ndim != ndim:
            raise ValueError(f"{name} must be a {ndim}-D {dtype} tensor; got "
                             f"{t.ndim}-D {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if idx.shape != coeff.shape:
        raise ValueError(f"check_idx {tuple(idx.shape)} and check_coeff "
                         f"{tuple(coeff.shape)} differ in shape")
    if values.shape[0] != N or erased.shape != (N,):
        raise ValueError(f"values {tuple(values.shape)} / erased "
                         f"{tuple(erased.shape)} do not match N={N}")
    if N < 1 or values.shape[1] < 1 or idx.shape[0] < 1 or idx.shape[1] < 1:
        raise ValueError("empty code or payload")
    if iters < 0:
        raise ValueError(f"iters must be >= 0; got {iters}")
    if _smem_bytes(N) > MAX_SMEM_BYTES:
        raise ValueError(f"N={N} needs {_smem_bytes(N)} bytes of shared "
                         f"memory per block; the kernel takes at most "
                         f"{MAX_SMEM_BYTES}")


def peel_decode_cuda(tables: CodeTables, values: torch.Tensor,
                     erased: torch.Tensor, iters: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exactly ``iters`` flooding rounds of one erasure pattern.

    ``values (N, V)`` float32 and ``erased (N,)`` bool, contiguous, on the
    same device as the tables.  Returns new ``(values, erased)`` tensors;
    the inputs are not modified.  When several checks resolve one
    coordinate, the lowest check row wins.
    """
    iters = int(iters)
    _check(tables, values, erased, iters)
    if values.device.type == "cpu":
        H = ref.dense_h(tables.check_idx, tables.check_coeff, tables.N)
        return ref.decode_fused_ref(H, values, erased, iters)
    if values.device.type != "cuda":
        raise ValueError(f"no decode for device {values.device}")
    lib = _lib()
    idx, coeff, N = tables
    p, r = idx.shape
    V = values.shape[1]
    out_v = torch.empty_like(values)
    out_e = torch.empty_like(erased)
    scratch = torch.empty((p, V), dtype=torch.float32, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib.peel_decode_launch(
            idx.data_ptr(), coeff.data_ptr(), p, r, values.data_ptr(),
            erased.data_ptr(), out_v.data_ptr(), out_e.data_ptr(),
            scratch.data_ptr(), N, V, iters, stream)
    if rc != 0:
        msg = lib.peel_decode_error_string(rc).decode()
        raise RuntimeError(f"peel_decode kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    peel_decode_cuda.launches += 1
    return out_v, out_e


peel_decode_cuda.launches = 0
