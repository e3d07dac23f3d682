"""Wrappers of the CUDA flooding peeling decode, one per contract.

============================== ============================================
wrapper                        contract (TPU kernel it replaces)
============================== ============================================
:func:`peel_decode_cuda`       one pattern, exactly ``iters`` rounds
                               (``decode_fused``)
:func:`peel_decode_batch_cuda` B patterns, exactly ``iters`` rounds each
                               (``decode_fused_batch``)
:func:`peel_decode_adaptive_cuda`
                               one pattern, early exit within ``max_iters``
                               rounds (``decode_fused_adaptive``)
:func:`peel_decode_batch_adaptive_cuda`
                               B patterns, per-slot early exit under
                               per-slot budgets (``decode_fused_batch_adaptive``)
============================== ============================================

All four launch the one hand-written kernel (``csrc/peel_decode.cu``).
For tensors on a CUDA device a wrapper launches it or raises; for tensors
on the CPU it runs the plain PyTorch version (:mod:`.ref`).  There is no
other path: a failed build or launch is an error, never a fallback.

Each wrapper's ``.launches`` counts its own kernel launches (and nothing
else), so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ldpc_peel import ref

__all__ = ["CodeTables", "peel_decode_cuda", "peel_decode_batch_cuda",
           "peel_decode_adaptive_cuda", "peel_decode_batch_adaptive_cuda",
           "MAX_SMEM_BYTES"]

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
                                       ptr, ptr, ptr, i32, i32, i32, i32, i32,
                                       ptr]
    lib.peel_decode_launch.restype = ctypes.c_int
    lib.peel_decode_error_string.argtypes = [ctypes.c_int]
    lib.peel_decode_error_string.restype = ctypes.c_char_p
    return lib


def _check(tables: CodeTables, values: torch.Tensor, erased: torch.Tensor,
           iters: int, *, batched: bool,
           budgets: torch.Tensor | None = None) -> None:
    idx, coeff, N = tables
    dev = values.device
    vdim = 3 if batched else 2
    operands = [("check_idx", idx, torch.int32, 2),
                ("check_coeff", coeff, torch.float32, 2),
                ("values", values, torch.float32, vdim),
                ("erased", erased, torch.bool, vdim - 1)]
    if budgets is not None:
        operands.append(("budgets", budgets, torch.int32, 1))
    for name, t, dtype, ndim in operands:
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
    lead = tuple(values.shape[:-2])
    if values.shape[-2] != N or erased.shape != (*lead, N):
        raise ValueError(f"values {tuple(values.shape)} / erased "
                         f"{tuple(erased.shape)} do not match N={N}")
    if budgets is not None and tuple(budgets.shape) != lead:
        raise ValueError(f"budgets must be {lead}; got {tuple(budgets.shape)}")
    if (N < 1 or values.shape[-1] < 1 or idx.shape[0] < 1 or idx.shape[1] < 1
            or (batched and values.shape[0] < 1)):
        raise ValueError("empty code, batch or payload")
    if iters < 0:
        raise ValueError(f"iters must be >= 0; got {iters}")
    if _smem_bytes(N) > MAX_SMEM_BYTES:
        raise ValueError(f"N={N} needs {_smem_bytes(N)} bytes of shared "
                         f"memory per block; the kernel takes at most "
                         f"{MAX_SMEM_BYTES}")


def _launch(tables: CodeTables, values: torch.Tensor, erased: torch.Tensor,
            iters: int, *, adaptive: bool,
            budgets: torch.Tensor | None = None):
    """Launch the kernel on ``values (B, N, V)`` / ``erased (B, N)``;
    returns ``(values, erased, rounds)`` (``rounds`` (B,) int32 for the
    adaptive contract, else None)."""
    if values.device.type != "cuda":
        raise ValueError(f"no decode for device {values.device}")
    lib = _lib()
    idx, coeff, N = tables
    p, r = idx.shape
    B, _, V = values.shape
    dev = values.device
    out_v = torch.empty_like(values)
    out_e = torch.empty_like(erased)
    rounds = torch.empty(B, dtype=torch.int32, device=dev) if adaptive else None
    scratch = torch.empty((B, p, V), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.peel_decode_launch(
            idx.data_ptr(), coeff.data_ptr(), p, r, values.data_ptr(),
            erased.data_ptr(), None if budgets is None else budgets.data_ptr(),
            out_v.data_ptr(), out_e.data_ptr(),
            None if rounds is None else rounds.data_ptr(), scratch.data_ptr(),
            B, N, V, iters, int(adaptive), stream)
    if rc != 0:
        msg = lib.peel_decode_error_string(rc).decode()
        raise RuntimeError(f"peel_decode kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    return out_v, out_e, rounds


def _dense_h(tables: CodeTables) -> torch.Tensor:
    return ref.dense_h(tables.check_idx, tables.check_coeff, tables.N)


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
    _check(tables, values, erased, iters, batched=False)
    if values.device.type == "cpu":
        return ref.decode_fused_ref(_dense_h(tables), values, erased, iters)
    v, e, _ = _launch(tables, values[None], erased[None], iters,
                      adaptive=False)
    peel_decode_cuda.launches += 1
    return v[0], e[0]


def peel_decode_batch_cuda(tables: CodeTables, values: torch.Tensor,
                           erased: torch.Tensor, iters: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exactly ``iters`` flooding rounds of each of B independent patterns,
    one launch: ``values (B, N, V)`` float32, ``erased (B, N)`` bool.  Slot
    ``b`` decodes exactly as :func:`peel_decode_cuda` decodes it alone."""
    iters = int(iters)
    _check(tables, values, erased, iters, batched=True)
    if values.device.type == "cpu":
        return ref.decode_fused_batch_ref(_dense_h(tables), values, erased,
                                          iters)
    v, e, _ = _launch(tables, values, erased, iters, adaptive=False)
    peel_decode_batch_cuda.launches += 1
    return v, e


def peel_decode_adaptive_cuda(tables: CodeTables, values: torch.Tensor,
                              erased: torch.Tensor, max_iters: int
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Early-exit decode of one pattern, one launch: stop when a round
    resolves nothing, nothing is erased, or ``max_iters`` rounds have run.
    ``values (N, V)`` float32, ``erased (N,)`` bool.  Returns ``(values,
    erased, rounds)`` with ``rounds`` a 0-d int32 tensor on the device (the
    no-progress probe round counts)."""
    max_iters = int(max_iters)
    _check(tables, values, erased, max_iters, batched=False)
    if values.device.type == "cpu":
        return ref.decode_fused_adaptive_ref(_dense_h(tables), values, erased,
                                             max_iters)
    v, e, d = _launch(tables, values[None], erased[None], max_iters,
                      adaptive=True)
    peel_decode_adaptive_cuda.launches += 1
    return v[0], e[0], d[0]


def peel_decode_batch_adaptive_cuda(tables: CodeTables, values: torch.Tensor,
                                    erased: torch.Tensor,
                                    budgets: torch.Tensor
                                    ) -> tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """Per-slot early-exit decode of B independent patterns, one launch.

    ``values (B, N, V)`` float32, ``erased (B, N)`` bool, ``budgets (B,)``
    int32 on the values' device: slot ``b`` runs at most ``budgets[b]``
    rounds and stops early as :func:`peel_decode_adaptive_cuda` does.
    Returns ``(values, erased, rounds (B,) int32)``; a slot with budget 0
    comes back untouched with 0 rounds.  Budgets are read on the device:
    varying them syncs nothing."""
    _check(tables, values, erased, 0, batched=True, budgets=budgets)
    if values.device.type == "cpu":
        return ref.decode_fused_batch_adaptive_ref(_dense_h(tables), values,
                                                   erased, budgets)
    v, e, d = _launch(tables, values, erased, 0, adaptive=True,
                      budgets=budgets)
    peel_decode_batch_adaptive_cuda.launches += 1
    return v, e, d


for _w in (peel_decode_cuda, peel_decode_batch_cuda, peel_decode_adaptive_cuda,
           peel_decode_batch_adaptive_cuda):
    _w.launches = 0
del _w
