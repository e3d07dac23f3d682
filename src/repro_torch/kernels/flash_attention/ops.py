"""The wrapper of the CUDA flash-attention kernel.

:func:`flash_attention_cuda` takes the layout of the JAX package's
``models/attention.sdpa_chunked`` (q ``(B, Sq, KV, G, Dh)``, k ``(B, T,
KV, Dh)``, v ``(B, T, KV, Dv)``, ``q_pos (Sq,)``, ``kv_pos (T,)``, optional
``kv_valid (T,)``) and stands in its place on the model's path
(``repro_torch.models.attention.sdpa_chunked`` calls it).  It replaces the
TPU kernel ``flash_call`` (``src/repro/kernels/flash_attention/kernel.py:70``).

For tensors on a CUDA device it launches ``csrc/flash_attention.cu`` or
raises; for tensors on the CPU it runs the plain version
(:func:`.ref.attention_ref`).  There is no other path: a failed build or
launch is an error, never a fallback.  ``flash_attention_cuda.launches``
counts its kernel launches and nothing else.

:func:`plain_version` is a test hook, not a user setting: inside it, CUDA
tensors too go to the plain version (``chip_smoke.py`` runs the model once
so, to hold the kernel's logits against the plain version's).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

__all__ = ["flash_attention_cuda", "plain_version", "MAX_HEAD_DIM", "MAX_GROUP"]

# The most query heads one KV head may carry (one block holds 64 (query,
# head) rows), and the largest q·k head dimension whose block fits in the
# 232,448 bytes of shared memory a block may use: a block stages 64 query
# rows and 32 key rows of Dh + 1 floats, 32 value rows of 64 floats and
# the 64 x 33 weights (_smem_bytes).  v's head dimension has no limit: a
# block owns 64 of its columns and the grid covers the rest.
MAX_GROUP = 64


def _smem_bytes(dh: int, dvc: int = 64) -> int:
    """Shared memory of a block at q·k head dimension ``dh`` with ``dvc``
    v columns a block (as ``smem_bytes`` in the source)."""
    return 4 * (64 * (dh + 1) + 32 * (dh + 1) + 32 * dvc + 64 * 33) + 4 * (64 + 32) + 32


MAX_HEAD_DIM = max(dh for dh in range(1, 1024) if _smem_bytes(dh) <= build.MAX_SMEM_BYTES)

_route_to_plain = False


@contextlib.contextmanager
def plain_version():
    """Test hook: route CUDA tensors to the plain version while inside."""
    global _route_to_plain
    before, _route_to_plain = _route_to_plain, True
    try:
        yield
    finally:
        _route_to_plain = before


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
                                           i32, i32, i32, i32, i32, i32, i32,
                                           ctypes.c_float, ptr]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, q_pos, kv_pos, kv_valid) -> None:
    dev = q.device
    floats = (torch.float32, torch.bfloat16) + ((torch.float64,) if dev.type == "cpu" else ())
    if q.dtype not in floats:
        raise ValueError(f"q must be one of {floats} on {dev}; got {q.dtype}")
    named = [("q", q, 5), ("k", k, 4), ("v", v, 4), ("q_pos", q_pos, 1),
             ("kv_pos", kv_pos, 1)] + ([("kv_valid", kv_valid, 1)] if kv_valid is not None
                                       else [])
    for name, t, ndim in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.ndim != ndim:
            raise ValueError(f"{name} must be {ndim}-D; got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q {q.dtype}: q, k and v must be alike")
    for name, t in (("q_pos", q_pos), ("kv_pos", kv_pos)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32; got {t.dtype}")
    if kv_valid is not None and kv_valid.dtype != torch.bool:
        raise ValueError(f"kv_valid must be bool; got {kv_valid.dtype}")
    B, Sq, KV, G, Dh = q.shape
    T = k.shape[1]
    if k.shape != (B, T, KV, Dh) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"(B, T, KV, Dh) = ({B}, T, {KV}, {Dh}) and (B, T, KV, Dv)")
    if q_pos.shape != (Sq,) or kv_pos.shape != (T,) or \
            (kv_valid is not None and kv_valid.shape != (T,)):
        raise ValueError(f"q_pos must be ({Sq},), kv_pos and kv_valid ({T},)")
    if min(B, Sq, KV, G, T, Dh, v.shape[3]) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if dev.type == "cuda":
        if Dh > MAX_HEAD_DIM:
            raise ValueError(f"q·k head dimension {Dh} past the kernel's {MAX_HEAD_DIM}: "
                             f"its block would need {_smem_bytes(Dh)} bytes of shared "
                             f"memory, {build.MAX_SMEM_BYTES} are there")
        if G > MAX_GROUP:
            raise ValueError(f"{G} query heads per KV head; the kernel takes {MAX_GROUP}")
        if B > 65535 or KV > 65535:
            raise ValueError(f"batch {B} or KV heads {KV} past the grid's 65535")
    elif dev.type != "cpu":
        raise ValueError(f"no attention for device {dev}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                         causal: bool = True, kv_valid: torch.Tensor | None = None,
                         chunk: int = 512) -> torch.Tensor:
    """``softmax(q·kᵀ/√Dh + mask)·v`` in ``sdpa_chunked``'s layout and masks
    (see :func:`.ref.attention_ref`), out ``(B, Sq, KV, G, Dv)`` in v's dtype.

    CUDA tensors: f32 or bf16, q, k and v alike; int32 positions; bool
    ``kv_valid``; all contiguous; any ``Dv``, and ``Dh`` up to
    :data:`MAX_HEAD_DIM` (64 and 128 with ``Dv = Dh`` have instantiations
    of their own, every other pair the generic path); at most
    :data:`MAX_GROUP` query heads per KV head.  The kernel tiles the keys
    itself, so ``chunk`` (the plain version's query chunk) does not change
    what it computes.  CPU tensors (also float64) run the plain version.
    """
    _check(q, k, v, q_pos, kv_pos, kv_valid)
    if q.device.type == "cpu" or _route_to_plain:
        return ref.attention_ref(q, k, v, q_pos, kv_pos, causal=causal, kv_valid=kv_valid,
                                 chunk=chunk)
    lib = _lib()
    B, Sq, KV, G, Dh = q.shape
    Dv = v.shape[3]
    out = torch.empty((B, Sq, KV, G, Dv), dtype=v.dtype, device=q.device)
    scale = float(torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
            None if kv_valid is None else kv_valid.data_ptr(), out.data_ptr(), B, Sq,
            k.shape[1], KV, G, Dh, Dv, int(q.dtype == torch.bfloat16), int(bool(causal)),
            scale, stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc} ({msg})")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
