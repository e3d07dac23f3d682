"""The wrapper of the CUDA flash-attention kernels.

:func:`flash_attention_cuda` takes the layout of the JAX package's
``models/attention.sdpa_chunked`` (q ``(B, Sq, KV, G, Dh)``, k ``(B, T,
KV, Dh)``, v ``(B, T, KV, Dv)``, ``q_pos (Sq,)``, ``kv_pos (T,)``, optional
``kv_valid (T,)``) and stands in its place on the model's path
(``repro_torch.models.attention.sdpa_chunked`` calls it).  It replaces the
TPU kernel ``flash_call`` (``src/repro/kernels/flash_attention/kernel.py:70``).

For tensors on a CUDA device it launches one of the three kernels of
``csrc/flash_attention.cu`` or raises; which one is a matter of shape
(:func:`kernel_path`): the tensor-core prefill for bf16 with ``Dh = Dv`` in
{64, 128} and ``Sq·G >= 64``, the split-KV decode for f32 or bf16 with
``Dh = Dv`` in {64, 128} and ``Sq·G <= 16`` (its number of splits from
:func:`split_count`), the SIMT kernel for everything else (among decodes:
every other head dimension, and more than 16 rows).  For tensors on the
CPU it runs the plain version (:func:`.ref.attention_ref`).  There is no
other path: a failed build or launch is an error, never a fallback.
``flash_attention_cuda.launches`` counts the kernels' launches and nothing
else, ``launches_tensor``, ``launches_decode`` and ``launches_simt`` each
path's.

:func:`plain_version`, :func:`tile_count` and :func:`forced_splits` are
test hooks, not user settings: inside the first, CUDA tensors too go to
the plain version (``chip_smoke.py`` runs the model once so, to hold the
kernel's logits against the plain version's); inside the second, each
launch adds the key tiles its blocks visited to a counter on the card,
which the tests hold against the skip rule's plain version
(:func:`.ref.tiles_visited`); inside the third, the decode kernel cuts
the keys into the given number of splits instead of :func:`split_count`'s.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

__all__ = ["flash_attention_cuda", "kernel_path", "split_count", "sm_count", "plain_version",
           "tile_count", "forced_splits", "MAX_GROUP", "DECODE_ROWS"]

# The most query heads one KV head may carry: one block holds 64 (query,
# head) rows.  Neither head dimension has a limit: the SIMT kernel stages
# q·k 64 columns at a time and gives each block 64 columns of v.
MAX_GROUP = 64

# The most (query, head) rows Sq·G the decode kernel takes: a decode step of
# up to 16 query heads a KV head (every dense config of the zoo has G <= 8),
# or 2 queries at G = 8.  Its block keeps all of them, at most four a warp
# over four warps, and reads each K/V tile from shared memory once a warp.
DECODE_ROWS = 16

# Blocks an SM the decode kernel's split count aims at (its blocks hold
# about 70 KB of shared memory at Dh = 128 in bf16, so three fit an SM),
# and the fewest key tiles a split takes.
DECODE_BLOCKS_PER_SM = 2
DECODE_MIN_SPLIT_TILES = 2

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


_tiles: torch.Tensor | None = None


@contextlib.contextmanager
def tile_count(device: torch.device | str):
    """Test hook: yields a one-element int64 tensor on ``device`` to which
    every launch inside adds the number of key tiles its blocks visited."""
    global _tiles
    before, _tiles = _tiles, torch.zeros(1, dtype=torch.int64, device=device)
    try:
        yield _tiles
    finally:
        _tiles = before


_splits: int | None = None


@contextlib.contextmanager
def forced_splits(n: int):
    """Test hook: the decode kernel cuts the keys into ``n`` splits while
    inside (the other kernels are unaffected)."""
    global _splits
    if n < 1:
        raise ValueError(f"splits must be at least 1; got {n}")
    before, _splits = _splits, n
    try:
        yield
    finally:
        _splits = before


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
                                           i32, i32, i32, i32, i32, i32, i32,
                                           ctypes.c_float, ptr, ptr]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_tc_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
                                              i32, i32, i32, i32, i32, ctypes.c_float, ptr,
                                              ptr]
    lib.flash_attention_tc_launch.restype = ctypes.c_int
    lib.flash_attention_decode_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
                                                  i32, i32, i32, i32, i32, i32, ctypes.c_float,
                                                  i32, ptr, ptr, ptr, ptr]
    lib.flash_attention_decode_launch.restype = ctypes.c_int
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
        if G > MAX_GROUP:
            raise ValueError(f"{G} query heads per KV head; the kernel takes {MAX_GROUP}")
        if B > 65535 or KV > 65535:
            raise ValueError(f"batch {B} or KV heads {KV} past the grid's 65535")
    elif dev.type != "cpu":
        raise ValueError(f"no attention for device {dev}")


def kernel_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_pos: torch.Tensor | None = None,
                kv_valid: torch.Tensor | None = None) -> str:
    """The kernel that takes these inputs on the card: ``"tensor"`` (the
    tensor-core prefill) for bf16 with ``Dh = Dv`` in {64, 128}, ``Sq·G >=
    64`` and q, k and v on 16-byte boundaries (as any tensor that starts its
    own storage is); ``"decode"`` (split-KV decoding) for ``Dh = Dv`` in
    {64, 128}, ``Sq·G <=`` :data:`DECODE_ROWS` and q, k, v and the keys'
    positions and flags (which it copies by TMA too; ``None`` is no
    constraint) on 16-byte boundaries; else ``"simt"``."""
    _, Sq, _, G, Dh = q.shape
    if not (Dh == v.shape[3] and Dh in (64, 128)
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v))):
        return "simt"
    if q.dtype == torch.bfloat16 and Sq * G >= 64:
        return "tensor"
    if Sq * G > DECODE_ROWS or any(t is not None and t.data_ptr() % 16
                                   for t in (kv_pos, kv_valid)):
        return "simt"
    return "decode"


def split_count(T: int, B: int, KV: int, sms: int) -> int:
    """The decode kernel's number of key splits: enough blocks (``splits ×
    B × KV``) for :data:`DECODE_BLOCKS_PER_SM` on each of ``sms`` SMs, but
    no split with fewer than :data:`DECODE_MIN_SPLIT_TILES` tiles of 32
    keys, and at least one.  At Qwen3-1.7B's decode (T = 2080, B × KV = 32)
    on 132 SMs: 9 splits of 7 or 8 tiles, 288 blocks."""
    tiles = -(-T // ref.TILE_KEYS["decode"])
    want = -(-DECODE_BLOCKS_PER_SM * sms // (B * KV))
    return max(1, min(want, tiles // DECODE_MIN_SPLIT_TILES))


# Per (device, stream): the decode kernel's workspace, each split's (m, l,
# acc) in f32, which a launch writes before it reads; and B·KV zeros for its
# last-block count, which every launch leaves at zero.  One stream's
# launches run in order, so each may reuse them.  They are made eagerly: a
# launch captured into a CUDA graph without them takes its own (the graph
# replays their zero fill) and keeps none.
_work: dict[tuple[int, int], torch.Tensor] = {}
_counters: dict[tuple[int, int], torch.Tensor] = {}


def _scratch(store: dict, device: torch.device, stream: int, n: int,
             dtype: torch.dtype) -> torch.Tensor:
    key = (device.index, stream)
    t = store.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(n, dtype=dtype, device=device)
        if not torch.cuda.is_current_stream_capturing():
            store[key] = t
    return t


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                         causal: bool = True, kv_valid: torch.Tensor | None = None,
                         chunk: int = 512) -> torch.Tensor:
    """``softmax(q·kᵀ/√Dh + mask)·v`` in ``sdpa_chunked``'s layout and masks
    (see :func:`.ref.attention_ref`), out ``(B, Sq, KV, G, Dv)`` in v's dtype.

    CUDA tensors: f32 or bf16, q, k and v alike; int32 positions; bool
    ``kv_valid``; all contiguous; any ``Dh`` and ``Dv``; at most
    :data:`MAX_GROUP` query heads per KV head.  :func:`kernel_path` names
    the kernel.  The kernels tile the keys themselves, so ``chunk`` (the
    plain version's query chunk) does not change what they compute.
    CPU tensors (also float64) run the plain version.
    """
    _check(q, k, v, q_pos, kv_pos, kv_valid)
    if q.device.type == "cpu" or _route_to_plain:
        return ref.attention_ref(q, k, v, q_pos, kv_pos, causal=causal, kv_valid=kv_valid,
                                 chunk=chunk)
    lib = _lib()
    B, Sq, KV, G, Dh = q.shape
    T, Dv = k.shape[1], v.shape[3]
    path = kernel_path(q, k, v, kv_pos, kv_valid)
    out = torch.empty((B, Sq, KV, G, Dv), dtype=v.dtype, device=q.device)
    scale = 1.0 / math.sqrt(Dh)           # rounded to f32 by ctypes.c_float
    counter = None if _tiles is None else _tiles.data_ptr()
    valid = None if kv_valid is None else kv_valid.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
                valid, out.data_ptr(), B, Sq, T, KV, G)
        if path == "tensor":
            rc = lib.flash_attention_tc_launch(*args, Dh, int(bool(causal)), scale, counter,
                                               stream)
        elif path == "decode":
            n = _splits or split_count(T, B, KV, sm_count(q.device))
            work = counters = None
            if n > 1:
                work = _scratch(_work, q.device, stream, B * KV * n * Sq * G * (Dv + 2),
                                torch.float32)
                counters = _scratch(_counters, q.device, stream, B * KV, torch.int32)
            rc = lib.flash_attention_decode_launch(
                *args, Dh, int(q.dtype == torch.bfloat16), int(bool(causal)), scale, n,
                None if work is None else work.data_ptr(),
                None if counters is None else counters.data_ptr(), counter, stream)
        else:
            rc = lib.flash_attention_launch(*args, Dh, Dv, int(q.dtype == torch.bfloat16),
                                            int(bool(causal)), scale, counter, stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention {path} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
    flash_attention_cuda.launches += 1
    if path == "tensor":
        flash_attention_cuda.launches_tensor += 1
    elif path == "decode":
        flash_attention_cuda.launches_decode += 1
    else:
        flash_attention_cuda.launches_simt += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_tensor = 0
flash_attention_cuda.launches_decode = 0
flash_attention_cuda.launches_simt = 0
