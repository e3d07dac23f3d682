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

All four launch the one hand-written kernel (``csrc/peel_decode.cu``),
which keeps a count of erased neighbours per check row, reaches a
coordinate's rows through the table's column table (:func:`.ref.column_table`,
built from ``check_idx`` on its device and kept beside that tensor while
it is unchanged) and acts only on the rows with one erased neighbour.
For tensors on a CUDA device a wrapper launches it or raises; for tensors
on the CPU it runs the plain PyTorch version over the same table
(:mod:`.ref`, ``decode_table*_ref``).  There is no other path: a failed
build or launch is an error, never a fallback.  A block's state (two bits
a coordinate, a count a row and the XOR of each row's erased columns)
lives in shared memory while it fits (a (3, 6) code up to N ~ 77,000) and
in device memory past that, so the decode has no limit on N but device
memory; while they fit too, its payload columns and then the code's
tables join it there (:func:`table_layout`).

The SEEDED codes have wrappers of their own, which take the code's
seeded structure (``repro_torch.core.ldpc.SeededStructure``) in place of a
table:

======================================== ====================================
wrapper                                  contract (TPU kernel it replaces)
======================================== ====================================
:func:`peel_decode_seeded_cuda`          as :func:`peel_decode_cuda`
                                         (``decode_seeded``)
:func:`peel_decode_batch_seeded_cuda`    as :func:`peel_decode_batch_cuda`
                                         (``decode_seeded_batch``)
:func:`peel_decode_adaptive_seeded_cuda` as :func:`peel_decode_adaptive_cuda`
                                         (``decode_seeded_adaptive``)
:func:`peel_decode_batch_adaptive_seeded_cuda`
                                         as :func:`peel_decode_batch_adaptive_cuda`
                                         (``decode_seeded_batch_adaptive``)
:func:`encode_seeded_fused_cuda`         seeded-LDGM codeword rows from
                                         ``row0`` (``encode_seeded_fused``)
======================================== ====================================

The four decodes launch ``csrc/seeded_decode.cu``, which keeps a count of
erased neighbours per check row, reaches a coordinate's rows through the
layers' inverse permutations, regenerates a row from the seed only when
it acts, and follows exactly the trajectory, and computes exactly the
values, of ``csrc/peel_decode.cu`` over the same code's table.  A pattern
is spread over a thread-block cluster of up to 8 blocks where that fits
(``SEEDED_CLUSTERS``), else one block whose state (two bits a coordinate and a count
a row) lives in shared memory while it fits
(the (4, 8) code up to N ~ 370,000) and in device memory past that, so it
has no limit on N (:func:`seeded_layout`).  The encode launches
``csrc/seeded_encode.cu``.

The schedule REPLAY has one wrapper, :func:`peel_decode_replay_cuda`
(``decode_replay``, and the JAX package's replay executors): B slots, each
replaying its own packed :class:`ReplayPack` schedule under its own round
budget, in one launch of ``csrc/replay_decode.cu``; on CPU tensors
:func:`.ref.replay_ref`.

The one-round entry point :func:`peel_round_cuda` (the JAX package's
``peel_round_pallas``) runs the check pass of ``csrc/check_pass.cu``
through :func:`check_pass_cuda` (``check_pass``), then scatters in torch.

Each wrapper's ``.launches`` counts its own kernel launches (and nothing
else), so a run can show that it went through the kernel.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build
from repro_torch.kernels.ldpc_peel import ref

__all__ = ["CodeTables", "peel_decode_cuda", "peel_decode_batch_cuda",
           "peel_decode_adaptive_cuda", "peel_decode_batch_adaptive_cuda",
           "peel_decode_seeded_cuda", "peel_decode_batch_seeded_cuda",
           "peel_decode_adaptive_seeded_cuda",
           "peel_decode_batch_adaptive_seeded_cuda", "encode_seeded_fused_cuda",
           "forced_cluster", "seeded_layout", "seeded_cluster_fits", "TableLayout",
           "table_layout",
           "ReplayPack", "check_replay_host", "peel_decode_replay_cuda", "MAX_SMEM_BYTES",
           "check_pass_cuda", "peel_round_cuda"]

MAX_SMEM_BYTES = build.MAX_SMEM_BYTES
# Payload columns one decode block owns (kCols in the decode kernels).
_COLS_PER_BLOCK = 4


class CodeTables(NamedTuple):
    """A code's neighbour table on one device: ``check_idx (p, r)`` int32
    columns (padding slots hold the sentinel ``N``) and ``check_coeff
    (p, r)`` float32 edge weights."""

    check_idx: torch.Tensor
    check_coeff: torch.Tensor
    N: int


# What a table-decode block keeps in shared memory whatever the shape: its
# warps' lists of acting rows (16 warps of 160 ints), three counters
# (padded to 16 bytes) and its list of a round's resolved coordinates (2048
# ints) (kOwnBytes in csrc/peel_decode.cu).
_OWN_BYTES = 16 * 160 * 4 + 16 + 2048 * 4
# Flags of where a table-decode block's operands live (``place``):
# each puts one more of them in shared memory, in this order.
_STATE_ON_CHIP, _VALUES_ON_CHIP, _TABLES_ON_CHIP = 1, 2, 4


def _pad16(n: int) -> int:
    return (n + 15) & ~15


def _state_bytes(N: int, p: int, r: int) -> int:
    """A table-decode block's state, as ``peel_decode_state_bytes()``: the
    erased and the resolved bitmaps of ``N`` bits (each padded to 16 bytes),
    a count per check row, one byte while ``r <= 255``, else two (padded to
    16 bytes), and the XOR of each row's erased columns (an int a row)."""
    words = ((N + 31) // 32 + 3) & ~3
    return 8 * words + _pad16(p * (1 if r <= 255 else 2)) + _pad16(4 * p)


def _smem_bytes(N: int, p: int, r: int, V: int = 1, place: int = _STATE_ON_CHIP) -> int:
    """Shared memory a table-decode block takes, as
    ``peel_decode_smem_bytes()``: its lists and counters, and what ``place``
    puts on chip (by default the state alone): the state; the block's
    payload columns (1, 2 or 4 floats a coordinate for V = 1, 2 or more);
    the table, the column table's rows (reserved at ``p·r``) and its ``N +
    1`` offsets."""
    size = _OWN_BYTES
    if place & _STATE_ON_CHIP:
        size += _state_bytes(N, p, r)
    if place & _VALUES_ON_CHIP:
        size += _pad16(N * (V if V <= 2 else _COLS_PER_BLOCK) * 4)
    if place & _TABLES_ON_CHIP:
        size += 3 * _pad16(4 * p * r) + _pad16(4 * (N + 1))
    return size


def _load(name: str) -> ctypes.CDLL:
    """The library ``name`` (built first if needed), its error-string
    function declared."""
    lib = build.library(name)
    getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, lib: ctypes.CDLL, name: str) -> None:
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _load("peel_decode")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.peel_decode_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr,
                                       ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                       i32, i32, ptr]
    lib.peel_decode_launch.restype = ctypes.c_int
    lib.peel_decode_state_bytes.argtypes = [i32, i32, i32]
    lib.peel_decode_smem_bytes.argtypes = [i32, i32, i32, i32, i32]
    lib.peel_decode_state_bytes.restype = lib.peel_decode_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check_operands(dev: torch.device, operands) -> None:
    for name, t, dtype, ndim in operands:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, values on {dev}")
        if t.dtype != dtype or t.ndim != ndim:
            raise ValueError(f"{name} must be a {ndim}-D {dtype} tensor; got "
                             f"{t.ndim}-D {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_decode(N: int, values: torch.Tensor, erased: torch.Tensor,
                  iters: int, *, batched: bool, budgets: torch.Tensor | None,
                  extra=()) -> None:
    """What every decode wrapper checks: the payload, mask and budgets of
    a code of length ``N`` (and the ``extra`` operands) on one device."""
    vdim = 3 if batched else 2
    operands = [*extra, ("values", values, torch.float32, vdim),
                ("erased", erased, torch.bool, vdim - 1)]
    if budgets is not None:
        operands.append(("budgets", budgets, torch.int32, 1))
    _check_operands(values.device, operands)
    lead = tuple(values.shape[:-2])
    if values.shape[-2] != N or erased.shape != (*lead, N):
        raise ValueError(f"values {tuple(values.shape)} / erased "
                         f"{tuple(erased.shape)} do not match N={N}")
    if budgets is not None and tuple(budgets.shape) != lead:
        raise ValueError(f"budgets must be {lead}; got {tuple(budgets.shape)}")
    if N < 1 or values.shape[-1] < 1 or (batched and values.shape[0] < 1):
        raise ValueError("empty code, batch or payload")
    if iters < 0:
        raise ValueError(f"iters must be >= 0; got {iters}")


def _check(tables: CodeTables, values: torch.Tensor, erased: torch.Tensor,
           iters: int, *, batched: bool,
           budgets: torch.Tensor | None = None) -> None:
    idx, coeff, N = tables
    _check_decode(N, values, erased, iters, batched=batched, budgets=budgets,
                  extra=[("check_idx", idx, torch.int32, 2),
                         ("check_coeff", coeff, torch.float32, 2)])
    if idx.shape != coeff.shape:
        raise ValueError(f"check_idx {tuple(idx.shape)} and check_coeff "
                         f"{tuple(coeff.shape)} differ in shape")
    if idx.shape[0] < 1 or idx.shape[1] < 1:
        raise ValueError("empty code, batch or payload")


def _column_table(idx: torch.Tensor, N: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The column table of ``check_idx`` on its device (:func:`.ref.column_table`),
    built once and kept on that tensor under its version, storage and ``N``:
    an in-place change of the table, or a table of another code (a
    ``CodeTables._replace``), builds it anew, so it is never stale."""
    key = (idx._version, idx.data_ptr(), N)
    hit = getattr(idx, "_peel_column_table", None)
    if hit is None or hit[0] != key:
        hit = (key, ref.column_table(idx, N))
        idx._peel_column_table = hit
    return hit[1]


class TableLayout(NamedTuple):
    """Where a table-decode launch puts what (:func:`table_layout`)."""

    grid: tuple[int, int]          # (ceil(V / 4), B) blocks of 512 threads
    state: bool                    # the state in shared memory (else device memory)
    values: bool                   # the block's payload columns in shared memory
    tables: bool                   # the table and its column table in shared memory

    @property
    def place(self) -> int:
        return (self.state * _STATE_ON_CHIP | self.values * _VALUES_ON_CHIP
                | self.tables * _TABLES_ON_CHIP)


def _smem_sizer(on_card: bool):
    """The function that sizes a table-decode block's shared memory,
    ``(N, p, r, V, place) -> bytes``: on the card the library's own
    ``peel_decode_smem_bytes``, so the dispatch follows the kernel's
    layout; elsewhere its mirror :func:`_smem_bytes`, which the CPU tests
    read and a card test holds equal to the library."""
    return _lib().peel_decode_smem_bytes if on_card else _smem_bytes


@functools.lru_cache(maxsize=256)
def _place(N: int, p: int, r: int, V: int, max_smem: int, on_card: bool) -> int:
    """The placement flags of :func:`table_layout` for these shapes under a
    shared-memory cap of ``max_smem`` bytes, sized by :func:`_smem_sizer`."""
    smem_bytes = _smem_sizer(on_card)
    place = 0
    for flag in (_STATE_ON_CHIP, _VALUES_ON_CHIP, _TABLES_ON_CHIP):
        if smem_bytes(N, p, r, V, place | flag) > max_smem:
            break
        place |= flag
    return place


def table_layout(tables: CodeTables, B: int, V: int) -> TableLayout:
    """The dispatch by shape of the table decode.  The grid is ``(ceil(V /
    4), B)`` blocks of 512 threads, a block owning 4 payload columns of one
    pattern and computing the pattern's trajectory itself.  Then, in turn,
    while the block's shared memory (:func:`_smem_sizer`) stays within
    ``MAX_SMEM_BYTES``: its state (the erased and resolved bitmaps, a count
    and an XOR per check row), its payload columns (the rounds read and write
    them there; they go out at the end) and the code's table and column
    table go to shared memory.  A state that does not fit lives in a
    device-memory scratch of one state per block, initialised by the kernel
    at every launch; values and tables that do not fit are read from device
    memory."""
    p, r = tables.check_idx.shape
    place = _place(tables.N, p, r, V, MAX_SMEM_BYTES, tables.check_idx.device.type == "cuda")
    return TableLayout((-(-V // _COLS_PER_BLOCK), B), bool(place & _STATE_ON_CHIP),
                       bool(place & _VALUES_ON_CHIP), bool(place & _TABLES_ON_CHIP))


def _on(dev: torch.device):
    """A guard that makes ``dev`` the current device, where it is not."""
    return (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
            else torch.cuda.device(dev))


def _launch(tables: CodeTables, values: torch.Tensor, erased: torch.Tensor,
            iters: int, *, adaptive: bool,
            budgets: torch.Tensor | None = None):
    """Launch the kernel on ``values (B, N, V)`` / ``erased (B, N)``, or on
    one pattern's ``values (N, V)`` / ``erased (N,)``; returns ``(values,
    erased, rounds)`` of the same shapes (``rounds`` int32, ``(B,)`` or 0-d,
    for the adaptive contract, else None).  Where a block's state, values
    and tables live is :func:`table_layout`'s dispatch by shape."""
    if values.device.type != "cuda":
        raise ValueError(f"no decode for device {values.device}")
    idx, coeff, N = tables
    p, r = idx.shape
    if r > 65535:
        raise ValueError(f"the table kernel counts a row's erased neighbours in 16 bits: "
                         f"table width {r} > 65535")
    lib = _lib()
    V = values.shape[-1]
    B = values.shape[0] if values.ndim == 3 else 1
    dev = values.device
    col_ptr, col_rows = _column_table(idx, N)
    out_v = torch.empty_like(values)
    out_e = torch.empty_like(erased)
    rounds = torch.empty(values.shape[:-2], dtype=torch.int32, device=dev) if adaptive else None
    place = _place(N, p, r, V, MAX_SMEM_BYTES, True)
    state = None if place & _STATE_ON_CHIP else torch.empty(
        -(-V // _COLS_PER_BLOCK) * B * lib.peel_decode_state_bytes(N, p, r), dtype=torch.uint8,
        device=dev)
    with _on(dev):
        rc = lib.peel_decode_launch(
            idx.data_ptr(), coeff.data_ptr(), col_ptr.data_ptr(), col_rows.data_ptr(), p, r,
            col_rows.numel(), values.data_ptr(), erased.data_ptr(),
            None if budgets is None else budgets.data_ptr(),
            out_v.data_ptr(), out_e.data_ptr(),
            None if rounds is None else rounds.data_ptr(),
            None if state is None else state.data_ptr(), B, N, V, iters,
            int(adaptive), place, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, "peel_decode")
    return out_v, out_e, rounds


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
        return ref.decode_table_ref(*tables[:2], values, erased, iters)
    v, e, _ = _launch(tables, values, erased, iters, adaptive=False)
    peel_decode_cuda.launches += 1
    return v, e


def peel_decode_batch_cuda(tables: CodeTables, values: torch.Tensor,
                           erased: torch.Tensor, iters: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exactly ``iters`` flooding rounds of each of B independent patterns,
    one launch: ``values (B, N, V)`` float32, ``erased (B, N)`` bool.  Slot
    ``b`` decodes exactly as :func:`peel_decode_cuda` decodes it alone."""
    iters = int(iters)
    _check(tables, values, erased, iters, batched=True)
    if values.device.type == "cpu":
        return ref.decode_table_batch_ref(*tables[:2], values, erased, iters)
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
        return ref.decode_table_adaptive_ref(*tables[:2], values, erased,
                                             max_iters)
    v, e, d = _launch(tables, values, erased, max_iters, adaptive=True)
    peel_decode_adaptive_cuda.launches += 1
    return v, e, d


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
        return ref.decode_table_batch_adaptive_ref(*tables[:2], values,
                                                   erased, budgets)
    v, e, d = _launch(tables, values, erased, 0, adaptive=True,
                      budgets=budgets)
    peel_decode_batch_adaptive_cuda.launches += 1
    return v, e, d


# ------------------------------------------------------------------ seeded


@functools.lru_cache(maxsize=64)
def _layer_consts(st, dev: torch.device) -> torch.Tensor:
    """The structure's per-layer constants on ``dev``, uploaded once per
    structure, int32: the ``layers`` strides a_t, the offsets b_t, the
    inverse strides a_t⁻¹ mod cols (the layers' inverse permutations) and
    the strides mod cols (a row's step from one slot's column to the
    next)."""
    inv = [pow(a, -1, st.cols) for a in st.strides]
    return torch.tensor([*st.strides, *st.offsets, *inv, *(a % st.cols for a in st.strides)],
                        dtype=torch.int32, device=dev)


def _spec_args(st, dev: torch.device) -> tuple:
    """The seeded structure as the kernels' launch arguments."""
    return (st.rows, st.cols, st.row_weight, st.layers, st.wseed,
            _layer_consts(st, dev).data_ptr())


def _check_spec(st) -> None:
    """Any row weight up to 65535 and any number of whole layers: the
    kernels sort a row in registers up to row weight 64 and by selection
    past it, and read the layer constants from device memory.  A row's
    first column ``a_t·x + b_t`` (x < cols) is reduced in 32 bits, as
    ``seeded_structure`` bounds it."""
    if not 1 <= st.row_weight <= 65535:
        raise ValueError(f"row weight must be in [1, 65535]; got {st.row_weight}")
    if max(st.strides) * (st.cols - 1) + max(st.offsets) >= 2 ** 32:
        raise ValueError("layer strides too large for 32-bit columns")
    if st.layers < 1 or st.rows % st.layers != 0 or \
            len(st.strides) != st.layers or len(st.offsets) != st.layers:
        raise ValueError(f"{st.layers} layers do not split {st.rows} rows with "
                         f"{len(st.strides)} strides and {len(st.offsets)} offsets")


@functools.cache
def _decode_lib() -> ctypes.CDLL:
    lib = _load("seeded_decode")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.seeded_decode_launch.argtypes = [i32, i32, i32, i32, ctypes.c_uint, ptr,
                                         ptr, ptr, ptr, ptr, ptr, ptr,
                                         ptr, i32, i32, i32, i32, i32, i32, ptr]
    lib.seeded_decode_launch.restype = ctypes.c_int
    lib.seeded_decode_smem_bytes.argtypes = [i32, i32, i32, i32, i32]
    lib.seeded_decode_smem_bytes.restype = ctypes.c_size_t
    lib.seeded_decode_state_bytes.argtypes = [i32, i32, i32]
    lib.seeded_decode_state_bytes.restype = ctypes.c_size_t
    return lib


@functools.cache
def _encode_lib() -> ctypes.CDLL:
    lib = _load("seeded_encode")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.seeded_encode_launch.argtypes = [i32, i32, i32, i32, ctypes.c_uint, ptr,
                                         ptr, ptr, ctypes.c_longlong, i32, i32,
                                         ptr]
    lib.seeded_encode_launch.restype = ctypes.c_int
    return lib


# The cluster sizes the seeded decode takes, largest first (seeded_layout):
# on the card the fastest layout of 1, 2, 4 and 8 blocks a pattern was the
# largest cluster whose patterns are all resident at once (8 at B = 1 and
# 8, 2 at B = 64; PERF.md).
SEEDED_CLUSTERS = (8, 4, 2)
_forced_cluster: list[int | None] = [None]


@contextlib.contextmanager
def forced_cluster(C: int):
    """Within the block, every seeded decode launch spreads a pattern over
    ``C`` blocks (1: one block, its state placed as :func:`seeded_layout`
    would place it), whatever the shape: the hook by which tests and
    ``chip_smoke.py`` hold each layout against the plain versions and time
    them."""
    _forced_cluster[0] = int(C)
    try:
        yield
    finally:
        _forced_cluster[0] = None


def seeded_cluster_fits(st, C: int) -> bool:
    """Whether a cluster of ``C`` blocks can hold a pattern of ``st``: any
    ``C`` of 2 to 8 while the row weight is at most 255 and a block's share
    (the erased bitmap, two resolved bitmaps, its rows' counts and its
    warps' lists) fits its shared memory; one block always can."""
    return C == 1 or (2 <= C <= 8 and st.row_weight <= 255 and _decode_lib(
    ).seeded_decode_smem_bytes(st.cols, st.rows, st.row_weight, C, 1) <= MAX_SMEM_BYTES)


def seeded_layout(st, B: int, V: int, device: torch.device) -> tuple[int, bool]:
    """The dispatch by shape of the seeded decode on ``device``: ``(C,
    in_shared)``, the blocks it spreads a pattern over and whether their
    state lives in shared memory.  The largest cluster of
    ``SEEDED_CLUSTERS`` (each block holding the erased bitmap and the
    counts of its share of the rows in shared memory) that
    :func:`seeded_cluster_fits` and whose patterns can all be resident at
    once (``B·ceil(V / 4)·C`` blocks, at most the device's SM count);
    else one block a pattern, its state (two bits a coordinate and a count
    a row) in shared memory while it fits and in device memory past that.
    A cluster the card refuses to launch raises: there is no fallback."""
    C = _forced_cluster[0]
    if C is None:
        C = next((c for c in SEEDED_CLUSTERS if seeded_cluster_fits(st, c)
                  and B * -(-V // _COLS_PER_BLOCK) * c <= sm_count(device)), 1)
    return C, C > 1 or _decode_lib().seeded_decode_smem_bytes(
        st.cols, st.rows, st.row_weight, 1, 1) <= MAX_SMEM_BYTES


def _check_seeded(st, values, erased, iters, *, batched, budgets=None) -> None:
    _check_spec(st)
    _check_decode(st.cols, values, erased, iters, batched=batched,
                  budgets=budgets)


def _launch_seeded(st, values: torch.Tensor, erased: torch.Tensor, iters: int,
                   *, adaptive: bool, budgets: torch.Tensor | None = None):
    """Launch the seeded decode on ``values (B, N, V)`` / ``erased (B, N)``;
    returns ``(values, erased, rounds)`` as :func:`_launch` does.  The
    blocks a pattern is spread over, and where a block's state lives, are
    :func:`seeded_layout`'s dispatch by shape."""
    if values.device.type != "cuda":
        raise ValueError(f"no decode for device {values.device}")
    lib = _decode_lib()
    B, N, V = values.shape
    dev = values.device
    out_v = torch.empty_like(values)
    out_e = torch.empty_like(erased)
    rounds = torch.empty(B, dtype=torch.int32, device=dev) if adaptive else None
    C, in_shared = seeded_layout(st, B, V, dev)
    state = None if in_shared else torch.empty(
        -(-V // _COLS_PER_BLOCK) * B * lib.seeded_decode_state_bytes(N, st.rows, st.row_weight),
        dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.seeded_decode_launch(
            *_spec_args(st, dev), values.data_ptr(), erased.data_ptr(),
            None if budgets is None else budgets.data_ptr(), out_v.data_ptr(),
            out_e.data_ptr(), None if rounds is None else rounds.data_ptr(),
            None if state is None else state.data_ptr(), B, N, V, iters, int(adaptive), C,
            stream)
    _raise_on(rc, lib, "seeded_decode")
    return out_v, out_e, rounds


def peel_decode_seeded_cuda(st, values: torch.Tensor, erased: torch.Tensor,
                            iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`peel_decode_cuda` for the seeded code whose ``(rows, cols)``
    block ``st`` is H: exactly ``iters`` rounds of one pattern, ``values
    (st.cols, V)`` float32, ``erased (st.cols,)`` bool."""
    iters = int(iters)
    _check_seeded(st, values, erased, iters, batched=False)
    if values.device.type == "cpu":
        return ref.decode_seeded_ref(st, values, erased, iters)
    v, e, _ = _launch_seeded(st, values[None], erased[None], iters,
                             adaptive=False)
    peel_decode_seeded_cuda.launches += 1
    return v[0], e[0]


def peel_decode_batch_seeded_cuda(st, values: torch.Tensor,
                                  erased: torch.Tensor, iters: int
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`peel_decode_batch_cuda` for a seeded code: ``values (B, N,
    V)``, ``erased (B, N)``, one launch."""
    iters = int(iters)
    _check_seeded(st, values, erased, iters, batched=True)
    if values.device.type == "cpu":
        return ref.decode_seeded_batch_ref(st, values, erased, iters)
    v, e, _ = _launch_seeded(st, values, erased, iters, adaptive=False)
    peel_decode_batch_seeded_cuda.launches += 1
    return v, e


def peel_decode_adaptive_seeded_cuda(st, values: torch.Tensor,
                                     erased: torch.Tensor, max_iters: int
                                     ) -> tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """:func:`peel_decode_adaptive_cuda` for a seeded code: early exit
    within ``max_iters`` rounds; ``rounds`` a 0-d int32 device tensor."""
    max_iters = int(max_iters)
    _check_seeded(st, values, erased, max_iters, batched=False)
    if values.device.type == "cpu":
        return ref.decode_seeded_adaptive_ref(st, values, erased, max_iters)
    v, e, d = _launch_seeded(st, values[None], erased[None], max_iters,
                             adaptive=True)
    peel_decode_adaptive_seeded_cuda.launches += 1
    return v[0], e[0], d[0]


def peel_decode_batch_adaptive_seeded_cuda(st, values: torch.Tensor,
                                           erased: torch.Tensor,
                                           budgets: torch.Tensor
                                           ) -> tuple[torch.Tensor, torch.Tensor,
                                                      torch.Tensor]:
    """:func:`peel_decode_batch_adaptive_cuda` for a seeded code: per-slot
    early exit under ``budgets (B,)`` int32 on the values' device."""
    _check_seeded(st, values, erased, 0, batched=True, budgets=budgets)
    if values.device.type == "cpu":
        return ref.decode_seeded_batch_adaptive_ref(st, values, erased, budgets)
    v, e, d = _launch_seeded(st, values, erased, 0, adaptive=True,
                             budgets=budgets)
    peel_decode_batch_adaptive_seeded_cuda.launches += 1
    return v, e, d


def encode_seeded_fused_cuda(st, y: torch.Tensor, row0: int = 0,
                             n_out: int | None = None) -> torch.Tensor:
    """Codeword rows ``[row0, row0 + n_out)`` of a seeded LDGM code,
    generator rows regenerated from the seed in the kernel: no generator
    and no gather table.

    ``st`` is the structure of the generator's ``(p, K)`` parity block
    (``st.cols == K``); ``y (K, V)`` float32 contiguous; ``n_out`` defaults
    to the whole codeword ``K + p``.  Rows at or past ``K + p`` come out
    zero (for finite ``y``).  Returns ``(n_out, V)`` float32, bit-identical
    to :func:`ref.gather_encode` over the same rows' tables.
    """
    _check_spec(st)
    row0 = int(row0)
    n_out = st.cols + st.rows if n_out is None else int(n_out)
    _check_operands(y.device, [("y", y, torch.float32, 2)])
    if y.shape[0] != st.cols or y.shape[1] < 1:
        raise ValueError(f"y must be ({st.cols}, V) with V >= 1; got "
                         f"{tuple(y.shape)}")
    if row0 < 0 or n_out < 1:
        raise ValueError(f"need row0 >= 0 and n_out >= 1; got row0={row0}, "
                         f"n_out={n_out}")
    if y.device.type == "cpu":
        return ref.encode_seeded_ref(st, y, row0, n_out)
    if y.device.type != "cuda":
        raise ValueError(f"no encode for device {y.device}")
    lib = _encode_lib()
    out = torch.empty((n_out, y.shape[1]), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = lib.seeded_encode_launch(*_spec_args(st, y.device), y.data_ptr(),
                                      out.data_ptr(),
                                      row0, n_out, y.shape[1], stream)
    _raise_on(rc, lib, "seeded_encode")
    encode_seeded_fused_cuda.launches += 1
    return out


# ------------------------------------------------------------------ replay


class ReplayPack(NamedTuple):
    """B packed peeling schedules, one per slot, on one device.

    ``meta (B, 3)`` int32 holds each slot's ``(entries, rounds R, probe)``
    (``probe``: the adaptive decode's round count under an unbounded
    budget).  Slot ``b``'s entries follow those of the slots before it in
    ``nidx (E, r_max)`` int32 (each resolving check's neighbour columns,
    sentinel ``N``), ``w (E, r_max)`` float32 (its pre-masked weights),
    ``coeff (E,)`` float32 (its target's coefficient) and ``tgt (E,)``
    int32 (its target column); its ``R + 1`` local round offsets follow
    those of the slots before it in ``roff``.  Built by
    ``repro_torch.core.decoder`` from ``PeelSchedule``s."""

    nidx: torch.Tensor
    w: torch.Tensor
    coeff: torch.Tensor
    tgt: torch.Tensor
    roff: torch.Tensor
    meta: torch.Tensor


def check_replay_host(nidx: np.ndarray, w: np.ndarray, coeff: np.ndarray,
                      tgt: np.ndarray, roff: np.ndarray, meta: np.ndarray, *,
                      N: int) -> None:
    """Raise unless one slot's pack, on the host before its upload, is one
    the replay kernel can walk: ``0 <= nidx <= N`` (``N`` the sentinel),
    ``0 <= tgt < N``, ``roff`` ascending from 0 to the entry count with
    one offset per round and one more, ``meta = [[E, R, probe]]`` with
    ``probe <= R + 1``.  The launch itself checks only shapes and types, so
    a pack that did not pass here may read out of bounds on the card."""
    E = nidx.shape[0] if nidx.ndim == 2 else -1
    if (E < 0 or w.shape != nidx.shape or coeff.shape != (E,) or tgt.shape != (E,)
            or meta.shape != (1, 3) or roff.ndim != 1):
        raise ValueError("replay pack shapes disagree")
    n, R, probe = (int(x) for x in meta[0])
    if n != E or roff.shape != (R + 1,) or not 0 <= probe <= R + 1:
        raise ValueError(f"replay pack meta {meta[0].tolist()} disagrees with "
                         f"{E} entries and {roff.shape[0]} round offsets")
    if roff[0] != 0 or roff[-1] != E or (np.diff(roff) < 0).any():
        raise ValueError("replay round offsets must ascend from 0 to the entry count")
    if E and (nidx.min() < 0 or nidx.max() > N or tgt.min() < 0 or tgt.max() >= N):
        raise ValueError(f"replay pack columns must lie in [0, {N}] and targets "
                         f"in [0, {N})")


@functools.cache
def _replay_lib() -> ctypes.CDLL:
    lib = _load("replay_decode")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.replay_decode_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, ptr,
                                         ptr, ptr, i32, ptr, ptr, ptr, ptr, i32,
                                         i32, i32, ptr]
    lib.replay_decode_launch.restype = ctypes.c_int
    return lib


def _check_replay(pack: ReplayPack, values: torch.Tensor, erased: torch.Tensor,
                  budgets) -> None:
    nidx, w = pack.nidx, pack.w
    _check_decode(values.shape[1] if values.ndim == 3 else 0, values, erased,
                  budgets if isinstance(budgets, int) else 0, batched=True,
                  budgets=None if isinstance(budgets, int) else budgets,
                  extra=[("nidx", nidx, torch.int32, 2), ("w", w, torch.float32, 2),
                         ("coeff", pack.coeff, torch.float32, 1),
                         ("tgt", pack.tgt, torch.int32, 1),
                         ("roff", pack.roff, torch.int32, 1),
                         ("meta", pack.meta, torch.int32, 2)])
    E = nidx.shape[0]
    if w.shape != nidx.shape or nidx.shape[1] < 1 or pack.coeff.shape != (E,) \
            or pack.tgt.shape != (E,):
        raise ValueError(f"replay pack shapes disagree: nidx {tuple(nidx.shape)}, "
                         f"w {tuple(w.shape)}, coeff {tuple(pack.coeff.shape)}, "
                         f"tgt {tuple(pack.tgt.shape)}")
    if tuple(pack.meta.shape) != (values.shape[0], 3):
        raise ValueError(f"meta must be ({values.shape[0]}, 3); got "
                         f"{tuple(pack.meta.shape)}")
    if pack.roff.shape[0] < values.shape[0]:
        raise ValueError("roff holds fewer than one offset per slot")


def peel_decode_replay_cuda(pack: ReplayPack, values: torch.Tensor,
                            erased: torch.Tensor, budgets
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Replay B packed peeling schedules, one launch: slot ``b`` applies the
    first ``min(budget_b, R_b)`` rounds of its schedule to ``values[b]``.

    ``pack`` as :func:`repro_torch.core.decoder.replay_operands` builds it
    (each slot's arrays checked by :func:`check_replay_host` before their
    upload; here only shapes and types are checked, so the launch syncs
    nothing).  ``values (B, N, V)`` float32 and ``erased (B, N)`` bool,
    contiguous, on the pack's device; ``budgets`` an int for every slot, or ``(B,)`` int32
    on that device (read there: varying it syncs nothing).  Each entry
    gathers its neighbours, sums the products with the Neumaier chain of
    the JAX package's ``_edge_sum`` and divides the negated sum by its
    coefficient; the round's results then move to their targets.  The
    duplicate-check tie-break is whatever rule the pack was built under.
    Returns new ``(values, erased, rounds (B,) int32)``, ``rounds[b] =
    max(0, min(budget_b, probe_b))``; the inputs are not modified.
    Bit-identical to :func:`.ref.replay_ref`, which runs for CPU tensors.
    """
    if not isinstance(budgets, torch.Tensor):
        budgets = int(budgets)
    _check_replay(pack, values, erased, budgets)
    if values.device.type == "cpu":
        return ref.replay_ref(*pack, values, erased, budgets)
    if values.device.type != "cuda":
        raise ValueError(f"no replay for device {values.device}")
    lib = _replay_lib()
    B, N, V = values.shape
    dev = values.device
    out_v = torch.empty_like(values)
    out_e = torch.empty_like(erased)
    rounds = torch.empty(B, dtype=torch.int32, device=dev)
    scratch = torch.empty((max(pack.nidx.shape[0], 1), V), dtype=torch.float32,
                          device=dev)
    tensor_budgets = isinstance(budgets, torch.Tensor)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.replay_decode_launch(
            pack.nidx.data_ptr(), pack.w.data_ptr(), pack.coeff.data_ptr(),
            pack.tgt.data_ptr(), pack.roff.data_ptr(), pack.meta.data_ptr(),
            pack.nidx.shape[1], values.data_ptr(), erased.data_ptr(),
            budgets.data_ptr() if tensor_budgets else None,
            0 if tensor_budgets else budgets, out_v.data_ptr(), out_e.data_ptr(),
            rounds.data_ptr(), scratch.data_ptr(), B, N, V, stream)
    _raise_on(rc, lib, "replay_decode")
    peel_decode_replay_cuda.launches += 1
    return out_v, out_e, rounds


# -------------------------------------------------------------- check pass


@functools.cache
def _check_lib() -> ctypes.CDLL:
    lib = _load("check_pass")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.check_pass_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.check_pass_launch.restype = ctypes.c_int
    return lib


def check_pass_cuda(H: torch.Tensor, values: torch.Tensor, erased: torch.Tensor):
    """One round's check-node pass over a dense ``H (p, N)`` float32:
    ``values (N, V)`` float32, ``erased (N,)`` bool, all contiguous on one
    device.  Returns ``(sums (p, V), cnt (p, 1), pos (p, 1) int32, coeff
    (p, 1))`` as the JAX ``check_pass`` does (see
    :func:`.ref.check_pass_ref`, which CPU tensors run): ``cnt`` float32,
    ``pos`` the highest erased neighbour (-1 if none).  Any p, N and V."""
    dev = H.device
    _check_operands(dev, [("H", H, torch.float32, 2), ("values", values, torch.float32, 2),
                          ("erased", erased, torch.bool, 1)])
    p, N = H.shape
    V = values.shape[1]
    if values.shape[0] != N or erased.shape[0] != N or min(p, N, V) < 1:
        raise ValueError(f"H {tuple(H.shape)}, values {tuple(values.shape)} and erased "
                         f"{tuple(erased.shape)} must be (p, N), (N, V) and (N,), none empty")
    if dev.type == "cpu":
        return ref.check_pass_ref(H, values, erased.to(torch.float32)[:, None])
    if dev.type != "cuda":
        raise ValueError(f"no check pass for device {dev}")
    lib = _check_lib()
    sums = torch.empty((p, V), dtype=torch.float32, device=dev)
    cnt = torch.empty((p, 1), dtype=torch.float32, device=dev)
    pos = torch.empty((p, 1), dtype=torch.int32, device=dev)
    coeff = torch.empty((p, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.check_pass_launch(H.data_ptr(), values.data_ptr(), erased.data_ptr(),
                                   sums.data_ptr(), cnt.data_ptr(), pos.data_ptr(),
                                   coeff.data_ptr(), p, N, V, stream)
    _raise_on(rc, lib, "check_pass")
    check_pass_cuda.launches += 1
    return sums, cnt, pos, coeff


def peel_round_cuda(H: torch.Tensor, values: torch.Tensor, erased: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One flooding round over a dense ``H (p, N)`` float32, the
    counterpart of the JAX package's ``peel_round_pallas``: ``values (N,)``
    or ``(N, V)`` float32, ``erased (N,)`` bool; returns ``(values,
    erased)`` updated.  The check pass is :func:`check_pass_cuda` (one
    kernel launch; its plain version on the CPU); the scatter follows in
    torch: every check with exactly one erased neighbour proposes
    ``-sums / coeff`` for it, and where several propose for one
    coordinate the HIGHEST check row's value is kept (chosen explicitly,
    as ``core.decoder.peel_round`` does).  Erased entries enter the sums
    as ``v·0``, JAX's arithmetic: a NaN or inf there makes every
    proposal of the round NaN."""
    squeeze = values.ndim == 1
    vals = (values[:, None] if squeeze else values).contiguous()
    H = H.contiguous()
    sums, cnt, pos, coeff = check_pass_cuda(H, vals, erased.contiguous())
    cnt, pos, coeff = cnt[:, 0], pos[:, 0].long(), coeff[:, 0]
    p, N = H.shape
    new_val = -sums / torch.where(coeff == 0.0, 1.0, coeff)[:, None]
    safe_pos = torch.where(cnt == 1.0, pos, N)               # N = dropped
    winner = torch.full((N + 1,), -1, dtype=torch.long, device=H.device)
    winner.scatter_reduce_(0, safe_pos, torch.arange(p, device=H.device), reduce="amax")
    winner = winner[:N]
    resolved = winner >= 0
    out = torch.where(resolved[:, None], new_val[winner.clamp(min=0)], vals)
    return (out[:, 0] if squeeze else out), erased & ~resolved


for _w in (peel_decode_cuda, peel_decode_batch_cuda, peel_decode_adaptive_cuda,
           peel_decode_batch_adaptive_cuda, peel_decode_seeded_cuda,
           peel_decode_batch_seeded_cuda, peel_decode_adaptive_seeded_cuda,
           peel_decode_batch_adaptive_seeded_cuda, encode_seeded_fused_cuda,
           peel_decode_replay_cuda, check_pass_cuda):
    _w.launches = 0
del _w
