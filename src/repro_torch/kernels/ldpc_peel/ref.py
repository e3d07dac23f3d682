"""Plain PyTorch versions of the flooding peeling decodes and of the
schedule replay.

A transcription, on a dense ``(p, N)`` H in float32, of the round the CUDA
kernel (``csrc/peel_decode.cu``) computes.  In each round, every check with
exactly one erased neighbour proposes the value
``-(Σ_known H[i, j'] c_j') / H[i, j]`` for that neighbour ``j``, against
the state at the START of the round (flooding, not layered); when several
checks resolve one coordinate, the LOWEST check row wins.  Erased entries
are never read.  The sum runs over each row's nonzeros in ascending column
order, one rounded multiply and one rounded add per known neighbour, as
the kernel does (it never contracts them into a fused multiply-add): the
kernel and its plain version compute the same floats.

All four contracts are built from the one round, :func:`lo_round`, which
takes a batch of patterns:

* :func:`decode_fused_ref` — one pattern, exactly ``iters`` rounds;
* :func:`decode_fused_batch_ref` — B patterns, exactly ``iters`` rounds;
* :func:`decode_fused_adaptive_ref` — one pattern, early exit;
* :func:`decode_fused_batch_adaptive_ref` — B patterns, per-slot early exit
  under per-slot budgets.

:func:`table_round` is the same round as a GATHER over the code's
neighbour table (no dense H, no ``(B, p, N)`` masks), bit-identical to
:func:`lo_round`; ``decode_table{,_batch,_adaptive,_batch_adaptive}_ref``
are the four contracts over it.  They are what the table kernel's
wrappers run for tensors on the CPU, and what the kernel is held against
on the card at any N.

The SEEDED codes (``csrc/seeded_decode.cu``, ``csrc/seeded_encode.cu``)
have no table at all: :func:`seeded_rows` regenerates the (column, weight)
pairs of any row range from the seed, bit-identical to the NumPy
reference ``repro_torch.core.ldpc._structure_rows_raw``.  Their plain
versions build the sorted table of the rows they need and run
:func:`table_round` over it (so they run at N = 262144):

* :func:`decode_seeded_ref`, :func:`decode_seeded_batch_ref`,
  :func:`decode_seeded_adaptive_ref`, :func:`decode_seeded_batch_adaptive_ref`;
* :func:`encode_seeded_ref` — seeded-LDGM codeword rows from ``row0``, the
  sequential unfused chain of :func:`gather_encode` in table order.

:func:`check_pass_ref` is the plain version of the check-pass kernel
(``csrc/check_pass.cu``): one round's check-node pass over a dense H, a
copy of the JAX package's ``ldpc_peel/ref.py:10 check_pass_ref`` whose
sums run in the kernel's order.

A seeded structure ``st`` is anything with the fields of
``repro_torch.core.ldpc.SeededStructure``.

:func:`replay_ref` is the plain version of the schedule-replay kernel
(``csrc/replay_decode.cu``): each slot replays its own pre-solved peeling
schedule, entry by entry, with the Neumaier-compensated edge sum of the
JAX package's ``_edge_sum``.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["dense_h", "lo_round", "adaptive_loop", "decode_fused_ref",
           "decode_fused_batch_ref", "decode_fused_adaptive_ref",
           "decode_fused_batch_adaptive_ref", "seeded_rows", "seeded_table",
           "table_round", "decode_seeded_ref", "decode_seeded_batch_ref",
           "decode_seeded_adaptive_ref", "decode_seeded_batch_adaptive_ref",
           "decode_table_ref", "decode_table_batch_ref", "decode_table_adaptive_ref",
           "decode_table_batch_adaptive_ref", "fixed_loop", "gather_encode",
           "generator_window", "encode_seeded_ref", "edge_sum", "replay_ref",
           "check_pass_ref"]


def dense_h(check_idx: torch.Tensor, check_coeff: torch.Tensor,
            N: int) -> torch.Tensor:
    """The dense ``(p, N)`` float32 H of a neighbour table whose padding
    slots hold the column sentinel ``N`` (dropped here)."""
    p = check_idx.shape[0]
    H = torch.zeros((p, N + 1), dtype=torch.float32, device=check_idx.device)
    H.scatter_(1, check_idx.long(), check_coeff.float())
    return H[:, :N].contiguous()


def _row_table(H: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's nonzero columns in ascending order and their weights, as
    ``r_max`` columns of ``(p,)`` (padding holds the column ``N``)."""
    p, N = H.shape
    nz = H != 0.0
    r_max = max(int(nz.sum(dim=1).max()), 1)
    col = torch.arange(N, device=H.device)
    idx = torch.where(nz, col, N).sort(dim=1).values[:, :r_max]
    w = torch.gather(torch.cat([H, H.new_zeros((p, 1))], dim=1), 1, idx)
    return idx.T, w.T


def lo_round(H: torch.Tensor, vals: torch.Tensor, e: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One flooding round of B patterns, "lo" tie-break.

    ``H (p, N)`` f32, ``vals (B, N, V)`` f32, ``e (B, N)`` bool.  Returns
    the new ``(vals, e)``; coordinates left unresolved keep their values.
    """
    p, N = H.shape
    col = torch.arange(N, dtype=torch.int32, device=H.device)
    row = torch.arange(p, dtype=torch.int32, device=H.device)
    emask = (H != 0.0) & e[:, None, :]                           # (B, p, N)
    cnt = emask.sum(dim=-1)                                      # exact ints
    solvable = cnt == 1
    sums = torch.zeros((vals.shape[0], p, vals.shape[2]), dtype=vals.dtype,
                       device=vals.device)                       # (B, p, V)
    for idx, w in zip(*_row_table(H)):      # the s-th nonzero of each row
        take = idx < N
        j = idx.clamp(max=N - 1).long()
        add = (take[None, :] & ~e[:, j])[..., None]              # (B, p, 1)
        sums = torch.where(add, sums + w[:, None] * vals[:, j, :], sums)
    pos = torch.where(emask, col, -1).amax(dim=-1)               # (B, p)
    onehot = (col == pos[..., None]) & solvable[..., None]       # (B, p, N)
    coeff = (H * onehot).sum(dim=-1)                             # (B, p)
    new_val = -sums / torch.where(coeff == 0.0, 1.0, coeff)[..., None]
    winner_row = torch.where(onehot, row[:, None], p).amin(dim=-2)  # (B, N)
    resolved = winner_row < p
    take = winner_row.clamp(max=p - 1).long()[..., None].expand_as(vals)
    scattered = torch.gather(new_val, 1, take)                   # (B, N, V)
    vals = torch.where(resolved[..., None], scattered, vals)
    return vals, e & ~resolved


def adaptive_loop(round_fn: Callable, vals: torch.Tensor, e: torch.Tensor,
                  budgets: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-slot early exit around ``round_fn(vals, e)`` on ``vals (B, N,
    V)`` / ``e (B, N)``.

    Slot ``b`` runs round ``d`` only while ``d < budgets[b]``, round
    ``d - 1`` resolved something (true before the first round) and
    something is erased; ``rounds (B,)`` int32 counts the rounds it ran, the
    last no-progress probe round included (the JAX package's
    ``_adaptive_loop``).  Each pass runs the round on every slot and keeps
    it only for the active ones; the loop tests ``active.any()`` on the
    host once per round.
    """
    budgets = budgets.to(device=vals.device, dtype=torch.int32)
    d = torch.zeros(vals.shape[0], dtype=torch.int32, device=vals.device)
    active = (budgets > 0) & e.any(dim=-1)
    while bool(active.any()):
        v2, e2 = round_fn(vals, e)
        changed = (e2 != e).any(dim=-1)
        vals = torch.where(active[:, None, None], v2, vals)
        e = torch.where(active[:, None], e2, e)
        d = d + active.to(torch.int32)
        active = active & (d < budgets) & changed & e.any(dim=-1)
    return vals, e, d


def fixed_loop(round_fn: Callable, values: torch.Tensor, erased: torch.Tensor,
               iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exactly ``iters`` rounds of ``round_fn(vals, e)`` on copies of
    ``values (B, N, V)`` / ``erased (B, N)``."""
    vals, e = values.clone(), erased.clone()
    for _ in range(int(iters)):
        vals, e = round_fn(vals, e)
    return vals, e


def _one(batch_fn, values: torch.Tensor, erased: torch.Tensor, arg):
    """A batch contract ``batch_fn(values, erased, arg)`` on one pattern."""
    return tuple(x[0] for x in batch_fn(values[None], erased[None], arg))


def _budgets(max_iters: int, device) -> torch.Tensor:
    return torch.full((1,), int(max_iters), dtype=torch.int32, device=device)


def decode_fused_batch_ref(H: torch.Tensor, values: torch.Tensor,
                           erased: torch.Tensor, iters: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exactly ``iters`` rounds of each of B patterns: ``values (B, N, V)``
    f32, ``erased (B, N)`` bool → ``(values, erased)``."""
    return fixed_loop(lambda v, e: lo_round(H, v, e), values, erased, iters)


def decode_fused_ref(H: torch.Tensor, values: torch.Tensor,
                     erased: torch.Tensor, iters: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exactly ``iters`` flooding rounds of one pattern.

    ``H (p, N)`` f32, ``values (N, V)`` f32, ``erased (N,)`` bool.  Returns
    ``(values (N, V), erased (N,))``; coordinates left unresolved keep their
    input values.
    """
    return _one(lambda v, e, n: decode_fused_batch_ref(H, v, e, n), values,
                erased, iters)


def decode_fused_batch_adaptive_ref(H: torch.Tensor, values: torch.Tensor,
                                    erased: torch.Tensor,
                                    budgets: torch.Tensor
                                    ) -> tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """Per-slot early exit of B patterns under ``budgets (B,)``: returns
    ``(values (B, N, V), erased (B, N), rounds (B,) int32)``."""
    return adaptive_loop(lambda v, e: lo_round(H, v, e), values.clone(),
                         erased.clone(), budgets)


def decode_fused_adaptive_ref(H: torch.Tensor, values: torch.Tensor,
                              erased: torch.Tensor, max_iters: int
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Early exit of one pattern within ``max_iters`` rounds: returns
    ``(values (N, V), erased (N,), rounds)`` with ``rounds`` 0-d int32."""
    return _one(lambda v, e, b: decode_fused_batch_adaptive_ref(H, v, e, b),
                values, erased, _budgets(max_iters, values.device))


# ------------------------------------------------------------------- table


def table_round(idx: torch.Tensor, w: torch.Tensor, vals: torch.Tensor,
                e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One flooding round of B patterns over a neighbour table, "lo"
    tie-break, with no dense H.

    ``idx (p, r)`` integer columns, each row's real columns in ascending
    order and then its padding slots, which hold the sentinel ``N`` with
    weight 0; ``w (p, r)`` their weights; ``vals (B, N, V)``, ``e (B, N)``
    bool.  The same round as :func:`lo_round`, bit for bit: each check with
    exactly one erased neighbour proposes ``-(Σ_known w·c) / w_erased``,
    summed over its known neighbours in ascending column order, one
    rounded multiply and one rounded add per term (padding slots add
    nothing, not even a zero); the lowest proposing row wins.
    """
    p = idx.shape[0]
    N = vals.shape[1]
    idx = idx.long()
    real = idx < N                                             # (p, r)
    col = idx.clamp(max=N - 1)
    eg = e[:, col] & real                                      # (B, p, r)
    solvable = eg.sum(dim=-1) == 1                             # exact ints
    slot = eg.to(torch.int8).argmax(dim=-1, keepdim=True)      # (B, p, 1)
    pos = torch.gather(idx.expand(e.shape[0], -1, -1), 2, slot)[..., 0]
    coeff = torch.gather(w.expand(e.shape[0], -1, -1), 2, slot)[..., 0]
    sums = vals.new_zeros((vals.shape[0], p, vals.shape[2]))  # (B, p, V)
    for s in range(idx.shape[1]):
        add = (real[None, :, s] & ~eg[:, :, s])[..., None]
        sums = torch.where(add, sums + w[:, s, None] * vals[:, col[:, s], :], sums)
    new_val = -sums / torch.where(coeff == 0.0, 1.0, coeff)[..., None]
    rows = torch.arange(p, device=idx.device).expand(e.shape[0], -1)
    winner = torch.full((e.shape[0], N + 1), p, dtype=torch.int64,
                        device=idx.device)
    winner.scatter_reduce_(1, torch.where(solvable, pos, N), rows, reduce="amin")
    winner = winner[:, :N]
    resolved = winner < p
    take = winner.clamp(max=p - 1)[..., None].expand_as(vals)
    vals = torch.where(resolved[..., None], torch.gather(new_val, 1, take), vals)
    return vals, e & ~resolved


# The same four contracts over a code's neighbour table (``check_idx (p,
# r)`` int, sentinel-``N`` padding; ``check_coeff (p, r)`` f32): what the
# table kernel's wrappers run for CPU tensors, and what it is held against
# at any N (no dense H, no (B, p, N) masks).

def decode_table_batch_ref(check_idx: torch.Tensor, check_coeff: torch.Tensor,
                           values: torch.Tensor, erased: torch.Tensor,
                           iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`decode_fused_batch_ref` over the table, bit for bit."""
    return fixed_loop(lambda v, e: table_round(check_idx, check_coeff, v, e),
                      values, erased, iters)


def decode_table_ref(check_idx: torch.Tensor, check_coeff: torch.Tensor,
                     values: torch.Tensor, erased: torch.Tensor,
                     iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`decode_fused_ref` over the table, bit for bit."""
    return _one(lambda v, e, n: decode_table_batch_ref(check_idx, check_coeff,
                                                       v, e, n),
                values, erased, iters)


def decode_table_batch_adaptive_ref(check_idx: torch.Tensor,
                                    check_coeff: torch.Tensor,
                                    values: torch.Tensor, erased: torch.Tensor,
                                    budgets: torch.Tensor
                                    ) -> tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """:func:`decode_fused_batch_adaptive_ref` over the table, bit for bit."""
    return adaptive_loop(lambda v, e: table_round(check_idx, check_coeff, v, e),
                         values.clone(), erased.clone(), budgets)


def decode_table_adaptive_ref(check_idx: torch.Tensor, check_coeff: torch.Tensor,
                              values: torch.Tensor, erased: torch.Tensor,
                              max_iters: int
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """:func:`decode_fused_adaptive_ref` over the table, bit for bit."""
    return _one(lambda v, e, b: decode_table_batch_adaptive_ref(
        check_idx, check_coeff, v, e, b), values, erased,
        _budgets(max_iters, values.device))


# ------------------------------------------------------------------ seeded

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, mult: int) -> torch.Tensor:
    """``x * mult mod 2^32`` for ``x`` in [0, 2^32) held in int64.

    The product itself can reach 2^64 and overflow int64, so the multiply
    is split at 16 bits: each partial product stays below 2^48.
    """
    lo = (x & 0xFFFF) * mult
    hi = (((x >> 16) * mult) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The lowbias32 avalanche hash on uint32 values held in int64 (torch
    has no usable uint32 multiply): every multiply wraps mod 2^32 and every
    shift is logical, as in ``repro_torch.core.ldpc._mix32``."""
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def seeded_rows(st, lo: int, hi: int, device=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cols (n, r) int64, weights (n, r) float32)`` of rows [lo, hi) in
    DRAW order, regenerated from the seed on ``device``.

    Row ``i`` of layer ``t = i // rows_per_layer`` covers the columns
    ``(a_t·(jl·r + s) + b_t) mod cols`` (``jl`` the row within its layer,
    computed in int64, so exact), and slot ``s`` weighs
    ``sign·(1 + m·2^-23)`` from the hash of the edge counter ``i·r + s``
    cast to uint32 — every float32 step exact.
    """
    if not (0 <= lo <= hi <= st.rows):
        raise ValueError(f"row range [{lo}, {hi}) outside [0, {st.rows})")
    r = st.row_weight
    rows = torch.arange(lo, hi, dtype=torch.int64, device=device)[:, None]
    s = torch.arange(r, dtype=torch.int64, device=device)[None, :]
    t = rows // st.rows_per_layer
    jl = rows - t * st.rows_per_layer
    a = torch.tensor(st.strides, dtype=torch.int64, device=device)[t]
    b = torch.tensor(st.offsets, dtype=torch.int64, device=device)[t]
    cols = (a * (jl * r + s) + b) % st.cols
    u = _mix32(((rows * r + s) & _MASK32) ^ st.wseed)
    sign = 1.0 - 2.0 * (u & 1).to(torch.float32)
    m = (u >> 9).to(torch.float32)                            # [0, 2^23)
    return cols, sign * (1.0 + m * 2.0 ** -23)


def seeded_table(st, lo: int, hi: int, device=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows [lo, hi) as a neighbour table: each row's pairs sorted by
    ascending column (columns within a row are distinct)."""
    cols, w = seeded_rows(st, lo, hi, device)
    cols, order = cols.sort(dim=1)
    return cols, torch.gather(w, 1, order)


def _seeded_round(st, device):
    idx, w = seeded_table(st, 0, st.rows, device)
    return lambda v, e: table_round(idx, w, v, e)


def decode_seeded_batch_ref(st, values: torch.Tensor, erased: torch.Tensor,
                            iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exactly ``iters`` rounds of each of B patterns of the seeded code
    ``st`` (its ``(rows, cols)`` block is H): ``values (B, N, V)``,
    ``erased (B, N)`` → ``(values, erased)``."""
    return fixed_loop(_seeded_round(st, values.device), values, erased, iters)


def decode_seeded_ref(st, values: torch.Tensor, erased: torch.Tensor,
                      iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exactly ``iters`` rounds of one pattern: ``values (N, V)``,
    ``erased (N,)``."""
    return _one(lambda v, e, n: decode_seeded_batch_ref(st, v, e, n), values,
                erased, iters)


def decode_seeded_batch_adaptive_ref(st, values: torch.Tensor,
                                     erased: torch.Tensor,
                                     budgets: torch.Tensor
                                     ) -> tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """Per-slot early exit of B patterns under ``budgets (B,)``: returns
    ``(values, erased, rounds (B,) int32)``."""
    return adaptive_loop(_seeded_round(st, values.device), values.clone(),
                         erased.clone(), budgets)


def decode_seeded_adaptive_ref(st, values: torch.Tensor, erased: torch.Tensor,
                               max_iters: int
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Early exit of one pattern within ``max_iters`` rounds: returns
    ``(values (N, V), erased (N,), rounds)`` with ``rounds`` 0-d int32."""
    return _one(lambda v, e, b: decode_seeded_batch_adaptive_ref(st, v, e, b),
                values, erased, _budgets(max_iters, values.device))


def gather_encode(idx: torch.Tensor, coeff: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """``z[i] = Σ_s coeff[i, s]·y[idx[i, s]]``, summed SEQUENTIALLY in
    table-slot order: the first term a rounded product, every later one a
    rounded product and a rounded add (never a fused multiply-add).
    ``y (K,)`` or ``(K, V)``; returns ``(n,)`` / ``(n, V)``."""
    c = coeff.to(y.dtype)
    if y.ndim == 2:
        c = c[..., None]
    idx = idx.long()
    out = c[:, 0] * y[idx[:, 0]]
    for s in range(1, idx.shape[1]):
        out = out + c[:, s] * y[idx[:, s]]
    return out


def generator_window(st, row0: int, n_out: int, device=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather tables ``(idx (n_out, r), coeff (n_out, r))`` of the
    seeded-LDGM generator rows ``[row0, row0 + n_out)``, ``st`` the
    structure of its ``(p, K)`` parity block: systematic rows (< K) are
    ``[row, 0, ...]`` with weights ``[1, 0, ...]``, parity rows the seeded
    rows in ascending column order, and rows at or past ``N = K + p`` all
    column 0 with weight 0 (they encode to zero, as the kernel's do)."""
    K, N = st.cols, st.cols + st.rows
    rows = torch.arange(row0, row0 + n_out, dtype=torch.int64, device=device)
    idx = torch.zeros((n_out, st.row_weight), dtype=torch.int64, device=device)
    coeff = torch.zeros((n_out, st.row_weight), dtype=torch.float32,
                        device=device)
    sys = rows < K
    idx[:, 0] = torch.where(sys, rows, 0)
    coeff[:, 0] = sys.to(torch.float32)
    plo, phi = min(max(row0, K), N) - K, min(max(row0 + n_out, K), N) - K
    if phi > plo:
        first = plo + K - row0
        idx[first:first + phi - plo], coeff[first:first + phi - plo] = \
            seeded_table(st, plo, phi, device)
    return idx, coeff


def encode_seeded_ref(st, y: torch.Tensor, row0: int, n_out: int) -> torch.Tensor:
    """Seeded-LDGM codeword rows ``[row0, row0 + n_out)`` of ``y (K, V)``:
    :func:`gather_encode` over :func:`generator_window`."""
    idx, coeff = generator_window(st, int(row0), int(n_out), y.device)
    return gather_encode(idx, coeff, y)


# ------------------------------------------------------------------ replay


def edge_sum(pt: torch.Tensor) -> torch.Tensor:
    """Neumaier-compensated sum over axis 1 of the products ``pt (n, r,
    ...)``, in slot order, as the JAX package's ``_edge_sum`` computes it:
    ``s = pt[:, 0]``, ``c = +0``; for each later term ``x``: ``t = s + x``,
    ``c += (s - t) + x`` if ``|s| >= |x|`` else ``(x - t) + s``, ``s = t``;
    the result is ``s + c``.  Every step is one rounded f32 operation."""
    s = pt[:, 0]
    c = torch.zeros_like(s)
    for q in range(1, pt.shape[1]):
        x = pt[:, q]
        t = s + x
        c = c + torch.where(s.abs() >= x.abs(), (s - t) + x, (x - t) + s)
        s = t
    return s + c


def replay_ref(nidx: torch.Tensor, w: torch.Tensor, coeff: torch.Tensor,
               tgt: torch.Tensor, roff: torch.Tensor, meta: torch.Tensor,
               values: torch.Tensor, erased: torch.Tensor, budgets
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Replay B packed peeling schedules, one per slot.

    Slot ``b``'s schedule is ``meta[b] = (entries, rounds R, probe)``; its
    entries follow those of the slots before it in ``nidx (E, r_max)``
    (neighbour columns, sentinel ``N`` reads +0), ``w (E, r_max)``
    (pre-masked weights), ``coeff (E,)`` and ``tgt (E,)`` (target column);
    its ``R + 1`` round offsets (local, from 0) follow those of the slots
    before it in ``roff``.  Slot ``b`` applies its first ``min(budget,
    R)`` rounds (none for a budget below 1): each entry gathers its
    neighbours' current values, forms every product, sums them with
    :func:`edge_sum` and divides the negated sum by its coefficient (1 where
    it is 0); then all of the round's results move to their targets (a
    target at or past ``N`` takes nothing), whose erased flags clear.
    ``budgets`` is an int for every slot or a ``(B,)`` int tensor.

    ``values (B, N, V)`` f32, ``erased (B, N)`` bool.  Returns ``(values,
    erased, rounds (B,) int32)`` with ``rounds[b] = max(0, min(budget,
    probe))``, the adaptive decode's round count.
    """
    B, N, V = values.shape
    vals, e = values.clone(), erased.clone()
    bud = budgets.tolist() if isinstance(budgets, torch.Tensor) else [int(budgets)] * B
    offs = roff.tolist()
    rounds = []
    ebase = rbase = 0
    for b, (n_b, R_b, probe) in enumerate(meta.tolist()):
        v = torch.cat([vals[b], vals.new_zeros((1, V))])        # row N reads +0
        for k in range(max(0, min(bud[b], R_b))):
            s0, s1 = ebase + offs[rbase + k], ebase + offs[rbase + k + 1]
            pt = v[nidx[s0:s1].long().clamp(max=N)] * w[s0:s1, :, None]
            cf = coeff[s0:s1]
            res = -edge_sum(pt) / torch.where(cf == 0.0, 1.0, cf)[:, None]
            t = tgt[s0:s1].long()
            ok = t < N
            v[t[ok]] = res[ok]
            e[b, t[ok]] = False
        vals[b] = v[:N]
        rounds.append(max(0, min(bud[b], probe)))
        ebase += n_b
        rbase += R_b + 1
    return vals, e, torch.tensor(rounds, dtype=torch.int32, device=values.device)


def check_pass_ref(H: torch.Tensor, values: torch.Tensor, erased_f: torch.Tensor):
    """H (p, N) f32, values (N, V) f32, erased_f (N, 1) f32 (1.0 = erased)
    -> (sums (p, V), cnt (p, 1), pos (p, 1) int32, coeff (p, 1)), as the
    JAX ``check_pass_ref``: ``cnt`` the erased neighbours of each row,
    ``pos`` the highest one's column (-1 if none), ``coeff`` its weight (0
    if none), ``sums = H @ (values·(1 − e))`` over every column, zeros of H
    included, so a NaN or inf in an erased entry (times 0, NaN) reaches
    every row's sum as in JAX.  The sum runs in ascending column order, a
    rounded product and a rounded add per term from +0, as the kernel
    does: the two agree bit for bit."""
    e = erased_f[:, 0]
    Hb = (H != 0.0).to(H.dtype)
    cnt = Hb @ e
    known = values * (1.0 - e)[:, None]
    sums = torch.zeros((H.shape[0], values.shape[1]), dtype=H.dtype, device=H.device)
    for j in range(H.shape[1]):
        sums = sums + H[:, j, None] * known[None, j, :]
    idx = torch.arange(H.shape[1], dtype=torch.int32, device=H.device).expand(H.shape)
    mask = (Hb * e[None, :]) > 0
    pos = torch.where(mask, idx, -1).max(dim=1).values
    coeff = (H * (idx == pos[:, None])).sum(dim=1)
    return sums, cnt[:, None], pos[:, None], coeff[:, None]
