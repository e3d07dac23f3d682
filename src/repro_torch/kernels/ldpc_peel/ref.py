"""Plain PyTorch versions of the flooding peeling decodes.

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

These are what the kernel's wrappers run for tensors on the CPU, and what
the kernel is held against on the card.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["dense_h", "lo_round", "adaptive_loop", "decode_fused_ref",
           "decode_fused_batch_ref", "decode_fused_adaptive_ref",
           "decode_fused_batch_adaptive_ref"]


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


def decode_fused_batch_ref(H: torch.Tensor, values: torch.Tensor,
                           erased: torch.Tensor, iters: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exactly ``iters`` rounds of each of B patterns: ``values (B, N, V)``
    f32, ``erased (B, N)`` bool → ``(values, erased)``."""
    vals, e = values.clone(), erased.clone()
    for _ in range(int(iters)):
        vals, e = lo_round(H, vals, e)
    return vals, e


def decode_fused_ref(H: torch.Tensor, values: torch.Tensor,
                     erased: torch.Tensor, iters: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exactly ``iters`` flooding rounds of one pattern.

    ``H (p, N)`` f32, ``values (N, V)`` f32, ``erased (N,)`` bool.  Returns
    ``(values (N, V), erased (N,))``; coordinates left unresolved keep their
    input values.
    """
    v, e = decode_fused_batch_ref(H, values[None], erased[None], iters)
    return v[0], e[0]


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
    budgets = torch.full((1,), int(max_iters), dtype=torch.int32,
                         device=values.device)
    v, e, d = decode_fused_batch_adaptive_ref(H, values[None], erased[None],
                                              budgets)
    return v[0], e[0], d[0]
