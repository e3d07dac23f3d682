"""Plain PyTorch version of the fixed-D flooding peeling decode.

A transcription, on a dense ``(p, N)`` H in float32, of the round the CUDA
kernel (``csrc/peel_decode.cu``) computes.  In each round, every check with
exactly one erased neighbour proposes the value
``-(Σ_known H[i, j'] c_j') / H[i, j]`` for that neighbour ``j``, against
the state at the START of the round (flooding, not layered); when several
checks resolve one coordinate, the LOWEST check row wins.  Erased entries
are never read: ``known`` is ``values`` with the erased rows replaced by 0.

This is what the kernel's wrapper runs for tensors on the CPU, and what
the kernel is held against on the card.
"""
from __future__ import annotations

import torch

__all__ = ["dense_h", "decode_fused_ref"]


def dense_h(check_idx: torch.Tensor, check_coeff: torch.Tensor,
            N: int) -> torch.Tensor:
    """The dense ``(p, N)`` float32 H of a neighbour table whose padding
    slots hold the column sentinel ``N`` (dropped here)."""
    p = check_idx.shape[0]
    H = torch.zeros((p, N + 1), dtype=torch.float32, device=check_idx.device)
    H.scatter_(1, check_idx.long(), check_coeff.float())
    return H[:, :N].contiguous()


def decode_fused_ref(H: torch.Tensor, values: torch.Tensor,
                     erased: torch.Tensor, iters: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exactly ``iters`` flooding rounds.

    ``H (p, N)`` f32, ``values (N, V)`` f32, ``erased (N,)`` bool.  Returns
    ``(values (N, V), erased (N,))``; coordinates left unresolved keep their
    input values.
    """
    p, N = H.shape
    Hb = H != 0.0
    col = torch.arange(N, device=H.device)
    row = torch.arange(p, device=H.device)
    vals = values.clone()
    e = erased.clone()
    for _ in range(int(iters)):
        known = torch.where(e[:, None], torch.zeros_like(vals), vals)
        emask = Hb & e[None, :]                                   # (p, N)
        cnt = emask.sum(dim=1)                                    # exact ints
        solvable = cnt == 1
        sums = H @ known                                          # (p, V)
        pos = torch.where(emask, col[None, :], -1).amax(dim=1)    # (p,)
        onehot = (col[None, :] == pos[:, None]) & solvable[:, None]
        coeff = (H * onehot).sum(dim=1)
        new_val = -sums / torch.where(coeff == 0.0, 1.0, coeff)[:, None]
        winner_row = torch.where(onehot, row[:, None], p).amin(dim=0)  # (N,)
        resolved = winner_row < p
        scattered = new_val[winner_row.clamp(max=p - 1)]          # (N, V)
        vals = torch.where(resolved[:, None], scattered, vals)
        e = e & ~resolved
    return vals, e
