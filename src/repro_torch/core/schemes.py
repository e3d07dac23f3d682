"""The paper's uncoded baseline.

:class:`Uncoded` — w workers each hold m/w samples; the master sums the
partial gradients that arrive (stragglers' contributions are simply lost).
It has the same surface as the coded schemes (``.w``, ``.gradient``,
``.step``), so :func:`repro_torch.core.coded_step.run_pgd` drives it too.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.padding import pad_blocks
from repro_torch.optim import projections

__all__ = ["Uncoded"]


@dataclasses.dataclass(frozen=True)
class Uncoded:
    X: torch.Tensor  # (m, k)
    y: torch.Tensor  # (m,)
    w: int
    lr: float
    projection: Callable = projections.identity

    def gradient(self, theta, straggler_mask):
        Xb, yb = pad_blocks(self.X, self.y, self.w)
        resid = torch.einsum("wmk,k->wm", Xb, theta) - yb      # (w, m/w)
        partial = torch.einsum("wmk,wm->wk", Xb, resid)        # (w, k)
        alive = (~straggler_mask).to(theta.dtype)
        return partial.T @ alive, straggler_mask.sum().to(torch.int32)

    def step(self, theta, mask):
        g, aux = self.gradient(theta, mask)
        return self.projection(theta - self.lr * g), aux
