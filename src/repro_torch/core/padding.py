"""Zero-padding of sample blocks for worker data partitioning."""
from __future__ import annotations

import torch

__all__ = ["pad_blocks"]


def pad_blocks(X: torch.Tensor, y: torch.Tensor,
               parts: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Split samples into ``parts`` equal blocks, zero-padding the tail.

    Zero rows contribute nothing to X^T(Xθ - y), so padding is exact (the
    paper's 40-worker / m=2048 setup has uneven partitions too).
    """
    m = X.shape[0]
    pad = (-m) % parts
    if pad:
        X = torch.nn.functional.pad(X, (0, 0, 0, pad))
        y = torch.nn.functional.pad(y, (0, pad))
    mp = m + pad
    return X.reshape(parts, mp // parts, -1), y.reshape(parts, mp // parts)
