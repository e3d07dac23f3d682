"""The plain PyTorch version of the tiled matrix-product kernel: the product
in float32 of the float32-cast inputs (float64 when both inputs are
float64: the port's float64 reference runs), as the JAX package's
``block_matmul/ref.py`` computes it.

The CPU tests hold it against JAX; ``chip_smoke.py`` and
tests/test_torch_cuda.py hold the kernel against it, and against float64,
on the card.  Nothing on the encode's path calls it when a card is
present: the wrapper (:func:`.ops.block_matmul`) takes it only for CPU
tensors.
"""
from __future__ import annotations

import torch

__all__ = ["block_matmul_ref"]


def block_matmul_ref(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` with ``torch.matmul`` (2-D, or batched over a leading axis
    of either) in float32, or in float64 when both inputs are float64."""
    acc = torch.float64 if A.dtype == B.dtype == torch.float64 else torch.float32
    return torch.matmul(A.to(acc), B.to(acc))
