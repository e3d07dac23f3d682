"""Synthetic least-squares problems matching the paper's experimental setup.

Paper Section 4: X has i.i.d. random entries; y = X θ* (+ optional noise)
with θ* dense (least squares).  The draws are NumPy's, in the same order
as the JAX package's, so one seed gives the same X, y and θ* bit for bit
in both packages; the result is returned as float32 tensors on ``device``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["LinearProblem", "make_linear_problem"]


class LinearProblem(NamedTuple):
    X: torch.Tensor           # (m, k)
    y: torch.Tensor           # (m,)
    theta_star: torch.Tensor  # (k,)
    # suggested PGD learning rate: 1/λ_max(X^T X) (guaranteed descent for exact GD)
    lr: float


def _lr_for(X: np.ndarray) -> float:
    lam = np.linalg.norm(X, 2) ** 2  # λ_max(X^T X)
    return float(1.0 / lam)


def make_linear_problem(m: int, k: int, *, noise: float = 0.0, seed: int = 0,
                        normalize: bool = True, device=None) -> LinearProblem:
    """Dense least squares: X ~ N(0, 1/m)^{m x k}, y = X θ* + noise."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, k))
    if normalize:
        X /= np.sqrt(m)
    theta = rng.standard_normal(k)
    y = X @ theta + noise * rng.standard_normal(m)
    dev = resolve_device(device)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return LinearProblem(f32(X), f32(y), f32(theta), _lr_for(X))
