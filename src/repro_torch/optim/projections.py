"""Projection operators P_Θ for constrained PGD (all non-expansive).

The paper's experiments use: identity (plain least squares) and the
hard-thresholding operator H_u (IHT for sparse recovery, Garg & Khandekar).
L2-ball and L1-ball projections cover the R(θ) <= R formulation of (1).
"""
from __future__ import annotations

import torch

__all__ = ["identity", "l2_ball", "l1_ball", "hard_threshold", "box"]


def identity(theta: torch.Tensor) -> torch.Tensor:
    return theta


def l2_ball(radius: float):
    def proj(theta: torch.Tensor) -> torch.Tensor:
        nrm = torch.linalg.vector_norm(theta)
        scale = torch.clamp(radius / torch.clamp(nrm, min=1e-30), max=1.0)
        return theta * scale

    return proj


def l1_ball(radius: float):
    """Euclidean projection onto {||x||_1 <= r} (Duchi et al. 2008)."""

    def proj(theta: torch.Tensor) -> torch.Tensor:
        a = theta.abs()
        u = torch.sort(a, descending=True).values
        css = torch.cumsum(u, 0)
        ks = torch.arange(1, a.numel() + 1, device=theta.device, dtype=u.dtype)
        cond = u * ks > (css - radius)
        rho = torch.amax(torch.where(cond, ks, torch.zeros_like(ks)))
        lam = (css[rho.long() - 1] - radius) / rho
        projected = torch.sign(theta) * torch.clamp(a - lam, min=0.0)
        # select, not branch: no host round trip inside a step loop
        return torch.where(a.sum() <= radius, theta, projected)

    return proj


def hard_threshold(u: int):
    """H_u: keep the u largest-magnitude coordinates, zero the rest (IHT)."""

    def proj(theta: torch.Tensor) -> torch.Tensor:
        if u >= theta.numel():
            return theta
        idx = torch.topk(theta.abs(), u).indices
        mask = torch.zeros(theta.shape, dtype=torch.bool, device=theta.device)
        mask[idx] = True
        return torch.where(mask, theta, torch.zeros_like(theta))

    return proj


def box(lo: float, hi: float):
    def proj(theta: torch.Tensor) -> torch.Tensor:
        return torch.clamp(theta, lo, hi)

    return proj
