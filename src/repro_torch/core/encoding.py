"""Moment encoding (the paper's preprocessing step).

Given data ``X in R^{m x k}`` and labels ``y in R^m``, the gradient of the
squared loss is ``∇L(θ) = M θ - b`` with ``M = X^T X`` and ``b = X^T y``.
``M`` is computed ONCE and encoded:

* Scheme 2 (``K == k``): ``C = G @ M in R^{N x k}``; worker ``j`` stores row
  ``c_j`` and computes the scalar ``⟨c_j, θ⟩`` per step.  ``C θ`` is a
  codeword whose first ``k`` coordinates are ``M θ`` (systematic G).
* Blocked (``K | k``): the rows of ``M`` are partitioned into ``k/K``
  blocks, each encoded separately: ``C^(i) = G M_{P_i}``; worker ``j`` holds
  row ``j`` of every block and returns ``k/K`` scalars.

The encode is a plain float32 matrix product on the tensors' device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.ldpc import LDPCCode

__all__ = ["Moments", "second_moment", "encode_moment", "encode_moment_blocks"]


class Moments(NamedTuple):
    M: torch.Tensor  # (k, k)
    b: torch.Tensor  # (k,)


def second_moment(X: torch.Tensor, y: torch.Tensor) -> Moments:
    """M = X^T X, b = X^T y — the one-time preprocessing pass."""
    return Moments(X.T @ X, X.T @ y)


def _generator(code: LDPCCode, M: torch.Tensor) -> torch.Tensor:
    if code.G.size == 0:
        raise ValueError("a parity-only code has no generator to encode with")
    return torch.as_tensor(code.G, dtype=M.dtype, device=M.device)


def encode_moment(code: LDPCCode, M: torch.Tensor) -> torch.Tensor:
    """Scheme 2 encode: C = G @ M, shape (N, k); requires code.K == k."""
    if code.K != M.shape[0]:
        raise ValueError(f"code dimension K={code.K} != k={M.shape[0]}; "
                         "use encode_moment_blocks for K | k")
    return _generator(code, M) @ M


def encode_moment_blocks(code: LDPCCode, M: torch.Tensor) -> torch.Tensor:
    """Blocked encode: ``C`` of shape (k/K, N, k) with
    ``C[i] = G @ M[i*K:(i+1)*K]``; worker ``j`` holds ``C[:, j, :]``."""
    k = M.shape[0]
    if k % code.K != 0:
        raise ValueError(f"K={code.K} must divide k={k}")
    nb = k // code.K
    return torch.matmul(_generator(code, M), M.reshape(nb, code.K, k))
