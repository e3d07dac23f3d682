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

The encode ``C = G @ M`` runs through the tiled matrix-product kernel
(:func:`repro_torch.kernels.block_matmul.encode_gm`, ``csrc/block_matmul.cu``)
on the card, the blocked encode as one launch over the k/K blocks; on the
CPU through its plain version, ``torch.matmul``.  float32 moments encode
in float32 (FMAs, never TF32).  float64 moments encode in float64 on the
CPU only; on the card a float64 reference run builds its ``C`` with
:func:`repro_torch.kernels.block_matmul.block_matmul_ref`.

SEEDED encode: for a seeded LDGM code
(:func:`repro_torch.core.ldpc.make_seeded_ldgm`) every generator row is an
O(row_weight) function of ``(seed, row)``, so ``C = G @ M`` reduces to
per-row gathers over M (:func:`encode_moment_seeded`) and the per-step
codeword ``C θ`` to a gather over ``y = M θ`` (:func:`gather_encode`): no
generator is materialized.  :func:`encode_seeded` runs that gather in the
CUDA kernel ``kernels/ldpc_peel/csrc/seeded_encode.cu``, which regenerates
each row's (column, weight) pairs from the seed, so not even the gather
tables exist.  Both sum SEQUENTIALLY in table-slot order, one rounded
multiply and one rounded add per term, so they agree bit for bit.  (The JAX
package's jitted ``gather_encode`` and its Pallas encode agree with each
other but not with this unfused chain: XLA contracts some of the
multiply-adds.  Its eager ``gather_encode`` is this chain.)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.ldpc import (LDPCCode, SeededStructure, seeded_generator_rows,
                                   seeded_structure)
from repro_torch.device import resolve_device
from repro_torch.kernels.block_matmul import encode_gm
from repro_torch.kernels.ldpc_peel import encode_seeded_fused_cuda
from repro_torch.kernels.ldpc_peel.ref import gather_encode

__all__ = ["Moments", "second_moment", "encode_moment", "encode_moment_blocks",
           "encode_moment_seeded", "gather_encode", "generator_gather_tables",
           "encode_seeded", "generator_structure_of"]


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
    return encode_gm(_generator(code, M), M)


def encode_moment_blocks(code: LDPCCode, M: torch.Tensor) -> torch.Tensor:
    """Blocked encode (Scheme 1's, and :class:`Scheme2Blocked`'s): ``C`` of
    shape (k/K, N, k) with ``C[i] = G @ M[i*K:(i+1)*K]``; worker ``j`` holds
    ``C[:, j, :]``.  One launch for all k/K blocks."""
    k = M.shape[0]
    if k % code.K != 0:
        raise ValueError(f"K={code.K} must divide k={k}")
    nb = k // code.K
    return encode_gm(_generator(code, M), M.reshape(nb, code.K, k))


def generator_gather_tables(code: LDPCCode, device=None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-generator gather tables of a seeded LDGM code on ``device``:
    ``(idx (N, row_weight) int32, coeff (N, row_weight) f32)`` with
    ``G[i] = Σ_s coeff[i, s]·e_{idx[i, s]}`` — the whole generator in
    ``O(N·row_weight)`` numbers instead of an ``(N, K)`` matrix.  Built
    once per device."""
    device = resolve_device(device)
    key = ("generator", device)
    hit = code.device_cache.get(key)
    if hit is None:
        idx, coeff = seeded_generator_rows(code, 0, code.N)
        hit = (torch.from_numpy(idx).to(device), torch.from_numpy(coeff).to(device))
        code.device_cache[key] = hit
    return hit


def encode_moment_seeded(code: LDPCCode, M: torch.Tensor) -> torch.Tensor:
    """Scheme 2 encode ``C = G @ M`` through the seeded generator gathers:
    same contract as :func:`encode_moment` (``(N, k)``, ``code.K == k``)
    with no generator materialized; needs a ``make_seeded_ldgm`` code."""
    if code.K != M.shape[0]:
        raise ValueError(f"code dimension K={code.K} != k={M.shape[0]}; "
                         "use encode_moment_blocks for K | k")
    return gather_encode(*generator_gather_tables(code, M.device), M)


def generator_structure_of(code: LDPCCode) -> SeededStructure:
    """The :class:`SeededStructure` of a seeded LDGM code's generator parity
    block ``P`` (``G = [I; P]``): what the seeded encode regenerates rows
    from."""
    kind = getattr(code, "kind", None)
    if kind != "ldgm-seeded":
        raise ValueError(
            f"fused seeded encode needs a make_seeded_ldgm code "
            f"(kind='ldgm-seeded'); got kind={kind!r}")
    return seeded_structure(code.p, code.K, code.r - 1, code.seed)


def encode_seeded(code: LDPCCode, y: torch.Tensor, row0: int = 0, *,
                  n_out: int | None = None) -> torch.Tensor:
    """Codeword rows ``[row0, row0 + n_out)`` of ``G @ y`` through the
    seeded encode kernel (its plain version for CPU tensors): no gather
    tables, no generator.

    ``y`` is ``(K,)`` or ``(K, V)``, computed in float32 and returned in
    its own dtype; ``n_out`` defaults to the whole codeword ``N``.
    Bit-identical to :func:`gather_encode` over
    :func:`generator_gather_tables` rows.
    """
    st = generator_structure_of(code)
    squeeze = y.ndim == 1
    yv = (y[:, None] if squeeze else y).to(torch.float32).contiguous()
    out = encode_seeded_fused_cuda(st, yv, row0, code.N if n_out is None else n_out)
    out = out.to(y.dtype)
    return out[:, 0] if squeeze else out
