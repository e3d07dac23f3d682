"""The plain PyTorch version of the flash-attention kernel: attention as
the JAX package's ``models/attention.sdpa_chunked`` computes it, one full
softmax per chunk of queries, with the same masks.

The CPU tests hold it against JAX; ``chip_smoke.py`` and
tests/test_torch_cuda.py hold the kernel against it on the card.  Nothing
on the model's path calls it when a card is present: the wrapper
(:func:`.ops.flash_attention_cuda`) takes it only for CPU tensors.
"""
from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "attention_ref", "bf16_ulp"]

# The reference's finite mask value: with -inf, a row whose keys are all
# masked would give exp(-inf - -inf) = NaN.
NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool = True,
                  kv_valid: torch.Tensor | None = None, chunk: int = 512) -> torch.Tensor:
    """``softmax(q·kᵀ·scale + mask)·v`` with ``scale = 1/√Dh``.

    q ``(B, Sq, KV, G, Dh)`` (query head ``h`` of KV head ``h // G``), k
    ``(B, T, KV, Dh)``, v ``(B, T, KV, Dv)`` (Dv may differ from Dh, as in
    MLA), ``q_pos (Sq,)`` and ``kv_pos (T,)`` int positions,
    ``kv_valid (T,)`` bool or None.  Key ``t`` is visible to query ``i``
    when ``kv_pos[t] <= q_pos[i]`` (if ``causal``) and ``kv_valid[t]``.
    Computes in float32 (float64 for float64 inputs) and returns ``(B, Sq,
    KV, G, Dv)`` in v's dtype.
    Queries are taken ``chunk`` at a time when ``chunk`` divides ``Sq``
    into more than one chunk, as ``sdpa_chunked`` does.
    """
    B, Sq, KV, G, Dh = q.shape
    scale = 1.0 / math.sqrt(Dh)
    acc = torch.promote_types(v.dtype, torch.float32)
    kf, vf = k.to(acc), v.to(acc)

    def block(qc: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
        s = torch.einsum("bqkgd,btkd->bkgqt", qc.to(acc), kf) * scale
        mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device)
        if causal:
            mask = qp[:, None] >= kv_pos[None, :]
        if kv_valid is not None:
            mask = mask & kv_valid[None, :]
        s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=acc, device=s.device))
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bkgqt,btkd->bqkgd", p, vf).to(v.dtype)

    cq = min(chunk, Sq)
    if Sq % cq != 0 or Sq == cq:
        return block(q, q_pos)
    return torch.cat([block(q[:, i:i + cq], q_pos[i:i + cq]) for i in range(0, Sq, cq)],
                     dim=1)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at ``|x|`` (float32): the tolerance a
    bf16 output of the kernel is held to against the plain version's, since
    both compute in float32 and round once."""
    mant, exp = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(mant), exp - 8)
