"""The plain PyTorch version of the flash-attention kernels: attention as
the JAX package's ``models/attention.sdpa_chunked`` computes it, one full
softmax per chunk of queries, with the same masks; the decode kernel's
split and combine (:func:`attention_split_ref`, :func:`split_bounds`); and
the kernels' causal skip, the key tiles a block visits
(:func:`visited_tiles`, :func:`tiles_visited`).

The CPU tests hold it against JAX; ``chip_smoke.py`` and
tests/test_torch_cuda.py hold the kernel against it on the card.  Nothing
on the model's path calls it when a card is present: the wrapper
(:func:`.ops.flash_attention_cuda`) takes it only for CPU tensors.
"""
from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "TILE_KEYS", "BLOCK_ROWS", "attention_ref", "attention_split_ref",
           "split_bounds", "bf16_ulp", "query_tiles", "visited_tiles", "tiles_visited"]

# The reference's finite mask value: with -inf, a row whose keys are all
# masked would give exp(-inf - -inf) = NaN.
NEG_INF = -1e30

# Keys a tile of each kernel holds, and the (query, head) rows of a block
# of the tensor-core and SIMT kernels (a decode block holds all its rows).
TILE_KEYS = {"tensor": 64, "simt": 32, "decode": 32}
BLOCK_ROWS = 64


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool = True,
                  kv_valid: torch.Tensor | None = None, chunk: int = 512,
                  p_terms: int | None = None) -> torch.Tensor:
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

    ``p_terms`` (a control for the tests, not a setting of the model): p =
    exp(s - max s) is rounded to a sum of that many bf16 terms before p·v,
    each the bf16 rounding of what is left, each term's product summed in
    float32 and divided by p's float32 sum at the end.  The tensor-core
    kernel's split is 3 terms and carries p's 24 bits; 1 is p rounded once
    to bf16, as torch's scaled_dot_product_attention does, the function the
    bf16 checks must tell apart from the kernel's.
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
        if p_terms is None:
            p = torch.softmax(s, dim=-1)
            return torch.einsum("bkgqt,btkd->bqkgd", p, vf).to(v.dtype)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True).permute(0, 3, 1, 2, 4)         # (b, q, k, g, 1)
        out = 0
        for _ in range(p_terms):
            term = p.to(torch.bfloat16).to(acc)
            out = out + torch.einsum("bkgqt,btkd->bqkgd", term, vf)
            p = p - term
        return (out / l).to(v.dtype)

    cq = min(chunk, Sq)
    if Sq % cq != 0 or Sq == cq:
        return block(q, q_pos)
    return torch.cat([block(q[:, i:i + cq], q_pos[i:i + cq]) for i in range(0, Sq, cq)],
                     dim=1)


def split_bounds(T: int, splits: int) -> list[range]:
    """The keys of each split of the decode kernel: the ``ceil(T / 32)``
    key tiles cut into ``splits`` contiguous ranges, split ``s`` taking
    tiles ``[n·s // splits, n·(s + 1) // splits)`` (empty when there are
    more splits than tiles)."""
    bk = TILE_KEYS["decode"]
    n = -(-T // bk)
    return [range(min(bk * (n * s // splits), T), min(bk * (n * (s + 1) // splits), T))
            for s in range(splits)]


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, kv_pos: torch.Tensor, *, splits: int,
                        causal: bool = True, kv_valid: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """:func:`attention_ref` as the decode kernel computes it: for each split
    of :func:`split_bounds`, the partial ``m`` (the largest masked score),
    ``l = Σ exp(s - m)`` and ``acc = Σ exp(s - m)·v`` over its keys (a split
    with no keys: ``m = -1e30``, ``l = 0``, ``acc = 0``); then folded in
    ascending split order from ``(-1e30, 0, 0)``: with ``M = max(m, m')``,
    ``l·e^(m - M) + l'·e^(m' - M)`` and the same for acc; and ``acc /
    max(l, 1e-30)`` in v's dtype.  Same arguments and masks as
    :func:`attention_ref`; float32 arithmetic (float64 for float64 inputs).
    The tests hold it against JAX; the model's path never calls it."""
    B, Sq, KV, G, Dh = q.shape
    scale = 1.0 / math.sqrt(Dh)
    acc_t = torch.promote_types(v.dtype, torch.float32)
    s = torch.einsum("bqkgd,btkd->bkgqt", q.to(acc_t), k.to(acc_t)) * scale
    mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device)
    if causal:
        mask = q_pos[:, None] >= kv_pos[None, :]
    if kv_valid is not None:
        mask = mask & kv_valid[None, :]
    neg = torch.tensor(NEG_INF, dtype=acc_t, device=s.device)
    s = torch.where(mask, s, neg)
    vf = v.to(acc_t)
    parts = []
    for keys in split_bounds(k.shape[1], splits):
        if len(keys) == 0:
            parts.append((neg.expand(s.shape[:-1]), torch.zeros(s.shape[:-1], dtype=acc_t,
                                                               device=s.device),
                          torch.zeros(s.shape[:-1] + (v.shape[3],), dtype=acc_t,
                                      device=s.device)))
            continue
        ss = s[..., keys.start:keys.stop]
        m = ss.amax(-1)
        p = torch.exp(ss - m[..., None])
        parts.append((m, p.sum(-1), torch.einsum("bkgqt,btkd->bkgqd", p,
                                                  vf[:, keys.start:keys.stop])))
    M, L, A = parts[0][0].clone().fill_(NEG_INF), torch.zeros_like(parts[0][1]), 0
    for m, l, a in parts:
        mx = torch.maximum(M, m)
        wa, wb = torch.exp(M - mx), torch.exp(m - mx)
        M, L, A = mx, L * wa + l * wb, A * wa[..., None] + a * wb[..., None]
    out = A / L.clamp_min(1e-30)[..., None]                       # (b, k, g, q, d)
    return out.permute(0, 3, 1, 2, 4).to(v.dtype)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at ``|x|`` (float32): the tolerance a
    bf16 output of the kernel is held to against the plain version's, since
    both compute in float32 and round once."""
    mant, exp = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(mant), exp - 8)


def query_tiles(Sq: int, G: int) -> list[range]:
    """The queries of each block along the query axis: ``64 // G`` at a
    time (at least one, at most ``Sq``), the last tile ragged."""
    bq = min(max(1, BLOCK_ROWS // G), Sq)
    return [range(q0, min(q0 + bq, Sq)) for q0 in range(0, Sq, bq)]


def visited_tiles(q_pos, kv_pos, *, bk: int, causal: bool = True, kv_valid=None) -> list[int]:
    """The key tiles (``bk`` keys each) that a block whose queries sit at
    ``q_pos`` visits, in order: tile ``j`` is skipped when no key in it is
    visible to any of the queries and every query has met a visible key
    in an earlier tile.  A query with no visible key keeps every tile.
    Positions need not ascend."""
    kv_pos = torch.as_tensor(kv_pos).long().cpu()
    q_pos = torch.as_tensor(q_pos).long().cpu()
    valid = (torch.ones(kv_pos.shape, dtype=torch.bool) if kv_valid is None
             else torch.as_tensor(kv_valid).bool().cpu())
    lo, hi = int(q_pos.min()), int(q_pos.max())
    seen = valid & (kv_pos <= hi) if causal else valid     # visible to some query
    to_all = valid & (kv_pos <= lo) if causal else valid   # visible to every query
    n = -(-len(kv_pos) // bk)
    pad = n * bk - len(kv_pos)
    seen, to_all = (torch.nn.functional.pad(x, (0, pad)).view(n, bk).any(1)
                    for x in (seen, to_all))
    met = torch.cat([torch.zeros(1, dtype=torch.bool), to_all.cumsum(0)[:-1] > 0])
    return (seen | ~met).nonzero().flatten().tolist()


def tiles_visited(q_pos, kv_pos, *, B: int, KV: int, G: int, Dh: int, Dv: int, path: str,
                  causal: bool = True, kv_valid=None, splits: int | None = None) -> int:
    """The key tiles one launch of ``path``'s kernel visits over all its
    blocks: ``B × KV`` for each query tile, and on the SIMT kernel's generic
    path (any head dimensions but ``Dh = Dv`` in {64, 128}) one block for
    each 64 columns of v as well.  The decode kernel (``splits`` of them, of
    :func:`split_bounds`) runs the rule on each split's keys alone, with all
    the queries.  The counter of :func:`.ops.tile_count` holds the kernel to
    it."""
    q_pos = torch.as_tensor(q_pos).cpu()
    kv_pos = torch.as_tensor(kv_pos).cpu()
    kv_valid = None if kv_valid is None else torch.as_tensor(kv_valid).cpu()
    if path == "decode":
        if splits is None:
            raise ValueError("the decode kernel's tiles depend on its number of splits")
        return B * KV * sum(
            len(visited_tiles(q_pos, kv_pos[r.start:r.stop], bk=TILE_KEYS[path], causal=causal,
                              kv_valid=None if kv_valid is None else kv_valid[r.start:r.stop]))
            for r in split_bounds(len(kv_pos), splits) if len(r))
    per_row = sum(len(visited_tiles(q_pos[list(r)], kv_pos, bk=TILE_KEYS[path], causal=causal,
                                    kv_valid=kv_valid))
                  for r in query_tiles(len(q_pos), G))
    chunks = 1 if path == "tensor" or (Dh == Dv and Dh in (64, 128)) else -(-Dv // 64)
    return per_row * B * KV * chunks
