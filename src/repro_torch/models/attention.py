"""Grouped-query attention for the model zoo: the port of the JAX package's
``models/attention.py`` (``sdpa_chunked``, ``_qkv``, ``gqa_forward`` and
``gqa_decode``; MLA and cross-attention wait for their families).

The attention core, :func:`sdpa_chunked`, is the flash kernel's wrapper
(``kernels/flash_attention``): on CUDA tensors it launches the hand-written
kernel, on CPU tensors it runs the plain version, which computes as the
JAX ``sdpa_chunked`` does.  Its layout is JAX's: q ``(B, Sq, KV, G, Dh)``,
k and v ``(B, T, KV, Dh)``, ``q_pos (Sq,)``, ``kv_pos (T,)``, optional
``kv_valid (T,)``.

Caches (:mod:`repro_torch.serving.kvcache`) are updated IN PLACE, where
JAX builds new arrays: ``gqa_forward`` and ``gqa_decode`` write the new
keys, values and positions into the cache they are given and return it.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
from repro_torch.models.layers import Dense, RMSNorm, apply_rope

__all__ = ["sdpa_chunked", "GQA", "gqa_forward", "gqa_decode"]


def sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                 kv_pos: torch.Tensor, *, causal: bool = True, chunk: int = 512,
                 kv_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Scaled-dot-product attention in the GQA layout (see the module
    docstring); the flash kernel on the card, its plain version on the CPU.
    Positions are int32; the output takes v's dtype."""
    return flash_attention_cuda(q, k, v, q_pos, kv_pos, causal=causal, kv_valid=kv_valid,
                                chunk=chunk)


class GQA(nn.Module):
    """The projections of a GQA layer: ``wq``, ``wk``, ``wv`` (QKV bias
    optional) and ``wo``, with optional per-head ``q_norm`` / ``k_norm``."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int, *,
                 qk_norm: bool = False, bias: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq = Dense(d_model, n_heads * head_dim, bias=bias, **kw)
        self.wk = Dense(d_model, n_kv * head_dim, bias=bias, **kw)
        self.wv = Dense(d_model, n_kv * head_dim, bias=bias, **kw)
        self.wo = Dense(n_heads * head_dim, d_model, bias=False, **kw)
        self.q_norm = RMSNorm(head_dim, **kw) if qk_norm else None
        self.k_norm = RMSNorm(head_dim, **kw) if qk_norm else None

    def init(self, generator: torch.Generator) -> None:
        for m in (self.wq, self.wk, self.wv, self.wo):
            m.init(generator)
        for m in (self.q_norm, self.k_norm):
            if m is not None:
                m.init()


def _qkv(p: GQA, x: torch.Tensor, positions: torch.Tensor, rope_theta: float,
         use_rope: bool = True):
    B, S, _ = x.shape
    q = p.wq(x).reshape(B, S, p.n_heads, p.head_dim)
    k = p.wk(x).reshape(B, S, p.n_kv, p.head_dim)
    v = p.wv(x).reshape(B, S, p.n_kv, p.head_dim)
    if p.q_norm is not None:
        q = p.q_norm(q)
        k = p.k_norm(k)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def gqa_forward(p: GQA, x: torch.Tensor, *, positions: torch.Tensor,
                rope_theta: float = 1e6, causal: bool = True, chunk: int = 512,
                cache: dict | None = None, use_rope: bool = True):
    """Self-attention over a full sequence (training shape, or prefill when
    ``cache`` is given: the prompt's K/V go into its first S slots, every
    slot's position becomes its index, and ``length`` becomes S).
    ``positions (S,)`` int32.  Returns ``(y, cache)``."""
    B, S, _ = x.shape
    G = p.n_heads // p.n_kv
    q, k, v = _qkv(p, x, positions, rope_theta, use_rope)
    if cache is not None:
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
        torch.arange(cache["pos"].shape[0], dtype=torch.int32, out=cache["pos"])
        cache["length"].fill_(S)
    o = sdpa_chunked(q.reshape(B, S, p.n_kv, G, p.head_dim), k.contiguous(),
                     v.contiguous(), positions, positions, causal=causal, chunk=chunk)
    y = p.wo(o.reshape(B, S, p.n_heads * p.head_dim))
    return y, cache


def gqa_decode(p: GQA, x: torch.Tensor, *, pos: int, pos_t: torch.Tensor, cache: dict,
               rope_theta: float = 1e6, use_rope: bool = True):
    """One token. x ``(B, 1, d)``; ``pos`` the token's position (a host int)
    and ``pos_t`` the same as an int32 ``(1,)`` tensor on x's device.  Works
    on a full cache (slot == pos) and on a ring-buffer window (slot == pos
    mod W; each slot's position says whether it holds a key yet: empty
    slots hold ``INVALID_POS``).  Returns ``(y, cache)``."""
    B = x.shape[0]
    q = p.wq(x).reshape(B, 1, p.n_heads, p.head_dim)
    k = p.wk(x).reshape(B, 1, p.n_kv, p.head_dim)
    v = p.wv(x).reshape(B, 1, p.n_kv, p.head_dim)
    if p.q_norm is not None:
        q = p.q_norm(q)
        k = p.k_norm(k)
    if use_rope:
        q = apply_rope(q, pos_t, rope_theta)
        k = apply_rope(k, pos_t, rope_theta)
    W = cache["k"].shape[1]
    slot = pos % W
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = pos
    cache["length"].clamp_(min=pos + 1)
    kv_valid = cache["pos"] <= pos          # unfilled slots hold INT32_MAX
    o = sdpa_chunked(q.reshape(B, 1, p.n_kv, p.n_heads // p.n_kv, p.head_dim),
                     cache["k"], cache["v"], pos_t, cache["pos"], causal=True,
                     kv_valid=kv_valid)
    return p.wo(o.reshape(B, 1, p.n_heads * p.head_dim)), cache
