"""KV caches of the attention layers: the port of the JAX package's
``serving/kvcache.py`` for the ``"attn"`` mixer (the MLA, Mamba, RWKV and
cross-attention states wait for their families).

Layout, as JAX's: ``{"k", "v": (B, W, KV, Dh), "pos": (W,) int32,
"length": () int32}``.  W is the full ``max_len``, or a sliding window
(ring buffer); ``pos`` holds the absolute position in each slot, initially
``INVALID_POS`` (INT32_MAX, empty).  Unlike JAX's, the port's caches are
updated in place by ``models.attention.gqa_forward`` / ``gqa_decode``.
"""
from __future__ import annotations

import torch

__all__ = ["INVALID_POS", "make_attn_cache", "make_layer_cache"]

INVALID_POS = torch.iinfo(torch.int32).max


def make_attn_cache(B: int, window: int, n_kv: int, head_dim: int, dtype,
                    device=None) -> dict:
    return {
        "k": torch.zeros((B, window, n_kv, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((B, window, n_kv, head_dim), dtype=dtype, device=device),
        "pos": torch.full((window,), INVALID_POS, dtype=torch.int32, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def make_layer_cache(cfg, mixer: str, B: int, window: int, dtype, device=None) -> dict:
    """Cache for one layer of the given mixer type (see ArchConfig)."""
    if mixer == "attn" and not cfg.enc_layers:
        return make_attn_cache(B, window, cfg.n_kv_heads, cfg.hd, dtype, device)
    raise NotImplementedError(
        f"the port's caches cover decoder-only attention; {cfg.name}'s "
        f"{'cross-attention' if mixer == 'attn' else mixer} state is not ported yet")
