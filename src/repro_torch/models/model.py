"""The model zoo's decoder, for the dense family: the port of the JAX
package's ``models/model.py`` (``Model.init``, ``_apply_layer``'s attention
and dense-FFN branches, ``_embed_inputs`` for text, ``init_cache``,
``prefill``, ``decode_step`` and ``param_count``).

An ``nn.Module`` over an ``nn.ModuleList`` of layers: JAX's ``lax.scan``
over parameter-stacked blocks becomes a loop over the layers.  The
parameters carry the JAX tree's names (``embed.table``, ``final_norm.scale``,
``unembed.w``, ``layers.{i}.ln1.scale``, ``layers.{i}.mixer.wq.w``, ...), so
``repro_torch.convert.model_from_params`` loads a JAX ``Model.init`` tree by
name.  Every attention layer's core is the flash kernel
(``models.attention.sdpa_chunked``).  ``forward`` and ``loss_fn`` (training)
wait for the training slice; families other than "dense" (experts, MLA,
Mamba, RWKV, the audio encoder, image patches) raise.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models.layers import MLP, Embedding, LayerNorm, RMSNorm, _param
from repro_torch.serving import kvcache as KV

__all__ = ["Model"]


class Layer(nn.Module):
    """One decoder layer: ``ln1``, the GQA ``mixer``, ``ln2`` and the dense
    ``ffn``, each with a residual."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        norm = RMSNorm if cfg.norm == "rmsnorm" else LayerNorm
        kw = dict(dtype=dtype, device=device)
        self.ln1 = norm(cfg.d_model, cfg.norm_eps, **kw)
        self.mixer = A.GQA(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           qk_norm=cfg.qk_norm, bias=cfg.qkv_bias, **kw)
        self.ln2 = norm(cfg.d_model, cfg.norm_eps, **kw)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, act=cfg.act, **kw)

    def init(self, generator: torch.Generator) -> None:
        self.ln1.init()
        self.mixer.init(generator)
        self.ln2.init()
        self.ffn.init(generator)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor, mode: str, cache: dict,
                pos: int | None = None, pos_t: torch.Tensor | None = None,
                chunk: int = 512) -> torch.Tensor:
        """``mode`` "prefill" or "decode" (with ``pos`` and ``pos_t``); the
        cache is written in place."""
        cfg = self.cfg
        use_rope = cfg.pos == "rope"
        h = self.ln1(x)
        if mode == "decode":
            y, _ = A.gqa_decode(self.mixer, h, pos=pos, pos_t=pos_t, cache=cache,
                                rope_theta=cfg.rope_theta, use_rope=use_rope)
        else:
            y, _ = A.gqa_forward(self.mixer, h, positions=positions,
                                 rope_theta=cfg.rope_theta, causal=True, chunk=chunk,
                                 cache=cache, use_rope=use_rope)
        x = x + y
        return x + self.ffn(self.ln2(x))


class _Unembed(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, device):
        super().__init__()
        self.w = _param((vocab, d), dtype, device)     # applied as x @ w.T

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        x = torch.randn(self.w.shape, generator=generator, device=generator.device)
        self.w.copy_((x * 0.02).to(self.w.dtype))


class Model(nn.Module):
    """The dense family's decoder on ``device`` (default: the card), in the
    config's dtype.  Parameters are created empty: call :meth:`init` with a
    ``torch.Generator`` (on the same device) or load weights
    (``convert.model_from_params``)."""

    def __init__(self, cfg: ArchConfig, *, attn_chunk: int = 512, device=None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"the port's Model covers the dense family; {cfg.name} is family "
                f"{cfg.family!r}, not ported yet")
        dev = resolve_device(device)
        dt = cfg.torch_dtype
        self.cfg = cfg
        self.attn_chunk = attn_chunk
        self.prefix_len, self.period = cfg.stack_plan()
        self.n_blocks = (cfg.n_layers - self.prefix_len) // self.period
        self.specs = cfg.layer_specs()
        norm = RMSNorm if cfg.norm == "rmsnorm" else LayerNorm
        self.embed = Embedding(cfg.vocab, cfg.d_model, dtype=dt, device=dev)
        self.final_norm = norm(cfg.d_model, cfg.norm_eps, dtype=dt, device=dev)
        self.unembed = _Unembed(cfg.vocab, cfg.d_model, dt, dev)
        self.layers = nn.ModuleList(Layer(cfg, dt, dev) for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def init(self, generator: torch.Generator | None = None) -> "Model":
        """Draw every parameter from ``generator`` (default: seed 0 on the
        model's device) with JAX's scales; returns the model."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.embed.init(generator)
        self.final_norm.init()
        self.unembed.init(generator)
        for layer in self.layers:
            layer.init(generator)
        return self

    # ---------------------------------------------------------- inputs ---
    def _embed_inputs(self, batch: dict):
        """Text tokens ``batch["tokens"] (B, S)`` -> ``(x, positions)``."""
        x = self.embed(batch["tokens"].to(self.device))
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=self.device)
        return x, positions

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        return (x @ self.unembed.w.T).to(torch.promote_types(x.dtype, torch.float32))

    # ---------------------------------------------------------- serving ---
    def init_cache(self, B: int, max_len: int, *, window: int | None = None) -> list[dict]:
        """One cache per layer (:mod:`repro_torch.serving.kvcache`), of
        ``min(window or max_len, max_len)`` slots, in the parameters' dtype."""
        W = min(window or max_len, max_len)
        return [KV.make_layer_cache(self.cfg, mixer, B, W, self.embed.table.dtype,
                                    self.device) for mixer, _ in self.specs]

    @torch.no_grad()
    def prefill(self, batch: dict, cache: list[dict]):
        """Run the whole prompt, writing the caches (in place). Returns
        ``(last_logits (B, 1, vocab) float32, cache)``."""
        x, positions = self._embed_inputs(batch)
        for layer, c in zip(self.layers, cache):
            x = layer(x, positions=positions, mode="prefill", cache=c,
                      chunk=self.attn_chunk)
        return self._logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, pos: int, cache: list[dict]):
        """``token (B, 1)`` int, ``pos`` the position (an int). Returns
        ``(logits (B, 1, vocab) float32, cache)``, the caches written in
        place."""
        pos = int(pos)
        x = self.embed(token.to(self.device))
        pos_t = torch.full((1,), pos, dtype=torch.int32, device=self.device)
        for layer, c in zip(self.layers, cache):
            x = layer(x, positions=pos_t, mode="decode", cache=c, pos=pos, pos_t=pos_t)
        return self._logits(x), cache

    # ------------------------------------------------------------ sizes ---
    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
