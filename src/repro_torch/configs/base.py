"""Architecture configuration system: the port's copy of the JAX
package's ``configs/base.py``, held equal field by field by
tests/test_torch_model.py.

One ``ArchConfig`` per assigned architecture (see sibling modules, each of
which cites its source).  The only change is the dtype property:
``torch_dtype`` gives the torch dtype where the JAX copy's ``jdtype`` gives
the jnp one.

``reduced()`` produces the CPU-smoke-test variant (<=2 layers, d_model<=512,
<=4 experts) of the same family, per the assignment contract.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["MoESpec", "MLASpec", "MambaSpec", "RWKVSpec", "ArchConfig",
           "register", "get_config", "list_configs"]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0          # shared experts (DeepSeek style), as a dense MLP
    capacity_factor: float = 1.25
    every: int = 1             # MoE ffn every `every` layers (jamba: 2)
    first_dense: int = 0       # leading layers with dense FFN (dsv2/kimi: 1)


@dataclasses.dataclass(frozen=True)
class MLASpec:
    kv_lora: int = 512
    q_lora: int = 0
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class RWKVSpec:
    head_dim: int = 64
    decay_lora: int = 64


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    act: str = "swiglu"
    norm: str = "rmsnorm"      # rmsnorm | layernorm (whisper)
    pos: str = "rope"          # rope | sinusoidal | none
    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None
    mamba: Optional[MambaSpec] = None
    rwkv: Optional[RWKVSpec] = None
    attn_every: int = 1        # attention mixer every N layers (jamba: 8); 0 = attn-free
    attn_offset: int = 0       # which index within the period is attention (jamba: 4)
    enc_layers: int = 0        # whisper encoder depth (enc-dec if > 0)
    enc_seq: int = 1500        # encoder frame count (post-conv stub)
    n_patches: int = 0         # vlm: image patch embeddings prepended
    sliding_window: int = 8192  # window used for the long_500k decode variant
    dtype: str = "bfloat16"
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def mixer_of(self, i: int) -> str:
        if self.rwkv is not None:
            return "rwkv"
        if self.mla is not None:
            return "mla"
        if self.attn_every == 0:
            raise ValueError("attn-free arch must set rwkv/mamba")
        if self.mamba is not None:
            return "attn" if i % self.attn_every == self.attn_offset else "mamba"
        return "attn"

    def ffn_of(self, i: int) -> str:
        if self.rwkv is not None:
            return "rwkv_cm"
        if self.moe is not None and i >= self.moe.first_dense and \
                (i % self.moe.every == self.moe.every - 1 or self.moe.every == 1):
            return "moe"
        return "dense"

    def layer_specs(self) -> list[tuple[str, str]]:
        return [(self.mixer_of(i), self.ffn_of(i)) for i in range(self.n_layers)]

    def stack_plan(self) -> tuple[int, int]:
        """(prefix_len, period): layers[prefix:] is periodic with `period`."""
        specs = self.layer_specs()
        n = len(specs)
        for prefix in range(0, min(3, n)):
            body = specs[prefix:]
            if not body:
                continue
            for period in range(1, min(len(body), 16) + 1):
                if len(body) % period == 0 and all(
                        body[i] == body[i % period] for i in range(len(body))):
                    return prefix, period
        return n, 1  # fully unrolled fallback

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        hd = 64 if self.rwkv is None else 32
        heads = 4
        kv = min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else heads
        d_model = heads * hd
        changes: dict = dict(
            n_layers=2, d_model=d_model, n_heads=heads, n_kv_heads=kv,
            head_dim=hd, d_ff=4 * d_model, vocab=min(self.vocab, 512),
            enc_layers=min(self.enc_layers, 2), enc_seq=min(self.enc_seq, 32),
            n_patches=min(self.n_patches, 8), sliding_window=16,
            dtype="float32",
        )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_ff_expert=2 * d_model,
                n_shared=min(self.moe.n_shared, 1),
                first_dense=min(self.moe.first_dense, 1))
        if self.mla:
            changes["mla"] = MLASpec(kv_lora=32, q_lora=16 if self.mla.q_lora else 0,
                                     qk_nope=hd // 2, qk_rope=hd // 4, v_head=hd // 2)
        if self.mamba:
            changes["mamba"] = MambaSpec(d_state=8, d_conv=4, expand=2)
            changes["attn_every"] = 2  # 2 layers: one mamba, one attention
            changes["attn_offset"] = 1
        if self.rwkv:
            changes["rwkv"] = RWKVSpec(head_dim=hd, decay_lora=16)
        return dataclasses.replace(self, **changes)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from repro_torch import configs as _  # ensure all config modules imported
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from repro_torch import configs as _
    return sorted(_REGISTRY)
