"""Layer primitives of the model zoo: the port of the JAX package's
``models/layers.py``.

Each layer is an ``nn.Module`` holding its parameters under the JAX
parameter tree's names (``Dense.w``, ``RMSNorm.scale``, ``Embedding.table``),
so a JAX pytree loads by name (:func:`repro_torch.convert.model_from_params`),
and a plain function on tensors does the arithmetic.  The casts sit where
JAX's sit: ``rmsnorm``, ``layernorm`` and ``apply_rope`` compute in float32
(float64 for float64 inputs) and cast back to ``x.dtype``; everything else
runs in the working dtype.

Parameters are created empty; each module's ``init(generator)`` draws them
with JAX's scales (``_he``: normal / √fan_in; the embedding: normal·0.02),
from an explicit ``torch.Generator`` (whose numbers differ from
``jax.random``'s: the tests load JAX's weights instead).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Dense", "dense", "RMSNorm", "rmsnorm", "LayerNorm", "layernorm", "MLP",
           "mlp", "rope_freqs", "apply_rope", "Embedding"]


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64 tensors."""
    return torch.promote_types(dtype, torch.float32)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


@torch.no_grad()
def _he_(p: torch.Tensor, generator: torch.Generator, fan_in: int | None = None) -> None:
    fan_in = fan_in if fan_in is not None else p.shape[0]
    x = torch.randn(p.shape, generator=generator, device=generator.device)
    p.copy_((x / math.sqrt(fan_in)).to(p.dtype))


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ w (+ b)``, with ``w (d_in, d_out)`` as JAX keeps it."""
    y = x @ w
    return y if b is None else y + b


class Dense(nn.Module):
    """``y = x @ w + b``.  ``w`` is ``(d_in, d_out)``, JAX's orientation, and is
    applied as it stands: no transposition anywhere (``nn.Linear`` would keep
    ``(d_out, d_in)``)."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)
        self.b = _param((d_out,), dtype, device) if bias else None

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        _he_(self.w, generator)
        if self.b is not None:
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.w, self.b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    ct = _compute_dtype(x.dtype)
    x32 = x.to(ct)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(ct)).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-6, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param((d,), dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None) -> None:
        self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, self.eps)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    ct = _compute_dtype(x.dtype)
    x32 = x.to(ct)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(ct) + bias.to(ct)).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-5, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param((d,), dtype, device)
        self.bias = _param((d,), dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.scale, self.bias, self.eps)


def mlp(x: torch.Tensor, gate: Dense | None, up: Dense, down: Dense, *,
        act: str = "swiglu") -> torch.Tensor:
    if act == "swiglu":
        return down(F.silu(gate(x)) * up(x))
    if act == "gelu":                     # jax.nn.gelu's default: the tanh form
        return down(F.gelu(up(x), approximate="tanh"))
    if act == "relu2":
        return down(F.relu(up(x)).square())
    raise ValueError(act)


class MLP(nn.Module):
    """swiglu (``gate``, ``up``, ``down``) or a two-matrix gelu / relu² MLP."""

    def __init__(self, d: int, d_ff: int, *, act: str = "swiglu", bias: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        if act not in ("swiglu", "gelu", "relu2"):
            raise ValueError(act)
        self.act = act
        kw = dict(bias=bias, dtype=dtype, device=device)
        self.gate = Dense(d, d_ff, **kw) if act == "swiglu" else None
        self.up = Dense(d, d_ff, **kw)
        self.down = Dense(d_ff, d, **kw)

    def init(self, generator: torch.Generator) -> None:
        for m in (self.gate, self.up, self.down):
            if m is not None:
                m.init(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(x, self.gate, self.up, self.down, act=self.act)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, float32."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, Dh); positions: (..., S) or (S,)."""
    dh = x.shape[-1]
    ct = _compute_dtype(x.dtype)
    freqs = rope_freqs(dh, theta, device=x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs     # (..., S, dh/2)
    cos = torch.cos(ang)[..., :, None, :].to(ct)                 # (..., S, 1, dh/2)
    sin = torch.sin(ang)[..., :, None, :].to(ct)
    x1, x2 = x.to(ct).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class Embedding(nn.Module):
    """``table (vocab, d)``; ``forward(tokens)`` gathers its rows."""

    def __init__(self, vocab: int, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.table = _param((vocab, d), dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        x = torch.randn(self.table.shape, generator=generator, device=generator.device)
        self.table.copy_((x * 0.02).to(self.table.dtype))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table[tokens]
