"""Carry the JAX side's arrays across into the port's objects.

Everything here takes plain arrays (NumPy, or anything ``np.asarray``
accepts) and returns the port's objects, with tensors on ``device``.  With
it, both packages compute from the very same code and encoded moment, or
the very same model weights (:func:`model_from_params`).  This module
imports nothing of the JAX package: a JAX-side object is read through its
attributes only (:func:`code_from`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.coded_step import Scheme2, Scheme2Blocked
from repro_torch.core.ldpc import LDPCCode, SeededLDPC
from repro_torch.device import resolve_device
from repro_torch.models.model import Model

__all__ = ["code_from_arrays", "code_from", "tensor", "scheme2_blocked_from_arrays",
           "scheme2_from_arrays", "model_from_params"]

_CODE_FIELDS = ("H", "G", "N", "K", "l", "r", "kind", "seed")


def tensor(a, device=None) -> torch.Tensor:
    """A float32 copy of the array ``a`` as a tensor on ``device``."""
    return torch.as_tensor(np.array(a), dtype=torch.float32).to(resolve_device(device))


def code_from_arrays(H, G, N: int, K: int, l: int, r: int, kind: str = "ldpc",
                     seed: int = 0) -> LDPCCode:
    """An :class:`LDPCCode` with exactly these H and G."""
    return LDPCCode(H=np.array(H), G=np.array(G), N=int(N), K=int(K),
                    l=int(l), r=int(r), kind=str(kind), seed=int(seed))


def code_from(obj) -> LDPCCode | SeededLDPC:
    """An :class:`LDPCCode` from any object with the attributes
    ``H, G, N, K, l, r, kind, seed`` (such as the JAX package's code), or a
    :class:`SeededLDPC` from a structure-only seeded code (``N, K, l, r,
    seed`` and no ``H``)."""
    if not hasattr(obj, "H") and getattr(obj, "kind", None) == "ldpc-seeded":
        return SeededLDPC(N=int(obj.N), K=int(obj.K), l=int(obj.l), r=int(obj.r),
                          seed=int(obj.seed))
    return code_from_arrays(**{f: getattr(obj, f) for f in _CODE_FIELDS})


def scheme2_blocked_from_arrays(code: LDPCCode, C_blocks, b, lr: float,
                                decode_iters: int, *, device=None,
                                **kw) -> Scheme2Blocked:
    """A :class:`Scheme2Blocked` over the encoded blocks ``C_blocks
    (k/K, N, k)`` and moment vector ``b (k,)``; ``kw`` are its other
    fields (``decode_backend``, ``projection``)."""
    return Scheme2Blocked(code=code, C_blocks=tensor(C_blocks, device),
                          b=tensor(b, device), lr=float(lr),
                          decode_iters=int(decode_iters), **kw)


def scheme2_from_arrays(code: LDPCCode, C, b, lr: float, decode_iters: int, *,
                        device=None, **kw) -> Scheme2:
    """A :class:`Scheme2` over the encoded moment ``C (N, k)`` and ``b``;
    ``kw`` are its other fields.  A JAX ``Scheme2.build_seeded`` scheme
    carries ``M (k, k)`` as its ``C``: pass it with ``seeded_encode=True``
    (and ``encode_fused``) to carry it across."""
    return Scheme2(code=code, C=tensor(C, device), b=tensor(b, device),
                   lr=float(lr), decode_iters=int(decode_iters), **kw)


def _to_tensor(a) -> torch.Tensor:
    """A CPU tensor of the array ``a``, bfloat16 arrays (ml_dtypes) included."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def model_from_params(cfg: ArchConfig, params: dict, *, device=None,
                      attn_chunk: int = 512) -> Model:
    """The port's :class:`Model` holding the JAX ``Model.init`` tree
    ``params`` (nested dicts of arrays), on ``device``, in the config's dtype.

    ``params["prefix"][str(i)]`` is layer ``i``; ``params["blocks"]["sub{j}"]``
    carries a leading ``n_blocks`` axis whose entry ``b`` is layer
    ``prefix_len + b * period + j`` (``cfg.stack_plan()``).  Every weight
    keeps its JAX orientation: a dense ``w`` is ``(d_in, d_out)`` and applied
    as ``x @ w``; ``unembed.w`` is ``(vocab, d)`` and applied as ``x @ w.T``.
    Nothing is transposed.  Loading is strict: a missing, extra or
    misshapen weight raises.
    """
    model = Model(cfg, attn_chunk=attn_chunk, device=device)
    state = {}
    for name in ("embed", "final_norm", "unembed"):
        state.update(_flatten(params[name], f"{name}."))
    for i, layer in params.get("prefix", {}).items():
        state.update(_flatten(layer, f"layers.{int(i)}."))
    for sub, stacked in params.get("blocks", {}).items():
        j = int(sub.removeprefix("sub"))
        for key, arr in _flatten(stacked).items():
            arr = np.asarray(arr)
            if arr.shape[0] != model.n_blocks:
                raise ValueError(f"blocks.{sub}.{key} has {arr.shape[0]} blocks, "
                                 f"want {model.n_blocks}")
            for b in range(model.n_blocks):
                state[f"layers.{model.prefix_len + b * model.period + j}.{key}"] = arr[b]
    model.load_state_dict({k: _to_tensor(v) for k, v in state.items()}, strict=True)
    return model
