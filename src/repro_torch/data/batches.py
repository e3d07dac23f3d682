"""Token batches for the text families: the port of the JAX package's
``data/batches.py``.  Tokens come from an explicit ``torch.Generator``
(whose numbers differ from ``jax.random``'s: the tests hand both packages
the same numpy tokens).  The audio frames and image patches of the other
families wait for their slices."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

__all__ = ["make_batch", "make_decode_inputs"]


def _text_only(cfg: ArchConfig) -> None:
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(f"{cfg.family} inputs (patches, frames) are not "
                                  f"ported yet")


def make_batch(cfg: ArchConfig, batch: int, seq: int,
               generator: torch.Generator | None = None, device=None) -> dict:
    """``{"tokens": (batch, seq), "labels": (batch, seq)}``, labels the
    tokens shifted by one, drawn on ``device`` (default: the card) from
    ``generator`` (default: seed 0 there)."""
    _text_only(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (batch, seq + 1), generator=gen,
                         device=gen.device).to(dev)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_decode_inputs(cfg: ArchConfig, batch: int,
                       generator: torch.Generator | None = None, device=None) -> dict:
    """``{"token": (batch, 1)}`` (default generator: seed 1)."""
    _text_only(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(1)
    return {"token": torch.randint(0, cfg.vocab, (batch, 1), generator=gen,
                                   device=gen.device).to(dev)}
