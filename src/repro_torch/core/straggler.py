"""Straggler models.

The paper analyzes Assumption 1 (each worker independently straggles with
probability ``q0``) and experiments with a fixed straggler count ``s`` out of
``w = 40`` workers.  On one card there are no real stragglers, so the mask
is *injected*: it is exactly the erasure-channel abstraction the analysis is
built on.  Masks are drawn on ``device`` (the card unless the caller asks
for the CPU) from an explicit :class:`torch.Generator` on that device.  They
match the JAX package's masks in distribution, not in bits (the two
generators differ); tests that compare the packages hand both the same
masks.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol

import torch

from repro_torch.device import resolve_device

__all__ = ["StragglerModel", "BernoulliStragglers", "FixedCountStragglers"]


class StragglerModel(Protocol):
    def sample(self, generator: torch.Generator | None, w: int,
               device=None) -> torch.Tensor:
        """Return a (w,) bool mask, True = straggler (erased)."""
        ...


@dataclasses.dataclass(frozen=True)
class BernoulliStragglers:
    """Assumption 1: i.i.d. Bernoulli(q0) straggling per worker per step."""

    q0: float

    def sample(self, generator: torch.Generator | None, w: int,
               device=None) -> torch.Tensor:
        dev = resolve_device(device)
        return torch.rand(w, generator=generator, device=dev) < self.q0


@dataclasses.dataclass(frozen=True)
class FixedCountStragglers:
    """Exactly ``s`` uniformly-random stragglers per step (the paper's
    experimental setting: wait for the fastest ``w - s`` workers).  The mask
    is a random permutation's first ``s`` indices, so the count is exactly
    ``s`` by construction."""

    s: int

    def sample(self, generator: torch.Generator | None, w: int,
               device=None) -> torch.Tensor:
        dev = resolve_device(device)
        mask = torch.zeros(w, dtype=torch.bool, device=dev)
        if self.s > 0:
            idx = torch.randperm(w, generator=generator, device=dev)[: self.s]
            mask[idx] = True
        return mask
