"""Batched-request serving scheduler (wave batching with early exit): the
port of the JAX package's ``serving/batcher.py``.

A fixed pool of ``n_slots`` decode slots advances in LOCKSTEP, one
``Model.decode_step`` per tick for the whole batch, all slots at the same
position.  Requests are admitted in waves of up to ``n_slots``, starting
together at position 0; a slot whose prompt is shorter switches to greedy
generation while others still feed theirs; a slot that finishes (``eos``
or ``max_new``) idles until the wave drains, then the next wave comes in.
The same waves, ticks and greedy rule as JAX's (``np.argmax`` over the
float32 logits, first maximum on ties).
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

__all__ = ["Request", "WaveBatcher"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    eos: int | None = None
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class WaveBatcher:
    """Serves :class:`Request` s through ``model`` (a
    :class:`repro_torch.models.Model`, which holds its weights), on the
    model's device."""

    def __init__(self, model, *, n_slots: int = 4, max_len: int = 128):
        cfg = model.cfg
        if cfg.family in ("audio", "vlm"):
            raise NotImplementedError("batcher demo covers text decoders")
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.ticks = 0

    def submit(self, req: Request):
        self.queue.append(req)

    @property
    def active(self) -> bool:
        return bool(self.queue)

    def _run_wave(self, wave: list[Request], max_ticks: int):
        cache = self.model.init_cache(self.n_slots, self.max_len)
        pending = [list(r.prompt) for r in wave]
        live = [True] * len(wave)
        tokens = np.zeros((self.n_slots, 1), np.int64)
        for s, r in enumerate(wave):
            tokens[s, 0] = pending[s].pop(0)
        pos = 0
        while any(live) and pos < self.max_len - 1 and self.ticks < max_ticks:
            self.ticks += 1
            logits, cache = self.model.decode_step(torch.from_numpy(tokens), pos, cache)
            ln = logits[:, 0].float().cpu().numpy()
            pos += 1
            for s, r in enumerate(wave):
                if not live[s]:
                    continue
                if pending[s]:               # still feeding the prompt
                    tokens[s, 0] = pending[s].pop(0)
                    continue
                nxt = int(np.argmax(ln[s]))  # greedy generation
                r.out.append(nxt)
                tokens[s, 0] = nxt
                if (r.eos is not None and nxt == r.eos) or \
                        len(r.out) >= r.max_new:
                    r.done = True
                    live[s] = False
                    self.finished.append(r)
        for s, r in enumerate(wave):  # drain anything cut off by max_len
            if live[s]:
                r.done = True
                self.finished.append(r)

    def run(self, max_ticks: int = 100_000) -> list[Request]:
        while self.queue and self.ticks < max_ticks:
            wave = [self.queue.popleft()
                    for _ in range(min(self.n_slots, len(self.queue)))]
            self._run_wave(wave, max_ticks)
        return self.finished
