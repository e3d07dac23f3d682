"""Cross-step LRU cache of pattern-compiled peeling schedules.

The peeling elimination order is a pure function of ``(code, erasure
pattern)`` — never of the payload values — and straggler patterns recur
(worker straggling is sticky).  :class:`ScheduleCache` closes that loop:
the first decode of a pattern pays the one-time symbolic solve
(:func:`repro_torch.core.decoder.compile_peel_schedule`, O(rounds · edges)
host work), every later decode of the same pattern replays the cached
:class:`~repro_torch.core.decoder.PeelSchedule` (``backend="replay"``),
whose packed kernel operands stay on the device with it.

Keys are ``(id(code), packed erasure bitmask)``.  The cache holds a strong
reference to every code it has seen, so ``id()`` can never be recycled
onto a different live code object; a stale-by-content entry is impossible
because the mask bytes ARE the pattern and the schedule stores the same
fingerprint (``PeelSchedule.mask_key``), which the decode entry points
re-verify against the masks they decode.

Eviction is LRU by access order with a fixed ``capacity``; a recurring
straggler working set therefore stays resident while one-off patterns age
out.  ``hits`` / ``misses`` / ``evictions`` count the cache's lifetime.

Thread-safety: a single lock around every change of the entries.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

from repro_torch.core.decoder import (PeelSchedule, _host_mask,
                                      compile_peel_schedule, erasure_mask_key)

__all__ = ["ScheduleCache", "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 256


class ScheduleCache:
    """LRU ``(code, erasure pattern) -> PeelSchedule``."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if int(capacity) < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = int(capacity)
        self._entries: OrderedDict[tuple, PeelSchedule] = OrderedDict()
        self._codes: dict[int, object] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, code, erased) -> PeelSchedule:
        """The schedule for ``(code, erased)`` — cached, or solved on miss.
        ``erased`` is an (N,) mask, numpy or a tensor on any device (read to
        the host once)."""
        erased = _host_mask(erased)
        key = (id(code), erasure_mask_key(erased))
        with self._lock:
            sched = self._entries.get(key)
            if sched is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return sched
        sched = compile_peel_schedule(code, erased)
        with self._lock:
            self.misses += 1
            self._codes[id(code)] = code
            self._entries[key] = sched
            while len(self._entries) > self.capacity:
                old_key, _ = self._entries.popitem(last=False)
                self.evictions += 1
                if not any(k[0] == old_key[0] for k in self._entries):
                    self._codes.pop(old_key[0], None)
        return sched

    def get_batch(self, code, erased) -> tuple[PeelSchedule, ...]:
        """Per-slot schedules for a (B, N) mask batch (read to the host
        once) — the ``schedules=`` operand of the batched replay decodes;
        each slot hits or misses independently."""
        e = _host_mask(erased)
        if e.ndim != 2:
            raise ValueError(f"erased must be (B, N); got shape {e.shape}")
        return tuple(self.get(code, e[b]) for b in range(e.shape[0]))

    def stats(self) -> dict:
        """Hit/miss/eviction counters, occupancy, and the realized hit
        rate."""
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "size": len(self._entries),
            "capacity": self.capacity,
            "hit_rate": self.hits / total if total else 0.0,
        }

    def clear(self) -> None:
        """Drop every entry (counters keep accumulating — they describe
        the cache's lifetime, not its current contents)."""
        with self._lock:
            self._entries.clear()
            self._codes.clear()
