"""The continuous-admission slot lifecycle: the port's copy of the JAX
package's ``serving/slot_lifecycle.py``.

A fixed pool of ``B`` decode slots, each owned by at most one in-flight
query; per launch, every occupied slot is granted at most a chunk of its
remaining round budget; after the launch, a slot retires when its query
converged (early exit or nothing left erased) or spent its total budget,
and free slots refill from a FIFO queue.

:class:`SlotPool` owns the HOST-side bookkeeping only (who occupies which
slot, rounds spent, per-slot chunk sizes); callers own the device-resident
decode state and the launches.  Per-slot chunk sizes serve the priority
scheduler: a query admitted with a ``chunk=`` larger than the pool default
gets proportionally more peeling rounds per launch.
"""
from __future__ import annotations

from typing import Any, Iterator

import numpy as np

__all__ = ["SlotPool"]


class SlotPool:
    """Host-side slot lifecycle for continuous-admission decode serving.

    ``n_slots`` decode slots, each query granted a total round ``budget``
    and at most its per-slot chunk (default ``rounds_per_launch``) of it
    per launch.  The caller loop is always::

        while pool.active or queue:
            for s in pool.free_slots():              # FIFO refill
                pool.admit(s, owner, chunk=...)      # caller stages state
            budgets = pool.launch_budgets()          # (B,) int32, 0 = inert
            ... one batched adaptive decode launch under ``budgets`` ...
            for s, owner in pool.account(rounds, unresolved):
                ... owner retired: pull its results, free slot ...

    Retire rule: a slot retires when its launch stopped early (``rounds <
    granted budget``), nothing is left erased (``unresolved == 0``), or its
    total budget is spent (``used >= budget``).  A slot whose fixpoint
    lands exactly on its chunk boundary is found one launch later through a
    no-progress probe round — the same probe the sequential adaptive decode
    charges, so per-query round counts match it exactly.
    """

    def __init__(self, n_slots: int, budget: int,
                 rounds_per_launch: int | None = None):
        if n_slots < 1:
            raise ValueError(f"need at least one slot; got {n_slots}")
        self.n_slots = int(n_slots)
        self.budget = int(budget)
        self.default_chunk = (self.budget if rounds_per_launch is None
                              else int(rounds_per_launch))
        if self.default_chunk < 1:
            raise ValueError("rounds_per_launch must be >= 1")
        self._owner: list[Any | None] = [None] * self.n_slots
        self._used = np.zeros(self.n_slots, np.int32)
        self._chunk = np.full(self.n_slots, self.default_chunk, np.int32)
        self._granted = np.zeros(self.n_slots, np.int32)

    # ------------------------------------------------------------- occupancy

    @property
    def occupied(self) -> np.ndarray:
        """(B,) bool — slots currently owned by an in-flight query."""
        return np.array([o is not None for o in self._owner])

    @property
    def active(self) -> bool:
        return any(o is not None for o in self._owner)

    def owner(self, s: int) -> Any | None:
        return self._owner[s]

    def owners(self) -> Iterator[tuple[int, Any]]:
        """(slot, owner) for every occupied slot, in slot order."""
        for s, o in enumerate(self._owner):
            if o is not None:
                yield s, o

    def free_slots(self) -> list[int]:
        return [s for s, o in enumerate(self._owner) if o is None]

    def rounds_spent(self, s: int) -> int:
        return int(self._used[s])

    # -------------------------------------------------------------- lifecycle

    def admit(self, s: int, owner: Any, *, chunk: int | None = None) -> None:
        """Seat ``owner`` in free slot ``s`` with a fresh budget; ``chunk``
        overrides the pool's per-launch default (priority scheduling)."""
        if self._owner[s] is not None:
            raise ValueError(f"slot {s} is occupied")
        if owner is None:
            raise ValueError("owner must not be None (None marks free slots)")
        self._owner[s] = owner
        self._used[s] = 0
        self._chunk[s] = self.default_chunk if chunk is None \
            else max(1, int(chunk))

    def launch_budgets(self) -> np.ndarray:
        """(B,) int32 per-slot round grants for the next launch: each
        occupied slot gets at most its chunk of its remaining budget; free
        slots get 0 (inert — the decode passes their rows through)."""
        grant = np.where(self.occupied,
                         np.minimum(self._chunk, self.budget - self._used),
                         0).astype(np.int32)
        self._granted = grant
        return grant

    def account(self, rounds: np.ndarray, unresolved: np.ndarray
                ) -> list[tuple[int, Any]]:
        """Fold one launch's per-slot stats back in; frees and returns the
        retired ``(slot, owner)`` pairs in slot order.

        ``rounds`` / ``unresolved`` are the launch's (B,) per-slot rounds
        spent and post-decode unresolved counts (free slots' entries are
        ignored).  Must follow a :meth:`launch_budgets` call — the retire
        test compares against the budgets actually granted.
        """
        rounds = np.asarray(rounds)
        unresolved = np.asarray(unresolved)
        retired: list[tuple[int, Any]] = []
        for s, owner in self.owners():
            self._used[s] += int(rounds[s])
            converged = (int(rounds[s]) < int(self._granted[s])
                         or int(unresolved[s]) == 0)
            if converged or int(self._used[s]) >= self.budget:
                retired.append((s, owner))
        for s, _ in retired:
            self._owner[s] = None
        return retired
