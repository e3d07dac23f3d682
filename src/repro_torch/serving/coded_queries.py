"""Continuous-admission slot server for concurrent coded-compute queries.

Clients submit coded gradient queries — each a ``(θ, straggler_mask)`` pair
with its OWN independent straggler realization — and the batcher serves
them through batched encode→erase→decode→epilogue launches over a fixed
pool of ``B`` decode slots.  Two admission policies share the pool:

``mode="continuous"`` (default)
    Slots retire and refill INDEPENDENTLY between launches.  Every launch
    advances each in-flight slot by at most its chunk of peeling rounds via
    the per-slot adaptive batched decode
    (:meth:`repro_torch.core.engine.CodedComputeEngine.decode_batch` with
    ``adaptive=True`` and a per-slot round-budget vector): a light query
    converges inside its first launch and its slot refills from the FIFO
    queue, while a heavy query keeps its slot across launches.  The slot
    lifecycle (admission, budget chunking, retirement) is
    :class:`repro_torch.serving.slot_lifecycle.SlotPool`, and each query's
    ``priority`` scales its per-launch chunk.  Slot state (partial values,
    erasure mask) stays on the device across launches; the host pulls only
    the ``(B,)`` rounds and unresolved counts and the retired slots'
    gradients.  The worker products of newly admitted slots are computed
    only on launches that admitted.  With ``backend="cuda"`` each launch is
    ONE kernel launch, budgets a device operand.  With a scheme whose
    ``decode_backend`` is "replay", each slot replays its admission-time
    pattern's pre-solved schedule from a
    :class:`~repro_torch.core.schedule_cache.ScheduleCache` (the scheme's,
    or the batcher's own), granted its whole round budget in its admission
    launch; each launch reads the slots' masks to the host once, for the
    cache's keys, and is one replay-kernel launch.

``mode="lockstep"``
    The wave policy, kept as the measured baseline: queries flush in waves
    of ``B`` through one batched launch
    (:meth:`repro_torch.core.coded_step.Scheme2.gradient_batch`); the whole
    wave pays the round budget and refills only when it drains.

Both modes pad partial occupancy with inert slots (θ = 0, no stragglers;
in continuous mode a round budget of 0), which the decode passes through
untouched.  ``launches`` counts the batched decode launches issued.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.schedule_cache import ScheduleCache
from repro_torch.serving.slot_lifecycle import SlotPool

__all__ = ["CodedQuery", "CodedQueryBatcher", "MODES"]

MODES = ("continuous", "lockstep")


@dataclasses.dataclass
class CodedQuery:
    """One coded gradient query: evaluate ∇L̂(θ) under a straggler mask."""

    qid: int
    theta: np.ndarray            # (k,)
    straggler_mask: np.ndarray   # (N,) bool — this query's erasure pattern
    # Priority hint: 1.0 = normal; > 1 = more urgent.  Continuous mode
    # grants the slot ``priority ×`` the pool's per-launch round chunk, so
    # urgent queries spend their decode budget in fewer launches (the total
    # budget is unchanged, so results are too).
    priority: float = 1.0
    gradient: np.ndarray | None = None
    unresolved: int = -1
    done: bool = False
    # per-query serving stats (filled by the batcher):
    rounds: int = 0              # decode rounds charged to this query
    #                              (-1: lockstep wave of an adaptive scheme —
    #                               per-slot rounds unknown at this layer)
    launches: int = 0            # batched launches this query rode in
    admitted_launch: int = -1    # launch index at slot admission
    finished_launch: int = -1    # launch index at retirement
    submitted_s: float = -1.0    # host clock at submit() (-1: never queued)


class CodedQueryBatcher:
    """Slot-pool serving of coded queries over one shared scheme.

    ``scheme`` exposes ``gradient_batch(theta_B, mask_B)`` (e.g.
    :class:`repro_torch.core.coded_step.Scheme2`); continuous mode also
    drives its engine stages directly (``C`` / ``engine`` /
    ``finish_gradient`` / ``worker_mask_to_erasure``) so partial decode
    state can live across launches.  All queries share the scheme's code,
    encoded operator and device; each brings its own straggler realization.
    ``scheme.decode_iters`` is the per-query total round budget in both
    modes; ``rounds_per_launch`` (continuous only, default the full budget)
    caps how many rounds one launch may spend per slot.
    """

    def __init__(self, scheme, *, n_slots: int = 8, mode: str = "continuous",
                 rounds_per_launch: int | None = None):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; want one of {MODES}")
        if not hasattr(scheme, "gradient_batch"):
            raise TypeError(
                f"{type(scheme).__name__} has no gradient_batch; the coded "
                "batcher needs an engine-backed scheme (e.g. Scheme2)")
        if mode == "continuous" and not all(
                hasattr(scheme, a)
                for a in ("engine", "C", "finish_gradient",
                          "worker_mask_to_erasure")):
            raise TypeError(
                f"{type(scheme).__name__} does not expose engine/C/"
                "finish_gradient/worker_mask_to_erasure; continuous "
                "admission needs the engine stages directly")
        self.scheme = scheme
        self.mode = mode
        self.n_slots = n_slots
        self.budget = int(scheme.decode_iters)
        self.rounds_per_launch = (self.budget if rounds_per_launch is None
                                  else int(rounds_per_launch))
        if self.mode == "continuous" and self.rounds_per_launch < 1:
            raise ValueError("rounds_per_launch must be >= 1")
        # Replay serving: each slot's decode is the straight-line replay of
        # its pattern's compiled schedule — there is no round loop to chunk,
        # and carrying partially-peeled state across launches would key the
        # schedule cache on transient partial masks (correct, but every
        # lookup a miss).  Grant the full budget per launch so every slot
        # retires in its admission launch and the cache keys stay the
        # admission-time straggler patterns.
        self._replay = (mode == "continuous"
                        and getattr(scheme, "decode_backend", "") == "replay")
        if self._replay and self.rounds_per_launch < self.budget:
            raise ValueError(
                "backend='replay' serving is straight-line schedule replay: "
                f"rounds_per_launch ({self.rounds_per_launch}) must cover "
                f"the full budget ({self.budget}) so slots never carry "
                "partial decode state across launches")
        self.queue: deque[CodedQuery] = deque()
        self.finished: list[CodedQuery] = []
        self.launches = 0   # batched decode launches issued
        self.device = scheme.C.device
        self._k = int(scheme.C.shape[1])
        self._N = int(scheme.w)
        self.schedule_cache = None
        if mode == "continuous":
            self.engine = scheme.engine
            if self._replay:
                if self.engine.schedule_cache is None:
                    # the scheme brought no cache: the batcher keeps its
                    # own, so per-slot patterns still hit across admissions
                    self.engine = dataclasses.replace(
                        self.engine, schedule_cache=ScheduleCache())
                self.schedule_cache = self.engine.schedule_cache
            B = n_slots
            self.pool = SlotPool(B, self.budget, self.rounds_per_launch)
            self._theta = np.zeros((B, self._k), np.float32)
            self._mask = np.zeros((B, self._N), bool)
            self._fresh = np.zeros((B,), bool)
            # decode state lives on the device across launches (inert slots
            # get budget 0, so the launch passes their rows through)
            self._vals = torch.zeros((B, self._N), dtype=torch.float32,
                                     device=self.device)
            self._erased = torch.zeros((B, self._N), dtype=torch.bool,
                                       device=self.device)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ---------------------------------------------------------------- intake

    def submit(self, query: CodedQuery) -> None:
        if query.theta.shape != (self._k,):
            raise ValueError(f"theta must be ({self._k},); got {query.theta.shape}")
        if query.straggler_mask.shape != (self._N,):
            raise ValueError(
                f"straggler_mask must be ({self._N},); got {query.straggler_mask.shape}")
        query.submitted_s = time.perf_counter()
        self.queue.append(query)

    @property
    def active(self) -> bool:
        if self.mode == "continuous" and self.pool.active:
            return True
        return bool(self.queue)

    # ------------------------------------------------------------- lockstep

    def _run_wave(self, wave: list[CodedQuery]) -> None:
        B = self.n_slots
        theta_B = np.zeros((B, self._k), np.float32)
        mask_B = np.zeros((B, self._N), bool)  # padding slots: no stragglers
        for s, q in enumerate(wave):
            theta_B[s] = q.theta
            mask_B[s] = q.straggler_mask
        grads, unresolved = self.scheme.gradient_batch(
            self._to_device(theta_B), self._to_device(mask_B))
        # Fixed-budget waves charge every query the full budget; a scheme
        # built with adaptive=True stops early per slot inside the launch,
        # so its per-slot rounds are unknown at this layer (-1).
        wave_rounds = (-1 if getattr(self.scheme, "adaptive", False)
                       else self.budget)
        for q in wave:
            q.admitted_launch = self.launches
            q.finished_launch = self.launches
            q.launches = 1
            q.rounds = wave_rounds
        self.launches += 1
        grads = grads.cpu().numpy()
        unresolved = unresolved.cpu().numpy()
        for s, q in enumerate(wave):
            q.gradient = grads[s]
            q.unresolved = int(unresolved[s])
            q.done = True
            self.finished.append(q)

    # ----------------------------------------------------------- continuous

    def _admit(self) -> None:
        """FIFO: fill every free slot from the head of the queue.

        A query's priority scales its per-launch round chunk
        (``priority × rounds_per_launch``, at least 1): urgent queries
        spend their budget in fewer launches, everyone's TOTAL budget is
        the same.
        """
        for s in self.pool.free_slots():
            if not self.queue:
                break
            q = self.queue.popleft()
            self.pool.admit(
                s, q, chunk=round(self.rounds_per_launch * q.priority))
            self._theta[s] = q.theta
            self._mask[s] = q.straggler_mask
            self._fresh[s] = True
            q.admitted_launch = self.launches

    def _encode_fresh(self) -> None:
        """Admission-time encode: fresh slots start from their erased worker
        products; in-flight slots keep their carried partial decode state."""
        scheme, eng = self.scheme, self.engine
        fresh = self._to_device(self._fresh)[:, None]
        Z = self._to_device(self._theta) @ scheme.C.T               # (B, N)
        erased_new = scheme.worker_mask_to_erasure(self._to_device(self._mask))
        self._vals = torch.where(fresh, eng.erase(Z, erased_new), self._vals)
        self._erased = torch.where(fresh, erased_new, self._erased)
        self._fresh[:] = False

    def _step_continuous(self) -> None:
        scheme, eng = self.scheme, self.engine
        budgets = self.pool.launch_budgets()
        if self._fresh.any():
            self._encode_fresh()
        dec = eng.decode_batch(self._vals, self._erased, adaptive=True,
                               budgets=self._to_device(budgets))
        c_hat, unresolved = eng.systematic(dec)
        # the scheme's own epilogue (zero-filled b̂ + debias), shared with
        # gradient / gradient_batch
        g, n_unres = scheme.finish_gradient(c_hat, unresolved)
        self._vals, self._erased = dec.values, dec.erased
        launch_idx = self.launches
        self.launches += 1
        # the launch's only sync: (B,) rounds, unresolved and erased counts
        rounds, unres, ecnt = torch.stack(
            [dec.rounds_used.long(), n_unres.long(),
             dec.erased.sum(dim=1)]).cpu().numpy()
        for s, q in self.pool.owners():
            q.launches += 1
            q.rounds += int(rounds[s])
        retired = self.pool.account(rounds, ecnt)
        if not retired:
            return
        slots = torch.tensor([s for s, _ in retired], device=self.device)
        grads = g[slots].cpu().numpy()
        for (s, q), grad in zip(retired, grads):
            self._theta[s] = 0.0               # the slot is inert until refilled
            self._mask[s] = False
            q.gradient = grad
            q.unresolved = int(unres[s])
            q.finished_launch = launch_idx
            q.done = True
            self.finished.append(q)

    # ------------------------------------------------------------------ run

    def run(self) -> list[CodedQuery]:
        """Serve until the queue and all slots drain; returns finished
        queries (continuous mode: in completion order, which is FIFO up to
        heavy queries finishing later)."""
        if self.mode == "lockstep":
            while self.queue:
                wave = [self.queue.popleft()
                        for _ in range(min(self.n_slots, len(self.queue)))]
                self._run_wave(wave)
            return self.finished
        while self.active:
            self._admit()
            self._step_continuous()
        return self.finished
