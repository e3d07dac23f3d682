"""Iterative (peeling) erasure decoder for real-valued LDPC codes, in PyTorch.

The classic peeling decoder resolves degree-1 checks one at a time.  On the
card we use the equivalent *flooding* schedule: in each round, every parity
check with exactly one erased neighbour resolves that neighbour.  The fixed
number of rounds ``D`` is exactly the paper's decoding-iteration knob — the
quality of the recovered gradient is monotone in ``D`` (Remark 3).

Four entry points, one per contract:

==============================  ============================================
entry point                     contract
==============================  ============================================
:func:`peel_decode`             one pattern, exactly ``iters`` rounds
:func:`peel_decode_batch`       B independent patterns, exactly ``iters``
                                rounds each
:func:`peel_decode_adaptive`    one pattern, early exit: stop when a round
                                resolves nothing, nothing is erased, or
                                ``max_iters`` rounds have run
:func:`peel_decode_batch_adaptive`
                                B patterns, each with its own early exit
                                under its own round budget
==============================  ============================================

Backends (``backend=``):

=============  ==============================================================
backend        what runs
=============  ==============================================================
"dense"        the reference: dense ``H``-structured tensor ops per round
               (mask matvec, matmul, argmax) — O(p·N·V) work.  When several
               checks resolve one coordinate, the HIGHEST check row wins, as
               the JAX package's dense scatter does.
"cuda"         the hand-written flooding kernel
               (:mod:`repro_torch.kernels.ldpc_peel`): the whole decode in
               one launch over the code's neighbour table.  The LOWEST check
               row wins, as in the JAX package's fused Pallas decodes.  For
               CPU tensors the wrappers run the kernel's plain PyTorch
               versions.
"cuda_seeded"  the seeded flooding kernel: the same four contracts and the
               same "lo" tie-break with NO table — each check row is
               regenerated from the code's seed inside the round.  Needs a
               seeded parity-only code: :func:`~repro_torch.core.ldpc.make_seeded_ldpc`
               (H materialized) or the structure-only
               :class:`~repro_torch.core.ldpc.SeededLDPC`, which never builds
               H at any size.  On a ``make_seeded_ldpc`` code it follows the
               trajectory and computes the values of "cuda" bit for bit.
"replay"       straight-line REPLAY of a pre-solved :class:`PeelSchedule`: the
               elimination order is a pure function of (code, erasure
               pattern), so :func:`compile_peel_schedule` solves it once on
               the host, and the replay kernel (``csrc/replay_decode.cu``)
               runs only the resolving checks' arithmetic, O(resolved
               edges).  Pass the schedule (``schedule=`` / per-slot
               ``schedules=``, e.g. from a
               :class:`repro_torch.core.schedule_cache.ScheduleCache` hit)
               or let the mask be solved on the fly.  Values are those of
               the JAX package's replay, bit for bit: the single-pattern
               contracts keep the HIGHEST check row where several resolve one
               coordinate, the batched ones the LOWEST, and every resolving
               sum is the Neumaier chain of its ``_edge_sum``; adaptive round
               counts follow the early-exit rule, probe round included.
               Needs an :class:`LDPCCode`; "auto" never picks it.
"auto"         "cuda_seeded" for a seeded parity-only code, else "cuda".
=============  ==============================================================

A :class:`SeededLDPC` decodes only with "cuda_seeded" (or "auto"); other
names raise, as "cuda_seeded" does on a code without a seed.  The JAX
package's ``seeded_mode`` knob ("dense_tile" | "gather" | "auto") picks
between two TPU round layouts that follow the same trajectory; the port
carries no such knob, since its one CUDA round stands for both.  TPU
layout choices are means, not contracts.

All backends follow the same erasure trajectory (solvability is an exact
count of erased neighbours), so masks and round counts agree exactly;
decoded values agree up to f32 summation order and the choice among checks
that resolve one coordinate.

``values`` may be ``(N,)`` scalars (the paper's inner products) or ``(N, V)``
payloads (the blocked Scheme 2, where one straggler erases the same
coordinate of every block); the batched entry points take ``(B, N)`` or
``(B, N, V)``.  Unresolved coordinates keep their input values and are
flagged in the returned mask; callers zero-fill them (Lemma 1).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.ldpc import (LDPCCode, SeededLDPC, SeededStructure,
                                   seeded_structure, seeded_structure_of)
from repro_torch.kernels.ldpc_peel import (CodeTables, peel_decode_adaptive_cuda,
                                           peel_decode_adaptive_seeded_cuda,
                                           peel_decode_batch_adaptive_cuda,
                                           peel_decode_batch_adaptive_seeded_cuda,
                                           peel_decode_batch_cuda,
                                           peel_decode_batch_seeded_cuda,
                                           peel_decode_cuda, peel_decode_replay_cuda,
                                           peel_decode_seeded_cuda)
from repro_torch.kernels.ldpc_peel.ops import ReplayPack, check_replay_host
from repro_torch.kernels.ldpc_peel.ref import adaptive_loop

__all__ = ["DecodeResult", "BACKENDS", "resolve_backend", "peel_round",
           "peel_fixed_dense", "peel_decode", "peel_decode_batch",
           "peel_decode_adaptive", "peel_decode_batch_adaptive", "code_tables",
           "seeded_spec", "PeelSchedule", "ScheduleLookup", "erasure_mask_key",
           "compile_peel_schedule", "replay_operands"]

BACKENDS = ("auto", "dense", "cuda", "cuda_seeded", "replay")


class DecodeResult(NamedTuple):
    values: torch.Tensor       # (N,) / (N, V); batched: (B, N) / (B, N, V)
    erased: torch.Tensor       # (N,) bool (batched: (B, N)); True where unresolved
    # int (== D) for the fixed-D decodes; a 0-d int32 tensor for the
    # adaptive decode and the per-slot (B,) int32 tensor for the batched
    # adaptive decode, both on the values' device.
    rounds_used: int | torch.Tensor


def resolve_backend(backend: str, code=None) -> str:
    """Resolve the ``backend=`` knob to "dense", "cuda", "cuda_seeded" or
    "replay" (see the module docstring), by the JAX package's rules for its
    seeded backend: "auto" picks "cuda_seeded" for a seeded parity-only
    ``code`` (a :class:`SeededLDPC` or kind "ldpc-seeded") and "cuda"
    otherwise, never "replay".  Raises on unknown names, on "cuda_seeded"
    for a code without a seed, and on any other backend for a
    structure-only :class:`SeededLDPC`.  Without a ``code`` only the name
    is checked."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown decode backend {backend!r}; "
                         f"want one of {BACKENDS}")
    seeded = getattr(code, "kind", None) == "ldpc-seeded"
    if backend == "auto":
        backend = "cuda_seeded" if seeded else "cuda"
    if code is None:
        return backend
    if backend == "cuda_seeded" and not seeded:
        kind = getattr(code, "kind", type(code).__name__)
        raise ValueError(
            "backend='cuda_seeded' needs a seeded parity-only code "
            "(make_seeded_ldpc / SeededLDPC) whose H is regenerable from "
            f"its seed; got {kind!r}")
    if isinstance(code, SeededLDPC) and backend != "cuda_seeded":
        raise ValueError(
            f"backend={backend!r} needs a materialized H, but a SeededLDPC "
            "is structure-only; use backend='cuda_seeded'/'auto' or build "
            "the code with make_seeded_ldpc")
    return backend


_seeded_structure = functools.cache(seeded_structure)


def seeded_spec(code) -> SeededStructure:
    """The :class:`SeededStructure` the seeded kernel regenerates a seeded
    parity-only code's H from (``make_seeded_ldpc`` or :class:`SeededLDPC`),
    derived once per distinct code.  Raises for a code without a seed."""
    if getattr(code, "kind", None) != "ldpc-seeded":
        return seeded_structure_of(code)              # raises
    return _seeded_structure(code.p, code.N, code.r, code.seed)


def _check_ascending(idx: np.ndarray, N: int) -> None:
    """Raise unless each row of ``idx`` holds its columns in strictly
    ascending order, then only the sentinel ``N``: the order the table
    kernel and its plain versions sum in."""
    d = np.diff(idx.astype(np.int64), axis=1)
    ok = (d > 0) | ((idx[:, 1:] == N) & (d == 0))
    if idx.size and (idx.min() < 0 or idx.max() > N or not ok.all()):
        raise ValueError("check_idx must hold each row's columns in ascending "
                         f"order, padded after them with the sentinel N={N}")


def code_tables(code: LDPCCode, device) -> CodeTables:
    """The code's neighbour table on ``device``, uploaded once per device;
    raises unless each row's columns ascend (see :func:`_check_ascending`)."""
    key = ("tables", torch.device(device))
    hit = code.device_cache.get(key)
    if hit is None:
        _check_ascending(np.asarray(code.check_idx), code.N)
        hit = CodeTables(
            torch.as_tensor(code.check_idx, dtype=torch.int32).to(device),
            torch.as_tensor(code.check_coeff, dtype=torch.float32).to(device),
            code.N)
        code.device_cache[key] = hit
    return hit


def _mats(code: LDPCCode, dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The code's dense ``H`` and its support on ``device``, built once per
    device and dtype."""
    key = ("dense", torch.device(device), dtype)
    hit = code.device_cache.get(key)
    if hit is None:
        H = torch.as_tensor(code.H).to(device, dtype)
        hit = (H, H != 0.0)
        code.device_cache[key] = hit
    return hit


# --------------------------------------------------------------- dense round


def peel_round(H: torch.Tensor, Hb: torch.Tensor, values: torch.Tensor,
               erased: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One flooding round (dense). values: (N, V), erased: (N,) bool, or a
    batch of patterns: values (B, N, V), erased (B, N).

    For every check row ``i`` with exactly one erased neighbour ``j``:
    ``c_j = -(sum_{j' known} H[i, j'] c_{j'}) / H[i, j]``.  Where several
    rows resolve one coordinate, the highest row's value is kept.
    """
    p, N = H.shape
    e = erased.to(H.dtype)
    cnt = e @ Hb.to(H.dtype).T                     # (..., p) erased neighbours
    solvable = cnt == 1.0
    known = torch.where(erased[..., None], torch.zeros_like(values), values)
    row_sums = H @ known                           # (..., p, V)
    # first erased neighbour of each row; arbitrary for non-solvable rows
    pos = torch.argmax((Hb & erased[..., None, :]).to(torch.uint8), dim=-1)
    rows = torch.arange(p, device=H.device)
    coeff = H[rows, pos]                           # (..., p)
    new_val = -row_sums / torch.where(coeff == 0.0, 1.0, coeff)[..., None]
    safe_pos = torch.where(solvable, pos, N)       # N = dropped
    winner = torch.full((*safe_pos.shape[:-1], N + 1), -1, dtype=torch.long,
                        device=H.device)
    winner.scatter_reduce_(-1, safe_pos, rows.expand_as(safe_pos),
                           reduce="amax")
    winner = winner[..., :N]
    resolved = winner >= 0
    take = winner.clamp(min=0)[..., None].expand_as(values)
    values = torch.where(resolved[..., None],
                         torch.gather(new_val, -2, take), values)
    return values, erased & ~resolved


def peel_fixed_dense(H, Hb, values, erased, iters: int):
    """``iters`` dense flooding rounds; ``values`` (N, V) / ``erased`` (N,),
    or batched (B, N, V) / (B, N)."""
    for _ in range(int(iters)):
        values, erased = peel_round(H, Hb, values, erased)
    return values, erased


# ------------------------------------------------- pattern-compiled replay


class PeelSchedule:
    """Pre-solved peeling elimination order for ONE ``(code, erasure)`` pair.

    The flooding trajectory — which check resolves which variable in which
    round — is a pure function of the code structure and the erasure mask,
    never of the payload values.  :func:`compile_peel_schedule` runs that
    trajectory ONCE symbolically (host-side numpy, to fixpoint) and records,
    per resolved variable: its flooding round (``offsets`` delimits the
    per-round segments, so replay parallelizes within a round), its gathered
    neighbor columns, and the pre-masked edge weights — under BOTH duplicate
    -check tie-break rules:

    * ``idx_hi``/``w_hi``/``coeff_hi`` — HIGHEST check row wins, what the
      single-pattern replay contracts use (the JAX package's dense and
      sparse scatters are last-write-wins over ascending rows);
    * ``idx_lo``/``w_lo``/``coeff_lo`` — LOWEST check row wins, what the
      batched replay contracts and the flooding kernels use.

    Duplicate winners write consistent values (parity checks of one
    codeword), so the choice only pins f32 rounding.  Because flooding is
    monotone (a round that resolves nothing ends the decode), the resolving
    rounds form a prefix: replay under a smaller round budget applies a
    prefix of the same schedule.

    Instances hash and compare by identity (the arrays are frozen after
    construction).  The replay kernel's packed operands are built once per
    ``(rule, device)`` and kept in ``_ops``, so replaying a cached schedule
    uploads nothing.
    """

    __slots__ = ("N", "r_max", "n_erased", "n_rounds", "n_resolved",
                 "fully_resolved", "offsets", "target",
                 "idx_lo", "w_lo", "coeff_lo",
                 "idx_hi", "w_hi", "coeff_hi", "mask_key", "_ops")

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"PeelSchedule(N={self.N}, n_erased={self.n_erased}, "
                f"n_resolved={self.n_resolved}, n_rounds={self.n_rounds}, "
                f"fully_resolved={self.fully_resolved})")


def _host_mask(erased) -> np.ndarray:
    """A mask (numpy, or a tensor on any device: one read) as a numpy bool
    array."""
    if isinstance(erased, torch.Tensor):
        return erased.detach().to("cpu", torch.bool).numpy()
    return np.asarray(erased, bool)


def erasure_mask_key(erased) -> bytes:
    """Canonical packed-bitmask key of an erasure mask — the schedule-cache
    key and the schedule/mask consistency fingerprint."""
    return np.packbits(_host_mask(erased)).tobytes()


def compile_peel_schedule(code: LDPCCode, erased) -> PeelSchedule:
    """Symbolically solve the peeling decode for ``(code, erased)``.

    Runs the flooding schedule on the erasure mask alone (host-side numpy,
    no payload arithmetic) until fixpoint and returns the
    :class:`PeelSchedule` that :func:`peel_decode` et al. replay under
    ``backend="replay"``.  Work is O(rounds · edges) once per pattern;
    every replay of the result is O(resolved edges).  ``erased`` is an
    (N,) mask, numpy or a tensor on any device.
    """
    if not isinstance(code, LDPCCode):
        raise ValueError(
            "compile_peel_schedule needs an LDPCCode (neighbor table); got "
            f"{type(code).__name__!r}")
    idx = np.asarray(code.check_idx)          # (p, r_max), sentinel N
    coeff = np.asarray(code.check_coeff)      # (p, r_max), 0-padded
    N = int(code.N)
    e0 = _host_mask(erased)
    if e0.shape != (N,):
        raise ValueError(f"erased must be ({N},); got {e0.shape}")
    e = np.zeros(N + 1, bool)
    e[:N] = e0

    offsets = [0]
    tgt_parts: list[np.ndarray] = []
    lo_parts: list[np.ndarray] = []
    hi_parts: list[np.ndarray] = []
    while True:
        ne = e[idx]                           # (p, r_max)
        rows = np.flatnonzero(ne.sum(axis=1) == 1)
        if rows.size == 0:
            break
        slot = ne[rows].argmax(axis=1)
        tgts = idx[rows, slot]
        # Per duplicate-resolved variable: lowest and highest check row
        # (``rows`` ascends, so first/last occurrence = lowest/highest).
        uniq, first = np.unique(tgts, return_index=True)
        _, first_rev = np.unique(tgts[::-1], return_index=True)
        last = tgts.size - 1 - first_rev
        tgt_parts.append(uniq.astype(np.int32))
        lo_parts.append(rows[first].astype(np.int32))
        hi_parts.append(rows[last].astype(np.int32))
        offsets.append(offsets[-1] + uniq.size)
        e[uniq] = False

    def _cat(parts):
        return (np.concatenate(parts) if parts
                else np.zeros((0,), np.int32))

    target = _cat(tgt_parts)
    n = int(target.size)
    sched = PeelSchedule.__new__(PeelSchedule)
    sched.N = N
    sched.r_max = int(idx.shape[1])
    sched.n_erased = int(e0.sum())
    sched.n_rounds = len(offsets) - 1
    sched.n_resolved = n
    sched.fully_resolved = not e[:N].any()
    sched.offsets = np.asarray(offsets, np.int32)
    sched.target = target
    for rule, rows_all in (("lo", _cat(lo_parts)), ("hi", _cat(hi_parts))):
        nidx = idx[rows_all]                  # (n, r_max)
        ncoeff = coeff[rows_all]
        tslot = (nidx == target[:, None]).argmax(axis=1)
        # Known-neighbor weights exactly as the flooding rounds compute them
        # (coeff * (1 - erased)): the target slot is the ONLY erased
        # neighbor of a firing check, so the multiply — not an overwrite —
        # preserves signed zeros bit-for-bit.
        known_f = np.ones_like(ncoeff)
        known_f[np.arange(n), tslot] = 0.0
        setattr(sched, f"idx_{rule}", nidx.astype(np.int32))
        setattr(sched, f"w_{rule}", ncoeff * known_f)
        setattr(sched, f"coeff_{rule}", ncoeff[np.arange(n), tslot])
    sched.mask_key = erasure_mask_key(e0)
    sched._ops = {}
    return sched


def _replay_rounds_used(sched: PeelSchedule, budget: int) -> int:
    """Round count matching the adaptive decode's stopping rule
    ``(d < budget) & progressed & e.any()``, from the schedule alone:
    0 if nothing was erased, else min(budget, R) when the pattern fully
    resolves in R rounds, else min(budget, R+1) — one probe round past the
    fixpoint observes no progress.  The kernel applies the same rule on
    the device, from the budgets there and this rule's count under an
    unbounded budget (the pack's ``probe``)."""
    if sched.n_erased == 0:
        return 0
    probe = sched.n_rounds + (0 if sched.fully_resolved else 1)
    return max(0, min(int(budget), probe))


def _device_key(device) -> torch.device:
    """``device`` with its index filled in, so "cuda" and "cuda:0" share
    one cached copy."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _sched_mask(sched: PeelSchedule, device: torch.device) -> torch.Tensor:
    """The schedule's (N,) erasure mask on ``device``, from its key, built
    once per device."""
    device = _device_key(device)
    key = ("mask", device)
    mask = sched._ops.get(key)
    if mask is None:
        bits = np.unpackbits(np.frombuffer(sched.mask_key, np.uint8))[:sched.N]
        mask = torch.from_numpy(bits.astype(bool)).to(device)
        sched._ops[key] = mask
    return mask


class ScheduleLookup(tuple):
    """The schedules ``cache`` holds for the rows of the mask tensor
    ``erased`` ((B, N), or (N,) for one), looked up with the mask read to
    the host once and each schedule's key checked against those bytes
    there.  It remembers the tensor and its version, so a replay decode
    handed this very tensor, unmodified since, skips the device compare of
    the masks (one sync fewer a launch).  Pass it as ``schedules=``, or as
    ``schedule=`` when it holds one schedule."""

    def __new__(cls, cache, code, erased: torch.Tensor):
        host = _host_mask(erased)
        rows = host if host.ndim == 2 else host[None]
        scheds = cache.get_batch(code, rows)
        for s, row in zip(scheds, rows):
            if s.mask_key != erasure_mask_key(row):
                raise ValueError("the schedule cache returned a schedule for "
                                 "another erasure mask")
        self = super().__new__(cls, scheds)
        self.erased, self.version = erased, erased._version
        return self

    def of(self, erased: torch.Tensor) -> bool:
        """Whether these schedules were looked up from ``erased`` as it
        stands now."""
        return self.erased is erased and erased._version == self.version


def _check_schedules(scheds, code, erased: torch.Tensor) -> None:
    """Raise unless every schedule was solved for ``code`` and for its
    slot's row of ``erased`` ((B, N), or (N,) for one schedule).  The masks
    are compared on their own device (one boolean comes back), unless
    ``scheds`` is a :class:`ScheduleLookup` of this very tensor."""
    for s in scheds:
        if not isinstance(s, PeelSchedule):
            raise ValueError(f"schedule must be a PeelSchedule; got "
                             f"{type(s).__name__!r}")
        if s.N != code.N:
            raise ValueError(f"schedule was solved for N={s.N}, code has "
                             f"N={code.N}")
    if isinstance(scheds, ScheduleLookup) and scheds.of(erased):
        return
    masks = torch.stack([_sched_mask(s, erased.device) for s in scheds])
    if not torch.equal(masks[0] if erased.ndim == 1 else masks, erased):
        raise ValueError(
            "schedule does not match the erasure mask being decoded "
            "(stale cache entry or wrong pattern)")


def _replay_pack(sched: PeelSchedule, rule: str, device: torch.device) -> ReplayPack:
    """The schedule as the replay kernel's one-slot operands under ``rule``
    on ``device``, built once per (rule, device) and cached on it."""
    device = _device_key(device)
    key = (rule, device)
    pack = sched._ops.get(key)
    if pack is None:
        probe = _replay_rounds_used(sched, sched.n_rounds + 1)
        host = (getattr(sched, f"idx_{rule}"), getattr(sched, f"w_{rule}"),
                getattr(sched, f"coeff_{rule}"), sched.target, sched.offsets,
                np.array([[sched.n_resolved, sched.n_rounds, probe]], np.int32))
        check_replay_host(*host, N=sched.N)
        pack = ReplayPack(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                            for a in host))
        sched._ops[key] = pack
    return pack


def replay_operands(scheds, rule: str, device: torch.device) -> ReplayPack:
    """The replay kernel's operands for one schedule per slot under
    ``rule`` ("hi" or "lo"): each schedule's cached pack on ``device``,
    joined there (a cache hit uploads nothing)."""
    packs = [_replay_pack(s, rule, device) for s in scheds]
    if len(packs) == 1:
        return packs[0]
    return ReplayPack(*(torch.cat(parts) for parts in zip(*packs)))


def _replay(scheds, rule: str, v: torch.Tensor, e: torch.Tensor, budgets):
    """Replay one schedule per slot of ``v (B, N, V)`` / ``e (B, N)`` in one
    launch, ``budgets`` an int or a ``(B,)`` int32 tensor on the values'
    device; returns ``(values, erased, rounds (B,) int32)``."""
    out_v, out_e, rounds = peel_decode_replay_cuda(
        replay_operands(scheds, rule, v.device), v.to(torch.float32).contiguous(),
        e.contiguous(), budgets)
    return out_v.to(v.dtype), out_e, rounds


def _replay_schedule(code, erased: torch.Tensor, schedule) -> PeelSchedule:
    """The given schedule, checked against ``erased (N,)``, or one solved
    from it."""
    if schedule is None:
        return compile_peel_schedule(code, erased)
    scheds = schedule if isinstance(schedule, ScheduleLookup) else (schedule,)
    if len(scheds) != 1:
        raise ValueError(f"schedule= takes one schedule; got {len(scheds)}")
    _check_schedules(scheds, code, erased)
    return scheds[0]


def _replay_schedules(code, erased: torch.Tensor, schedules, B: int) -> tuple:
    """Per-slot schedules for the batched replay: the given ones, checked
    against ``erased (B, N)``, or ones solved from its rows (read to the
    host once)."""
    if schedules is None:
        masks = _host_mask(erased)
        return tuple(compile_peel_schedule(code, masks[b]) for b in range(B))
    scheds = schedules if isinstance(schedules, ScheduleLookup) else tuple(schedules)
    if len(scheds) != B:
        raise ValueError(f"schedules must have length {B}; got {len(scheds)}")
    _check_schedules(scheds, code, erased)
    return scheds


def _no_schedule_unless_replay(backend: str, given, name: str) -> str:
    """``backend`` resolved; raises when ``name=`` is given without replay."""
    if given is not None and backend != "replay":
        raise ValueError(f"{name}= is only meaningful with backend='replay'")
    return backend


# ----------------------------------------------------------- entry points


def _budget_vector(budgets, B: int, max_iters: int, device) -> torch.Tensor:
    if budgets is None:
        return torch.full((B,), int(max_iters), dtype=torch.int32,
                          device=device)
    budgets = torch.as_tensor(budgets).to(device=device, dtype=torch.int32)
    if tuple(budgets.shape) != (B,):
        raise ValueError(f"budgets must be ({B},); got {tuple(budgets.shape)}")
    return budgets.contiguous()


def _batched(values: torch.Tensor) -> tuple[torch.Tensor, bool]:
    if values.ndim not in (2, 3):
        raise ValueError(f"batched values must be (B, N) or (B, N, V); "
                         f"got shape {tuple(values.shape)}")
    squeeze = values.ndim == 2
    return (values[..., None] if squeeze else values), squeeze


# The wrappers of one contract: (table kernel, seeded kernel, dense reference).
_FIXED = (peel_decode_cuda, peel_decode_seeded_cuda, peel_fixed_dense)
_BATCH = (peel_decode_batch_cuda, peel_decode_batch_seeded_cuda, peel_fixed_dense)


def _run(code, backend: str, v: torch.Tensor, e: torch.Tensor, fns, *args):
    """Dispatch to the table kernel's wrapper ``cuda_fn(tables, v, e,
    *args)``, the seeded kernel's ``seeded_fn(spec, v, e, *args)`` or the
    dense reference ``dense_fn(H, Hb, v, e, *args)``, with ``fns = (cuda_fn,
    seeded_fn, dense_fn)``; results come back in ``v``'s dtype."""
    cuda_fn, seeded_fn, dense_fn = fns
    backend = resolve_backend(backend, code)
    if backend == "dense":
        H, Hb = _mats(code, v.dtype, v.device)
        out = dense_fn(H, Hb, v, e, *args)
    else:
        v32, e = v.to(torch.float32).contiguous(), e.contiguous()
        out = (seeded_fn(seeded_spec(code), v32, e, *args)
               if backend == "cuda_seeded"
               else cuda_fn(code_tables(code, v.device), v32, e, *args))
    return (out[0].to(v.dtype), *out[1:])


def peel_decode(code: LDPCCode | SeededLDPC, values: torch.Tensor,
                erased: torch.Tensor, iters: int, *,
                backend: str = "auto",
                schedule: PeelSchedule | None = None) -> DecodeResult:
    """Run exactly ``iters`` flooding rounds (the paper's fixed-D decode)
    on the device ``values`` lie on.  ``schedule`` feeds
    ``backend="replay"`` a pre-solved :class:`PeelSchedule` (e.g. a
    :mod:`repro_torch.core.schedule_cache` hit); without it the pattern is
    solved from the mask, which is read to the host."""
    backend = _no_schedule_unless_replay(resolve_backend(backend, code),
                                         schedule, "schedule")
    squeeze = values.ndim == 1
    v = values[:, None] if squeeze else values
    e = erased.to(torch.bool)
    if backend == "replay":
        sched = _replay_schedule(code, e, schedule)
        v, e, _ = _replay([sched], "hi", v[None], e[None], int(iters))
        v, e = v[0], e[0]
    else:
        v, e = _run(code, backend, v, e, _FIXED, int(iters))
    return DecodeResult(v[:, 0] if squeeze else v, e, int(iters))


def peel_decode_batch(code: LDPCCode | SeededLDPC, values: torch.Tensor,
                      erased: torch.Tensor, iters: int, *,
                      backend: str = "auto", schedules=None) -> DecodeResult:
    """Decode ``B`` INDEPENDENT erasure patterns in one launch.

    ``values`` is ``(B, N)`` or ``(B, N, V)``; ``erased`` is ``(B, N)`` bool
    — one straggler realization per batch element.  Each element follows
    the trajectory :func:`peel_decode` gives it alone; the batch axis only
    amortizes the launch and shares the code's table.  This is the serving
    primitive: many concurrent coded queries, each with its own straggler
    mask (see :mod:`repro_torch.serving.coded_queries`).  With
    ``backend="replay"`` slot ``b`` replays ``schedules[b]`` (or one solved
    from its mask).
    """
    backend = _no_schedule_unless_replay(resolve_backend(backend, code),
                                         schedules, "schedules")
    v, squeeze = _batched(values)
    e = erased.to(torch.bool)
    if backend == "replay":
        scheds = _replay_schedules(code, e, schedules, v.shape[0])
        v, e, _ = _replay(scheds, "lo", v, e, int(iters))
    else:
        v, e = _run(code, backend, v, e, _BATCH, int(iters))
    return DecodeResult(v[..., 0] if squeeze else v, e, int(iters))


def _dense_adaptive(H, Hb, v, e, budgets):
    return adaptive_loop(lambda v_, e_: peel_round(H, Hb, v_, e_), v, e,
                         budgets)


def _dense_adaptive_one(H, Hb, v, e, max_iters: int):
    budgets = torch.full((1,), max_iters, dtype=torch.int32, device=v.device)
    v, e, d = _dense_adaptive(H, Hb, v[None], e[None], budgets)
    return v[0], e[0], d[0]


def peel_decode_adaptive(code: LDPCCode | SeededLDPC, values: torch.Tensor,
                         erased: torch.Tensor, max_iters: int | None = None,
                         *, backend: str = "auto",
                         schedule: PeelSchedule | None = None) -> DecodeResult:
    """Decode until a round resolves nothing, nothing is erased, or
    ``max_iters`` rounds (default ``N``) have run.

    This is the "decoding effort adapts to the number of stragglers" mode:
    with few erasures the decode stops after 1-2 rounds.  ``rounds_used``
    is a 0-d int32 tensor on the values' device and counts the last,
    no-progress probe round of a pattern that does not fully resolve.
    ``backend="replay"`` knows the fixpoint from the schedule: it applies
    ``min(max_iters, R)`` rounds and counts the rounds by the same rule.
    """
    backend = _no_schedule_unless_replay(resolve_backend(backend, code),
                                         schedule, "schedule")
    max_iters = code.N if max_iters is None else int(max_iters)
    squeeze = values.ndim == 1
    v = values[:, None] if squeeze else values
    e = erased.to(torch.bool)
    if backend == "replay":
        sched = _replay_schedule(code, e, schedule)
        v, e, d = (x[0] for x in _replay([sched], "hi", v[None], e[None], max_iters))
    else:
        v, e, d = _run(code, backend, v, e,
                       (peel_decode_adaptive_cuda, peel_decode_adaptive_seeded_cuda,
                        _dense_adaptive_one), max_iters)
    return DecodeResult(v[:, 0] if squeeze else v, e, d)


def peel_decode_batch_adaptive(code: LDPCCode | SeededLDPC, values: torch.Tensor,
                               erased: torch.Tensor,
                               max_iters: int | None = None, *,
                               backend: str = "auto",
                               budgets=None, schedules=None) -> DecodeResult:
    """Decode ``B`` independent patterns with PER-SLOT early exit, one launch.

    The batched form of :func:`peel_decode_adaptive`: every slot follows
    its own stopping rule (no progress, nothing erased, or its round budget
    spent) and reports its own round count — ``rounds_used`` is the
    per-slot ``(B,)`` int32 tensor, on the device.  No slot's trajectory
    depends on any other slot's.

    ``budgets`` optionally gives each slot its own round budget ``(B,)``
    (a tensor on the values' device, or anything ``torch.as_tensor``
    takes); a slot with budget 0 comes back untouched with 0 rounds.
    Without it every slot gets ``max_iters`` (default ``N``).  On the card
    the budgets are a kernel operand: varying them rebuilds nothing and
    syncs nothing.  This is the primitive behind continuous-admission
    serving (:mod:`repro_torch.serving.coded_queries`).  With
    ``backend="replay"`` slot ``b`` replays ``schedules[b]`` (or one solved
    from its mask) under its budget, and its round count comes from the
    schedule, computed on the device.
    """
    backend = _no_schedule_unless_replay(resolve_backend(backend, code),
                                         schedules, "schedules")
    v, squeeze = _batched(values)
    if max_iters is None:
        max_iters = code.N
    budgets = _budget_vector(budgets, v.shape[0], max_iters, v.device)
    e = erased.to(torch.bool)
    if backend == "replay":
        scheds = _replay_schedules(code, e, schedules, v.shape[0])
        v, e, d = _replay(scheds, "lo", v, e, budgets)
    else:
        v, e, d = _run(code, backend, v, e,
                       (peel_decode_batch_adaptive_cuda,
                        peel_decode_batch_adaptive_seeded_cuda, _dense_adaptive),
                       budgets)
    return DecodeResult(v[..., 0] if squeeze else v, e, d)
