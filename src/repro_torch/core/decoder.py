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

import torch

from repro_torch.core.ldpc import (LDPCCode, SeededLDPC, SeededStructure,
                                   seeded_structure, seeded_structure_of)
from repro_torch.kernels.ldpc_peel import (CodeTables, peel_decode_adaptive_cuda,
                                           peel_decode_adaptive_seeded_cuda,
                                           peel_decode_batch_adaptive_cuda,
                                           peel_decode_batch_adaptive_seeded_cuda,
                                           peel_decode_batch_cuda,
                                           peel_decode_batch_seeded_cuda,
                                           peel_decode_cuda, peel_decode_seeded_cuda)
from repro_torch.kernels.ldpc_peel.ref import adaptive_loop

__all__ = ["DecodeResult", "BACKENDS", "resolve_backend", "peel_round",
           "peel_fixed_dense", "peel_decode", "peel_decode_batch",
           "peel_decode_adaptive", "peel_decode_batch_adaptive", "code_tables",
           "seeded_spec"]

BACKENDS = ("auto", "dense", "cuda", "cuda_seeded")


class DecodeResult(NamedTuple):
    values: torch.Tensor       # (N,) / (N, V); batched: (B, N) / (B, N, V)
    erased: torch.Tensor       # (N,) bool (batched: (B, N)); True where unresolved
    # int (== D) for the fixed-D decodes; a 0-d int32 tensor for the
    # adaptive decode and the per-slot (B,) int32 tensor for the batched
    # adaptive decode, both on the values' device.
    rounds_used: int | torch.Tensor


def resolve_backend(backend: str, code=None) -> str:
    """Resolve the ``backend=`` knob to "dense", "cuda" or "cuda_seeded"
    (see the module docstring), by the JAX package's rules for its seeded
    backend: "auto" picks "cuda_seeded" for a seeded parity-only ``code``
    (a :class:`SeededLDPC` or kind "ldpc-seeded") and "cuda" otherwise.
    Raises on unknown names, on "cuda_seeded" for a code without a seed,
    and on any other backend for a structure-only :class:`SeededLDPC`.
    Without a ``code`` only the name is checked."""
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


def code_tables(code: LDPCCode, device) -> CodeTables:
    """The code's neighbour table on ``device``, uploaded once per device."""
    key = ("tables", torch.device(device))
    hit = code.device_cache.get(key)
    if hit is None:
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
                backend: str = "auto") -> DecodeResult:
    """Run exactly ``iters`` flooding rounds (the paper's fixed-D decode)
    on the device ``values`` lie on."""
    squeeze = values.ndim == 1
    v = values[:, None] if squeeze else values
    v, e = _run(code, backend, v, erased.to(torch.bool), _FIXED, int(iters))
    return DecodeResult(v[:, 0] if squeeze else v, e, int(iters))


def peel_decode_batch(code: LDPCCode | SeededLDPC, values: torch.Tensor,
                      erased: torch.Tensor, iters: int, *,
                      backend: str = "auto") -> DecodeResult:
    """Decode ``B`` INDEPENDENT erasure patterns in one launch.

    ``values`` is ``(B, N)`` or ``(B, N, V)``; ``erased`` is ``(B, N)`` bool
    — one straggler realization per batch element.  Each element follows
    the trajectory :func:`peel_decode` gives it alone; the batch axis only
    amortizes the launch and shares the code's table.  This is the serving
    primitive: many concurrent coded queries, each with its own straggler
    mask (see :mod:`repro_torch.serving.coded_queries`).
    """
    v, squeeze = _batched(values)
    v, e = _run(code, backend, v, erased.to(torch.bool), _BATCH, int(iters))
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
                         *, backend: str = "auto") -> DecodeResult:
    """Decode until a round resolves nothing, nothing is erased, or
    ``max_iters`` rounds (default ``N``) have run.

    This is the "decoding effort adapts to the number of stragglers" mode:
    with few erasures the decode stops after 1-2 rounds.  ``rounds_used``
    is a 0-d int32 tensor on the values' device and counts the last,
    no-progress probe round of a pattern that does not fully resolve.
    """
    max_iters = code.N if max_iters is None else int(max_iters)
    squeeze = values.ndim == 1
    v = values[:, None] if squeeze else values
    v, e, d = _run(code, backend, v, erased.to(torch.bool),
                   (peel_decode_adaptive_cuda, peel_decode_adaptive_seeded_cuda,
                    _dense_adaptive_one), max_iters)
    return DecodeResult(v[:, 0] if squeeze else v, e, d)


def peel_decode_batch_adaptive(code: LDPCCode | SeededLDPC, values: torch.Tensor,
                               erased: torch.Tensor,
                               max_iters: int | None = None, *,
                               backend: str = "auto",
                               budgets=None) -> DecodeResult:
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
    serving (:mod:`repro_torch.serving.coded_queries`).
    """
    v, squeeze = _batched(values)
    if max_iters is None:
        max_iters = code.N
    budgets = _budget_vector(budgets, v.shape[0], max_iters, v.device)
    v, e, d = _run(code, backend, v, erased.to(torch.bool),
                   (peel_decode_batch_adaptive_cuda,
                    peel_decode_batch_adaptive_seeded_cuda, _dense_adaptive), budgets)
    return DecodeResult(v[..., 0] if squeeze else v, e, d)
