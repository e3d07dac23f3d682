"""Coded-compute engine: encode → erase → decode → epilogue.

:class:`CodedComputeEngine` owns the paper's pipeline once, as composable
stages, and the schemes in :mod:`repro_torch.core.coded_step` are thin
clients of it:

======== ====================================================================
stage    what it does
======== ====================================================================
encode   ``symbols = G @ payload`` — systematic codeword(s) of the payload.
erase    zero the straggled coordinates (workers that did not report).
decode   the peeling decode via :mod:`repro_torch.core.decoder` (the CUDA
         kernel over the code's table or regenerated from its seed, the
         replay of pre-solved schedules, or the dense reference): fixed
         ``D`` rounds, or early exit within ``D`` rounds
         (``adaptive=True``).  The engine's ``code`` may be a
         structure-only :class:`repro_torch.core.ldpc.SeededLDPC`: every
         stage but ``encode`` works on it unchanged.
epilogue zero-fill the unresolved systematic coordinates (paper Scheme 2:
         both ``ĉ`` and ``b̂`` zeroed on the unresolved set keeps the
         gradient estimate an unbiased (1-q_D)-scaled gradient — Lemma 1).
======== ====================================================================

The payload axis ``V`` (many codewords sharing ONE erasure pattern — the
paper's blocked Scheme 2, where one straggler erases the same coordinate of
every block) and the pattern axis ``B`` (many independent erasure patterns,
:meth:`CodedComputeEngine.decode_batch`) are orthogonal; the engine exposes
both.  The batch axis carries per-slot adaptive state: with
``adaptive=True`` every slot stops at its own fixpoint, under its own
round budget, and reports its own round count.  This is the primitive of
the coded-query server (:mod:`repro_torch.serving.coded_queries`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.decoder import (DecodeResult, ScheduleLookup, peel_decode,
                                      peel_decode_adaptive, peel_decode_batch,
                                      peel_decode_batch_adaptive, resolve_backend)
from repro_torch.core.ldpc import LDPCCode, SeededLDPC

__all__ = ["CodedComputeEngine", "blocked_epilogue"]


def blocked_epilogue(values: torch.Tensor, erased: torch.Tensor,
                     b: torch.Tensor, *, K: int,
                     nb: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked-Scheme-2 epilogue: zero-fill + re-interleave + moment shift.

    ``values (N, nb)`` / ``erased (N,)`` come out of a payload-batched
    decode of ``nb`` blocks sharing one erasure pattern; block ``i`` holds
    rows ``M[i*K:(i+1)*K]``, so flat coordinate ``j = i*K + r``.  Returns
    ``(g, unresolved_flat)`` with ``g = ĉ - b̂`` the (k,) approximate
    gradient (both ``ĉ`` and ``b̂`` zeroed on the unresolved set) and
    ``unresolved_flat`` its (k,) bool unresolved mask.
    """
    unresolved = erased[:K]                                   # same for all blocks
    c_hat = torch.where(unresolved[:, None], 0.0, values[:K])  # (K, nb)
    c_flat = c_hat.T.reshape(-1)                              # (k,)
    unresolved_flat = unresolved.repeat(nb)
    b_hat = torch.where(unresolved_flat, 0.0, b)
    return c_flat - b_hat, unresolved_flat


@dataclasses.dataclass(frozen=True)
class CodedComputeEngine:
    """One code + one decode policy, applied as composable pipeline stages."""

    code: LDPCCode | SeededLDPC
    decode_iters: int = 10
    backend: str = "auto"          # dense | cuda | cuda_seeded | replay | auto
    adaptive: bool = False
    # backend="replay" only: the cross-pattern LRU of compiled peeling
    # schedules (repro_torch.core.schedule_cache.ScheduleCache).  With a
    # cache, recurring straggler patterns pay the symbolic solve once and
    # every later decode is pure replay; without one the decode entry
    # points solve per call.
    schedule_cache: object | None = None

    def __post_init__(self) -> None:
        # fail fast on bad names and on backends the code cannot take
        resolve_backend(self.backend, self.code)

    def _schedule_kw(self, erased: torch.Tensor, *, batch: bool) -> dict:
        """``schedule=`` / ``schedules=`` for the replay decode, from the
        engine's cache: the masks are read to the host once, and the decode
        of this same ``erased`` does not compare them again on the device."""
        if self.backend != "replay" or self.schedule_cache is None:
            return {}
        lookup = ScheduleLookup(self.schedule_cache, self.code, erased)
        return {"schedules" if batch else "schedule": lookup}

    def encode(self, payload: torch.Tensor) -> torch.Tensor:
        """(K, ...) systematic payload → (N, ...) worker symbols (G @ m).
        Raises for a code with no generator (parity-only or structure-only
        codes)."""
        G = getattr(self.code, "G", None)
        if G is None or G.size == 0:
            raise ValueError(f"a code of kind {self.code.kind!r} has no "
                             "generator to encode with")
        return torch.as_tensor(G, dtype=payload.dtype, device=payload.device) @ payload

    @staticmethod
    def erase(symbols: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Zero the straggled coordinates.  ``mask`` broadcasts from the
        right-aligned coordinate axis: (N,) against (N,), (N, V), or the
        batched (B, N) against (B, N), (B, N, V)."""
        m = mask
        while m.ndim < symbols.ndim:
            m = m[..., None]
        return torch.where(m, torch.zeros_like(symbols), symbols)

    def decode(self, values: torch.Tensor, erased: torch.Tensor) -> DecodeResult:
        """One erasure pattern; values (N,) or (N, V) (payload axis).  With
        ``adaptive``, ``decode_iters`` is the round budget of the early-exit
        decode."""
        kw = self._schedule_kw(erased, batch=False)
        if self.adaptive:
            return peel_decode_adaptive(self.code, values, erased,
                                        self.decode_iters, backend=self.backend,
                                        **kw)
        return peel_decode(self.code, values, erased, self.decode_iters,
                           backend=self.backend, **kw)

    def decode_batch(self, values: torch.Tensor, erased: torch.Tensor, *,
                     adaptive: bool | None = None,
                     budgets=None) -> DecodeResult:
        """B independent erasure patterns in ONE launch; values (B, N) or
        (B, N, V), erased (B, N).  Each slot decodes as :meth:`decode`
        would decode it alone.

        ``adaptive`` overrides the engine's policy for this call (``None``
        = engine default).  Adaptive batches run the per-slot early-exit
        decode: each slot stops at its own fixpoint within
        ``decode_iters`` rounds, or within its entry of ``budgets (B,)``,
        and ``rounds_used`` is the per-slot ``(B,)`` tensor.  ``budgets``
        is only meaningful for adaptive decodes."""
        use_adaptive = self.adaptive if adaptive is None else adaptive
        if not use_adaptive and budgets is not None:
            raise ValueError(
                "budgets= requires the adaptive batched decode (engine "
                "adaptive=True or decode_batch(adaptive=True)); the fixed-D "
                "path would silently ignore the per-slot round budgets")
        kw = self._schedule_kw(erased, batch=True)
        if use_adaptive:
            return peel_decode_batch_adaptive(
                self.code, values, erased, self.decode_iters,
                backend=self.backend, budgets=budgets, **kw)
        return peel_decode_batch(self.code, values, erased, self.decode_iters,
                                 backend=self.backend, **kw)

    def systematic(self, dec: DecodeResult) -> tuple[torch.Tensor, torch.Tensor]:
        """Epilogue: zero-filled systematic part + its unresolved mask.

        Takes single (values (N,)/(N, V)) and batched (values (B, N)/
        (B, N, V)) decode results: the systematic part is the first K
        coordinates of the coordinate axis."""
        K = self.code.K
        batched = dec.erased.ndim == 2
        vals = dec.values[:, :K] if batched else dec.values[:K]
        unresolved = dec.erased[:, :K] if batched else dec.erased[:K]
        m = unresolved
        while m.ndim < vals.ndim:
            m = m[..., None]
        return torch.where(m, torch.zeros_like(vals), vals), unresolved

    def recover(self, symbols: torch.Tensor, mask: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """erase → decode → epilogue for one pattern: returns the
        zero-filled systematic (K, ...) values and the (K,) unresolved mask."""
        dec = self.decode(self.erase(symbols, mask), mask)
        return self.systematic(dec)

    def recover_batch(self, symbols: torch.Tensor, mask: torch.Tensor, *,
                      adaptive: bool | None = None, budgets=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """erase → decode → epilogue for B patterns in one launch: returns
        (B, K, ...) zero-filled systematic values and (B, K) unresolved.
        ``adaptive`` / ``budgets`` pass through to :meth:`decode_batch`."""
        dec = self.decode_batch(self.erase(symbols, mask), mask,
                                adaptive=adaptive, budgets=budgets)
        return self.systematic(dec)
