"""Coded-compute engine: encode → erase → decode → epilogue.

:class:`CodedComputeEngine` owns the paper's pipeline once, as composable
stages, and the schemes in :mod:`repro_torch.core.coded_step` are thin
clients of it:

======== ====================================================================
stage    what it does
======== ====================================================================
encode   ``symbols = G @ payload`` — systematic codeword(s) of the payload.
erase    zero the straggled coordinates (workers that did not report).
decode   the peeling decode via :func:`repro_torch.core.decoder.peel_decode`
         (the CUDA kernel, or the dense reference), fixed ``D`` rounds.
epilogue zero-fill the unresolved systematic coordinates (paper Scheme 2:
         both ``ĉ`` and ``b̂`` zeroed on the unresolved set keeps the
         gradient estimate an unbiased (1-q_D)-scaled gradient — Lemma 1).
======== ====================================================================

The payload axis ``V`` (many codewords sharing ONE erasure pattern — the
paper's blocked Scheme 2, where one straggler erases the same coordinate of
every block) is the decode's second axis.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.decoder import DecodeResult, peel_decode, resolve_backend
from repro_torch.core.ldpc import LDPCCode

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

    code: LDPCCode
    decode_iters: int = 10
    backend: str = "auto"          # dense | cuda | auto

    def __post_init__(self) -> None:
        resolve_backend(self.backend)   # fail fast on bad names

    def encode(self, payload: torch.Tensor) -> torch.Tensor:
        """(K, ...) systematic payload → (N, ...) worker symbols (G @ m)."""
        G = torch.as_tensor(self.code.G, dtype=payload.dtype,
                            device=payload.device)
        return G @ payload

    @staticmethod
    def erase(symbols: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Zero the straggled coordinates; ``mask (N,)`` broadcasts over the
        payload axis of ``symbols (N,)`` / ``(N, V)``."""
        m = mask
        while m.ndim < symbols.ndim:
            m = m[..., None]
        return torch.where(m, torch.zeros_like(symbols), symbols)

    def decode(self, values: torch.Tensor, erased: torch.Tensor) -> DecodeResult:
        """One erasure pattern; values (N,) or (N, V) (payload axis)."""
        return peel_decode(self.code, values, erased, self.decode_iters,
                           backend=self.backend)

    def systematic(self, dec: DecodeResult) -> tuple[torch.Tensor, torch.Tensor]:
        """Epilogue: zero-filled systematic part + its unresolved mask."""
        K = self.code.K
        vals = dec.values[:K]
        unresolved = dec.erased[:K]
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
