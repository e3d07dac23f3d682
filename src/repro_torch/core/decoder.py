"""Iterative (peeling) erasure decoder for real-valued LDPC codes, in PyTorch.

The classic peeling decoder resolves degree-1 checks one at a time.  On the
card we use the equivalent *flooding* schedule: in each round, every parity
check with exactly one erased neighbour resolves that neighbour.  The fixed
number of rounds ``D`` is exactly the paper's decoding-iteration knob — the
quality of the recovered gradient is monotone in ``D`` (Remark 3).

Backends (``backend=`` on :func:`peel_decode`):

=========  ==================================================================
backend    what runs
=========  ==================================================================
"dense"    the reference: dense ``H``-structured tensor ops per round (mask
           matvec, matmul, argmax) — O(p·N·V) work.  When several checks
           resolve one coordinate, the HIGHEST check row wins, as the JAX
           package's dense scatter does.
"cuda"     the hand-written fixed-D flooding kernel
           (:func:`repro_torch.kernels.ldpc_peel.peel_decode_cuda`): the whole
           decode in one launch over the code's neighbour table.  The LOWEST
           check row wins, as in the JAX package's fused Pallas decodes.  For
           CPU tensors the wrapper runs the kernel's plain PyTorch version.
"auto"     "cuda".
=========  ==================================================================

Both backends follow the same erasure trajectory (solvability is an exact
count of erased neighbours); decoded values agree up to f32 summation order
and the choice among checks that resolve one coordinate.

``values`` may be ``(N,)`` scalars (the paper's inner products) or ``(N, V)``
payloads (the blocked Scheme 2, where one straggler erases the same
coordinate of every block).  Unresolved coordinates keep their input values
and are flagged in the returned mask; callers zero-fill them (Lemma 1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.ldpc import LDPCCode
from repro_torch.kernels.ldpc_peel import CodeTables, peel_decode_cuda

__all__ = ["DecodeResult", "BACKENDS", "resolve_backend", "peel_round",
           "peel_fixed_dense", "peel_decode", "code_tables"]

BACKENDS = ("auto", "dense", "cuda")


class DecodeResult(NamedTuple):
    values: torch.Tensor       # (N,) / (N, V)
    erased: torch.Tensor       # (N,) bool; True where unresolved
    rounds_used: int           # == D for the fixed-D decode


def resolve_backend(backend: str) -> str:
    """Resolve the ``backend=`` knob to "dense" or "cuda" (see the module
    docstring).  Raises on unknown names."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown decode backend {backend!r}; "
                         f"want one of {BACKENDS}")
    return "cuda" if backend == "auto" else backend


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
    """One flooding round (dense). values: (N, V), erased: (N,) bool.

    For every check row ``i`` with exactly one erased neighbour ``j``:
    ``c_j = -(sum_{j' known} H[i, j'] c_{j'}) / H[i, j]``.  Where several
    rows resolve one coordinate, the highest row's value is kept.
    """
    p, N = H.shape
    e = erased.to(H.dtype)
    cnt = Hb.to(H.dtype) @ e                       # erased neighbours per check
    solvable = cnt == 1.0
    known = torch.where(erased[:, None], torch.zeros_like(values), values)
    row_sums = H @ known                           # (p, V)
    # first erased neighbour of each row; arbitrary for non-solvable rows
    pos = torch.argmax((Hb & erased[None, :]).to(torch.uint8), dim=1)
    coeff = torch.gather(H, 1, pos[:, None])[:, 0]
    new_val = -row_sums / torch.where(coeff == 0.0, 1.0, coeff)[:, None]
    safe_pos = torch.where(solvable, pos, N)       # N = dropped
    rows = torch.arange(p, device=H.device)
    winner = torch.full((N + 1,), -1, dtype=torch.long, device=H.device)
    winner.scatter_reduce_(0, safe_pos, rows, reduce="amax")
    winner = winner[:N]
    resolved = winner >= 0
    values = torch.where(resolved[:, None], new_val[winner.clamp(min=0)],
                         values)
    return values, erased & ~resolved


def peel_fixed_dense(H, Hb, values, erased, iters: int):
    """``iters`` dense flooding rounds; ``values`` (N, V), ``erased`` (N,)."""
    for _ in range(int(iters)):
        values, erased = peel_round(H, Hb, values, erased)
    return values, erased


def peel_decode(code: LDPCCode, values: torch.Tensor, erased: torch.Tensor, iters: int, *,
                backend: str = "auto") -> DecodeResult:
    """Run exactly ``iters`` flooding rounds (the paper's fixed-D decode)
    on the device ``values`` lie on."""
    backend = resolve_backend(backend)
    squeeze = values.ndim == 1
    v = values[:, None] if squeeze else values
    e = erased.to(torch.bool)
    if backend == "cuda":
        tables = code_tables(code, v.device)
        v, e = peel_decode_cuda(tables, v.to(torch.float32).contiguous(),
                                e.contiguous(), iters)
        v = v.to(values.dtype)
    else:
        H, Hb = _mats(code, v.dtype, v.device)
        v, e = peel_fixed_dense(H, Hb, v, e, iters)
    if squeeze:
        v = v[:, 0]
    return DecodeResult(v, e, int(iters))
