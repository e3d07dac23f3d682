"""The paper's coded PGD step (Scheme 2), in PyTorch.

Scheme 2 (the main contribution) per step ``t``:

  1. worker products:   z = C θ_{t-1}            (each worker: one scalar/row)
  2. erasures:          z_S  — stragglers' coordinates masked
  3. peeling decode:    D rounds; unresolved set U_t
  4. zero-fill:         ĉ (and b̂) zeroed on U_t
  5. update:            θ_t = P_Θ(θ_{t-1} - η (ĉ_{1:k} - b̂))

Steps 2–4 are the :class:`repro_torch.core.engine.CodedComputeEngine`
pipeline; the schemes here own the encoded operator ``C`` / moment vector
``b`` and the update rule.  The engine's batch axis gives Scheme 2 a
batched query path (:meth:`Scheme2.gradient_batch`): B concurrent
(θ, straggler-mask) queries, one decode launch — the serving primitive
behind :mod:`repro_torch.serving.coded_queries`.  :func:`run_pgd` drives
any scheme for a number of steps as a Python loop on the tensors' device.

Under Assumption 1 this is PSGD with an unbiased (1-q_D)-scaled gradient
(Lemma 1) and converges at RB/((1-q_D)√T) (Theorem 1).  An optional
``debias`` flag divides the estimate by (1-q_D).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.core import density_evolution
from repro_torch.core.encoding import (Moments, encode_moment,
                                       encode_moment_blocks, encode_seeded,
                                       gather_encode, generator_gather_tables)
from repro_torch.core.engine import CodedComputeEngine, blocked_epilogue
from repro_torch.core.ldpc import LDPCCode
from repro_torch.optim import projections

__all__ = ["Scheme2", "Scheme2Blocked", "run_pgd", "RunResult"]


class RunResult(NamedTuple):
    theta: torch.Tensor       # final iterate
    theta_bar: torch.Tensor   # running average (Theorem 1 is stated for it)
    errors: torch.Tensor      # (T,) ||theta_t - theta*|| if theta_star given, else loss
    unresolved: torch.Tensor  # (T,) |U_t| — decode quality per step


@dataclasses.dataclass(frozen=True)
class Scheme2:
    """LDPC moment-encoded approximate-gradient PGD (paper Scheme 2)."""

    code: LDPCCode
    C: torch.Tensor  # (N, k) encoded moment = G @ M; seeded_encode: M (k, k)
    b: torch.Tensor  # (k,)  = X^T y
    lr: float
    decode_iters: int = 10
    # early exit within decode_iters rounds (the decode's effort tracks the
    # stragglers); per-slot on gradient_batch
    adaptive: bool = False
    decode_backend: str = "auto"  # dense | cuda | cuda_seeded | replay | auto (decoder.py)
    projection: Callable[[torch.Tensor], torch.Tensor] = projections.identity
    debias: bool = False
    q0_for_debias: float = 0.1
    # Seeded on-the-fly encode (a make_seeded_ldgm code): ``C`` holds the
    # raw (k, k) moment M, and every step computes the codeword as the
    # generator gather over y = M θ; the (N, k) encoded matrix never exists.
    seeded_encode: bool = False
    # With ``encode_fused`` the gather runs in the seeded encode kernel
    # (encoding.encode_seeded), which regenerates the rows from the seed:
    # no gather tables either.  Bit-identical to the table gather.
    encode_fused: bool = False
    # decode_backend="replay" only: the cross-step LRU of compiled peeling
    # schedules (repro_torch.core.schedule_cache.ScheduleCache), threaded
    # into the scheme's engine so recurring straggler patterns pay the
    # symbolic solve once.  None: each decode solves its pattern.
    schedule_cache: object | None = None

    @classmethod
    def build(cls, code: LDPCCode, moments: Moments, *, lr: float, **kw) -> "Scheme2":
        return cls(code=code, C=encode_moment(code, moments.M), b=moments.b,
                   lr=lr, **kw)

    @classmethod
    def build_seeded(cls, code: LDPCCode, moments: Moments, *, lr: float,
                     **kw) -> "Scheme2":
        """Scheme 2 over a seeded LDGM code with the on-the-fly encode:
        stores ``M`` itself ((k, k)) in place of the ``(N, k)`` encoded
        ``C`` and regenerates the generator rows at every step (``z =
        gather(M θ)``); ``encode_fused=True`` runs the gather in the
        seeded encode kernel."""
        return cls(code=code, C=moments.M, b=moments.b, lr=lr,
                   seeded_encode=True, **kw)

    def _encode(self, y: torch.Tensor) -> torch.Tensor:
        """Seeded codeword of ``y`` ((K,) or (K, V)): the encode kernel or
        the table gather, bit-identical."""
        if self.encode_fused:
            return encode_seeded(self.code, y)
        return gather_encode(*generator_gather_tables(self.code, y.device), y)

    @property
    def w(self) -> int:
        return self.code.N

    @functools.cached_property
    def engine(self) -> CodedComputeEngine:
        return CodedComputeEngine(self.code, decode_iters=self.decode_iters,
                                  backend=self.decode_backend,
                                  adaptive=self.adaptive,
                                  schedule_cache=self.schedule_cache)

    def worker_mask_to_erasure(self, mask: torch.Tensor) -> torch.Tensor:
        """Worker straggler mask(s) ``(..., w)`` → erasure mask(s) over the
        codeword: row ``j`` is worker ``j`` (N == w)."""
        return mask

    def _debias(self, g: torch.Tensor) -> torch.Tensor:
        if not self.debias:
            return g
        qD = density_evolution.q_final(
            self.q0_for_debias, self.code.l, self.code.r, self.decode_iters)
        return g / max(1.0 - qD, 1e-6)

    def finish_gradient(self, c_hat: torch.Tensor, unresolved: torch.Tensor):
        """Scheme-2 gradient epilogue from recovered systematic values: zero
        ``b̂`` on the unresolved set, subtract, (optionally) debias.

        Shapes: ``c_hat (K,)`` / ``unresolved (K,)`` or batched ``(B, K)``
        (``b`` broadcasts over the batch).  Returns ``(gradient,
        unresolved_count)`` with the count reduced over the coordinate axis
        only: one count per query.  :meth:`gradient`, :meth:`gradient_batch`
        and the serving layer's continuous launches share it."""
        b_hat = torch.where(unresolved, 0.0, self.b)
        return self._debias(c_hat - b_hat), unresolved.sum(dim=-1)

    def gradient(self, theta: torch.Tensor, straggler_mask: torch.Tensor):
        """Return (approx gradient, |U_t|)."""
        if self.seeded_encode:
            z = self._encode(self.C @ theta)   # gather(M θ)
        else:
            z = self.C @ theta  # (N,) worker inner products (codeword of C)
        erased = self.worker_mask_to_erasure(straggler_mask)
        c_hat, unresolved = self.engine.recover(z, erased)
        return self.finish_gradient(c_hat, unresolved)

    def gradient_batch(self, theta_B: torch.Tensor,
                       straggler_mask_B: torch.Tensor):
        """B concurrent queries (θ_b, mask_b) → ((B, k) gradients, (B,)
        unresolved counts), ONE decode launch.

        Each query carries its own straggler realization; the worker
        products are one ``(B, k) @ (k, N)`` matrix product and the B
        peeling decodes one batched launch
        (:meth:`CodedComputeEngine.decode_batch`) — per slot early exit for
        an ``adaptive`` scheme.  Per-query results match :meth:`gradient`
        run separately, up to f32 summation order.  A seeded scheme
        encodes the ``(B, k) @ (k, k)`` products as one ``(K, B)`` payload.
        """
        if self.seeded_encode:
            Z = self._encode((theta_B @ self.C.T).T).T       # (B, N)
        else:
            Z = theta_B @ self.C.T                           # (B, N)
        erased_B = self.worker_mask_to_erasure(straggler_mask_B)
        c_hat, unresolved = self.engine.recover_batch(Z, erased_B)
        return self.finish_gradient(c_hat, unresolved)

    def step(self, theta: torch.Tensor, straggler_mask: torch.Tensor):
        g, n_unresolved = self.gradient(theta, straggler_mask)
        return self.projection(theta - self.lr * g), n_unresolved


@dataclasses.dataclass(frozen=True)
class Scheme2Blocked:
    """Scheme 2 generalized to k > K (paper footnote 2): the k rows of M are
    partitioned into k/K blocks, each encoded with the SAME (N=w, K) code;
    worker j holds row j of every block (α = k/K rows) and returns α scalars.

    A straggler erases the same coordinate of EVERY block's codeword, so all
    k/K codewords share one erasure pattern and the decode is one pass with
    payload width k/K.  This is the configuration of the paper's
    experiments: a (40, 20) code with k ∈ {200, ..., 2000}.
    """

    code: LDPCCode
    C_blocks: torch.Tensor  # (k/K, N, k)
    b: torch.Tensor         # (k,)
    lr: float
    decode_iters: int = 10
    decode_backend: str = "auto"  # dense | cuda | auto (decoder.py)
    projection: Callable[[torch.Tensor], torch.Tensor] = projections.identity

    @classmethod
    def build(cls, code: LDPCCode, moments: Moments, *, lr: float, **kw):
        return cls(code=code, C_blocks=encode_moment_blocks(code, moments.M),
                   b=moments.b, lr=lr, **kw)

    @property
    def w(self) -> int:
        return self.code.N

    @functools.cached_property
    def engine(self) -> CodedComputeEngine:
        return CodedComputeEngine(self.code, decode_iters=self.decode_iters,
                                  backend=self.decode_backend)

    def worker_products(self, theta: torch.Tensor) -> torch.Tensor:
        """``Z (N, k/K)``: worker ``j``'s inner products with ``θ``, one per
        block.  A batched product over the blocks: ``torch.matmul`` of the
        3-D ``C_blocks`` with a vector runs as one matrix-vector product,
        which the card computes several times slower (PERF.md)."""
        nb, _, k = self.C_blocks.shape
        Z = torch.bmm(self.C_blocks, theta.expand(nb, k).unsqueeze(-1))
        return Z.squeeze(-1).T.contiguous()

    def gradient(self, theta: torch.Tensor, straggler_mask: torch.Tensor):
        eng = self.engine
        nb = self.C_blocks.shape[0]
        Z = self.worker_products(theta)
        dec = eng.decode(eng.erase(Z, straggler_mask), straggler_mask)
        g, unresolved_flat = blocked_epilogue(dec.values, dec.erased, self.b,
                                              K=self.code.K, nb=nb)
        return g, unresolved_flat.sum()

    def step(self, theta: torch.Tensor, straggler_mask: torch.Tensor):
        g, aux = self.gradient(theta, straggler_mask)
        return self.projection(theta - self.lr * g), aux


def run_pgd(
    scheme,
    theta0: torch.Tensor,
    straggler_model,
    steps: int,
    *,
    generator: torch.Generator | None = None,
    masks: torch.Tensor | None = None,
    theta_star: torch.Tensor | None = None,
    loss_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> RunResult:
    """Drive any scheme (``.w``, ``.step(theta, mask)``) for ``steps``
    steps on ``theta0``'s device: draw a straggler mask, take a coded step,
    track the error.

    ``masks`` — a ``(steps, w)`` bool tensor — replaces sampling, so two
    runs (or two packages) can share one straggler realization; otherwise
    each step draws from ``straggler_model`` with ``generator``.  Nothing
    is copied to the host inside the loop.
    """
    w = scheme.w
    if masks is not None:
        if tuple(masks.shape) != (steps, w):
            raise ValueError(f"masks must be ({steps}, {w}); got "
                             f"{tuple(masks.shape)}")
        masks = masks.to(theta0.device, torch.bool)

    def metric(theta):
        if theta_star is not None:
            return torch.linalg.vector_norm(theta - theta_star)
        if loss_fn is not None:
            return loss_fn(theta)
        return torch.linalg.vector_norm(theta)

    theta, tbar = theta0, torch.zeros_like(theta0)
    errs, unres = [], []
    for t in range(steps):
        mask = (masks[t] if masks is not None
                else straggler_model.sample(generator, w, device=theta0.device))
        theta, unresolved = scheme.step(theta, mask)
        tbar = (tbar * float(t) + theta) / (t + 1.0)
        errs.append(metric(theta))
        unres.append(unresolved)
    return RunResult(theta, tbar, torch.stack(errs), torch.stack(unres))
