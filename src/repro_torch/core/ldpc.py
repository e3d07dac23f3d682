"""Real-valued LDPC code construction for coded computation (NumPy).

The paper (Maity, Rawat, Mazumdar 2018) encodes the second moment
``M = X^T X`` with an ``(N = w, K = k)`` systematic LDPC code over the reals.
Stragglers become erasures, which the iterative peeling decoder
(:mod:`repro_torch.core.decoder`) resolves; its behaviour is governed by
the ``(l, r)``-regular degree structure of the parity-check matrix ``H``.

* :func:`make_regular_ldpc` — the paper's code: an ``(l, r)``-regular
  parity-check matrix built with a configuration-model matching, Gaussian
  or ±1 edge weights, and a systematic generator ``G = [I_K ; -H2^{-1} H1]``.
* :func:`make_parity_only_ldpc` — the same parity structure without the
  O(p²·N) generator solve, for decode-only work at large N.

Everything here is host-side NumPy, run once per code.  The draws are the
same, seed for seed, as the JAX package's constructions, so both packages
build bit-identical codes from one seed.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Literal

import numpy as np

__all__ = ["LDPCCode", "make_regular_ldpc", "make_parity_only_ldpc"]


@dataclasses.dataclass(frozen=True)
class LDPCCode:
    """A systematic real-valued linear code defined by (H, G).

    Attributes:
      H: ``(p, N)`` parity-check matrix, ``H @ c = 0`` for codewords ``c``.
      G: ``(N, K)`` systematic generator, first ``K`` rows are ``I_K``
        (``(N, 0)`` for a parity-only code).
      N: code length (== number of workers ``w`` in the paper's Scheme 2).
      K: code dimension.
      l: column weight of ``H``.
      r: row weight of ``H``.
      kind: "ldpc" or "ldpc-parity-only".
      seed: construction seed (for reproducibility / re-derivation).
    """

    H: np.ndarray
    G: np.ndarray
    N: int
    K: int
    l: int
    r: int
    kind: str = "ldpc"
    seed: int = 0

    def __post_init__(self) -> None:
        # Build the neighbour table eagerly: construction is offline, and a
        # decode should not pay a first-use hitch inside a timed step.
        self._neighbor_table  # noqa: B018 — cached_property warm-up

    @property
    def p(self) -> int:
        return self.N - self.K

    @functools.cached_property
    def _neighbor_table(self) -> tuple[np.ndarray, np.ndarray]:
        """Padded CSR-like neighbour table of the Tanner graph.

        ``check_idx (p, r_max) int32`` holds each check row's nonzero
        columns in ascending order, padded with the sentinel ``N``;
        ``check_coeff (p, r_max) float32`` the matching ``H`` entries,
        padded with 0.  ``r_max`` is the largest row weight (``r`` for a
        regular code, so the table has no padding).
        """
        mask = self.H != 0.0
        row_weights = mask.sum(axis=1)
        r_max = int(max(row_weights.max() if row_weights.size else 0, 1))
        p = self.H.shape[0]
        check_idx = np.full((p, r_max), self.N, dtype=np.int32)
        check_coeff = np.zeros((p, r_max), dtype=np.float32)
        for i in range(p):
            cols = np.flatnonzero(mask[i])  # ascending
            check_idx[i, : cols.size] = cols
            check_coeff[i, : cols.size] = self.H[i, cols]
        return check_idx, check_coeff

    @property
    def check_idx(self) -> np.ndarray:
        """(p, r_max) int32 neighbour columns per check, sentinel-padded with N."""
        return self._neighbor_table[0]

    @property
    def check_coeff(self) -> np.ndarray:
        """(p, r_max) float32 edge weights matching :attr:`check_idx`."""
        return self._neighbor_table[1]

    @functools.cached_property
    def _var_table(self) -> np.ndarray:
        """``(N, l_max) int32``: for variable ``j``, the rows of its nonzero
        entries in ascending order, padded with the sentinel ``p``."""
        mask = self.H != 0.0
        col_weights = mask.sum(axis=0)
        l_max = int(max(col_weights.max() if col_weights.size else 0, 1))
        p = self.H.shape[0]
        var_idx = np.full((self.N, l_max), p, dtype=np.int32)
        for j in range(self.N):
            rows = np.flatnonzero(mask[:, j])  # ascending
            var_idx[j, : rows.size] = rows
        return var_idx

    @property
    def var_idx(self) -> np.ndarray:
        """(N, l_max) int32 incident check rows per variable, sentinel ``p``."""
        return self._var_table

    @functools.cached_property
    def device_cache(self) -> dict:
        """Tensor copies of this code's tables, keyed by the decoder per
        device and dtype, so a decode loop uploads them once."""
        return {}

    def encode(self, message: np.ndarray) -> np.ndarray:
        """Encode a (K, ...) message block into an (N, ...) codeword block."""
        if self.G.size == 0:
            raise ValueError(
                "this code was built parity-only (make_parity_only_ldpc): "
                "it carries H for decode-structure work but no generator — "
                "use make_regular_ldpc when you need to encode")
        return self.G @ message

    def check(self, codeword: np.ndarray, atol: float = 1e-4) -> bool:
        """True iff ``codeword`` satisfies all parity checks."""
        return bool(np.allclose(self.H @ codeword, 0.0, atol=atol))


def _configuration_model(
    p: int, n: int, l: int, r: int, rng: np.random.Generator, max_fix_rounds: int = 10_000
) -> np.ndarray:
    """Random simple (l, r)-biregular bipartite graph via stub matching.

    Returns a boolean (p, n) adjacency with exactly ``l`` ones per column and
    ``r`` ones per row.  Double edges from the random matching are repaired
    with random edge swaps (standard configuration-model cleanup).
    """
    if n * l != p * r:
        raise ValueError(f"degree mismatch: n*l={n * l} != p*r={p * r}")
    col_stubs = np.repeat(np.arange(n), l)
    row_stubs = np.repeat(np.arange(p), r)
    rng.shuffle(row_stubs)

    def dup_indices(rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        keys = rows.astype(np.int64) * n + cols
        order = np.argsort(keys, kind="stable")
        sorted_keys = keys[order]
        dup_sorted = np.concatenate([[False], sorted_keys[1:] == sorted_keys[:-1]])
        out = np.zeros_like(dup_sorted)
        out[order] = dup_sorted
        return np.nonzero(out)[0]

    rows, cols = row_stubs, col_stubs.copy()
    for _ in range(max_fix_rounds):
        dups = dup_indices(rows, cols)
        if dups.size == 0:
            break
        # Swap each duplicate edge's row endpoint with a random other edge,
        # one at a time (overlapping fancy-index swaps would corrupt the
        # degree multiset).
        for d in dups:
            partner = int(rng.integers(0, rows.size))
            rows[d], rows[partner] = rows[partner], rows[d]
    else:  # pragma: no cover - extremely unlikely for sane (l, r)
        raise RuntimeError("configuration model failed to produce a simple graph")

    adj = np.zeros((p, n), dtype=bool)
    adj[rows, cols] = True
    if not ((adj.sum(axis=0) == l).all() and (adj.sum(axis=1) == r).all()):
        raise RuntimeError("configuration model lost a degree")
    return adj


def _edge_weights(
    adj: np.ndarray, rng: np.random.Generator, values: Literal["gaussian", "pm1"]
) -> np.ndarray:
    w = rng.standard_normal(adj.shape).astype(np.float64)
    if values == "pm1":
        w = np.sign(w) + (w == 0.0)
    return np.where(adj, w, 0.0)


def _pivot_columns(H: np.ndarray, p: int) -> np.ndarray | None:
    """Greedy rank-revealing column selection (LU with column pivoting).

    Returns ``p`` column indices of ``H`` (p x N) forming a well-conditioned
    square basis, or None if H is rank-deficient.
    """
    R = H.astype(np.float64).copy()
    n = R.shape[1]
    available = np.ones(n, dtype=bool)
    chosen: list[int] = []
    for i in range(p):
        norms = np.linalg.norm(R[i:, :], axis=0)
        norms[~available] = -1.0
        j = int(np.argmax(norms))
        if norms[j] <= 1e-10:
            return None
        pr = i + int(np.argmax(np.abs(R[i:, j])))  # row pivot for stability
        if pr != i:
            R[[i, pr]] = R[[pr, i]]
        chosen.append(j)
        available[j] = False
        piv = R[i, j]
        if i + 1 < p:
            R[i + 1 :] -= np.outer(R[i + 1 :, j] / piv, R[i])
    return np.array(chosen)


def _check_lr(K: int, l: int, r: int) -> int:
    if l >= r:
        raise ValueError(f"need l < r for positive rate, got l={l}, r={r}")
    if (K * l) % (r - l) != 0:
        raise ValueError(f"K*l must be divisible by (r-l); K={K}, l={l}, r={r}")
    return K * l // (r - l)


def make_regular_ldpc(
    K: int,
    *,
    l: int = 3,
    r: int = 6,
    seed: int = 0,
    values: Literal["gaussian", "pm1"] = "gaussian",
    max_seed_tries: int = 64,
) -> LDPCCode:
    """Construct the paper's (l, r)-regular systematic LDPC code over R.

    Code length ``N = K * r / (r - l)`` (rate ``1 - l/r``); the paper's
    experiments use a rate-1/2 ``(40, 20)`` code, i.e. ``l/r = 1/2``.

    The systematic generator is ``G = [I_K ; -H2^{-1} H1]`` where
    ``H = [H1 | H2]``; seeds are retried until ``H2`` is well-conditioned.
    The generator solve is O(p²·N) on the host.
    """
    p = _check_lr(K, l, r)
    N = K + p

    for trial in range(max_seed_tries):
        rng = np.random.default_rng(seed + 7919 * trial)
        adj = _configuration_model(p, N, l, r, rng)
        H = _edge_weights(adj, rng, values)
        # A fixed set of p columns of a sparse biregular H is near-singular
        # with high probability at scale: pick the parity positions by
        # pivoted elimination and permute them to the back.  Column
        # permutation keeps the (l, r)-regularity.
        parity_cols = _pivot_columns(H, p)
        if parity_cols is None:
            continue
        msg_cols = np.setdiff1d(np.arange(N), parity_cols, assume_unique=False)
        perm = np.concatenate([msg_cols, parity_cols])
        H = H[:, perm]
        H2 = H[:, K:]
        if np.linalg.cond(H2) > 1e7:
            continue
        P = -np.linalg.solve(H2, H[:, :K])  # (p, K)
        G = np.concatenate([np.eye(K), P], axis=0)
        code = LDPCCode(H=H.astype(np.float64), G=G.astype(np.float64), N=N,
                        K=K, l=l, r=r, kind="ldpc", seed=seed + 7919 * trial)
        if not np.allclose(code.H @ code.G, 0.0,
                           atol=1e-6 * np.abs(H).max() * K):
            raise RuntimeError("generator does not satisfy the parity checks")
        return code
    raise RuntimeError(f"no well-conditioned H2 found in {max_seed_tries} tries")


def make_parity_only_ldpc(
    K: int,
    *,
    l: int = 3,
    r: int = 6,
    seed: int = 0,
    values: Literal["gaussian", "pm1"] = "gaussian",
) -> LDPCCode:
    """(l, r)-regular parity structure WITHOUT the systematic generator.

    The peeling decode trajectory depends only on ``H`` and the erasure
    mask, never on the payload being a codeword, so decode-only work at
    large N skips :func:`make_regular_ldpc`'s O(p²·N) generator solve.  H
    is f32; :meth:`LDPCCode.encode` raises.
    """
    p = _check_lr(K, l, r)
    N = K + p
    rng = np.random.default_rng(seed)
    adj = _configuration_model(p, N, l, r, rng)
    w = rng.standard_normal(adj.shape, dtype=np.float32)
    if values == "pm1":
        w = np.sign(w) + (w == 0.0)
    H = np.where(adj, w, 0.0).astype(np.float32)
    return LDPCCode(H=H, G=np.zeros((N, 0), np.float32), N=N, K=K, l=l, r=r,
                    kind="ldpc-parity-only", seed=seed)
