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
* the SEEDED family — :func:`make_seeded_ldpc`, :class:`SeededLDPC` and
  :func:`make_seeded_ldgm` — draws the degree structure from a stateless
  counter-based hash of ``(seed, row)``, so the (column, weight) pairs of
  any row are recomputable in O(r) without the matrix: the CUDA kernels
  regenerate them from the seed (:class:`SeededStructure`).

Everything here is host-side NumPy, run once per code.  The draws are the
same, seed for seed, as the JAX package's constructions, so both packages
build bit-identical codes from one seed.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Literal, NamedTuple

import numpy as np

__all__ = ["LDPCCode", "make_regular_ldpc", "make_parity_only_ldpc",
           "SeededStructure", "SeededLDPC", "make_seeded_ldpc", "make_seeded_ldgm",
           "seeded_structure", "seeded_structure_of", "seeded_check_rows",
           "seeded_h_rows", "seeded_generator_rows", "is_seeded"]


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


# ------------------------------------------------------------------ seeded --
#
# A deterministic, counter-based draw of the (l, r)-regular ensemble: the
# structure of any check row is a pure function of (seed, row), computable
# in O(r) integer ops with no state and no matrix.  The same function is
# written three times in this package — here in NumPy (the materializing
# reference), in torch (kernels/ldpc_peel/ref.seeded_rows) and in CUDA
# (kernels/ldpc_peel/csrc/) — and the three are bit-exact: every op is
# integer arithmetic plus float32 steps that are exact in IEEE-754
# (integer-to-float of < 2^23 values, scaling by powers of two, adding 1.0
# to a 23-bit fraction).
#
# Construction ("layered permutations"): the `rows` check rows split into
# `layers` layers of `rows_per_layer = cols / row_weight` rows each.  Layer
# t carries an affine permutation x -> (a_t * x + b_t) mod cols (a_t coprime
# to cols, drawn from the seed); row j of the layer covers the r-slice
# pi_t[j*r : (j+1)*r].  Each layer therefore covers every column exactly
# once, so the ensemble is exactly (layers, row_weight)-biregular.  a_t is
# bounded by 2^31 / cols so a_t * x + b_t never leaves int32.
#
# Edge weights: w = sign * (1 + m * 2^-23) with (sign, m) drawn from a
# lowbias32-style avalanche hash of the global edge counter row*r + s.
# Magnitudes live in [1, 2): never zero, well-conditioned for the peeling
# division.

_W_MULT1 = 0x7FEB352D          # lowbias32 multipliers (Ettinger)
_W_MULT2 = 0x846CA68B


def _mix32(x: np.ndarray) -> np.ndarray:
    """Stateless avalanche hash on uint32 arrays."""
    with np.errstate(over="ignore"):     # uint32 wraparound is the point
        x = x.astype(np.uint32)
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(_W_MULT1)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(_W_MULT2)
        x = x ^ (x >> np.uint32(16))
    return x


def _host_hash(*counters: int) -> int:
    """Fold integer counters through the mix (host-side constant draws)."""
    h = np.uint32(0x9E3779B9)
    for c in counters:
        h = _mix32(h ^ np.uint32(c & 0xFFFFFFFF))
    return int(h)


class SeededStructure(NamedTuple):
    """The complete seed-derived description of a sparse biregular block:
    ``rows x cols`` with exactly ``row_weight`` nonzeros per row and exactly
    ``layers = rows * row_weight / cols`` per column.  Plain ints and
    tuples, so the kernels take the layer constants as launch arguments.
    """

    rows: int
    cols: int
    row_weight: int
    layers: int
    rows_per_layer: int
    seed: int
    strides: tuple[int, ...]       # a_t per layer, gcd(a_t, cols) == 1
    offsets: tuple[int, ...]       # b_t per layer, in [0, cols)
    wseed: int                     # uint32 salt for the edge-weight hash


def seeded_structure(rows: int, cols: int, row_weight: int,
                     seed: int) -> SeededStructure:
    """Derive the full structure (layer constants included) from the seed.

    Requires ``cols % row_weight == 0`` (each layer's rows partition the
    columns into ``cols / row_weight`` slices) and
    ``rows % (cols // row_weight) == 0`` (whole layers).
    """
    if row_weight <= 0 or rows <= 0 or cols <= 0:
        raise ValueError("rows, cols, row_weight must be positive")
    if cols % row_weight != 0:
        raise ValueError(
            f"seeded structure needs cols % row_weight == 0 (layered "
            f"permutations partition the columns); got cols={cols}, "
            f"row_weight={row_weight} — pick a row weight dividing the "
            f"code length (e.g. the (4, 8) ensemble for power-of-two N)")
    rows_per_layer = cols // row_weight
    if rows % rows_per_layer != 0:
        raise ValueError(
            f"seeded structure needs whole layers: rows={rows} is not a "
            f"multiple of cols/row_weight={rows_per_layer}")
    layers = rows // rows_per_layer
    # a_t bounded so a_t * x + b_t stays inside int32 for every x < cols
    amax = max(1, min((2**31 - cols) // cols, 1 << 20))
    strides, offsets = [], []
    for t in range(layers):
        a = 1
        for trial in range(256):
            cand = 1 + _host_hash(seed, t, trial, 0xA11CE) % amax
            if math.gcd(cand, cols) == 1:
                a = cand
                break
        strides.append(a)
        offsets.append(_host_hash(seed, t, 0xB0FFE) % cols)
    return SeededStructure(rows=rows, cols=cols, row_weight=row_weight,
                           layers=layers, rows_per_layer=rows_per_layer,
                           seed=seed, strides=tuple(strides),
                           offsets=tuple(offsets),
                           wseed=_host_hash(seed, 0x5EED5))


def _structure_rows_raw(st: SeededStructure, lo: int, hi: int):
    """(cols, coeffs) of rows [lo, hi) in DRAW order (slot order, unsorted):
    ``(n, row_weight)`` int32 and float32."""
    if not (0 <= lo <= hi <= st.rows):
        raise ValueError(f"row range [{lo}, {hi}) outside [0, {st.rows})")
    rows = np.arange(lo, hi, dtype=np.int64)[:, None]       # (n, 1)
    s = np.arange(st.row_weight, dtype=np.int64)[None, :]   # (1, r)
    t = rows // st.rows_per_layer
    jl = rows - t * st.rows_per_layer
    a = np.asarray(st.strides, dtype=np.int64)[t]
    b = np.asarray(st.offsets, dtype=np.int64)[t]
    cols = (a * (jl * st.row_weight + s) + b) % st.cols     # < 2^31 by amax
    edge = (rows * st.row_weight + s).astype(np.uint32)     # global counter
    u = _mix32(edge ^ np.uint32(st.wseed))
    sign = np.float32(1.0) - np.float32(2.0) * (u & np.uint32(1)).astype(np.float32)
    m = (u >> np.uint32(9)).astype(np.int32).astype(np.float32)  # [0, 2^23)
    w = sign * (np.float32(1.0) + m * np.float32(2.0 ** -23))    # exact f32
    return cols.astype(np.int32), w.astype(np.float32)


def seeded_check_rows(st: SeededStructure, lo: int, hi: int):
    """``(check_idx, check_coeff)`` for rows [lo, hi): ``(n, row_weight)``
    int32 columns in ASCENDING order (the neighbour-table convention of
    :attr:`LDPCCode.check_idx`) with the matching float32 edge weights."""
    cols, w = _structure_rows_raw(st, lo, hi)
    order = np.argsort(cols, axis=1, kind="stable")
    return (np.take_along_axis(cols, order, axis=1),
            np.take_along_axis(w, order, axis=1))


def seeded_h_rows(st: SeededStructure, lo: int, hi: int) -> np.ndarray:
    """Materialize dense float32 rows [lo, hi) of the seeded block."""
    cols, w = _structure_rows_raw(st, lo, hi)
    out = np.zeros((hi - lo, st.cols), dtype=np.float32)
    np.put_along_axis(out, cols.astype(np.int64), w, axis=1)
    return out


@dataclasses.dataclass(frozen=True)
class SeededLDPC:
    """Structure-only seeded (l, r)-regular code: NO materialized matrix.

    Carries exactly what :func:`make_seeded_ldpc` derives, minus the H it
    materializes — for code lengths where a dense ``(p, N)`` H would not
    fit in host memory at all.  Only ``backend="cuda_seeded"`` can decode
    it (the kernel regenerates rows from the seed); anything that needs H
    or the full neighbour table should use :func:`make_seeded_ldpc`.
    """

    N: int
    K: int
    l: int
    r: int
    seed: int = 0
    kind: str = dataclasses.field(default="ldpc-seeded", init=False)

    def __post_init__(self) -> None:
        _validate_seeded_lr(self.K, self.l, self.r)

    @property
    def p(self) -> int:
        return self.N - self.K

    @property
    def rate(self) -> float:
        return self.K / self.N

    @property
    def structure(self) -> SeededStructure:
        return seeded_structure(self.p, self.N, self.r, self.seed)

    def check_rows(self, lo: int, hi: int):
        """O(r)-per-row ``(check_idx, check_coeff)`` for any row range."""
        return seeded_check_rows(self.structure, lo, hi)


def _validate_seeded_lr(K: int, l: int, r: int) -> int:
    if l >= r:
        raise ValueError(f"need l < r for positive rate, got l={l}, r={r}")
    if (K * l) % (r - l) != 0:
        raise ValueError(f"K*l must be divisible by (r-l); K={K}, l={l}, r={r}")
    p = K * l // (r - l)
    if (K + p) % r != 0:
        raise ValueError(
            f"seeded ensemble needs N % r == 0 (N={K + p}, r={r}): the "
            f"layered-permutation draw partitions the N columns into N/r "
            f"slices per layer — use e.g. the (4, 8) rate-1/2 ensemble for "
            f"power-of-two N, or pick K with r | N")
    return p


def make_seeded_ldpc(K: int, *, l: int = 4, r: int = 8, seed: int = 0) -> LDPCCode:
    """(l, r)-regular parity structure drawn from a counter-based seed.

    Same ensemble contract as :func:`make_parity_only_ldpc` (exactly ``r``
    nonzeros per check row, exactly ``l`` per column, real edge weights, no
    generator), but every row is a pure O(r) function of ``(seed, row)``
    (:func:`seeded_check_rows`).  H is materialized here (f32) so every
    backend runs on the same code and the seeded kernel has a table to be
    held against; for lengths where even that is impossible use
    :class:`SeededLDPC`.  The default (4, 8) ensemble is rate 1/2, with a
    row weight that divides every power-of-two code length.
    """
    p = _validate_seeded_lr(K, l, r)
    N = K + p
    st = seeded_structure(p, N, r, seed)
    assert st.layers == l, (st.layers, l)    # p*r == N*l guarantees this
    H = seeded_h_rows(st, 0, p)
    return LDPCCode(H=H, G=np.zeros((N, 0), np.float32), N=N, K=K, l=l, r=r,
                    kind="ldpc-seeded", seed=seed)


def make_seeded_ldgm(K: int, p: int, *, row_weight: int = 8,
                     seed: int = 0) -> LDPCCode:
    """Seeded low-density GENERATOR code: c = [m ; P m] with seeded P.

    The ``(p, K)`` parity block P is a seeded biregular structure (exactly
    ``row_weight`` per parity row, balanced column degrees), so each
    codeword row is an O(row_weight) gather from the seed alone
    (:func:`repro_torch.core.encoding.gather_encode`,
    :func:`repro_torch.core.encoding.encode_seeded`).  Parity-check matrix
    ``H = [P  -I_p]``; the same peeling decoder applies.

    Needs ``K % row_weight == 0`` and ``p % (K // row_weight) == 0``
    (whole layers of the layered-permutation draw).
    """
    if row_weight > K:
        raise ValueError("row_weight cannot exceed K")
    st = seeded_structure(p, K, row_weight, seed)
    P = seeded_h_rows(st, 0, p).astype(np.float64)
    H = np.concatenate([P, -np.eye(p)], axis=1)
    G = np.concatenate([np.eye(K), P], axis=0)
    l_eff = max(int(round(p * row_weight / K)), 1)
    return LDPCCode(H=H, G=G, N=K + p, K=K, l=l_eff, r=row_weight + 1,
                    kind="ldgm-seeded", seed=seed)


def is_seeded(code) -> bool:
    """True if ``code`` carries a recomputable seeded structure."""
    return getattr(code, "kind", "") in ("ldpc-seeded", "ldgm-seeded")


def seeded_structure_of(code) -> SeededStructure:
    """The seeded H-structure of a code built by :func:`make_seeded_ldpc`
    or :class:`SeededLDPC` (the (p, N) regular block the seeded decode
    regenerates).  Raises for codes that do not carry a seed."""
    if getattr(code, "kind", "") != "ldpc-seeded":
        raise ValueError(
            f"backend='cuda_seeded' needs a seeded (l, r)-regular code "
            f"(make_seeded_ldpc / SeededLDPC); got kind="
            f"{getattr(code, 'kind', type(code).__name__)!r}")
    return seeded_structure(code.p, code.N, code.r, code.seed)


def seeded_generator_rows(code: LDPCCode, lo: int, hi: int):
    """Generator rows [lo, hi) of a seeded LDGM code as gather tables.

    Returns ``(idx (n, row_weight) int32, coeff (n, row_weight) f32)`` with
    ``G[i] = sum_s coeff[i, s] * e_{idx[i, s]}``: systematic rows (i < K)
    are ``[i, 0, 0, ...]`` with coeffs ``[1, 0, 0, ...]`` (the zero-weight
    pad keeps the gather shape uniform), parity rows are the seeded P rows
    in ascending column order.
    """
    if code.kind != "ldgm-seeded":
        raise ValueError(f"seeded generator rows need a make_seeded_ldgm "
                         f"code; got kind={code.kind!r}")
    if not (0 <= lo <= hi <= code.N):
        raise ValueError(f"row range [{lo}, {hi}) outside [0, {code.N})")
    rw = code.r - 1                       # the LDGM kind stores r = row_weight+1
    st = seeded_structure(code.p, code.K, rw, code.seed)
    idx = np.zeros((hi - lo, rw), dtype=np.int32)
    coeff = np.zeros((hi - lo, rw), dtype=np.float32)
    n_sys = max(0, min(hi, code.K) - lo)
    if n_sys:
        idx[:n_sys, 0] = np.arange(lo, lo + n_sys, dtype=np.int32)
        coeff[:n_sys, 0] = 1.0
    if hi > code.K:
        plo, phi = max(lo, code.K) - code.K, hi - code.K
        idx[n_sys:], coeff[n_sys:] = seeded_check_rows(st, plo, phi)
    return idx, coeff
