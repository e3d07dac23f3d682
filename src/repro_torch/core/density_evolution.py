"""Density evolution for (l, r)-regular LDPC erasure decoding (Proposition 2).

``q_d = q0 * (1 - (1 - q_{d-1})^(r-1))^(l-1)`` is the probability that a
codeword coordinate remains erased after ``d`` peeling iterations, when each
coordinate is independently erased with probability ``q0`` (the paper's
Assumption 1 straggler model).  ``q_d`` is monotone non-increasing iff
``q0 < q*(l, r)`` (Remark 3); ``q*`` is the ensemble threshold.
"""
from __future__ import annotations

import numpy as np

__all__ = ["qd_sequence", "q_final", "threshold"]


def qd_sequence(q0: float, l: int, r: int, D: int) -> np.ndarray:
    """[q_0, q_1, ..., q_D] under the density-evolution recursion."""
    qs = [float(q0)]
    for _ in range(D):
        q = qs[-1]
        qs.append(q0 * (1.0 - (1.0 - q) ** (r - 1)) ** (l - 1))
    return np.array(qs)


def q_final(q0: float, l: int, r: int, D: int) -> float:
    """q_D — the erasure probability entering Lemma 1 / Theorem 1."""
    return float(qd_sequence(q0, l, r, D)[-1])


def threshold(l: int, r: int, *, iters: int = 2000, tol: float = 1e-9) -> float:
    """Erasure threshold q*(l, r): sup{q0 : q_d -> 0}.

    Found by bisection on whether the recursion converges to (near) zero.
    E.g. q*(3, 6) ~= 0.4294 (Richardson & Urbanke).
    """

    def converges(q0: float) -> bool:
        q = q0
        for _ in range(iters):
            q = q0 * (1.0 - (1.0 - q) ** (r - 1)) ** (l - 1)
            if q < 1e-12:
                return True
        return q < 1e-10

    lo, hi = 0.0, 1.0
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if converges(mid):
            lo = mid
        else:
            hi = mid
    return lo
