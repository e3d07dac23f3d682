"""The plain PyTorch versions of the matrix-product kernels.

* :func:`block_matmul_ref`: the product in float32 of the float32-cast
  inputs (float64 when both inputs are float64: the port's float64
  reference runs), as the JAX package's ``block_matmul/ref.py`` computes
  it.  The wrapper (:func:`.ops.block_matmul`) runs it for CPU tensors;
  ``chip_smoke.py`` and tests/test_torch_cuda.py hold the kernel against
  it, and against float64, on the card (the accuracy gates).
* :func:`split_terms_ref`: the split pass in the padded layout the kernel
  writes: along the inner axis (k) in chunks of ``CHUNK`` values, each
  value as a lead term on the chunk's grid and the bf16 terms of the rest
  (:func:`split4` for f32, four terms; :func:`split2` for bf16, two).  The
  card holds the split kernel to it bit for bit.
* :func:`terms_product_ref`: the product kernel's arithmetic, the products
  of the terms that it runs (:func:`product_pairs`), summed in float64:
  what the kernel computes before its own roundings; :func:`products_ref`
  the same from A and B.  The CPU tests hold it against JAX and float64.

The grid.  In each chunk of 64 values along k of a row of A (a column of
B), E is the largest exponent of a finite value and the grid is 2^(E-7):
the lead term is the value cut toward zero to that grid, at most 8
significant bits, so exact in bf16, and below 2^8 grid units.  Two lead
terms multiply to an integer number of units below 2^16, and a chunk's 64
such products sum below 2^22 units, exactly, whatever a tensor-core step
cuts.  The rest, value minus lead (exact in f32, below one grid unit),
goes into three bf16 terms, each the rounding of what the ones before it
leave (of a bf16 value the rest is one bf16 term, exact).

Nothing on the encode's path calls these when a card is present.
"""
from __future__ import annotations

import torch

__all__ = ["block_matmul_ref", "split4", "split2", "split_terms_ref", "terms_product_ref",
           "products_ref", "product_pairs", "LEVELS", "MAX_LEVEL", "CHUNK", "EXACT_ABOVE",
           "BOTTOM_ERROR"]

# Values along k that share one grid: one chunk of the product kernel's sum.
CHUNK = 64
# Each term's size, as a power of 2 below the chunk's scale 2^E: the lead
# term below 2^(E+1), the rest's terms below 2^(E-7), 2^(E-15), 2^(E-23)
# (f32, four terms; bf16, two, the second exact).
LEVELS = {4: (0, 7, 15, 23), 2: (0, 7)}
# The kernel runs the term products whose levels sum to at most this: ten
# of an f32 pair, the dropped ones below 2^-30 of the chunk's scale each.
MAX_LEVEL = 23
# The terms sum to x exactly for |x| >= 2^-110; below, within 2^-134.
EXACT_ABOVE = 2.0 ** -110
BOTTOM_ERROR = 2.0 ** -134

_NAN_BITS = 0x7FC0


def product_pairs(na: int, nb: int) -> list[tuple[int, int]]:
    """The term products ``a_i·b_j`` (0-based) the product kernel runs for
    ``na`` terms of A and ``nb`` of B, in its order: the leads' product
    first (its own accumulator), then the rest."""
    la, lb = LEVELS[na], LEVELS[nb]
    return [(i, j) for i in range(na) for j in range(nb) if la[i] + lb[j] <= MAX_LEVEL]


def block_matmul_ref(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` with ``torch.matmul`` (2-D, or batched over a leading axis
    of either) in float32, or in float64 when both inputs are float64."""
    acc = torch.float64 if A.dtype == B.dtype == torch.float64 else torch.float32
    return torch.matmul(A.to(acc), B.to(acc))


def _bf16_of_bits(h: torch.Tensor) -> torch.Tensor:
    """bf16 values from their bit patterns, given as int64 in [0, 2^16)."""
    return torch.where(h >= 32768, h - 65536, h).to(torch.int16).view(torch.bfloat16)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The bit pattern of f32 ``x`` as int64 in [0, 2^32)."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 (no NaN) to bf16, rounded to nearest even, subnormals included:
    the card's ``cvt.rn.bf16.f32``, written on the bits."""
    u = _bits(x)
    return _bf16_of_bits((u + 0x7FFF + ((u >> 16) & 1)) >> 16)


def _grid_exp(u: torch.Tensor) -> torch.Tensor:
    """The exponent field of f32 bits ``u`` (int64), at least 1 (zeros and
    subnormals count as 1), and 0 for inf and NaN, so that a chunk's
    largest skips them."""
    be = (u >> 23) & 0xFF
    return torch.where(be == 0xFF, 0, be.clamp(min=1))


def _lead(x: torch.Tensor) -> torch.Tensor:
    """The lead terms of f32 ``x`` (..., C) as f32: each value cut toward
    zero to its chunk's grid 2^(E-134) (E the chunk's largest exponent
    field, chunks of ``CHUNK`` along the last axis).  The cut clears the
    ``E - e + 16`` low bits of a value of exponent field e (all of it past
    23, keeping the sign)."""
    u = _bits(x)
    ge = _grid_exp(u)
    C = x.shape[-1]
    pad = -C % CHUNK
    E = torch.nn.functional.pad(ge, (0, pad)).unflatten(-1, (-1, CHUNK)).amax(-1)
    E = E.repeat_interleave(CHUNK, dim=-1)[..., :C]
    clear = E - (u >> 23 & 0xFF).clamp(min=1) + 16
    keep = torch.where(clear >= 24, 0x80000000, (0xFFFFFFFF << clear.clamp(0, 31)) & 0xFFFFFFFF)
    g = u & keep
    return torch.where(g >= 2**31, g - 2**32, g).to(torch.int32).view(torch.float32)


def _zero_lead(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The lead ``g`` of ``x``, where it is zero signed by whether ``x`` is:
    +0 for a zero ``x``, -0 for a nonzero one (whose sign the rest's first
    term carries), so that the product kernel's epilogue tells a value
    below bf16's range from a zero."""
    mark = torch.where(x != 0, -0.0, 0.0).to(g.dtype)
    return torch.where(g == 0, mark, g)


def split4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 ``x`` (..., C) as bf16 terms ``(g, r1, r2, r3)``, chunks of
    ``CHUNK`` along the last axis: ``g`` the lead (x cut toward zero to its
    chunk's grid), ``r1`` the bf16 rounding (to nearest even) of ``r = x -
    g``, ``r2`` that of ``r - r1``, ``r3`` that of the rest, each difference
    exact in f32.  They sum to x exactly for |x| >= 2^-110, and within
    2^-134 below.  A zero lead is +0 for a zero x and -0 for any other
    (:func:`_zero_lead`).  An inf or NaN is its own lead (NaN as 0x7FC0)
    with zeros after it, and no part of its chunk's grid."""
    finite = torch.isfinite(x)
    xf = torch.where(finite, x, 0.0)
    g = _zero_lead(torch.where(finite, _lead(x), 0.0), xf)
    r = xf - g
    h1 = _round_bf16(r)
    r2 = r - h1.float()
    h2 = _round_bf16(r2)
    h3 = _round_bf16(r2 - h2.float())
    nan = torch.full_like(h1, 0.0).view(torch.int16).fill_(_NAN_BITS).view(torch.bfloat16)
    lead = torch.where(finite, g.to(torch.bfloat16),
                       torch.where(torch.isnan(x), nan, x.to(torch.bfloat16)))
    return lead, h1, h2, h3


def split2(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """bf16 ``x`` (..., C) as two bf16 terms, chunks of ``CHUNK`` along the
    last axis: ``g`` the lead, x cut toward zero to its chunk's grid, and
    ``r = x - g``, exact (at most 8 bits).  An inf or NaN is its own lead
    (its bits) with a zero after it."""
    finite = torch.isfinite(x)
    xf = x.float()
    g = _zero_lead(torch.where(finite, _lead(xf), 0.0), torch.where(finite, xf, 0.0))
    lead = torch.where(finite, g.to(torch.bfloat16), x)
    return lead, _round_bf16(torch.where(finite, xf - g, 0.0))


def split_terms_ref(x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """The split pass's output for ``x`` ``(R, C)`` or ``(nb, R, C)``, f32
    (four terms, :func:`split4`) or bf16 (two, :func:`split2`): ``(nb,
    terms, R, Cp)`` bf16, or with ``transpose`` ``(nb, terms, C, Rp)``, the
    inner axis (k, along which the chunks run) padded with zeros to a
    multiple of 8."""
    X = x if x.ndim == 3 else x[None]
    if transpose:
        X = X.transpose(1, 2)
    terms = torch.stack(split2(X) if X.dtype == torch.bfloat16 else split4(X.float()), dim=1)
    nb, nt, rows, inner = terms.shape
    out = torch.zeros((nb, nt, rows, -(-inner // 8) * 8), dtype=torch.bfloat16,
                      device=x.device)
    out[..., :inner] = terms
    return out


def terms_product_ref(ta: torch.Tensor, tb: torch.Tensor) -> torch.Tensor:
    """The product kernel's function in float64, before its roundings: for
    the terms of A ``ta`` ``(nbA, terms, M, Kp)`` and of B, transposed, ``tb``
    ``(nbB, terms, N, Kp)`` (the split pass's layouts; a batch of 1 is
    shared), the sum of ``a_i @ b_jᵀ`` over :func:`product_pairs`,
    ``(batch, M, N)``."""
    out = None
    for i, j in product_pairs(ta.shape[1], tb.shape[1]):
        p = torch.matmul(ta[:, i].double(), tb[:, j].double().transpose(-1, -2))
        out = p if out is None else out + p
    return out


def products_ref(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` as the kernels form it, in float64: the split pass's terms
    and :func:`terms_product_ref`.
    Shapes as :func:`block_matmul_ref`."""
    out = terms_product_ref(split_terms_ref(A), split_terms_ref(B, transpose=True))
    return out[0] if A.ndim == B.ndim == 2 else out
