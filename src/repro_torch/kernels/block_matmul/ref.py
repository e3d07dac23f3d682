"""The plain PyTorch versions of the matrix-product kernels.

* :func:`block_matmul_ref`: the product in float32 of the float32-cast
  inputs (float64 when both inputs are float64: the port's float64
  reference runs), as the JAX package's ``block_matmul/ref.py`` computes
  it.  The wrapper (:func:`.ops.block_matmul`) runs it for CPU tensors;
  ``chip_smoke.py`` and tests/test_torch_cuda.py hold the kernel against
  it, and against float64, on the card (the accuracy gates).
* :func:`split_terms_ref`: the split pass, each f32 value as three bf16
  terms that sum to it and each bf16 value as two, in the padded layout
  the kernel writes.  The card
  holds the split kernel to it bit for bit.
* :func:`terms_product_ref`: the product kernel's arithmetic, the products
  of the terms that it runs (``PRODUCT_ORDER``), summed in float64: what
  the kernel computes before its own roundings; :func:`products_ref` the
  same from A and B.  The CPU tests hold it against JAX and float64.

Nothing on the encode's path calls these when a card is present.
"""
from __future__ import annotations

import torch

__all__ = ["block_matmul_ref", "split3", "split2", "split_terms_ref", "terms_product_ref",
           "products_ref", "PRODUCT_ORDER", "EXACT_ABOVE", "BOTTOM_ERROR"]

# The kernel runs the term products a_i·b_j (0-based) with i + j <= this:
# of two f32 operands eight of the nine, all but the smallest, |a_2·b_2| <=
# 2^-32·|a|·|b|; with a bf16 operand (two terms) all of them.
PRODUCT_ORDER = 3
# The three terms sum to x exactly for |x| >= 2^-110; below, within 2^-134.
EXACT_ABOVE = 2.0 ** -110
BOTTOM_ERROR = 2.0 ** -134

_NAN_BITS = 0x7FC0


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


def split3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 ``x`` as bf16 terms ``(x1, x2, x3)``: ``x1`` the bf16 rounding of
    x (to nearest even, or toward zero where that would give inf), ``x2``
    the rounding of ``r = x - x1``, ``x3`` that of ``r - x2``, each
    difference exact in f32.  They sum to x exactly for |x| >= 2^-110, and
    within 2^-134 below.  An inf or NaN is its own first term (NaN as
    0x7FC0) with zeros after it."""
    finite = torch.isfinite(x)
    xf = torch.where(finite, x, 0.0)
    h1 = _round_bf16(xf)
    h1 = torch.where(torch.isinf(h1.float()), _bf16_of_bits(_bits(xf) >> 16), h1)
    r = xf - h1.float()
    h2 = _round_bf16(r)
    h3 = _round_bf16(r - h2.float())
    nan = torch.full_like(h1, 0.0).view(torch.int16).fill_(_NAN_BITS).view(torch.bfloat16)
    h1 = torch.where(finite, h1, torch.where(torch.isnan(x), nan, x.to(torch.bfloat16)))
    return h1, h2, h3


def split2(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """bf16 ``x`` as two bf16 terms of 4 significant bits, ``x1`` its bits
    with the last 4 of the fraction cleared and ``x2 = x - x1``, exact.  An
    inf or NaN is its own first term (its bits) with a zero after it."""
    bits = x.view(torch.int16).to(torch.int64) & 0xFFFF
    finite = torch.isfinite(x)
    h1 = torch.where(finite, _bf16_of_bits(bits & 0xFFF0), x)
    h2 = _round_bf16(torch.where(finite, x.float() - h1.float(), 0.0))
    return h1, h2


def split_terms_ref(x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """The split pass's output for ``x`` ``(R, C)`` or ``(nb, R, C)``, f32
    (three terms, :func:`split3`) or bf16 (two, :func:`split2`): ``(nb,
    terms, R, Cp)`` bf16, or with ``transpose`` ``(nb, terms, C, Rp)``, the
    inner axis padded with zeros to a multiple of 8."""
    X = x if x.ndim == 3 else x[None]
    if transpose:
        X = X.transpose(1, 2)
    terms = torch.stack(split2(X) if X.dtype == torch.bfloat16 else split3(X.float()), dim=1)
    nb, nt, rows, inner = terms.shape
    out = torch.zeros((nb, nt, rows, -(-inner // 8) * 8), dtype=torch.bfloat16,
                      device=x.device)
    out[..., :inner] = terms
    return out


def terms_product_ref(ta: torch.Tensor, tb: torch.Tensor) -> torch.Tensor:
    """The product kernel's function in float64, before its roundings: for
    the terms of A ``ta`` ``(nbA, terms, M, Kp)`` and of B, transposed, ``tb``
    ``(nbB, terms, N, Kp)`` (the split pass's layouts; a batch of 1 is
    shared), the sum of ``a_i @ b_jᵀ`` over the term products with ``i + j
    <= PRODUCT_ORDER`` (0-based), ``(batch, M, N)``."""
    out = None
    for i in range(ta.shape[1]):
        for j in range(tb.shape[1]):
            if i + j <= PRODUCT_ORDER:
                p = torch.matmul(ta[:, i].double(), tb[:, j].double().transpose(-1, -2))
                out = p if out is None else out + p
    return out


def products_ref(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` as the kernels form it, in float64: the split pass's terms
    and :func:`terms_product_ref`.
    Shapes as :func:`block_matmul_ref`."""
    out = terms_product_ref(split_terms_ref(A), split_terms_ref(B, transpose=True))
    return out[0] if A.ndim == B.ndim == 2 else out
