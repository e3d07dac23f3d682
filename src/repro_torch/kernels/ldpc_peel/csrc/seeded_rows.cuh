// Check rows of a seeded code, regenerated from (seed, row) on the device:
// the counterpart of the JAX package's _mix32_jnp, _seeded_row_params and
// _seeded_edge_weight (src/repro/kernels/ldpc_peel/kernel.py:812-856) and
// of the NumPy reference src/repro/core/ldpc.py:528-548, bit for bit.
// Shared by seeded_decode.cu and seeded_encode.cu.  Any row weight and any
// number of layers.
//
// Row i of layer t = i / rows_per_layer (local row jl) covers the columns
// (a_t * (jl * r + s) + b_t) mod cols, s < r; slot s weighs sign * (1 + m *
// 2^-23), with (sign, m) from the lowbias32 hash of the edge counter
// (uint32)(i * r + s) ^ wseed.  Every f32 step is exact.  A row's first
// column takes one 32-bit reduction (the structure keeps a_t * x + b_t
// below 2^31, ldpc.py's seeded_structure); each next slot adds a_t mod cols
// and subtracts cols at most once.  Each layer is a permutation of the
// columns (gcd(a_t, cols) = 1), so column j lies in exactly one row of it:
// x = a_t^-1 * (j - b_t) mod cols, row t * rows_per_layer + x / r, slot
// x mod r (row_of, by a Barrett reduction).
#pragma once

#include <climits>

// Widths of the sorting networks that hold a row in registers; a row
// wider than the widest is visited by repeated selection (for_sorted_row).
constexpr int kNetworkWidths[] = {8, 16, 32, 64};

// The seeded structure as launch arguments.  The per-layer constants live
// in device memory: `layer` holds the `layers` strides a_t, the `layers`
// offsets b_t, the inverse strides a_t^-1 mod cols and the strides mod
// cols (the wrapper uploads them once per structure), so neither the layer
// count nor the row weight has a cap.  inv_cols: floor((2^64 - 1) / cols),
// the Barrett reciprocal of row_of; rcp_*: floor((2^32 - 1) / d) for the
// 32-bit divisions by cols, r and rows_per_layer (udiv).
struct SeededSpec {
  int rows;
  int cols;
  int r;
  int layers;
  int rows_per_layer;
  unsigned int wseed;
  const int* layer;
  unsigned long long inv_cols;
  unsigned rcp_cols, rcp_r, rcp_rpl;
};

// Builds the spec over the device array `layer` (4 * layers ints); false
// when the kernels cannot take it.
inline bool make_spec(SeededSpec* sp, int rows, int cols, int r, int layers,
                      unsigned int wseed, const int* layer) {
  if (r < 1 || layers < 1 || rows < 1 || cols < 1 || rows % layers != 0 ||
      layer == nullptr) {
    return false;
  }
  const int rpl = rows / layers;
  *sp = SeededSpec{rows, cols, r, layers, rpl, wseed, layer,
                   ~0ull / static_cast<unsigned long long>(cols), 0xFFFFFFFFu / cols,
                   0xFFFFFFFFu / r, 0xFFFFFFFFu / rpl};
  return true;
}

// The network width a row of weight r is sorted in, or 0 past the widest
// network (rows visited by selection).
inline int network_width(int r) {
  for (const int w : kNetworkWidths) {
    if (r <= w) return w;
  }
  return 0;
}

__device__ __forceinline__ unsigned int mix32(unsigned int x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// x / d for 32-bit x, by the reciprocal rcp = floor((2^32 - 1) / d): the
// high product is the quotient or one below it, so one correction.
__device__ __forceinline__ unsigned udiv(unsigned x, unsigned d, unsigned rcp) {
  const unsigned q = __umulhi(x, rcp);
  return x - q * d >= d ? q + 1 : q;
}

// The layer of row i.
__device__ __forceinline__ int layer_of(const SeededSpec& sp, int i) {
  return static_cast<int>(udiv(i, sp.rows_per_layer, sp.rcp_rpl));
}

// Column of slot 0 of row i, and in `step` the stride from one slot's
// column to the next (a_t mod cols).
__device__ __forceinline__ unsigned first_col(const SeededSpec& sp, int i, unsigned& step) {
  const int t = layer_of(sp, i);
  const unsigned x0 = static_cast<unsigned>(i - t * sp.rows_per_layer) * sp.r;
  const unsigned a = __ldg(sp.layer + t), b = __ldg(sp.layer + sp.layers + t);
  step = __ldg(sp.layer + 3 * sp.layers + t);
  const unsigned v = a * x0 + b;
  return v - udiv(v, sp.cols, sp.rcp_cols) * sp.cols;
}

// The column of the next slot after column c.
__device__ __forceinline__ unsigned next_col(const SeededSpec& sp, unsigned c, unsigned step) {
  c += step;
  return c >= static_cast<unsigned>(sp.cols) ? c - sp.cols : c;
}

// The row of layer t that holds column j.
__device__ __forceinline__ int row_of(const SeededSpec& sp, unsigned j, int t) {
  const unsigned cols = sp.cols;
  const unsigned b = __ldg(sp.layer + sp.layers + t);
  const unsigned inv = __ldg(sp.layer + 2 * sp.layers + t);
  const unsigned long long prod =
      static_cast<unsigned long long>(inv) * (j >= b ? j - b : j + cols - b);
  unsigned long long x = prod - __umul64hi(prod, sp.inv_cols) * cols;
  while (x >= cols) x -= cols;
  return t * sp.rows_per_layer +
         static_cast<int>(udiv(static_cast<unsigned>(x), sp.r, sp.rcp_r));
}

// Weight of slot s of row i.
__device__ __forceinline__ float seeded_weight(const SeededSpec& sp, int i, int s) {
  const unsigned int edge =
      static_cast<unsigned int>(i) * static_cast<unsigned int>(sp.r) + s;
  const unsigned int u = mix32(edge ^ sp.wseed);
  const float sign = __fsub_rn(1.0f, __fmul_rn(2.0f, __uint2float_rn(u & 1u)));
  const float m = __uint2float_rn(u >> 9);
  return __fmul_rn(sign, __fadd_rn(1.0f, __fmul_rn(m, 1.0f / 8388608.0f)));
}

// Row i's r pairs sorted by column into col and w (W >= r): an odd-even
// transposition network over W slots (kernel.py:1289-1295), the slots past
// r holding the column INT_MAX, so they stay at the end.  Columns within a
// row are distinct, so any correct sort gives this order.
template <int W>
__device__ __forceinline__ void sorted_row(const SeededSpec& sp, int i, int (&col)[W],
                                           float (&w)[W]) {
  unsigned step;
  unsigned c = first_col(sp, i, step);
#pragma unroll
  for (int s = 0; s < W; ++s) {
    col[s] = s < sp.r ? static_cast<int>(c) : INT_MAX;
    w[s] = s < sp.r ? seeded_weight(sp, i, s) : 0.0f;
    c = next_col(sp, c, step);
  }
#pragma unroll
  for (int pass = 0; pass < W; ++pass) {
#pragma unroll
    for (int q = pass % 2; q + 1 < W; q += 2) {
      if (col[q] > col[q + 1]) {
        const int tc = col[q];
        col[q] = col[q + 1];
        col[q + 1] = tc;
        const float tw = w[q];
        w[q] = w[q + 1];
        w[q + 1] = tw;
      }
    }
  }
}

// Calls visit(column, weight) for row i's r pairs in ascending column
// order, as seeded_check_rows sorts them (ldpc.py:551-559).
//   W > 0 (W >= r): sorted in registers (sorted_row).
//   W == 0 (any r): repeated selection, the least column above the last
//     one, r times: O(r^2) stepped columns and no storage.
template <int W, typename Visit>
__device__ __forceinline__ void for_sorted_row(const SeededSpec& sp, int i,
                                               Visit&& visit) {
  if constexpr (W > 0) {
    int col[W];
    float w[W];
    sorted_row<W>(sp, i, col, w);
#pragma unroll
    for (int s = 0; s < W; ++s) {
      if (s >= sp.r) break;
      visit(col[s], w[s]);
    }
  } else {
    int prev = -1;
    unsigned step;
    const unsigned c0 = first_col(sp, i, step);
    for (int k = 0; k < sp.r; ++k) {
      int best = INT_MAX, best_s = 0;
      unsigned c = c0;
      for (int s = 0; s < sp.r; ++s) {
        if (static_cast<int>(c) > prev && static_cast<int>(c) < best) {
          best = static_cast<int>(c);
          best_s = s;
        }
        c = next_col(sp, c, step);
      }
      visit(best, seeded_weight(sp, i, best_s));
      prev = best;
    }
  }
}
