// Check rows of a seeded code, regenerated from (seed, row) on the device:
// the counterpart of the JAX package's _mix32_jnp, _seeded_row_params and
// _seeded_edge_weight (src/repro/kernels/ldpc_peel/kernel.py:812-856) and
// of the NumPy reference src/repro/core/ldpc.py:528-548, bit for bit.
// Shared by seeded_decode.cu and seeded_encode.cu.  Any row weight and any
// number of layers.
//
// Row i of layer t = i / rows_per_layer (local row jl) covers the columns
// (a_t * (jl * r + s) + b_t) mod cols, s < r, computed in 64 bits; slot s
// weighs sign * (1 + m * 2^-23), with (sign, m) from the lowbias32 hash of
// the edge counter (uint32)(i * r + s) ^ wseed.  Every f32 step is exact.
#pragma once

#include <climits>

// Widths of the sorting networks that hold a row in registers; a row
// wider than the widest is visited by repeated selection (for_sorted_row).
constexpr int kNetworkWidths[] = {16, 32, 64};

// The seeded structure as launch arguments.  The per-layer constants live
// in device memory: `layer` holds the `layers` strides a_t, then the
// `layers` offsets b_t (the wrapper uploads them once per structure), so
// neither the layer count nor the row weight has a cap.
struct SeededSpec {
  int rows;
  int cols;
  int r;
  int layers;
  int rows_per_layer;
  unsigned int wseed;
  const int* layer;
};

// Builds the spec over the device array `layer` (2 * layers ints); false
// when the kernels cannot take it.
inline bool make_spec(SeededSpec* sp, int rows, int cols, int r, int layers,
                      unsigned int wseed, const int* layer) {
  if (r < 1 || layers < 1 || rows < 1 || cols < 1 || rows % layers != 0 ||
      layer == nullptr) {
    return false;
  }
  *sp = SeededSpec{rows, cols, r, layers, rows / layers, wseed, layer};
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

// Column of slot s of row i.
__device__ __forceinline__ int seeded_col(const SeededSpec& sp, int i, int s) {
  const int t = i / sp.rows_per_layer;
  const long long jl = i - static_cast<long long>(t) * sp.rows_per_layer;
  const long long x = jl * sp.r + s;
  const long long a = __ldg(sp.layer + t), b = __ldg(sp.layer + sp.layers + t);
  return static_cast<int>((a * x + b) % sp.cols);
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

// Calls visit(column, weight) for row i's r pairs in ascending column
// order, as seeded_check_rows sorts them (ldpc.py:551-559).  Columns
// within a row are distinct, so any correct sort gives this order.
//   W > 0 (W >= r): the row is sorted in registers by an odd-even
//     transposition network over W slots (kernel.py:1289-1295), the slots
//     past r holding the column INT_MAX, so they stay at the end.
//   W == 0 (any r): repeated selection, the least column above the last
//     one, r times: O(r^2) regenerated columns and no storage.
template <int W, typename Visit>
__device__ __forceinline__ void for_sorted_row(const SeededSpec& sp, int i,
                                               Visit&& visit) {
  if constexpr (W > 0) {
    int col[W];
    float w[W];
#pragma unroll
    for (int s = 0; s < W; ++s) {
      col[s] = s < sp.r ? seeded_col(sp, i, s) : INT_MAX;
      w[s] = s < sp.r ? seeded_weight(sp, i, s) : 0.0f;
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
#pragma unroll
    for (int s = 0; s < W; ++s) {
      if (s >= sp.r) break;
      visit(col[s], w[s]);
    }
  } else {
    int prev = -1;
    for (int k = 0; k < sp.r; ++k) {
      int best = INT_MAX, best_s = 0;
      for (int s = 0; s < sp.r; ++s) {
        const int c = seeded_col(sp, i, s);
        if (c > prev && c < best) {
          best = c;
          best_s = s;
        }
      }
      visit(best, seeded_weight(sp, i, best_s));
      prev = best;
    }
  }
}
