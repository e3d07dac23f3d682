// Check rows of a seeded code, regenerated from (seed, row) on the device:
// the counterpart of the JAX package's _mix32_jnp, _seeded_row_params and
// _seeded_edge_weight (src/repro/kernels/ldpc_peel/kernel.py:812-856) and
// of the NumPy reference src/repro/core/ldpc.py:528-548, bit for bit.
// Shared by seeded_decode.cu and seeded_encode.cu.
//
// Row i of layer t = i / rows_per_layer (local row jl) covers the columns
// (a_t * (jl * r + s) + b_t) mod cols, s < r, computed in 64 bits; slot s
// weighs sign * (1 + m * 2^-23), with (sign, m) from the lowbias32 hash of
// the edge counter (uint32)(i * r + s) ^ wseed.  Every f32 step is exact.
#pragma once

#include <climits>

constexpr int kMaxR = 16;
constexpr int kMaxLayers = 16;

// The seeded structure as launch arguments (layer constants included).
struct SeededSpec {
  int rows;
  int cols;
  int r;
  int rows_per_layer;
  unsigned int wseed;
  int stride[kMaxLayers];
  int offset[kMaxLayers];
};

// Builds the spec from host arrays of `layers` strides and offsets; false
// when the kernels cannot take it.
inline bool make_spec(SeededSpec* sp, int rows, int cols, int r, int layers,
                      unsigned int wseed, const int* strides, const int* offsets) {
  if (r < 1 || r > kMaxR || layers < 1 || layers > kMaxLayers || rows % layers != 0) {
    return false;
  }
  *sp = SeededSpec{};
  sp->rows = rows;
  sp->cols = cols;
  sp->r = r;
  sp->rows_per_layer = rows / layers;
  sp->wseed = wseed;
  for (int t = 0; t < layers; ++t) {
    sp->stride[t] = strides[t];
    sp->offset[t] = offsets[t];
  }
  return true;
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
  return static_cast<int>((sp.stride[t] * x + sp.offset[t]) % sp.cols);
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

// Row i's r (column, weight) pairs in ascending column order, as
// seeded_check_rows sorts them (ldpc.py:551-559): an odd-even transposition
// network over kMaxR slots (kernel.py:1289-1295), the slots past r holding
// the column INT_MAX, so they stay at the end.  Columns within a row are
// distinct, so any correct sort gives this order.
__device__ __forceinline__ void seeded_sorted_row(const SeededSpec& sp, int i,
                                                  int col[kMaxR], float w[kMaxR]) {
#pragma unroll
  for (int s = 0; s < kMaxR; ++s) {
    col[s] = s < sp.r ? seeded_col(sp, i, s) : INT_MAX;
    w[s] = s < sp.r ? seeded_weight(sp, i, s) : 0.0f;
  }
#pragma unroll
  for (int pass = 0; pass < kMaxR; ++pass) {
#pragma unroll
    for (int q = pass % 2; q + 1 < kMaxR; q += 2) {
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
