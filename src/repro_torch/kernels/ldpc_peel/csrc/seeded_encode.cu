// Seeded-LDGM encode: codeword rows [row0, row0 + n_out) of z = G y, with
// every generator row regenerated from the seed.  No generator and no
// gather table exists anywhere.
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/ldpc_peel/kernel.py:1316 encode_seeded_fused
// (body _encode_seeded_kernel, kernel.py:1263-1313).
//
// What it computes.  G = [I_K ; P] with P the seeded (p, K) block of row
// weight r (src/repro/core/ldpc.py:654 make_seeded_ldgm).  Every output row
// runs the same r-term chain as the table gather over seeded_generator_rows
// (ldpc.py:703-731):
//   - a systematic row (< K) is weight 1 on column `row`, then r - 1
//     zero-weight pad terms on column 0.  The pad terms are kept: 0 * y[0]
//     turns a -0.0 into +0.0 and an inf or NaN in y[0] into NaN, exactly as
//     the table gather does (kernel.py:1297-1311 keeps them too);
//   - a parity row regenerates its r (column, weight) pairs from the seed
//     and visits them by ascending column (seeded_rows.cuh, shared with
//     seeded_decode.cu): sorted in registers up to r = 64, by selection
//     past it, for any r;
//   - rows at or past N = K + p run the chain with all-zero weights on
//     column 0 (kernel.py `is_par`), which gives 0 for finite y.
// The sum is taken in slot order: the first term a rounded product, every
// later term one __fmul_rn and one __fadd_rn (never a fused multiply-add),
// so it equals the port's sequential gather_encode bit for bit.  `row0` is
// a launch argument: a worker's row window builds nothing.
//
// Design.  One thread per (output row, payload column); a thread
// regenerates its row, gathers r entries of y (V floats apart) and writes
// one float.  Bound on an H100 SXM (3.35 TB/s): the encode must read y once
// and write the output once, (K + n_out) * V * 4 bytes: at Scheme 2's full
// width (K = 16,384, N = 24,576, V = 1) 164 KB, 0.05 us.  The scattered
// gathers, the hash and the sort cost more than that; speed is later work.
#include <cuda_runtime.h>

#include <cstddef>

#include "seeded_rows.cuh"

namespace {

constexpr int kThreads = 256;

// W: the sorting network's width for the parity rows (0: selection), as
// for_sorted_row takes it.
template <int W>
__global__ void __launch_bounds__(kThreads)
seeded_encode_kernel(SeededSpec sp, const float* __restrict__ y, float* out,
                     long long row0, int n_out, int V) {
  const long long it = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (it >= static_cast<long long>(n_out) * V) return;
  const long long row = row0 + it / V;
  const int c = static_cast<int>(it % V);
  const int K = sp.cols, r = sp.r;
  const long long N = static_cast<long long>(K) + sp.rows;

  float acc = 0.0f;
  bool first = true;
  auto term = [&](int j, float w) {
    const float t = __fmul_rn(w, y[static_cast<size_t>(j) * V + c]);
    acc = first ? t : __fadd_rn(acc, t);
    first = false;
  };
  if (row >= K && row < N) {
    for_sorted_row<W>(sp, static_cast<int>(row - K), term);   // a row of P
  } else {             // systematic (weight 1 on `row`), or past N; pad terms
    term(row < K ? static_cast<int>(row) : 0, row < K ? 1.0f : 0.0f);
    for (int s = 1; s < r; ++s) term(0, 0.0f);
  }
  out[static_cast<size_t>(it)] = acc;
}

template <int W>
int launch(const SeededSpec& sp, const float* y, float* out, long long row0,
           int n_out, int V, cudaStream_t stream) {
  const long long total = static_cast<long long>(n_out) * V;
  const unsigned int blocks = static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  seeded_encode_kernel<W><<<blocks, kThreads, 0, stream>>>(sp, y, out, row0, n_out, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the encode on `stream`: out (n_out, V) f32 holds codeword rows
// [row0, row0 + n_out) of y (cols, V) f32, for the seeded parity block of
// `rows` x `cols` (row weight r, `layers` layers; `layer` a device array
// of the layers' strides, offsets, inverse strides and strides mod cols,
// as seeded_rows.cuh reads it).  Returns a CUDA error code
// (0 = launched).
int seeded_encode_launch(int rows, int cols, int r, int layers,
                         unsigned int wseed, const int* layer, const float* y,
                         float* out, long long row0, int n_out, int V,
                         void* stream) {
  SeededSpec sp;
  if (row0 < 0 || n_out < 1 || V < 1 ||
      !make_spec(&sp, rows, cols, r, layers, wseed, layer)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int w = network_width(r);
  auto* go = w == 8    ? &launch<8>
             : w == 16 ? &launch<16>
             : w == 32 ? &launch<32>
             : w == 64 ? &launch<64>
                       : &launch<0>;
  return go(sp, y, out, row0, n_out, V, static_cast<cudaStream_t>(stream));
}

const char* seeded_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
