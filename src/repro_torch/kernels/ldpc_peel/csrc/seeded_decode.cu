// Flooding peeling decode of B erasure patterns of a SEEDED code, in one
// launch: the fixed-D and the early-exit (adaptive) contracts, with no
// parity-check operand at all.  Each check row's (column, weight) pairs are
// regenerated from (seed, row) whenever the round needs them.
//
// Replaces the JAX package's Pallas TPU kernels
//   src/repro/kernels/ldpc_peel/kernel.py:1069 decode_seeded
//   src/repro/kernels/ldpc_peel/kernel.py:1122 decode_seeded_batch
//   src/repro/kernels/ldpc_peel/kernel.py:1172 decode_seeded_adaptive
//   src/repro/kernels/ldpc_peel/kernel.py:1223 decode_seeded_batch_adaptive
// with their helpers seeded_h_tile, _seeded_round, _mod_mul and
// _seeded_gather_round (kernel.py:859-1000); the row generator
// (_mix32_jnp, _seeded_row_params, _seeded_edge_weight) is seeded_rows.cuh.
// The TPU kernels choose between two round layouts ("dense_tile": a
// regenerated (bp, N) tile through the matrix unit; "gather": r pairs per
// row and the layered permutation's inverse to merge).  Both follow the
// same erasure trajectory; this kernel is one round that stands for both.
//
// What it computes: exactly what peel_decode.cu computes over a code's
// neighbour table, with the table replaced by the seed (seeded_rows.cuh).
// A winning row sorts its r pairs by column in registers and sums its
// known neighbours in ascending column order with one rounded multiply and
// one rounded add per term, as seeded_check_rows sorts the table
// (src/repro/core/ldpc.py:551-559).  So on a make_seeded_ldpc code this
// kernel equals peel_decode.cu over the same code's table bit for bit.  The "lo"
// tie-break (lowest check row wins, an explicit atomicMin bid) and the
// stopping rules are those of peel_decode.cu.
//
// Design.  peel_decode.cu's grid (payload column blocks, slots), its
// phases A-D and its block-wide __syncthreads_or stop test.  Per-block
// state is the erasure flags (N bytes) and the winning row per coordinate
// (4N bytes).  It lives in shared memory while it fits (N up to ~46,000);
// past that the wrapper passes a device-memory scratch of one such state
// per block, which the kernel initialises at every launch, so the
// structure-only decode runs at N = 262,144 and beyond.  The layer
// constants live in a small device array, so any number of layers is
// taken; a winning row is sorted in registers by a network of width 16,
// 32 or 64 (the least that holds r, a template argument), and past 64 is
// visited by selection, so any row weight is taken (seeded_rows.cuh).
//
// Bound on an H100 SXM (3.35 TB/s).  No table is read: the decode must
// move the values in and out (8 B·N·V), the masks (2 B·N) and, adaptive,
// the budgets and rounds.  At N = 32,768, V = 2, B = 1 that is 0.59 MB,
// 0.18 us; at N = 262,144, V = 1, 2.6 MB, 0.78 us.  The rounds of
// dependent loads and barriers inside one block cost far more: the kernel
// is latency-bound, and making the rounds shorter is later work.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

#include "seeded_rows.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kCols = 4;

__device__ __forceinline__ size_t at(int row, int col, int width) {
  return static_cast<size_t>(row) * static_cast<size_t>(width) + col;
}

// W: the sorting network's width (0: selection), as for_sorted_row takes it.
template <bool kAdaptive, int W>
__global__ void __launch_bounds__(kThreads)
seeded_decode_kernel(SeededSpec sp, const float* __restrict__ values_in,
                     const unsigned char* __restrict__ erased_in,
                     const int* __restrict__ budgets, float* values_out,
                     unsigned char* erased_out, int* rounds_out, float* scratch,
                     unsigned char* state, int N, int V, int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t state_bytes = static_cast<size_t>((N + 15) & ~15) + 4 * static_cast<size_t>(N);
  unsigned char* base =
      state == nullptr
          ? smem
          : state + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * state_bytes;
  unsigned char* e = base;                                        // N flags
  int* win = reinterpret_cast<int*>(base + ((N + 15) & ~15));     // N rows

  const int p = sp.rows, r = sp.r;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCols;
  const int nc = min(kCols, V - c0);
  values_in += static_cast<size_t>(b) * N * V;
  values_out += static_cast<size_t>(b) * N * V;
  erased_in += static_cast<size_t>(b) * N;
  scratch += static_cast<size_t>(b) * p * V;
  const int budget = (kAdaptive && budgets != nullptr) ? budgets[b] : iters;

  int mine_erased = 0;
  for (int j = tid; j < N; j += blockDim.x) {
    e[j] = erased_in[j] ? 1 : 0;
    mine_erased |= e[j];
    win[j] = INT_MAX;
  }
  for (int it = tid; it < N * nc; it += blockDim.x) {
    const int j = it / nc, c = c0 + it % nc;
    values_out[at(j, c, V)] = values_in[at(j, c, V)];
  }
  int any_erased = kAdaptive ? __syncthreads_or(mine_erased) : 1;
  if (!kAdaptive) __syncthreads();
  int progressed = 1;

  int t = 0;
  for (; t < budget; ++t) {
    if (kAdaptive && !(progressed && any_erased)) break;

    // A. count erased neighbours; solvable checks bid for their coordinate.
    for (int i = tid; i < p; i += blockDim.x) {
      int cnt = 0, pos = -1;
      for (int s = 0; s < r; ++s) {
        const int j = seeded_col(sp, i, s);
        if (e[j]) {
          ++cnt;
          pos = j;
        }
      }
      if (cnt == 1) atomicMin(&win[pos], i);
    }
    __syncthreads();

    // B. winners regenerate their row, sort it by column and compute their
    // proposals against the round-start values.
    for (int it = tid; it < p * nc; it += blockDim.x) {
      const int i = it / nc, c = c0 + it % nc;
      int cnt = 0, pos = -1;
      for (int s = 0; s < r; ++s) {
        const int j = seeded_col(sp, i, s);
        if (e[j]) {
          ++cnt;
          pos = j;
        }
      }
      if (cnt != 1 || win[pos] != i) continue;
      float sum = 0.0f, coeff = 0.0f;
      for_sorted_row<W>(sp, i, [&](int j, float w) {
        if (e[j]) {
          coeff = w;
        } else {
          sum = __fadd_rn(sum, __fmul_rn(w, values_out[at(j, c, V)]));
        }
      });
      scratch[at(i, c, V)] = __fdiv_rn(-sum, coeff == 0.0f ? 1.0f : coeff);
    }
    __syncthreads();

    // C. resolved coordinates take their winner's proposal.
    for (int it = tid; it < N * nc; it += blockDim.x) {
      const int j = it / nc, c = c0 + it % nc;
      const int wrow = win[j];
      if (wrow != INT_MAX) values_out[at(j, c, V)] = scratch[at(wrow, c, V)];
    }
    __syncthreads();

    // D. resolved coordinates leave the erased set; bids reset.
    int mine_resolved = 0;
    mine_erased = 0;
    for (int j = tid; j < N; j += blockDim.x) {
      if (win[j] != INT_MAX) {
        e[j] = 0;
        win[j] = INT_MAX;
        mine_resolved = 1;
      }
      mine_erased |= e[j];
    }
    if (kAdaptive) {
      progressed = __syncthreads_or(mine_resolved);
      any_erased = __syncthreads_or(mine_erased);
    } else {
      __syncthreads();
    }
  }

  if (blockIdx.x == 0) {
    unsigned char* out = erased_out + static_cast<size_t>(b) * N;
    for (int j = tid; j < N; j += blockDim.x) out[j] = e[j];
    if (kAdaptive && tid == 0) rounds_out[b] = t;
  }
}

template <bool kAdaptive, int W>
int launch(const SeededSpec& sp, const float* values_in,
           const unsigned char* erased_in, const int* budgets, float* values_out,
           unsigned char* erased_out, int* rounds_out, float* scratch,
           unsigned char* state, int B, int N, int V, int iters, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        seeded_decode_kernel<kAdaptive, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((V + kCols - 1) / kCols, B);
  seeded_decode_kernel<kAdaptive, W><<<grid, kThreads, smem, stream>>>(
      sp, values_in, erased_in, budgets, values_out, erased_out, rounds_out,
      scratch, state, N, V, iters);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAdaptive>
int launch_width(const SeededSpec& sp, const float* values_in,
                 const unsigned char* erased_in, const int* budgets,
                 float* values_out, unsigned char* erased_out, int* rounds_out,
                 float* scratch, unsigned char* state, int B, int N, int V,
                 int iters, size_t smem, cudaStream_t stream) {
  const int w = network_width(sp.r);
  auto* go = w == 16   ? &launch<kAdaptive, 16>
             : w == 32 ? &launch<kAdaptive, 32>
             : w == 64 ? &launch<kAdaptive, 64>
                       : &launch<kAdaptive, 0>;
  return go(sp, values_in, erased_in, budgets, values_out, erased_out,
            rounds_out, scratch, state, B, N, V, iters, smem, stream);
}

}  // namespace

extern "C" {

// Per-block state of a code of length N, in bytes: erasure flags padded to
// 16 bytes, then one int per coordinate.
size_t seeded_decode_state_bytes(int N) {
  return static_cast<size_t>((N + 15) & ~15) + 4 * static_cast<size_t>(N);
}

// Launches the decode of B patterns of the seeded code (rows x cols block,
// row weight r, `layers` layers of rows / layers rows each, `layer` a
// device array of the layers' strides, then their offsets) on `stream`:
// values (B, N, V) f32, erased (B, N) bytes, scratch (B, rows, V) f32,
// N == cols.  `state` null: the per-block state lives in shared memory;
// else a device buffer of ceil(V / 4) * B * seeded_decode_state_bytes(N)
// bytes.  adaptive = 0: exactly `iters` rounds (budgets and rounds_out
// unused).  adaptive = 1: early exit under budgets (B,) int32, or `iters`
// for every slot where budgets is null; rounds_out (B,) int32.  Returns a
// CUDA error code (0 = launched).
int seeded_decode_launch(int rows, int cols, int r, int layers,
                         unsigned int wseed, const int* layer,
                         const float* values_in,
                         const unsigned char* erased_in, const int* budgets,
                         float* values_out, unsigned char* erased_out,
                         int* rounds_out, float* scratch, unsigned char* state,
                         int B, int N, int V, int iters, int adaptive,
                         void* stream) {
  SeededSpec sp;
  if (N != cols || !make_spec(&sp, rows, cols, r, layers, wseed, layer)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = state == nullptr ? seeded_decode_state_bytes(N) : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (adaptive) {
    return launch_width<true>(sp, values_in, erased_in, budgets, values_out,
                              erased_out, rounds_out, scratch, state, B, N, V,
                              iters, smem, s);
  }
  return launch_width<false>(sp, values_in, erased_in, nullptr, values_out,
                             erased_out, nullptr, scratch, state, B, N, V,
                             iters, smem, s);
}

const char* seeded_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
