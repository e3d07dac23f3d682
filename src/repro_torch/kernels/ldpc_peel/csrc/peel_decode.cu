// Fixed-D flooding peeling decode of one erasure pattern, in one launch.
//
// Replaces the JAX package's Pallas TPU kernels
//   src/repro/kernels/ldpc_peel/kernel.py:353 decode_fused        (H resident in VMEM)
//   src/repro/kernels/ldpc_peel/kernel.py:600 decode_fused_tiled  (H streamed from HBM)
// Both compute the same function; the tiled one exists only because VMEM
// cannot hold a dense H past N ~ 2048.  This kernel reads the code's sparse
// neighbour table (check_idx / check_coeff, p x r) from device memory, so one
// kernel serves every N whose per-block state fits in shared memory.
//
// What it computes.  Exactly `iters` rounds.  In each round every check row
// with exactly one erased neighbour j proposes c_j = -(sum_known H c) / H_ij
// (a zero coefficient is guarded to 1), against the state at the START of the
// round; when several checks resolve one coordinate the LOWEST check row wins
// (kernel.py:235-237).  Erased entries are never read.  Counts of erased
// neighbours are integers: solvability takes no tolerance.
//
// Design.  A block owns up to kCols payload columns and recomputes the whole
// erasure trajectory itself (it depends only on H and the initial mask), the
// way the TPU grid over payload tiles does; blocks share nothing.  Per block,
// shared memory holds the erasure flags (N bytes) and the winning check row
// per coordinate (N ints): 5N bytes, so N up to ~46k.  Values live in device
// memory (the output buffer) and the proposals in a (p, V) scratch buffer.
// Each round is four phases split by block barriers:
//   A. every check counts its erased neighbours; a solvable check bids for
//      its coordinate with atomicMin(row) — the explicit "lo" tie-break;
//   B. each winning check computes its proposal into scratch, reading only
//      round-start values (nothing is written to the values in A or B);
//   C. each resolved coordinate copies its winner's proposal into the values;
//   D. the resolved coordinates leave the erased set and the bids reset.
//
// Bound on an H100 SXM (3.35 TB/s).  At the full-width shape (N = 2048,
// p = 1024, r = 6, V = 32, D = 8) the decode moves about 0.58 MB once (tables,
// values in and out, masks), 0.17 us; reading the tables and the values
// every round is 4.6 MB, 1.4 us.  Both are far below the latency of D
// rounds of dependent global loads and barriers plus the launch itself, so
// the kernel is latency-bound.  The design keeps every round inside one
// launch (no per-round relaunch) and leaves making the rounds shorter to
// later work.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kCols = 4;

__device__ __forceinline__ size_t at(int row, int col, int width) {
  return static_cast<size_t>(row) * static_cast<size_t>(width) + col;
}

__global__ void __launch_bounds__(kThreads)
peel_decode_kernel(const int* __restrict__ check_idx,
                   const float* __restrict__ check_coeff, int p, int r,
                   const float* __restrict__ values_in,
                   const unsigned char* __restrict__ erased_in,
                   float* values_out, unsigned char* erased_out,
                   float* scratch, int N, int V, int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* e = smem;                                        // N flags
  int* win = reinterpret_cast<int*>(smem + ((N + 15) & ~15));     // N rows

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kCols;
  const int nc = min(kCols, V - c0);

  for (int j = tid; j < N; j += blockDim.x) {
    e[j] = erased_in[j] ? 1 : 0;
    win[j] = INT_MAX;
  }
  for (int it = tid; it < N * nc; it += blockDim.x) {
    const int j = it / nc, c = c0 + it % nc;
    values_out[at(j, c, V)] = values_in[at(j, c, V)];
  }
  __syncthreads();

  for (int t = 0; t < iters; ++t) {
    // A. count erased neighbours; solvable checks bid for their coordinate.
    for (int i = tid; i < p; i += blockDim.x) {
      const int* nbr = check_idx + at(i, 0, r);
      int cnt = 0, pos = -1;
      for (int s = 0; s < r; ++s) {
        const int j = nbr[s];
        if (j < N && e[j]) {
          ++cnt;
          pos = j;
        }
      }
      if (cnt == 1) atomicMin(&win[pos], i);
    }
    __syncthreads();

    // B. winners compute their proposals against the round-start values.
    for (int it = tid; it < p * nc; it += blockDim.x) {
      const int i = it / nc, c = c0 + it % nc;
      const int* nbr = check_idx + at(i, 0, r);
      const float* w = check_coeff + at(i, 0, r);
      int cnt = 0, pos = -1;
      float coeff = 0.0f;
      for (int s = 0; s < r; ++s) {
        const int j = nbr[s];
        if (j < N && e[j]) {
          ++cnt;
          pos = j;
          coeff = w[s];
        }
      }
      if (cnt != 1 || win[pos] != i) continue;
      float sum = 0.0f;
      for (int s = 0; s < r; ++s) {
        const int j = nbr[s];
        if (j < N && !e[j]) sum = __fadd_rn(sum, __fmul_rn(w[s], values_out[at(j, c, V)]));
      }
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
    for (int j = tid; j < N; j += blockDim.x) {
      if (win[j] != INT_MAX) {
        e[j] = 0;
        win[j] = INT_MAX;
      }
    }
    __syncthreads();
  }

  if (blockIdx.x == 0) {
    for (int j = tid; j < N; j += blockDim.x) erased_out[j] = e[j];
  }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for a code of length N, in bytes.
size_t peel_decode_smem_bytes(int N) {
  return static_cast<size_t>((N + 15) & ~15) + 4 * static_cast<size_t>(N);
}

// Launches the decode on `stream`; returns cudaGetLastError() (0 = launched).
int peel_decode_launch(const int* check_idx, const float* check_coeff, int p,
                       int r, const float* values_in,
                       const unsigned char* erased_in, float* values_out,
                       unsigned char* erased_out, float* scratch, int N, int V,
                       int iters, void* stream) {
  const size_t smem = peel_decode_smem_bytes(N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        peel_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((V + kCols - 1) / kCols);
  peel_decode_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      check_idx, check_coeff, p, r, values_in, erased_in, values_out,
      erased_out, scratch, N, V, iters);
  return static_cast<int>(cudaGetLastError());
}

const char* peel_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
