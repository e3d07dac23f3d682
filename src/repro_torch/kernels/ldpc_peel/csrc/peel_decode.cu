// Flooding peeling decode of B erasure patterns, in one launch: the
// fixed-D contract and the early-exit (adaptive) contract.
//
// Replaces the JAX package's Pallas TPU kernels
//   src/repro/kernels/ldpc_peel/kernel.py:353 decode_fused
//   src/repro/kernels/ldpc_peel/kernel.py:402 decode_fused_batch
//   src/repro/kernels/ldpc_peel/kernel.py:459 decode_fused_adaptive
//   src/repro/kernels/ldpc_peel/kernel.py:514 decode_fused_batch_adaptive
// and their H-streaming twins decode_fused{,_batch,_adaptive,
// _batch_adaptive}_tiled (kernel.py:600, 651, 705, 761).  Each tiled kernel
// computes the same function as its resident one; it exists only because
// VMEM cannot hold a dense H past N ~ 2048.  This kernel reads the code's
// sparse neighbour table (check_idx / check_coeff, p x r) from device
// memory, so one kernel serves every N that device memory holds.  The
// single-pattern contracts are the B = 1 case.
//
// What it computes.  In each round every check row with exactly one erased
// neighbour j proposes c_j = -(sum_known H c) / H_ij (a zero coefficient
// is guarded to 1), against the state at the START of the round; when
// several checks resolve one coordinate the LOWEST check row wins
// (kernel.py:235-237).  Erased entries are never read.  Counts of erased
// neighbours are integers: solvability takes no tolerance.
//   fixed     exactly `iters` rounds for every slot.
//   adaptive  slot b stops before round d when d >= budget[b] (or `iters`
//             where no budgets are given), when round d-1 resolved nothing,
//             or when nothing is erased.  rounds[b] counts the rounds run,
//             the last no-progress probe round included (kernel.py:322-338
//             _adaptive_loop).  Budget 0, or nothing erased, returns the
//             slot untouched with 0 rounds.
//
// Design.  The grid is (ceil(V / kCols), B): a block owns up to kCols
// payload columns of one slot and recomputes that slot's whole erasure
// trajectory itself (it depends only on H, the slot's mask and budget), the
// way the TPU grid over payload tiles does; blocks share nothing.  All
// slots read the one neighbour table.  Per block, the state is the erasure
// flags (N bytes) and the winning check row per coordinate (N ints): 5N
// bytes.  It lives in shared memory while it fits (N up to ~46,000); past
// that the wrapper passes a device-memory scratch of one such state per
// block, which the kernel initialises at every launch (as seeded_decode.cu
// does), so the table decode runs at any N.  Values live in device memory
// (the output buffer) and the proposals in a (B, p, V) scratch buffer.
// Each round is four phases split by block barriers (which order the
// block's device-memory accesses as well as its shared ones):
//   A. every check counts its erased neighbours; a solvable check bids for
//      its coordinate with atomicMin(row) — the explicit "lo" tie-break;
//   B. each winning check computes its proposal into scratch, reading only
//      round-start values (nothing is written to the values in A or B);
//   C. each resolved coordinate copies its winner's proposal into the values;
//   D. the resolved coordinates leave the erased set and the bids reset.
//      The adaptive contract ends D with __syncthreads_or over "I resolved
//      a coordinate" and "a coordinate of mine is still erased": both stop
//      tests are block-wide, so every thread of a block leaves the loop
//      after the same round.  Budgets are read from device memory: varying
//      them rebuilds nothing and syncs nothing.
//
// Bound on an H100 SXM (3.35 TB/s).  At the blocked step's shape (N = 2048,
// p = 1024, r = 6, V = 32, D = 8, B = 1) the decode moves about 0.58 MB
// once, 0.17 us; at the serving shape (B = 64, V = 1) about 1.36 MB,
// 0.41 us.  Both are far below the latency of the rounds of dependent
// global loads and barriers plus the launch itself, so the kernel is
// latency-bound.  The design keeps every round inside one launch (no
// per-round relaunch) and leaves making the rounds shorter to later work.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kCols = 4;

__device__ __forceinline__ size_t at(int row, int col, int width) {
  return static_cast<size_t>(row) * static_cast<size_t>(width) + col;
}

template <bool kAdaptive>
__global__ void __launch_bounds__(kThreads)
peel_decode_kernel(const int* __restrict__ check_idx,
                   const float* __restrict__ check_coeff, int p, int r,
                   const float* __restrict__ values_in,
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
  // Adaptive: "something is erased" for the whole slot; the barrier also
  // publishes the flags and bids.
  int any_erased = kAdaptive ? __syncthreads_or(mine_erased) : 1;
  if (!kAdaptive) __syncthreads();
  int progressed = 1;

  int t = 0;
  for (; t < budget; ++t) {
    if (kAdaptive && !(progressed && any_erased)) break;

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

template <bool kAdaptive>
int launch(const int* check_idx, const float* check_coeff, int p, int r,
           const float* values_in, const unsigned char* erased_in,
           const int* budgets, float* values_out, unsigned char* erased_out,
           int* rounds_out, float* scratch, unsigned char* state, int B, int N,
           int V, int iters, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        peel_decode_kernel<kAdaptive>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((V + kCols - 1) / kCols, B);
  peel_decode_kernel<kAdaptive><<<grid, kThreads, smem, stream>>>(
      check_idx, check_coeff, p, r, values_in, erased_in, budgets, values_out,
      erased_out, rounds_out, scratch, state, N, V, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Per-block state of a code of length N, in bytes: erasure flags padded to
// 16 bytes, then one int per coordinate.
size_t peel_decode_smem_bytes(int N) {
  return static_cast<size_t>((N + 15) & ~15) + 4 * static_cast<size_t>(N);
}

// Launches the decode of B patterns on `stream`: values (B, N, V) f32,
// erased (B, N) bytes, scratch (B, p, V) f32.  `state` null: the per-block
// state lives in shared memory; else a device buffer of
// ceil(V / 4) * B * peel_decode_smem_bytes(N) bytes.  adaptive = 0: exactly
// `iters` rounds (budgets and rounds_out unused).  adaptive = 1: early exit
// under budgets (B,) int32, or `iters` for every slot where budgets is
// null; rounds_out (B,) int32.  Returns cudaGetLastError() (0 = launched).
int peel_decode_launch(const int* check_idx, const float* check_coeff, int p,
                       int r, const float* values_in,
                       const unsigned char* erased_in, const int* budgets,
                       float* values_out, unsigned char* erased_out,
                       int* rounds_out, float* scratch, unsigned char* state,
                       int B, int N, int V, int iters, int adaptive,
                       void* stream) {
  const size_t smem = state == nullptr ? peel_decode_smem_bytes(N) : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (adaptive) {
    return launch<true>(check_idx, check_coeff, p, r, values_in, erased_in,
                        budgets, values_out, erased_out, rounds_out, scratch,
                        state, B, N, V, iters, smem, s);
  }
  return launch<false>(check_idx, check_coeff, p, r, values_in, erased_in,
                       nullptr, values_out, erased_out, nullptr, scratch,
                       state, B, N, V, iters, smem, s);
}

const char* peel_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
