// The check-node pass of one flooding round of the peeling decode, over a
// dense parity-check matrix.
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/ldpc_peel/kernel.py:169 check_pass
// (body _check_kernel, kernel.py:142-166), which the JAX package runs
// behind its one-round entry point ldpc_peel/ops.py:126 peel_round_pallas
// (_peel_round_impl, ops.py:98-123); the port's counterpart is
// ops.peel_round_cuda.
//
// What it computes.  For H (p, N) f32, values (N, V) f32 and erased (N,)
// bytes, every check row i gives
//   cnt[i]   = the number of erased columns j with H[i, j] != 0 (as f32),
//   pos[i]   = the highest such column, -1 if none (kernel.py:156-158),
//   coeff[i] = H[i, pos[i]], 0 if none,
//   sums[i, c] = Σ_j H[i, j]·known[j, c], known = values·(1 − erased),
// over every column j, zeros of H included, as the TPU kernel's dense
// product does: known = v·0 is NaN for an erased NaN or inf, and then
// H[i, j]·NaN makes every row's sum NaN, as in JAX.  Each sum is taken in
// ascending j, one rounded product (__fmul_rn) and one rounded add
// (__fadd_rn) per term, starting from +0, never a fused multiply-add:
// the plain version (ref.check_pass_ref) sums in the same order and
// agrees bit for bit.  Any p, N and V: the TPU kernel's padding of N to
// 128 and p to its tile (ops.py:106-108) is not needed here.
//
// Design.  One block of 256 threads per tile of 32 check rows x 32 payload
// columns (grid x over row tiles, y over column tiles).  It walks the
// columns of H 32 at a time: the 32 x 32 tile of H and the 32 x 32 tile of
// known values go to shared memory, and each thread adds 4 rows x 1
// column of sums (a warp shares its rows: the H reads are broadcasts).
// The blocks of the first column tile also keep cnt, pos and coeff: the
// first warp's lane r walks row r of each H tile.  Bound on an H100 SXM
// (3.35 TB/s; 67 TFLOP/s f32): at the decode of the full-width blocked
// step (p = 1024, N = 2048, V = 32) the pass reads H (8.4 MB) and the
// values (0.26 MB) once: 2.6 µs by bytes, against 0.13 GFLOP (2 µs at
// the f32 rate).  Each block reads its H tile once per column tile of
// the payload, so H is read ceil(V / 32) times; with V < 32 most lanes
// idle.  Speed is later work.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsT = 32;     // check rows a block
constexpr int kColsT = 32;     // payload columns a block
constexpr int kJ = 32;         // columns of H a step
constexpr int kRowsPer = kRowsT / (kThreads / kColsT);   // 4

__global__ void __launch_bounds__(kThreads)
check_pass_kernel(const float* __restrict__ H, const float* __restrict__ values,
                  const unsigned char* __restrict__ erased, float* __restrict__ sums,
                  float* __restrict__ cnt, int* __restrict__ pos, float* __restrict__ coeff,
                  int p, int N, int V) {
  __shared__ float hs[kRowsT][kJ + 1];
  __shared__ float ks[kJ][kColsT];
  __shared__ unsigned char es[kJ];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRowsT, col0 = blockIdx.y * kColsT;
  const int c = tid % kColsT, rg = tid / kColsT;
  const bool flags = blockIdx.y == 0 && tid < kRowsT;   // lane r keeps row r's cnt, pos, coeff
  float acc[kRowsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) acc[i] = 0.0f;
  int n_erased = 0, last = -1;
  float h_last = 0.0f;

  for (int j0 = 0; j0 < N; j0 += kJ) {
    const int nj = min(kJ, N - j0);
    __syncthreads();                      // the last step's reads are done
    for (int e = tid; e < kRowsT * kJ; e += kThreads) {
      const int r = e / kJ, jj = e % kJ;
      hs[r][jj] = row0 + r < p && jj < nj ? H[static_cast<size_t>(row0 + r) * N + j0 + jj]
                                          : 0.0f;
    }
    for (int e = tid; e < kJ * kColsT; e += kThreads) {
      const int jj = e / kColsT, cc = e % kColsT;
      float x = 0.0f;
      if (jj < nj && col0 + cc < V) {
        x = __fmul_rn(values[static_cast<size_t>(j0 + jj) * V + col0 + cc],
                      erased[j0 + jj] ? 0.0f : 1.0f);
      }
      ks[jj][cc] = x;
    }
    if (tid < kJ) es[tid] = tid < nj ? erased[j0 + tid] : 0;
    __syncthreads();

    for (int jj = 0; jj < nj; ++jj) {
      const float kv = ks[jj][c];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        acc[i] = __fadd_rn(acc[i], __fmul_rn(hs[rg * kRowsPer + i][jj], kv));
      }
    }
    if (flags) {
      for (int jj = 0; jj < nj; ++jj) {
        const float h = hs[tid][jj];
        if (h != 0.0f && es[jj]) {
          ++n_erased;
          last = j0 + jj;
          h_last = h;
        }
      }
    }
  }

  if (col0 + c < V) {
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int row = row0 + rg * kRowsPer + i;
      if (row < p) sums[static_cast<size_t>(row) * V + col0 + c] = acc[i];
    }
  }
  if (flags && row0 + tid < p) {
    cnt[row0 + tid] = static_cast<float>(n_erased);
    pos[row0 + tid] = last;
    coeff[row0 + tid] = h_last;
  }
}

}  // namespace

extern "C" {

// Launches the check pass on `stream`: H (p, N) f32, values (N, V) f32 and
// erased (N,) bytes in; sums (p, V) f32, cnt (p,) f32, pos (p,) int32 and
// coeff (p,) f32 out; all contiguous.  Returns a CUDA error code (0 =
// launched).
int check_pass_launch(const float* H, const float* values, const unsigned char* erased,
                      float* sums, float* cnt, int* pos, float* coeff, int p, int N, int V,
                      void* stream) {
  if (p < 1 || N < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long gy = (V + kColsT - 1) / kColsT;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p + kRowsT - 1) / kRowsT, static_cast<unsigned>(gy));
  check_pass_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      H, values, erased, sums, cnt, pos, coeff, p, N, V);
  return static_cast<int>(cudaGetLastError());
}

const char* check_pass_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
