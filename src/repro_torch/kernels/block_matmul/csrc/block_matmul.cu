// Tiled matrix product C = A @ B with f32 accumulation, for a batch of
// products in one launch; f32 or bf16 inputs, f32 out.
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/block_matmul/kernel.py:36 matmul_kernel_call
// (body _mm_kernel, kernel.py:23-33; wrappers block_matmul, coded_matvec
// and encode_gm, block_matmul/ops.py:20-39).  On the port's path it is the
// moment encode C = G @ M (core/encoding.py encode_moment and
// encode_moment_blocks, Scheme 2 and Scheme 1's set-up).
//
// What it computes.  For b < batch: C_b (M, N) = A_b (M, K) @ B_b (K, N),
// row-major and contiguous, A_b at A + b·sA, B_b at B + b·sB, C_b at
// C + b·sC (sA = 0 shares one A across the batch, as G is shared by the
// k/K blocks of M).  Each output is summed in two levels: every step of
// BK = 8 columns of A is a chain of fused multiply-adds from 0 into a
// partial sum, and the partials are added to the output's sum in
// ascending k with Kahan's compensation (a second register per output
// carries the rounding error of each add into the next).  All in f32 (a
// bf16 value converts to f32 exactly, and a product of two is exact in
// f32): full-precision FMAs, never TF32, as the reference runs
// Precision.HIGHEST.  The error of an
// entry is then near (BK + 2)·u·(|A|·|B|) (u = 2^-24 in f32) whatever K,
// against up to K·u for one chain over K: the library's product splits K
// on small shapes, and a plain two-level sum strayed up to 2.8x farther
// from float64 than it did (K = 512 and 1029).  No split over K and no
// atomics: a product is the same bits from run to run.  Any M, N, K: the
// kernel masks the ragged edges.
//
// Design.  One block of 256 threads per BM x BN output tile of one batch
// entry (grid x over N tiles, y over M tiles, z over the batch).  It walks
// K in steps of BK: the A tile (BM x BK, stored transposed) and the B tile
// (BK x BN) go to shared memory, converted to the accumulation type once,
// and each thread keeps a TM x TN tile of outputs in registers, reading
// TM + TN values of shared memory for TM·TN FMAs.  The next step's tiles
// are loaded into registers while the current ones are used (two shared
// buffers, one barrier a step).  BM = 128, BN = 64, BK = 8, TM = 8,
// TN = 4.  The sum, its compensation and the partial sum triple the
// registers of the output tile, so a thread keeps 8 x 4 outputs, not
// 8 x 8.
//
// Bound on an H100 SXM (67 TFLOP/s f32 outside the tensor cores; 3.35
// TB/s).  The encode at full width (32 blocks of (2048 x 1024) @ (1024 x
// 32768)) is 4.40 TFLOP for 12.9 GB moved: bound by operations at 65.6
// ms.  This kernel runs plain FMAs (and four compensated-sum operations
// for every eight) with one shared-memory load for every three, no tensor
// cores (TF32 would not give the reference's precision;
// 3xTF32 or wgmma tiling is later work), no TMA, no asynchronous copies.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

constexpr int BM = 128, BN = 64, BK = 8, TM = 8, TN = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads, 1)
block_matmul_kernel(const TA* __restrict__ A, const TB* __restrict__ B, float* __restrict__ C,
                    int M, int N, int K, long long sA, long long sB, long long sC) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one output tile a thread");
  static_assert(BM * BK % kThreads == 0 && BK * BN % kThreads == 0, "even tile loads");
  constexpr int kLA = BM * BK / kThreads;   // A values a thread loads a step
  constexpr int kLB = BK * BN / kThreads;   // B values a thread loads a step
  __shared__ __align__(16) float As[2][BK][BM];   // A tile, transposed
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const TA* a = A + blockIdx.z * sA;
  const TB* b = B + blockIdx.z * sB;
  float* c = C + blockIdx.z * sC;
  const int tr = tid / (BN / TN), tc = tid % (BN / TN);

  float ra[kLA], rb[kLB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kLA; ++i) {
      const int e = tid + i * kThreads;     // element of the BM x BK tile, k fastest
      const int m = e / BK, kk = e % BK;
      const int gm = row0 + m, gk = k0 + kk;
      ra[i] = gm < M && gk < K ? to_f32(a[static_cast<size_t>(gm) * K + gk]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kLB; ++i) {
      const int e = tid + i * kThreads;     // element of the BK x BN tile, n fastest
      const int kk = e / BN, n = e % BN;
      const int gk = k0 + kk, gn = col0 + n;
      rb[i] = gk < K && gn < N ? to_f32(b[static_cast<size_t>(gk) * N + gn]) : 0.0f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kLA; ++i) {
      const int e = tid + i * kThreads;
      As[buf][e % BK][e / BK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kLB; ++i) {
      const int e = tid + i * kThreads;
      Bs[buf][e / BN][e % BN] = rb[i];
    }
  };

  float acc[TM][TN], comp[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = comp[i][j] = 0.0f;
  }

  fetch(0);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) fetch(k0 + BK);               // in flight while this step computes
    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
      // 16-byte loads: a warp's 16 column groups read 512 contiguous bytes
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 t = *reinterpret_cast<const float4*>(&As[buf][kk][tr * TM + i]);
        av[i] = t.x, av[i + 1] = t.y, av[i + 2] = t.z, av[i + 3] = t.w;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 t = *reinterpret_cast<const float4*>(&Bs[buf][kk][tc * TN + j]);
        bv[j] = t.x, bv[j + 1] = t.y, bv[j + 2] = t.z, bv[j + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {           // Kahan: acc + comp holds the sum
        const float y = part[i][j] - comp[i][j];
        const float t = acc[i][j] + y;
        comp[i][j] = (t - acc[i][j]) - y;
        acc[i][j] = t;
      }
    }
    if (more) {
      stash(buf ^ 1);                       // the other buffer: nobody reads it now
      __syncthreads();
      buf ^= 1;
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + tr * TM + i;
    if (gm >= M) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tc * TN + j;
      if (gn < N) c[static_cast<size_t>(gm) * N + gn] = acc[i][j];
    }
  }
}

template <typename TA, typename TB>
int launch(const void* A, const void* B, void* C, int M, int N, int K, int batch,
           long long sA, long long sB, long long sC, cudaStream_t stream) {
  const long long gy = (M + BM - 1) / BM;
  if (gy > 65535 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, static_cast<unsigned>(gy), batch);
  block_matmul_kernel<TA, TB><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(A), static_cast<const TB*>(B), static_cast<float*>(C), M, N, K,
      sA, sB, sC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches C_b = A_b @ B_b for b < batch on `stream`.  dtype codes: 0 f32,
// 1 bf16; C is f32.
// Strides between batch entries are in elements.  Returns a CUDA error
// code (0 = launched).
int block_matmul_launch(const void* A, int a_dtype, const void* B, int b_dtype, void* C,
                        int M, int N, int K, int batch, long long sA, long long sB,
                        long long sC, void* stream) {
  if (M < 1 || N < 1 || K < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == 0 && b_dtype == 0) {
    return launch<float, float>(A, B, C, M, N, K, batch, sA, sB, sC, s);
  }
  if (a_dtype == 1 && b_dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(A, B, C, M, N, K, batch, sA, sB, sC, s);
  }
  if (a_dtype == 0 && b_dtype == 1) {
    return launch<float, __nv_bfloat16>(A, B, C, M, N, K, batch, sA, sB, sC, s);
  }
  if (a_dtype == 1 && b_dtype == 0) {
    return launch<__nv_bfloat16, float>(A, B, C, M, N, K, batch, sA, sB, sC, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* block_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
