// Matrix product C = A @ B in f32 accuracy on the bf16 tensor cores, for a
// batch of products in one launch; f32 or bf16 inputs, f32 out.
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/block_matmul/kernel.py:36 matmul_kernel_call
// (body _mm_kernel, kernel.py:23-33, Precision.HIGHEST; wrappers
// block_matmul, coded_matvec and encode_gm, block_matmul/ops.py:20-39).  On
// the port's path it is the moment encode C = G @ M (core/encoding.py
// encode_moment and encode_moment_blocks, Scheme 2 and Scheme 1's set-up).
//
// What it computes.  For b < batch: C_b (M, N) = A_b (M, K) @ B_b (K, N),
// A or B shared by the whole batch when given once (G is shared by the k/K
// blocks of M).  Two kernels, launched in turn by the wrapper (ops.py):
//
// * split_rows_kernel / split_cols_kernel, the split pass.  Every f32 value
//   x becomes three bf16 terms x1 + x2 + x3: x1 the bf16 rounding of x (to
//   nearest, or toward zero where to nearest would give inf: |x| past
//   3.3895e38), x2 the rounding of r = x - x1, x3 the rounding of r - x2.
//   Both differences are exact in f32, and r - x2 fits in 8 bits, so the
//   terms sum to x exactly whenever |x| >= 2^-110 (all three terms are
//   then normal bf16 numbers, or zero).  Below, the third term is rounded
//   to bf16's subnormal grid: |x - (x1 + x2 + x3)| <= 2^-134.  |x2| <=
//   2^-8|x| and |x3| <= 2^-16|x|.  A bf16 value x becomes two terms of 4
//   significant bits, x1 its bits with the last 4 of the fraction cleared
//   and x2 = x - x1, exact (why two, below).  An inf or NaN is its own
//   first term (an f32 NaN as 0x7FC0), with zeros after it.  The terms go
//   to buffers of rows padded with zeros to a multiple of 8 values (16
//   bytes, as a TMA stride must be): A's as (planes, M, Kp), k contiguous;
//   B's transposed, as (planes, N, Kp), so that both operands are K-major.
//   A shared operand is split once.  ref.split_terms_ref is its plain
//   version, bit for bit.
// * gemm_kernel, the products.  a·b is the sum of the term products
//   a_i·b_j, each exact in f32 (at most 8 x 8 significant bits).  The
//   kernel runs those with i + j <= 5 (1-based): of two f32 operands eight
//   of the nine, dropping a3·b3 alone, |a3·b3| <= 2^-32|a|·|b|; with a bf16
//   operand all of them, so nothing is dropped.  (Dropping the pair with i
//   + j = 5 too, six products, leaves up to 2^-23|a|·|b| per product: as
//   large as f32's own rounding, and a single product then strays past
//   the correctly rounded one.)
//
// The fold.  A wgmma step aligns its 16 products and the accumulator to
// the largest, cuts the bits that fall below about 2^-24 of it, and rounds
// toward zero: within 1 ulp a step, biased, so over a chunk of L steps the
// error grows with L (PERF.md: the probe of chunks of 16 to 1024 exact
// products against float64).  So no accumulator holds the whole sum.  Two
// are kept per output: h, a1b1, and t, every smaller product, both summed
// on the tensor cores over a chunk of kFold = 4 steps (64 columns of k).  At
// a chunk's end the output's sum s takes h, then t, each by an error-free
// TwoSum (six f32 additions each, in ascending chunk order), and t
// restarts from the two errors.  The output is s + t, rounded once (or s
// alone where s is inf or NaN: a non-finite input gives NaN or inf through
// a1b1 exactly as IEEE arithmetic gives it to torch.matmul, and t, which
// inf·0 may poison in the same chunk, stays out of s).  So the sum is
// exact at every chunk's end and each chunk's error is the cut of its
// steps.  With bf16 inputs torch.matmul sums the exact 16-bit products
// almost exactly, while a step of 16-bit products cuts any product below
// 2^-9 of the largest: as two 4-bit terms a bf16 value gives 8-bit
// products, cut only below 2^-17 of the largest.  No split over k and no
// atomics: a product is the same bits from run to run.
//
// Design of gemm_kernel.  A block of two warpgroups (256 threads) owns a
// 128 x 128 tile of C_b; block x runs over the tiles with the M tiles
// fastest, so consecutive blocks read the same B tile from L2.  k goes 64
// columns a stage (one 128-byte row of bf16, the 128-byte swizzle): the A
// terms' 128 x 64 tiles and the B terms' 128 x 64 tiles of a stage arrive
// by TMA (3-D maps over (Kp, rows, planes), zero past the ends) behind one
// mbarrier, into a ring of stages (2 with five or six tiles a stage, 192
// KB; 3 with four), issued by thread 0 once both warpgroups are done with
// the stage.  Warpgroup w multiplies rows 64w .. 64w + 63: for each 16
// columns of k, one wgmma m64n128k16 (bf16 x bf16, f32 accumulator, both
// operands K-major in shared memory) per product, a1b1 into h and the rest
// into t; at a chunk's end it waits for them and folds.  The output tile is
// stored from the registers (a thread holds two rows and 32 column pairs).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 on the tensor cores; 3.35 TB/s).
// The encode at full width (32 blocks of (2048 x 1024) @ (1024 x 32768),
// 4.40 TFLOP of f32 products) is eight bf16 products: 35.2 TFLOP, 35.6 ms;
// its bytes (M read and its three terms written by the split pass, 10.7 GB,
// then the terms read and C written, 15.0 GB) take 7.7 ms.  So it is bound
// by operations.  Against it the old design's f32 bound, 4.40 TFLOP at 67
// TFLOP/s outside the tensor cores, is 65.6 ms.
#include <cuda.h>   // CUtensorMap and its enums; the encode is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxSmem = 232448;          // dynamic shared memory a block may use (sm_90)

// Shared memory, mbarriers, wgmma descriptors and fences, and the run-time
// lookup of cuTensorMapEncodeTiled, as in flash_attention.cu (a library
// includes only the headers beside its source).

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A wgmma operand in shared memory under the 128-byte swizzle: start address,
// leading byte offset, stride byte offset 1024 (8 rows of 128 bytes), in
// 16-byte units.  K-major operands ignore the leading offset (pass 16); an
// MN-major one (the flash kernel's V) takes the distance between its
// 64-column atoms.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins register operands of a wgmma at this point: writes before it are
// done before the next wgmma_fence, reads after it wait for wgmma_wait_all.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// ------------------------------------------------------------ the split pass

constexpr uint16_t kNaN = 0x7FC0;         // the quiet NaN every split writes

// x as up to three bf16 terms (bit patterns) that sum to x (see the note).
__device__ __forceinline__ void split3(float x, uint16_t& t1, uint16_t& t2, uint16_t& t3) {
  if (!isfinite(x)) {
    t1 = isnan(x) ? kNaN : (x > 0.0f ? 0x7F80 : 0xFF80);
    t2 = t3 = 0;
    return;
  }
  __nv_bfloat16 h1 = __float2bfloat16_rn(x);
  if (isinf(__bfloat162float(h1))) {      // past bf16's largest finite value: toward zero
    h1 = __ushort_as_bfloat16(static_cast<uint16_t>(__float_as_uint(x) >> 16));
  }
  const float r = __fsub_rn(x, __bfloat162float(h1));
  const __nv_bfloat16 h2 = __float2bfloat16_rn(r);
  const float r2 = __fsub_rn(r, __bfloat162float(h2));
  t1 = __bfloat16_as_ushort(h1);
  t2 = __bfloat16_as_ushort(h2);
  t3 = __bfloat16_as_ushort(__float2bfloat16_rn(r2));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// bf16 x (given as the f32 of the same value) as two bf16 terms of 4
// significant bits: x1 its bits with the last 4 of the fraction cleared, x2
// = x - x1, exact.  An inf or NaN is its own first term (its bits).
__device__ __forceinline__ void split2(float x, uint16_t& t1, uint16_t& t2) {
  const uint32_t bits = __float_as_uint(x) >> 16;
  if (!isfinite(x)) {
    t1 = static_cast<uint16_t>(bits);
    t2 = 0;
    return;
  }
  t1 = static_cast<uint16_t>(bits & 0xFFF0u);
  const float x1 = __uint_as_float(static_cast<uint32_t>(t1) << 16);
  t2 = __bfloat16_as_ushort(__float2bfloat16_rn(__fsub_rn(x, x1)));
}

// The terms of 8 consecutive values, stored as 16 bytes a term at
// dst + term·term_stride: three of an f32 value (NT = 3), two of a bf16
// one (NT = 2).
template <int NT>
__device__ __forceinline__ void store_terms(const float (&v)[8], uint16_t* dst,
                                            size_t term_stride) {
  uint16_t t[3][8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (NT == 2) {
      split2(v[e], t[0][e], t[1][e]);
    } else {
      split3(v[e], t[0][e], t[1][e], t[2][e]);
    }
  }
#pragma unroll
  for (int term = 0; term < NT; ++term) {
    uint4 w;
    w.x = t[term][0] | (static_cast<uint32_t>(t[term][1]) << 16);
    w.y = t[term][2] | (static_cast<uint32_t>(t[term][3]) << 16);
    w.z = t[term][4] | (static_cast<uint32_t>(t[term][5]) << 16);
    w.w = t[term][6] | (static_cast<uint32_t>(t[term][7]) << 16);
    *reinterpret_cast<uint4*>(dst + term * term_stride) = w;
  }
}

// x (nb planes of R x C, row-major) -> dst (nb, NT, R, Cp): each thread
// takes 8 consecutive columns of a row; columns C .. Cp - 1 get zeros.
template <typename T, int NT>
__global__ void __launch_bounds__(256)
split_rows_kernel(const T* __restrict__ x, uint16_t* __restrict__ dst, long long rows, int R,
                  int C, int Cp) {
  const int groups = Cp / 8;
  const long long total = rows * groups;
  for (long long gi = blockIdx.x * 256LL + threadIdx.x; gi < total;
       gi += static_cast<long long>(gridDim.x) * 256) {
    const long long row = gi / groups;
    const int c0 = static_cast<int>(gi % groups) * 8;
    const long long b = row / R, r = row % R;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = c0 + e < C ? to_f32(x[row * C + c0 + e]) : 0.0f;
    }
    store_terms<NT>(v, dst + (static_cast<size_t>(b * NT) * R + r) * Cp + c0,
                    static_cast<size_t>(R) * Cp);
  }
}

// x (nb planes of R x C, row-major) -> dst (nb, NT, C, Rp), transposed: a
// block moves a 64 x 32 tile (64 rows of x, 32 columns) through shared
// memory, reading rows and writing columns 16 bytes at a time; rows R ..
// Rp - 1 get zeros.
template <typename T, int NT>
__global__ void __launch_bounds__(256)
split_cols_kernel(const T* __restrict__ x, uint16_t* __restrict__ dst, int R, int C, int Rp) {
  __shared__ float tile[64][33];
  const int r0 = blockIdx.y * 64, c0 = blockIdx.x * 32, tid = threadIdx.x;
  const size_t plane = blockIdx.z;
  const T* src = x + plane * R * static_cast<size_t>(C);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rr = tid / 32 + 8 * i, cc = tid % 32;
    const int r = r0 + rr, c = c0 + cc;
    tile[rr][cc] = r < R && c < C ? to_f32(src[static_cast<size_t>(r) * C + c]) : 0.0f;
  }
  __syncthreads();
  const int cc = tid / 8, g = tid % 8;
  const int c = c0 + cc, r = r0 + 8 * g;
  if (c < C && r < Rp) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = tile[8 * g + e][cc];
    store_terms<NT>(v, dst + (plane * NT * C + c) * Rp + r, static_cast<size_t>(C) * Rp);
  }
}

template <typename T, int NT>
int launch_split(const void* x, void* dst, int nb, int R, int C, int transpose,
                 cudaStream_t stream) {
  const T* src = static_cast<const T*>(x);
  uint16_t* out = static_cast<uint16_t*>(dst);
  if (transpose) {
    const int Rp = (R + 7) / 8 * 8;
    const long long gx = (C + 31) / 32, gy = (Rp + 63) / 64;
    if (gy > 65535 || nb > 65535) return static_cast<int>(cudaErrorInvalidValue);
    split_cols_kernel<T, NT><<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy), nb),
                               256, 0, stream>>>(src, out, R, C, Rp);
  } else {
    const int Cp = (C + 7) / 8 * 8;
    const long long rows = static_cast<long long>(nb) * R;
    const long long groups = rows * (Cp / 8);
    const long long blocks = groups / 256 + 1;
    const unsigned grid = static_cast<unsigned>(blocks < 132LL * 64 ? blocks : 132LL * 64);
    split_rows_kernel<T, NT><<<grid, 256, 0, stream>>>(src, out, rows, R, C, Cp);
  }
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------- the tensor products

constexpr int kThreads = 256;             // two warpgroups
constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kTile = 128 * 128;          // bytes of one term's tile: 128 rows x 64 bf16

__host__ __device__ constexpr int stages_for(int terms) { return terms >= 5 ? 2 : 3; }

constexpr size_t gemm_smem_bytes(int terms) {
  return 1024 + static_cast<size_t>(stages_for(terms)) * terms * kTile +
         stages_for(terms) * sizeof(uint64_t);
}
static_assert(gemm_smem_bytes(6) <= kMaxSmem && gemm_smem_bytes(5) <= kMaxSmem &&
                  gemm_smem_bytes(4) <= kMaxSmem,
              "the ring fits in shared memory");

// One box of 64 k x 128 rows of one plane into shared memory, reported to `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int k0, int row0, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k0), "r"(row0), "r"(plane)
      : "memory");
}

#define ACC8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),            \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, f32) = a·bᵀ (acc = 0) or d += a·bᵀ: a (64 x 16) and b (128 x
// 16) bf16 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(da), "l"(db), "r"(acc));
}
#undef ACC8

// a + b = x + e exactly (Knuth's TwoSum, six roundings to nearest).
__device__ __forceinline__ float two_sum(float a, float b, float& e) {
  const float x = __fadd_rn(a, b);
  const float z = __fsub_rn(x, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(x, z)), __fsub_rn(b, z));
  return x;
}

// A chunk's end: the sum s takes the chunk's large term h and the small
// accumulator t, each by TwoSum, and t restarts from the two errors.  A
// non-finite t only comes with a non-finite h (see the note), and stays
// out of s, which then holds h's IEEE result.
__device__ __forceinline__ void fold_into(float& s, float& t, float h) {
  float e1, e2;
  const float x = two_sum(s, h, e1);
  const float y = two_sum(x, t, e2);
  const bool finite = isfinite(t);
  s = finite ? y : x;
  t = finite ? __fadd_rn(e1, e2) : t;
}

// The term products a_i·b_j run: those with i + j <= kOrder (0-based).
constexpr int kOrder = 3;
// Steps of 16 columns of k a chunk sums on the tensor cores before it is
// folded: one stage of the ring.  At 8 steps (40, 200, 1) strays past the
// 2x gate in 9 of 40 seeds (PERF.md); at 1 or 2 the kernel is slower.
constexpr int kFold = 4;

// NA, NB: terms of A and B (3 of an f32 operand, 2 of a bf16 one).  The A
// terms' map covers (Kp, M, planes), the B terms' (Kp, N, planes), plane =
// batch entry · terms + term (entry 0 for a shared operand).  Thread
// (warpgroup w, warp v, lane l) holds rows 64w + 16v + l/4 and 8 more, and
// for each 8 columns j, columns 8j + 2(l % 4) and one more: element 4j +
// 2·half + e of a 64-float fragment.
template <int NA, int NB>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            float* __restrict__ C, int M, int N, int n_k, int m_tiles, int a_batched,
            int b_batched) {
  constexpr int kTerms = NA + NB;
  constexpr int kStages = stages_for(kTerms);
  constexpr int kStage = kTerms * kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Tiles start on 1024 bytes of the shared window: the swizzle repeats there.
  unsigned char* tiles = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + kStages * kStage);

  const int tid = threadIdx.x, lane = tid % 32, warp = (tid / 32) % 4, wg = tid / 128;
  const int m0 = static_cast<int>(blockIdx.x % m_tiles) * kBM;
  const int n0 = static_cast<int>(blockIdx.x / m_tiles) * kBN;
  const int b = blockIdx.z;
  const int pa = a_batched ? b * NA : 0, pb = b_batched ? b * NB : 0;
  const CUtensorMap* tma = &map_a;
  const CUtensorMap* tmb = &map_b;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int s, int it) {
    unsigned char* st = tiles + s * kStage;
    mbar_expect_tx(&full[s], kStage);
#pragma unroll
    for (int t = 0; t < NA; ++t) tma_load(st + t * kTile, tma, &full[s], it * kBK, m0, pa + t);
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      tma_load(st + (NA + t) * kTile, tmb, &full[s], it * kBK, n0, pb + t);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kStages && s < n_k; ++s) load(s, s);
  }

  float sum[64], small[64], chunk[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = small[i] = chunk[i] = 0.0f;
  const int steps = 4 * n_k;              // 16 columns of k a step

  for (int it = 0; it < n_k; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], static_cast<unsigned>((it / kStages) & 1));
    const unsigned char* ta = tiles + s * kStage + wg * 64 * 128;   // this warpgroup's rows
    const unsigned char* tb = tiles + s * kStage + NA * kTile;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int g = 4 * it + kk;
      fence_regs(chunk);
      fence_regs(small);
      wgmma_fence();
      wgmma_128(chunk, sw128_desc(ta + 32 * kk, 16), sw128_desc(tb + 32 * kk, 16),
                g % kFold != 0);
#pragma unroll
      for (int i = 0; i < NA; ++i) {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          if ((i > 0 || j > 0) && i + j <= kOrder) {
            wgmma_128(small, sw128_desc(ta + i * kTile + 32 * kk, 16),
                      sw128_desc(tb + j * kTile + 32 * kk, 16), 1);
          }
        }
      }
      wgmma_commit();
      if ((g + 1) % kFold == 0 || g + 1 == steps) {
        wgmma_wait_all();
        fence_regs(chunk);
        fence_regs(small);
#pragma unroll
        for (int i = 0; i < 64; ++i) fold_into(sum[i], small[i], chunk[i]);
      }
    }
    wgmma_wait_all();                     // stage s is read: refill it
    fence_regs(chunk);
    fence_regs(small);
    __syncthreads();
    if (tid == 0 && it + kStages < n_k) load(s, it + kStages);
  }

  float* c = C + static_cast<size_t>(b) * M * N;
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * half;
    if (row >= M) continue;
    float* crow = c + static_cast<size_t>(row) * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * half + e;
        v[e] = isfinite(sum[i]) ? __fadd_rn(sum[i], small[i]) : sum[i];
      }
      if (pairs && col + 1 < N) {
        *reinterpret_cast<float2*>(crow + col) = make_float2(v[0], v[1]);
      } else {
        if (col < N) crow[col] = v[0];
        if (col + 1 < N) crow[col + 1] = v[1];
      }
    }
  }
}

// The 3-D map of a term buffer (planes, rows, Kp) of bf16: boxes of 64 k x
// 128 rows of one plane, 128-byte swizzled, zero past the ends.
bool term_map(CUtensorMap* map, const void* x, int Kp, int rows, long long planes) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Kp), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t row = static_cast<cuuint64_t>(Kp) * 2;
  const cuuint64_t strides[2] = {row, row * rows};
  const cuuint32_t box[3] = {kBK, 128, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NA, int NB>
int launch_gemm(const void* ta, int a_batched, const void* tb, int b_batched, void* C, int M,
                int N, int Kp, int batch, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  const long long planes_a = static_cast<long long>(a_batched ? batch : 1) * NA;
  const long long planes_b = static_cast<long long>(b_batched ? batch : 1) * NB;
  if (!term_map(&map_a, ta, Kp, M, planes_a) || !term_map(&map_b, tb, Kp, N, planes_b)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  constexpr size_t smem = gemm_smem_bytes(NA + NB);
  const cudaError_t err = cudaFuncSetAttribute(gemm_kernel<NA, NB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long m_tiles = (M + kBM - 1) / kBM, n_tiles = (N + kBN - 1) / kBN;
  if (m_tiles * n_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int n_k = (Kp + kBK - 1) / kBK;
  gemm_kernel<NA, NB>
      <<<dim3(static_cast<unsigned>(m_tiles * n_tiles), 1, batch), kThreads, smem, stream>>>(
          map_a, map_b, static_cast<float*>(C), M, N, n_k, static_cast<int>(m_tiles),
          a_batched, b_batched);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The split pass on `stream`: x (nb planes of R x C, row-major), dtype 0
// f32 (three terms) or 1 bf16 (two), into dst: (nb, terms, R, pad8(C))
// bf16, or with `transpose` (nb, terms, C, pad8(R)).  Returns a CUDA error
// code (0 = launched).
int split_terms_launch(const void* x, int dtype, void* dst, int nb, int R, int C,
                       int transpose, void* stream) {
  if (nb < 1 || R < 1 || C < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(dst) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_split<float, 3>(x, dst, nb, R, C, transpose, s)
                    : launch_split<__nv_bfloat16, 2>(x, dst, nb, R, C, transpose, s);
}

// C_b = A_b @ B_b for b < batch on `stream`, from the split pass's terms:
// ta (planes, M, Kp) with na terms a plane group, tb (planes, N, Kp) with
// nb terms, each shared by the batch unless *_batched; C f32 (batch, M, N).
// Returns a CUDA error code (0 = launched;
// cudaErrorNotSupported when cuTensorMapEncodeTiled is not found).
int block_matmul_launch(const void* ta, int na, int a_batched, const void* tb, int nb,
                        int b_batched, void* C, int M, int N, int Kp, int batch,
                        void* stream) {
  if (M < 1 || N < 1 || Kp < 8 || Kp % 8 != 0 || batch < 1 || batch > 65535 ||
      (na != 2 && na != 3) || (nb != 2 && nb != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(ta) | reinterpret_cast<uintptr_t>(tb)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (na == 3 && nb == 3) {
    return launch_gemm<3, 3>(ta, a_batched, tb, b_batched, C, M, N, Kp, batch, s);
  }
  if (na == 3) {
    return launch_gemm<3, 2>(ta, a_batched, tb, b_batched, C, M, N, Kp, batch, s);
  }
  if (nb == 3) {
    return launch_gemm<2, 3>(ta, a_batched, tb, b_batched, C, M, N, Kp, batch, s);
  }
  return launch_gemm<2, 2>(ta, a_batched, tb, b_batched, C, M, N, Kp, batch, s);
}

const char* block_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
