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
// * split_rows_kernel / split_cols_kernel, the split pass.  Along k, in
//   chunks of 64 values of a row of A (a column of B), E is the largest
//   exponent of a finite value and 2^(E-7) the chunk's grid.  Every value x
//   becomes a lead term g, x cut toward zero to the grid (at most 8
//   significant bits, so a bf16 number, below 2^8 grid units), and the bf16
//   terms of the rest r = x - g (exact in f32, below one grid unit): of an
//   f32 value three, r1 the bf16 rounding of r (to nearest), r2 that of r -
//   r1, r3 that of the rest, so four terms that sum to x exactly whenever
//   |x| >= 2^-110 (within 2^-134 below, where r3 falls under bf16's
//   subnormal grid); of a bf16 value one, r itself (at most 8 bits).  An inf
//   or NaN is its own lead (an f32 NaN as 0x7FC0), zeros after it, and no
//   part of its chunk's grid.  The terms go to buffers of rows padded with
//   zeros to a multiple of 8 values (16 bytes, as a TMA stride must be): A's
//   as (planes, M, Kp), k contiguous; B's transposed, as (planes, N, Kp), so
//   that both operands are K-major.  A shared operand is split once.
//   ref.split_terms_ref is its plain version, bit for bit.
// * gemm_kernel, the products.  a·b is the sum of the term products
//   a_i·b_j, each exact in f32 (at most 8 x 8 significant bits).  Term i
//   lies below 2^(E - L_i) of its chunk's scale, L = (0, 7, 15, 23) for an
//   f32 operand and (0, 7) for a bf16 one, and the kernel runs the products
//   with L_i + L_j <= 23: ten of two f32 operands, seven of mixed ones, all
//   four of two bf16 ones.  Each dropped product lies below 2^-30 of the
//   chunk's scale (ref.product_pairs).
//
// The fold.  A wgmma step aligns its 16 products and the accumulator to
// the largest, cuts the bits that fall below about 2^-24 of it, and rounds
// toward zero: within 1 ulp a step.  Two accumulators are kept per output:
// h, the leads' product g_a·g_b, and t, every smaller product, both summed
// on the tensor cores over a chunk of kFold = 4 steps (64 columns of k,
// one grid).  Every g_a·g_b of a chunk is an integer number of the grid
// units' product below 2^16, so h's partial sums stay below 2^22 units and
// no step cuts a bit of them: h is exact.  (Before the grid, h held a1·b1
// of the values' own bf16 roundings: when K <= 64 one chunk held the whole
// sum, and a step's cut, up to 1 ulp of it, could meet a torch.matmul that
// rounded to nearest, past the card's 2x gate; narrower terms only made
// that rarer.)  t lies below 2^-6 of the chunk's scale, so its cut is
// below 2^-30 of it.  At a chunk's end the output's sum s takes h, then t,
// each by an error-free TwoSum (six f32 additions each, in ascending chunk
// order), and t restarts from the two errors.  The output is s + t, rounded
// once.  No split over k and no atomics: a product is the same bits from run
// to run.
//
// Non-finite inputs.  A lead is 0 for a value below its chunk's grid, so a
// finite x times an inf of the other operand may meet it as 0·inf in h.
// So the products do not carry IEEE's non-finite results; instead every
// thread looks, in each stage, at its share of the two lead tiles for an
// inf or NaN (the only places one can be).  A block that saw one rebuilds
// each of its outputs' class over k in its epilogue from the leads and
// first remainders (sign of the value, zero, inf or NaN, as torch.matmul's
// IEEE sum would meet them; a zero lead is +0 for a zero value and -0 for
// any other, so a value below bf16's range is not taken for a zero) and
// writes NaN, +inf or -inf where that sum is not finite; every other
// output has no non-finite input and keeps s + t.  That scan is O(K) an
// output, paid only by a block that met an inf or NaN.
//
// Design of gemm_kernel.  A block of two warpgroups (256 threads) owns a
// 128 x 128 tile of C_b; block x runs over the tiles with the M tiles
// fastest, so consecutive blocks read the same B tile from L2.  k goes 32
// columns a stage (one 64-byte row of bf16, the 64-byte swizzle): the A
// terms' 128 x 32 tiles and the B terms' 128 x 32 tiles of a stage arrive
// by TMA (3-D maps over (Kp, rows, planes), zero past the ends) behind one
// mbarrier, into a ring of stages (3 with eight tiles a stage, 192 KB; 4
// with fewer), issued by thread 0 once both warpgroups are done with the
// stage.  Warpgroup w multiplies rows 64w .. 64w + 63: for each 16 columns
// of k, one wgmma m64n128k16 (bf16 x bf16, f32 accumulator, both operands
// K-major in shared memory) per product, g_a·g_b into h and the rest into
// t; at a chunk's end (every two stages) it waits for them and folds.  The
// output tile is stored from the registers (a thread holds two rows and 32
// column pairs).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 on the tensor cores; 3.35 TB/s).
// The encode at full width (32 blocks of (2048 x 1024) @ (1024 x 32768),
// 4.40 TFLOP of f32 products) is ten bf16 products: 44.0 TFLOP, 44.5 ms;
// its bytes (M read and its four terms written by the split pass, 12.9 GB,
// then the terms read and C written, 17.2 GB) take 9.0 ms.  So it is bound
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

// A K-major wgmma operand in shared memory under the 64-byte swizzle: start
// address, leading byte offset (ignored for K-major; 16), stride byte
// offset 512 (8 rows of 64 bytes), in 16-byte units; layout type 2.
__device__ __forceinline__ uint64_t sw64_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
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
constexpr int kChunk = 64;                // values along k that share one grid

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The exponent field of x, at least 1 (zeros and subnormals count as 1),
// and 0 for inf and NaN, so that a chunk's largest skips them.
__device__ __forceinline__ int grid_exp(float x) {
  const int be = static_cast<int>((__float_as_uint(x) >> 23) & 0xFF);
  return be == 0xFF ? 0 : max(be, 1);
}

// The lead term of finite x: x cut toward zero to the grid 2^(E - 134) of
// its chunk, whose largest exponent field is E.  The low E - e + 16 bits of
// a value of exponent field e are cleared (at least 16, so the lead is a
// bf16 number; past 23 only the sign stays).
__device__ __forceinline__ float lead(float x, int E) {
  const uint32_t u = __float_as_uint(x);
  const int clear = E - max(static_cast<int>((u >> 23) & 0xFF), 1) + 16;
  return __uint_as_float(clear >= 24 ? (u & 0x80000000u) : (u & (0xFFFFFFFFu << clear)));
}

// A lead of zero carries in its sign whether x is zero: +0 for x = ±0, -0
// for a nonzero x below its chunk's grid, whose sign the rest's first term
// carries (a signed zero where x is below bf16's least subnormal, 2^-133).
// The epilogue of a block that met an inf reads it (value_class); a zero
// term's sign changes no product's value.
__device__ __forceinline__ float zero_lead(float g, float x) {
  if ((__float_as_uint(g) & 0x7FFFFFFFu) != 0) return g;
  return x != 0.0f ? __uint_as_float(0x80000000u) : 0.0f;
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// x as NT bf16 terms (bit patterns) on its chunk's grid E (see the note):
// the lead, then the rest's three terms (f32, NT = 4) or the rest itself
// (bf16, NT = 2).  An inf or NaN is its own lead.
template <int NT>
__device__ __forceinline__ void split_value(float x, int E, uint16_t (&t)[NT]) {
#pragma unroll
  for (int i = 1; i < NT; ++i) t[i] = 0;
  if (!isfinite(x)) {
    t[0] = NT == 2 ? static_cast<uint16_t>(__float_as_uint(x) >> 16)
                   : (isnan(x) ? kNaN : (x > 0.0f ? 0x7F80 : 0xFF80));
    return;
  }
  const float g = zero_lead(lead(x, E), x);
  t[0] = static_cast<uint16_t>(__float_as_uint(g) >> 16);
  const float r = __fsub_rn(x, g);
  t[1] = bf16_bits(r);
  if constexpr (NT == 4) {
    const float r2 = __fsub_rn(r, __uint_as_float(static_cast<uint32_t>(t[1]) << 16));
    t[2] = bf16_bits(r2);
    t[3] = bf16_bits(__fsub_rn(r2, __uint_as_float(static_cast<uint32_t>(t[2]) << 16)));
  }
}

// The largest grid_exp over the 8 lanes of an aligned group of 8 (one
// chunk of 64 values, 8 a lane); every lane of the warp takes part.
__device__ __forceinline__ int chunk_exp(int e) {
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) e = max(e, __shfl_xor_sync(0xFFFFFFFFu, e, m));
  return e;
}

// The terms of 8 consecutive values of one chunk (grid E), stored as 16
// bytes a term at dst + term·term_stride.
template <int NT>
__device__ __forceinline__ void store_terms(const float (&v)[8], int E, uint16_t* dst,
                                            size_t term_stride) {
  uint16_t t[8][NT];
#pragma unroll
  for (int e = 0; e < 8; ++e) split_value<NT>(v[e], E, t[e]);
#pragma unroll
  for (int term = 0; term < NT; ++term) {
    uint4 w;
    w.x = t[0][term] | (static_cast<uint32_t>(t[1][term]) << 16);
    w.y = t[2][term] | (static_cast<uint32_t>(t[3][term]) << 16);
    w.z = t[4][term] | (static_cast<uint32_t>(t[5][term]) << 16);
    w.w = t[6][term] | (static_cast<uint32_t>(t[7][term]) << 16);
    *reinterpret_cast<uint4*>(dst + term * term_stride) = w;
  }
}

// x (nb planes of R x C, row-major) -> dst (nb, NT, R, Cp): each thread
// takes 8 consecutive columns of a row, 8 neighbouring lanes one chunk of
// 64; columns C .. Cp - 1 get zeros.  Whole warps run the loop (the
// chunk's largest exponent is taken by shuffles).
template <typename T, int NT>
__global__ void __launch_bounds__(256)
split_rows_kernel(const T* __restrict__ x, uint16_t* __restrict__ dst, long long rows, int R,
                  int C, int Cp) {
  const int chunks = (Cp + kChunk - 1) / kChunk;
  const long long total = rows * chunks * 8;
  const int lane = threadIdx.x % 32;
  for (long long w0 = blockIdx.x * 256LL + (threadIdx.x - lane); w0 < total;
       w0 += static_cast<long long>(gridDim.x) * 256) {
    const long long gi = w0 + lane;
    const long long row = gi / (chunks * 8);
    const int c0 = static_cast<int>(gi % (chunks * 8)) * 8;
    const bool live = gi < total && c0 < Cp;
    float v[8];
    int e = 1;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = live && c0 + k < C ? to_f32(x[row * C + c0 + k]) : 0.0f;
      e = max(e, grid_exp(v[k]));
    }
    e = chunk_exp(e);
    if (live) {
      const long long b = row / R, r = row % R;
      store_terms<NT>(v, e, dst + (static_cast<size_t>(b * NT) * R + r) * Cp + c0,
                      static_cast<size_t>(R) * Cp);
    }
  }
}

// x (nb planes of R x C, row-major) -> dst (nb, NT, C, Rp), transposed: a
// block moves a 64 x 32 tile (64 rows of x, one chunk along k, 32 columns)
// through shared memory, reading rows and writing columns 16 bytes at a
// time; rows R .. Rp - 1 get zeros.
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
  float v[8];
  int e = 1;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = tile[8 * g + k][cc];
    e = max(e, grid_exp(v[k]));
  }
  e = chunk_exp(e);
  if (c < C && r < Rp) {
    store_terms<NT>(v, e, dst + (plane * NT * C + c) * Rp + r, static_cast<size_t>(C) * Rp);
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
    const long long lanes = rows * ((Cp + kChunk - 1) / kChunk) * 8;
    const long long blocks = lanes / 256 + 1;
    const unsigned grid = static_cast<unsigned>(blocks < 132LL * 64 ? blocks : 132LL * 64);
    split_rows_kernel<T, NT><<<grid, 256, 0, stream>>>(src, out, rows, R, C, Cp);
  }
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------- the tensor products

constexpr int kThreads = 256;             // two warpgroups
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kTile = 128 * kBK * 2;      // bytes of one term's tile: 128 rows x 32 bf16

__host__ __device__ constexpr int stages_for(int terms) { return terms >= 7 ? 3 : 4; }

constexpr size_t gemm_smem_bytes(int terms) {
  return 1024 + static_cast<size_t>(stages_for(terms)) * terms * kTile +
         stages_for(terms) * sizeof(uint64_t);
}
static_assert(gemm_smem_bytes(8) <= kMaxSmem && gemm_smem_bytes(6) <= kMaxSmem &&
                  gemm_smem_bytes(4) <= kMaxSmem,
              "the ring fits in shared memory");

// One box of 32 k x 128 rows of one plane into shared memory, reported to `bar`.
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

// A chunk's end: the sum s takes the chunk's lead product h and the small
// accumulator t, each by TwoSum, and t restarts from the two errors.  A
// non-finite t (an f32 overflow of the sum) stays out of s, which then
// holds h's IEEE result.
__device__ __forceinline__ void fold_into(float& s, float& t, float h) {
  float e1, e2;
  const float x = two_sum(s, h, e1);
  const float y = two_sum(x, t, e2);
  const bool finite = isfinite(t);
  s = finite ? y : x;
  t = finite ? __fadd_rn(e1, e2) : t;
}

// Each term's level below its chunk's scale (see the note): the products
// run are those whose levels sum to at most kMaxLevel (ref.product_pairs).
__host__ __device__ constexpr int level(int terms, int i) {
  return terms == 2 ? 7 * i : (i == 0 ? 0 : 8 * i - 1);
}
constexpr int kMaxLevel = 23;
// Steps of 16 columns of k a chunk sums on the tensor cores before it is
// folded: one chunk of the split's grid, two stages of the ring.
constexpr int kFold = 4;

// 1 if any of the 8 bf16 values in w is an inf or NaN.
__device__ __forceinline__ uint32_t nonfinite8(uint4 w) {
  const uint32_t xs[4] = {w.x, w.y, w.z, w.w};
  uint32_t bad = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bad |= static_cast<uint32_t>((xs[i] & 0x7F80u) == 0x7F80u) |
           static_cast<uint32_t>((xs[i] & 0x7F800000u) == 0x7F800000u);
  }
  return bad;
}

// The class of a value from its lead g and first remainder r1 (bf16 bits):
// 0 zero, 1 finite > 0, 2 finite < 0, 3 +inf, 4 -inf, 5 NaN.  A lead of +0
// is a zero value; -0 a nonzero one of r1's sign (zero_lead), however far
// below bf16's range it lies.
__device__ __forceinline__ int value_class(uint16_t g, uint16_t r1) {
  if ((g & 0x7F80) == 0x7F80) return (g & 0x7F) ? 5 : ((g & 0x8000) ? 4 : 3);
  if (g == 0) return 0;
  const uint16_t s = (g & 0x7FFF) ? g : r1;
  return (s & 0x8000) ? 2 : 1;
}

// Where the IEEE sum over k of a_k·b_k is not finite: NaN, +inf or -inf as
// torch.matmul's sum meets them (a NaN, inf·0, or infs of both signs give
// NaN); 0 where it is finite.  a and b: the lead plane of a row of A (of a
// column of B), the first remainder's plane `rest` elements further on.
// Its cost: in a block that met an inf or NaN, each thread scans all Kp
// values of a row and a column from device memory for each of its 64
// outputs, O(K) an output (serial, off the tensor cores); blocks that met
// none skip it.
__device__ __noinline__ float ieee_nonfinite(const uint16_t* a, size_t a_rest, const uint16_t* b,
                                size_t b_rest, int Kp) {
  int nan = 0, pos = 0, neg = 0;
  for (int k = 0; k < Kp; ++k) {
    const int ka = value_class(a[k], a[a_rest + k]), kb = value_class(b[k], b[b_rest + k]);
    if (ka == 5 || kb == 5 || ((ka >= 3 || kb >= 3) && (ka == 0 || kb == 0))) {
      nan = 1;
    } else if (ka >= 3 || kb >= 3) {
      const bool minus = (ka == 2 || ka == 4) != (kb == 2 || kb == 4);
      (minus ? neg : pos) = 1;
    }
  }
  if (nan || (pos && neg)) return __int_as_float(0x7FC00000);
  return pos ? __int_as_float(0x7F800000) : (neg ? __int_as_float(0xFF800000) : 0.0f);
}

// NA, NB: terms of A and B (4 of an f32 operand, 2 of a bf16 one).  The A
// terms' map covers (Kp, M, planes), the B terms' (Kp, N, planes), plane =
// batch entry · terms + term (entry 0 for a shared operand); ta and tb are
// the same buffers, read in the epilogue of a block that met an inf or NaN.
// Thread (warpgroup w, warp v, lane l) holds rows 64w + 16v + l/4 and 8
// more, and for each 8 columns j, columns 8j + 2(l % 4) and one more:
// element 4j + 2·half + e of a 64-float fragment.
template <int NA, int NB>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const uint16_t* __restrict__ ta, const uint16_t* __restrict__ tb,
            float* __restrict__ C, int M, int N, int Kp, int m_tiles, int a_batched,
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
  const int n_k = (Kp + kBK - 1) / kBK;
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
  const int steps = 2 * n_k;              // 16 columns of k a step
  uint32_t bad = 0;                       // an inf or NaN in this thread's share of the leads

  for (int it = 0; it < n_k; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], static_cast<unsigned>((it / kStages) & 1));
    const unsigned char* ta_s = tiles + s * kStage + wg * 64 * (2 * kBK);  // this warpgroup's rows
    const unsigned char* tb_s = tiles + s * kStage + NA * kTile;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int g = 2 * it + kk;
      fence_regs(chunk);
      fence_regs(small);
      wgmma_fence();
      wgmma_128(chunk, sw64_desc(ta_s + 32 * kk), sw64_desc(tb_s + 32 * kk), g % kFold != 0);
#pragma unroll
      for (int i = 0; i < NA; ++i) {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          if ((i > 0 || j > 0) && level(NA, i) + level(NB, j) <= kMaxLevel) {
            wgmma_128(small, sw64_desc(ta_s + i * kTile + 32 * kk),
                      sw64_desc(tb_s + j * kTile + 32 * kk), 1);
          }
        }
      }
      wgmma_commit();
      if (kk == 0) {                      // while the products run: the leads' share
        const unsigned char* st = tiles + s * kStage;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          bad |= nonfinite8(*reinterpret_cast<const uint4*>(st + 16 * tid + 4096 * q));
          bad |= nonfinite8(*reinterpret_cast<const uint4*>(st + NA * kTile + 16 * tid + 4096 * q));
        }
      }
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
  const bool special = __syncthreads_or(static_cast<int>(bad)) != 0;

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
        if (special && col + e < N) {
          const float nf = ieee_nonfinite(ta + (static_cast<size_t>(pa) * M + row) * Kp,
                                          static_cast<size_t>(M) * Kp,
                                          tb + (static_cast<size_t>(pb) * N + col + e) * Kp,
                                          static_cast<size_t>(N) * Kp, Kp);
          v[e] = isfinite(nf) ? v[e] : nf;
        }
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

// The 3-D map of a term buffer (planes, rows, Kp) of bf16: boxes of 32 k x
// 128 rows of one plane, 64-byte swizzled, zero past the ends.
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
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
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
  gemm_kernel<NA, NB>
      <<<dim3(static_cast<unsigned>(m_tiles * n_tiles), 1, batch), kThreads, smem, stream>>>(
          map_a, map_b, static_cast<const uint16_t*>(ta), static_cast<const uint16_t*>(tb),
          static_cast<float*>(C), M, N, Kp, static_cast<int>(m_tiles), a_batched, b_batched);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The split pass on `stream`: x (nb planes of R x C, row-major), dtype 0
// f32 (four terms) or 1 bf16 (two), into dst: (nb, terms, R, pad8(C))
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
  return dtype == 0 ? launch_split<float, 4>(x, dst, nb, R, C, transpose, s)
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
      (na != 2 && na != 4) || (nb != 2 && nb != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(ta) | reinterpret_cast<uintptr_t>(tb)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (na == 4 && nb == 4) {
    return launch_gemm<4, 4>(ta, a_batched, tb, b_batched, C, M, N, Kp, batch, s);
  }
  if (na == 4) {
    return launch_gemm<4, 2>(ta, a_batched, tb, b_batched, C, M, N, Kp, batch, s);
  }
  if (nb == 4) {
    return launch_gemm<2, 4>(ta, a_batched, tb, b_batched, C, M, N, Kp, batch, s);
  }
  return launch_gemm<2, 2>(ta, a_batched, tb, b_batched, C, M, N, Kp, batch, s);
}

const char* block_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
