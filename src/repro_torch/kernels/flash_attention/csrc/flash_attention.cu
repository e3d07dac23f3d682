// Attention with an online softmax (flash attention), for the grouped-query
// layout of the model zoo, f32 or bf16 inputs, f32 arithmetic.
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py:70 flash_call
// and takes the place, on the model's path, of its jnp analogue
//   src/repro/models/attention.py:29 sdpa_chunked
// (every GQA layer's attention core, in prefill and in decode).
//
// What it computes: out = softmax(q·kᵀ·scale + mask)·v, scale = 1/√Dh, for
// q (B, Sq, KV, G, Dh), k (B, T, KV, Dh) and v (B, T, KV, Dv), out (B, Sq,
// KV, G, Dv): query head (h, g) reads KV head h, so K and V are never
// repeated G times.  Dv may differ from Dh (MLA: qk 192 with v 128).  Key t is visible to
// query i when kv_pos[t] <= q_pos[i] (if causal) and kv_valid[t] (if
// given); positions are int32 and compared as ints (INT32_MAX marks an
// empty ring slot).  flash_call's own masks are the case q_pos = 0..Sq-1,
// kv_pos = 0..T-1.  Masked scores are the reference's finite -1e30, never
// -inf: a tile whose keys are all masked then adds p = 1 terms that the
// next real maximum rescales away (alpha = exp(-1e30 - m) = 0), and a row
// with every key masked comes out as the mean of v over its T keys, as a
// full softmax gives it, where -inf would give NaN.  The dot product is
// taken first and then scaled, in f32, as the reference does; the result
// is acc / max(l, 1e-30) (kernel.py:82), rounded once to the output type
// (v's) with __float2bfloat16 (round to nearest) for bf16.
//
// Design.  One block per (query tile, KV head, batch row).  A block owns
// kRows = 64 (query, head) rows: bq = 64 / G queries of all G heads of its
// KV head, so each K/V tile is read once per KV head.  It stages its query
// rows in shared memory once, then walks the keys kBK = 32 at a time: the
// tile's K and V go to shared memory (each element converted to f32 once),
// every thread forms a 4 x 2 block of scores with FMAs in f32, the 16
// threads of a row group take the row's maximum and sum by warp shuffles,
// and the running m, l and the 4 x Dh/16 slice of acc stay in registers.
// Row strides in shared memory are padded by one float against bank
// conflicts.  Head dimensions: Dh = Dv = 64 and 128 (the dense family's)
// are instantiations of their own, with Dh fixed at compile time and a
// block owning all Dv columns.  Every other pair takes the generic path:
// Dh read at run time (the q·k loop runs to it; Q and K rows are staged
// whole), and v taken 64 columns at a time, one chunk a block, the last
// masked, so a block of chunk c recomputes the scores and accumulates
// only columns [64c, 64c + 64) (the chunks' softmax statistics are the
// same floats).  Dv is then unbounded, and Dh only by shared memory: Q and
// K rows of Dh + 1 floats fit up to Dh = 559 (the wrapper refuses past
// it, and so does the launch).  Every tile is visited: a causal prefill pays for the masked
// upper triangle too (the TPU kernel skips those tiles; with general
// positions that needs kv_pos known to ascend).  No tensor cores, no TMA.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s on the bf16 tensor cores,
// 67 TFLOP/s f32 outside them).  At Qwen3-1.7B's prefill (B = 4, 16 heads
// over 8 KV heads, Dh = 128, S = 2048, bf16) the visible causal pairs need
// 2·B·H·Dh·S(S+1)/2 = 34.4 GFLOP for q·kᵀ and as many for p·v.  q·kᵀ
// multiplies bf16 by bf16, exact in f32, so the tensor cores' f32-
// accumulating rate holds for it (0.03 ms); p·v multiplies the f32
// weights p and needs the f32 rate (0.51 ms): bound by operations at
// 0.55 ms, against 0.03 ms for the 100 MB of inputs and output.  Its
// decode step (Sq = 1, T = 2080) reads 34 MB of cache for 68 MFLOP:
// bound by bytes, 0.01 ms.  This kernel does both products as f32 FMAs,
// with a shared-memory load for about every two (0.75 in q·kᵀ, 0.375 in
// p·v), so it stays well above the prefill bound.  At decode a block has Sq·G = 2 of its 64 rows, which
// all fall to row group 0: 16 of the 256 threads compute, over 32 blocks
// (B × KV) for 132 SMs.  Giving the idle row groups key sub-ranges when
// Sq·G < 64 (and combining their m, l and acc at the end), skipping the
// tiles above the causal diagonal, wgmma on bf16 tiles and TMA are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                 // (query, head) rows of a block
constexpr int kBK = 32;                   // keys per tile
constexpr int kGroups = 16;               // threads per row group
constexpr int kRowsPer = kRows / (kThreads / kGroups);   // 4 rows a thread
constexpr int kKeysPer = kBK / kGroups;   // 2 keys a thread
constexpr int kGenericDv = 64;            // v columns a block of the generic path owns
constexpr int kMaxSmem = 232448;          // dynamic shared memory a block may use (sm_90)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Shared memory of a block: Q (kRows x (dh+1)), K (kBK x (dh+1)), V
// (kBK x dvc), P (kRows x (kBK+1)), positions and key flags.
constexpr size_t smem_bytes(int dh, int dvc) {
  return sizeof(float) * (kRows * (dh + 1) + kBK * (dh + 1) + kBK * dvc + kRows * (kBK + 1)) +
         sizeof(int) * (kRows + kBK) + kBK;
}

// DH > 0: the q·k dimension is DH, fixed at compile time (the instantiations
// for Dh = Dv = 64 and 128); DH = 0: it is dh_rt.  A block owns DVC columns
// of v (and of the output), the columns [vc·DVC, vc·DVC + DVC) of its chunk
// vc, masked past Dv; blockIdx.x runs over (query tile, v chunk).
template <typename T, int DH, int DVC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos,
                       const unsigned char* __restrict__ kv_valid, T* __restrict__ out,
                       int Sq, int Tk, int KV, int G, int bq, int causal, float scale,
                       int dh_rt, int Dv, int n_vc) {
  const int dh = DH > 0 ? DH : dh_rt;
  const int kQS = dh + 1;                 // padded strides
  constexpr int kPS = kBK + 1;
  constexpr int kDPer = DVC / kGroups;    // v columns a thread accumulates
  constexpr bool kSquare = DH > 0 && DH == DVC;   // Dv = Dh, one chunk
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // kRows x kQS
  float* ks = qs + kRows * kQS;           // kBK x kQS
  float* vs = ks + kBK * kQS;             // kBK x DVC
  float* ps = vs + kBK * DVC;             // kRows x kPS
  int* qpos = reinterpret_cast<int*>(ps + kRows * kPS);   // kRows
  int* kpos = qpos + kRows;               // kBK
  unsigned char* kok = reinterpret_cast<unsigned char*>(kpos + kBK);   // kBK

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int vc = kSquare ? 0 : static_cast<int>(blockIdx.x % n_vc);
  const int q0 = (kSquare ? static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x / n_vc)) * bq;
  const int d0 = vc * DVC;                // the chunk's first v column
  const int rows = min(bq, Sq - q0) * G;  // rows of this block that exist
  const size_t q_stride = static_cast<size_t>(KV) * G * dh;   // one query position
  const size_t o_stride = static_cast<size_t>(KV) * G * Dv;

  for (int e = tid; e < kRows * dh; e += kThreads) {
    const int rr = e / dh, d = e % dh;
    float x = 0.0f;
    if (rr < rows) {
      x = to_f32(q[(static_cast<size_t>(b) * Sq + q0 + rr / G) * q_stride +
                   (static_cast<size_t>(h) * G + rr % G) * dh + d]);
    }
    qs[rr * kQS + d] = x;
  }
  for (int rr = tid; rr < kRows; rr += kThreads) {
    qpos[rr] = rr < rows ? q_pos[q0 + rr / G] : 0;
  }

  const int rg = tid / kGroups, cg = tid % kGroups;
  const int r0 = rg * kRowsPer;
  const bool active = r0 < rows;          // the same for all 16 lanes of a group
  const unsigned half = (tid % 32) < kGroups ? 0x0000FFFFu : 0xFFFF0000u;
  float m[kRowsPer], l[kRowsPer], acc[kRowsPer][kDPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kDPer; ++c) acc[i][c] = 0.0f;
  }

  for (int t0 = 0; t0 < Tk; t0 += kBK) {
    const int nk = min(kBK, Tk - t0);
    __syncthreads();                      // the last tile's reads are done
    if constexpr (kSquare) {
      for (int e = tid; e < kBK * DH; e += kThreads) {
        const int kk = e / DH, d = e % DH;
        float xk = 0.0f, xv = 0.0f;
        if (kk < nk) {
          const size_t at = ((static_cast<size_t>(b) * Tk + t0 + kk) * KV + h) * DH + d;
          xk = to_f32(k[at]);
          xv = to_f32(v[at]);
        }
        ks[kk * kQS + d] = xk;
        vs[kk * DVC + d] = xv;
      }
    } else {
      for (int e = tid; e < kBK * dh; e += kThreads) {
        const int kk = e / dh, d = e % dh;
        ks[kk * kQS + d] =
            kk < nk ? to_f32(k[((static_cast<size_t>(b) * Tk + t0 + kk) * KV + h) * dh + d])
                    : 0.0f;
      }
      for (int e = tid; e < kBK * DVC; e += kThreads) {
        const int kk = e / DVC, d = e % DVC;
        vs[kk * DVC + d] =
            kk < nk && d0 + d < Dv
                ? to_f32(v[((static_cast<size_t>(b) * Tk + t0 + kk) * KV + h) * Dv + d0 + d])
                : 0.0f;
      }
    }
    for (int kk = tid; kk < kBK; kk += kThreads) {
      kpos[kk] = kk < nk ? kv_pos[t0 + kk] : 0;
      kok[kk] = kk < nk && (kv_valid == nullptr || kv_valid[t0 + kk] != 0);
    }
    __syncthreads();

    if (active) {
      float s[kRowsPer][kKeysPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
#pragma unroll
        for (int j = 0; j < kKeysPer; ++j) s[i][j] = 0.0f;
      }
#pragma unroll 8
      for (int d = 0; d < dh; ++d) {
        float kv[kKeysPer];
#pragma unroll
        for (int j = 0; j < kKeysPer; ++j) kv[j] = ks[(cg + kGroups * j) * kQS + d];
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) {
          const float qv = qs[(r0 + i) * kQS + d];
#pragma unroll
          for (int j = 0; j < kKeysPer; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kKeysPer; ++j) {
          const int kk = cg + kGroups * j;
          const bool visible = kok[kk] && (!causal || kpos[kk] <= qpos[r0 + i]);
          s[i][j] = visible ? __fmul_rn(s[i][j], scale) : kNegInf;
          if (kk < nk) mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = kGroups / 2; off > 0; off /= 2) {
          mx = fmaxf(mx, __shfl_xor_sync(half, mx, off));
        }
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kKeysPer; ++j) {
          const int kk = cg + kGroups * j;
          const float p = kk < nk ? expf(s[i][j] - m_new) : 0.0f;
          ps[(r0 + i) * kPS + kk] = p;
          sum += p;
        }
#pragma unroll
        for (int off = kGroups / 2; off > 0; off /= 2) {
          sum += __shfl_xor_sync(half, sum, off);
        }
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < kDPer; ++c) acc[i][c] *= alpha;
      }
    }
    __syncthreads();                      // the tile's p are in shared memory

    if (active) {
      for (int kk = 0; kk < nk; ++kk) {
        float p[kRowsPer];
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) p[i] = ps[(r0 + i) * kPS + kk];
#pragma unroll
        for (int c = 0; c < kDPer; ++c) {
          const float x = vs[kk * DVC + cg + kGroups * c];
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i) acc[i][c] = fmaf(p[i], x, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int rr = r0 + i;
    if (rr >= rows) break;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (static_cast<size_t>(b) * Sq + q0 + rr / G) * o_stride +
           (static_cast<size_t>(h) * G + rr % G) * Dv + d0;
#pragma unroll
    for (int c = 0; c < kDPer; ++c) {
      const int d = cg + kGroups * c;
      if (kSquare || d0 + d < Dv) store(o + d, acc[i][c] / denom);
    }
  }
}

template <typename T, int DH, int DVC>
int launch(const void* q, const void* k, const void* v, const int* q_pos,
           const int* kv_pos, const unsigned char* kv_valid, void* out, int B, int Sq,
           int Tk, int KV, int G, int causal, float scale, int Dh, int Dv,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(Dh, DVC);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  // Set at every launch: the attribute belongs to the current device.
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DH, DVC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bq = min(max(1, kRows / G), Sq);
  const int n_vc = (Dv + DVC - 1) / DVC;
  const long long nx = static_cast<long long>((Sq + bq - 1) / bq) * n_vc;
  if (nx > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nx), KV, B);
  flash_attention_kernel<T, DH, DVC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_pos,
      kv_pos, kv_valid, static_cast<T*>(out), Sq, Tk, KV, G, bq, causal, scale, Dh, Dv,
      n_vc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dims(const void* q, const void* k, const void* v, const int* q_pos,
                const int* kv_pos, const unsigned char* kv_valid, void* out, int B, int Sq,
                int Tk, int KV, int G, int Dh, int Dv, int causal, float scale,
                cudaStream_t stream) {
  if (Dh == 64 && Dv == 64) {
    return launch<T, 64, 64>(q, k, v, q_pos, kv_pos, kv_valid, out, B, Sq, Tk, KV, G,
                             causal, scale, Dh, Dv, stream);
  }
  if (Dh == 128 && Dv == 128) {
    return launch<T, 128, 128>(q, k, v, q_pos, kv_pos, kv_valid, out, B, Sq, Tk, KV, G,
                               causal, scale, Dh, Dv, stream);
  }
  return launch<T, 0, kGenericDv>(q, k, v, q_pos, kv_pos, kv_valid, out, B, Sq, Tk, KV, G,
                                  causal, scale, Dh, Dv, stream);
}

}  // namespace

extern "C" {

// Launches the attention on `stream`: q (B, Sq, KV, G, Dh), k (B, T, KV, Dh),
// v (B, T, KV, Dv), out (B, Sq, KV, G, Dv), all contiguous, f32 (bf16 = 0)
// or bf16 (bf16 = 1); q_pos (Sq,) and kv_pos (T,) int32; kv_valid (T,)
// bytes or null.  Dh >= 1 up to what shared memory holds (559: a larger
// Dh is refused), Dv >= 1, 1 <= G <= 64.  Returns a CUDA error code (0 =
// launched).
int flash_attention_launch(const void* q, const void* k, const void* v, const int* q_pos,
                           const int* kv_pos, const unsigned char* kv_valid, void* out,
                           int B, int Sq, int T, int KV, int G, int Dh, int Dv, int bf16,
                           int causal, float scale, void* stream) {
  if (B < 1 || Sq < 1 || T < 1 || KV < 1 || G < 1 || G > kRows || B > 65535 ||
      KV > 65535 || Dh < 1 || Dv < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_dims<__nv_bfloat16>(q, k, v, q_pos, kv_pos, kv_valid, out, B, Sq, T, KV,
                                      G, Dh, Dv, causal, scale, s);
  }
  return launch_dims<float>(q, k, v, q_pos, kv_pos, kv_valid, out, B, Sq, T, KV, G, Dh, Dv,
                            causal, scale, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
