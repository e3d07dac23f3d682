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
// repeated G times.  Dv may differ from Dh (MLA: qk 192 with v 128).  Key t
// is visible to query i when kv_pos[t] <= q_pos[i] (if causal) and
// kv_valid[t] (if given); positions are int32 and compared as ints
// (INT32_MAX marks an empty ring slot).  flash_call's own masks are the case
// q_pos = 0..Sq-1, kv_pos = 0..T-1.  Masked scores are the reference's
// finite -1e30, never -inf: a tile whose keys are all masked then adds p = 1
// terms that the next real maximum rescales away (alpha = exp(-1e30 - m) =
// 0), and a row with every key masked comes out as the mean of v over its T
// keys, as a full softmax gives it, where -inf would give NaN.  The dot
// product is taken first and then scaled, in f32, as the reference does; the
// result is acc / max(l, 1e-30) (kernel.py:82), rounded once to the output
// type (v's) with __float2bfloat16 (round to nearest) for bf16.
//
// Two kernels, one block per 64 (query, head) rows of one KV head and one
// batch row: bq = 64 / G queries of all G heads, so each K/V tile is read
// once per KV head.  The wrapper (ops.py) picks one by shape, never as a
// fallback:
//
// * flash_tc_kernel, the tensor-core prefill: bf16 with Dh = Dv in {64,
//   128}, taken when Sq·G >= 64 (a block has a full 64 rows).  One
//   warpgroup of 128 threads.  The Q tile is staged once in the 128-byte
//   swizzled layout; K and V tiles of 64 keys arrive by TMA (a 4-D tensor
//   map over (Dh, KV, T, B), zero past T), each behind an mbarrier: K into
//   a ring of two stages, so tile t + 1 loads while tile t computes, V into
//   one buffer, reloaded once tile t's p·v is done and waited for only
//   after tile t + 1's scores and softmax.  A block then holds 64 KB at
//   Dh = 128 and three blocks share an SM.  q·kᵀ is a wgmma m64n64k16 from
//   shared memory (bf16 × bf16, exact in f32, accumulated in f32).  The
//   online softmax runs on the accumulator fragment in registers (row max
//   and sum over the quad of lanes that hold a row; a tile whose every key
//   every row sees skips the mask; p = 2^((s - m)·log2 e) on the special-
//   function unit).  p·v is a wgmma with p in registers, and p keeps its f32
//   precision: p = p1 + p2 + p3, each the bf16 rounding of what is left
//   (p - p1 and p - p1 - p2 are exact in f32, and 3 × 8 significant bits,
//   each with its own sign, cover p's 24), and v is bf16, so the three
//   products are exact and sum in f32.  Rounding p once to bf16, as
//   scaled_dot_product_attention does, would be another function, and the
//   checks see it: beside this kernel, chip_smoke.py and the tests hold a
//   control, the plain version with p rounded once (ref.attention_ref,
//   p_terms=1), that the same bf16 comparison must reject.  Query
//   tiles run longest first (the causal triangle's long rows start early).
// * flash_simt_kernel, every other case (f32, other head dimensions,
//   decode): 256 threads; K and V tiles of 32 keys are converted to f32 in
//   shared memory, each thread forms a 4 x 2 block of scores with FMAs, the
//   16 threads of a row group take the row's maximum and sum by warp
//   shuffles, and the running m, l and the 4 x Dv/16 slice of acc stay in
//   registers.  Row strides in shared memory are padded by one float
//   against bank conflicts.  Dh = Dv = 64 and 128 are instantiations with
//   Dh fixed at compile time and a block owning all Dv columns.  Every
//   other pair takes the generic path: v taken 64 columns a block (one
//   chunk along grid x, the last masked; each chunk's block recomputes the
//   scores, and the softmax statistics are the same floats), and q·k in
//   chunks of 64 columns of Q and K staged in turn, each score's FMA chain
//   in ascending d across the chunks.  So no head dimension is bounded by
//   shared memory.
//
// The causal skip, in both kernels: a block skips key tile j when no key
// in it is visible to any of its rows and every row has already met a
// visible key in an earlier tile.  After a row's first visible key, a
// fully masked tile adds p = exp(-1e30 - m) = 0 with alpha = 1, so skipping
// it changes no bit (for finite inputs; a NaN or inf in a skipped v row is
// not read).  A row with no visible key at all keeps every tile, and comes
// out as the mean of v.  Positions need not ascend (ring buffers wrap): the
// block reads the keys' positions and flags, 32 tiles at a time
// (window_bits), before it loads a tile.  On causal prefill with ascending
// positions this keeps tiles 0 .. (q0 + bq + bk - 1) / bk - 1, flash_call's
// own loop range.  ref.visited_tiles is the rule's plain version.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s on the bf16 tensor cores,
// 67 TFLOP/s f32 outside them).  At Qwen3-1.7B's prefill (B = 4, 16 heads
// over 8 KV heads, Dh = 128, S = 2048, bf16) the visible causal pairs need
// 2·B·H·Dh·S(S+1)/2 = 34.4 GFLOP for q·kᵀ and as many for p·v.  The same
// f32-accurate work on the tensor cores is one bf16 product for q·kᵀ and
// three for p·v: 4 × 34.4 GFLOP at 989 TFLOP/s, 0.139 ms, against 0.030 ms
// for the 100 MB of inputs and output.  The tensor-core kernel issues each
// tile's wgmma, softmax and wgmma in turn (no warp specialisation, no
// ping-pong between warpgroups); the blocks on an SM overlap each other's.
// The SIMT work between the two products (mask, softmax, the split of p)
// is the largest share of a tile's cycles, as clock64 reads around the
// loop's phases showed.
// A decode step (Sq = 1, T = 2080) reads 34 MB of cache for 68 MFLOP: bound
// by bytes, 0.01 ms.  At decode a block has Sq·G = 2 of its 64 rows, which
// all fall to row group 0 of the SIMT kernel: 16 of the 256 threads
// compute, over 32 blocks (B × KV) for 132 SMs.  Giving the idle row groups
// key sub-ranges (and splitting the keys across SMs) is later work.
#include <cuda.h>   // CUtensorMap and its enums; the encode is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;                 // (query, head) rows of a block
constexpr int kWindow = 32;               // key tiles whose visits are decided at once
constexpr int kMaxSmem = 232448;          // dynamic shared memory a block may use (sm_90)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ------------------------------------------------------------ the causal skip

// What a block needs to decide its key tiles; the same in every thread.
struct KeyTiles {
  const int* kv_pos;
  const unsigned char* kv_valid;          // null: every key valid
  int Tk, causal;
  int qmin, qmax;                         // positions of the block's queries
  unsigned* scratch;                      // 3 words a warp, in shared memory
};

// The running walk over the key tiles: window w's tiles still to visit, its
// tiles whose every key is visible to every row of the block, and whether an
// earlier tile held a key visible to every row.
struct Walk {
  int w = -1;
  unsigned bits = 0, full = 0;
  bool met = false;
};

// The visits of window w (tiles 32w .. 32w + 31 of BK keys), as bits.  Every
// thread of the block calls it together; each checks 32·BK / THREADS
// consecutive keys.  A tile is visited when a key in it is visible to the
// block's highest query position (qmax), or when no earlier tile holds a key
// visible to its lowest (qmin): up to and including the first tile that
// does, every tile.  `full` gets the tiles whose every key is visible to
// qmin, so to every row: they need no mask.
template <int BK, int THREADS>
__device__ unsigned window_bits(int w, const KeyTiles& kt, bool& met, unsigned& full) {
  constexpr int kPer = kWindow * BK / THREADS;
  constexpr int kLanes = BK / kPer;       // lanes that share a tile
  constexpr int kTilesPerWarp = 32 / kLanes;
  constexpr int kWarps = THREADS / 32;
  static_assert(kPer >= 1 && BK % kPer == 0 && kWarps * kTilesPerWarp == kWindow,
                "a window is one tile per bit, spread over every thread");
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long t_first = static_cast<long long>(w) * kWindow * BK +
                            static_cast<long long>(tid) * kPer;
  bool vis = false, mt = false, partial = false;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const long long t = t_first + e;
    if (t < kt.Tk) {
      const bool ok = kt.kv_valid == nullptr || kt.kv_valid[t] != 0;
      const int p = kt.kv_pos[t];
      vis |= ok && (!kt.causal || p <= kt.qmax);
      mt |= ok && (!kt.causal || p <= kt.qmin);
      partial |= !(ok && (!kt.causal || p <= kt.qmin));
    } else {
      partial = true;
    }
  }
  const unsigned bv = __ballot_sync(0xffffffffu, vis), bm = __ballot_sync(0xffffffffu, mt);
  const unsigned bp = __ballot_sync(0xffffffffu, partial);
  __syncthreads();                        // the last window's words have been read
  if (lane == 0) {
    constexpr unsigned kGroup = kLanes == 32 ? 0xffffffffu : (1u << kLanes) - 1u;
    unsigned v = 0, m = 0, f = 0;
#pragma unroll
    for (int i = 0; i < kTilesPerWarp; ++i) {
      v |= ((bv >> (i * kLanes)) & kGroup) ? 1u << i : 0u;
      m |= ((bm >> (i * kLanes)) & kGroup) ? 1u << i : 0u;
      f |= ((bp >> (i * kLanes)) & kGroup) ? 0u : 1u << i;
    }
    kt.scratch[warp] = v << (warp * kTilesPerWarp);
    kt.scratch[kWarps + warp] = m << (warp * kTilesPerWarp);
    kt.scratch[2 * kWarps + warp] = f << (warp * kTilesPerWarp);
  }
  __syncthreads();
  unsigned vbits = 0, mbits = 0;
  full = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    vbits |= kt.scratch[i];
    mbits |= kt.scratch[kWarps + i];
    full |= kt.scratch[2 * kWarps + i];
  }
  unsigned visit = vbits;
  if (!met) {
    if (mbits != 0) {
      const int f = __ffs(mbits) - 1;
      visit |= f == 31 ? 0xffffffffu : (2u << f) - 1u;
      met = true;
    } else {
      visit = 0xffffffffu;
    }
  }
  const int n_tiles = (kt.Tk + BK - 1) / BK;
  const int left = n_tiles - w * kWindow;
  return left >= kWindow ? visit : visit & ((1u << left) - 1u);
}

// The next key tile the block visits, or -1, and whether its every key is
// visible to every row.  Called by every thread together.
template <int BK, int THREADS>
__device__ int next_tile(Walk& wk, const KeyTiles& kt, bool& full) {
  const int n_windows = (kt.Tk + kWindow * BK - 1) / (kWindow * BK);
  full = false;
  while (wk.bits == 0) {
    if (wk.w + 1 >= n_windows) return -1;
    ++wk.w;
    wk.bits = window_bits<BK, THREADS>(wk.w, kt, wk.met, wk.full);
  }
  const int b = __ffs(wk.bits) - 1;
  wk.bits &= wk.bits - 1;
  full = (wk.full >> b) & 1u;
  return wk.w * kWindow + b;
}

// The lowest and highest position of queries q0 .. q0 + nq - 1, by warp 0,
// into range[0..1]; the caller synchronises before reading them.
__device__ void query_range(const int* __restrict__ q_pos, int q0, int nq, int* range) {
  if (threadIdx.x >= 32) return;
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = threadIdx.x; i < nq; i += 32) {
    const int p = q_pos[q0 + i];
    lo = min(lo, p);
    hi = max(hi, p);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (threadIdx.x == 0) {
    range[0] = lo;
    range[1] = hi;
  }
}

// --------------------------------------------------------------- SIMT kernel

constexpr int kThreads = 256;
constexpr int kBK = 32;                   // keys per tile
constexpr int kGroups = 16;               // threads per row group
constexpr int kRowsPer = kRows / (kThreads / kGroups);   // 4 rows a thread
constexpr int kKeysPer = kBK / kGroups;   // 2 keys a thread
constexpr int kGenericDv = 64;            // v columns a block of the generic path owns
constexpr int kDC = 64;                   // q·k columns the generic path stages at a time

// Shared memory of a block: Q (kRows x (ds+1)), K (kBK x (ds+1)) with ds
// the q·k columns staged at a time, V (kBK x dvc), P (kRows x (kBK+1)),
// positions, the walk's words, the query range and key flags.
constexpr size_t smem_bytes(int ds, int dvc) {
  return sizeof(float) * (kRows * (ds + 1) + kBK * (ds + 1) + kBK * dvc + kRows * (kBK + 1)) +
         sizeof(int) * (kRows + kBK + 3 * (kThreads / 32) + 2) + kBK;
}

// DH > 0: Dh = Dv = DH, fixed at compile time (the instantiations for 64
// and 128), Q and K rows staged whole; DH = 0: Dh is dh_rt, staged kDC
// columns at a time when it is larger.  A block owns DVC columns of v (and
// of the output), the columns [vc·DVC, vc·DVC + DVC) of its chunk vc,
// masked past Dv; blockIdx.x runs over (query tile, v chunk).
template <typename T, int DH, int DVC>
__global__ void __launch_bounds__(kThreads)
flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                  const unsigned char* __restrict__ kv_valid, T* __restrict__ out, int Sq,
                  int Tk, int KV, int G, int bq, int causal, float scale, int dh_rt, int Dv,
                  int n_vc, unsigned long long* tiles_visited) {
  constexpr bool kFixed = DH > 0;
  constexpr int kDS = kFixed ? DH : kDC;  // q·k columns staged at a time
  constexpr int kQS = kDS + 1;            // padded strides
  constexpr int kPS = kBK + 1;
  constexpr int kDPer = DVC / kGroups;    // v columns a thread accumulates
  const int dh = kFixed ? DH : dh_rt;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // kRows x kQS
  float* ks = qs + kRows * kQS;           // kBK x kQS
  float* vs = ks + kBK * kQS;             // kBK x DVC
  float* ps = vs + kBK * DVC;             // kRows x kPS
  int* qpos = reinterpret_cast<int*>(ps + kRows * kPS);   // kRows
  int* kpos = qpos + kRows;               // kBK
  unsigned* words = reinterpret_cast<unsigned*>(kpos + kBK);   // the walk's
  int* qrange = reinterpret_cast<int*>(words + 3 * (kThreads / 32));
  unsigned char* kok = reinterpret_cast<unsigned char*>(qrange + 2);   // kBK

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int vc = kFixed ? 0 : static_cast<int>(blockIdx.x % n_vc);
  const int q0 = (kFixed ? static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x / n_vc)) * bq;
  const int d0 = vc * DVC;                // the chunk's first v column
  const int nq = min(bq, Sq - q0);
  const int rows = nq * G;                // rows of this block that exist
  const bool chunked = !kFixed && dh > kDC;
  const size_t q_stride = static_cast<size_t>(KV) * G * dh;   // one query position
  const size_t o_stride = static_cast<size_t>(KV) * G * Dv;

  // Q's columns [c0, c0 + w) and K's for keys t0 .. t0 + nk - 1 (zero past them).
  auto stage_q = [&](int c0, int w) {
    for (int e = tid; e < kRows * w; e += kThreads) {
      const int rr = e / w, d = e % w;
      float x = 0.0f;
      if (rr < rows) {
        x = to_f32(q[(static_cast<size_t>(b) * Sq + q0 + rr / G) * q_stride +
                     (static_cast<size_t>(h) * G + rr % G) * dh + c0 + d]);
      }
      qs[rr * kQS + d] = x;
    }
  };
  auto stage_k = [&](int t0, int nk, int c0, int w) {
    for (int e = tid; e < kBK * w; e += kThreads) {
      const int kk = e / w, d = e % w;
      ks[kk * kQS + d] =
          kk < nk ? to_f32(k[((static_cast<size_t>(b) * Tk + t0 + kk) * KV + h) * dh + c0 + d])
                  : 0.0f;
    }
  };

  if (!chunked) stage_q(0, dh);
  for (int rr = tid; rr < kRows; rr += kThreads) {
    qpos[rr] = rr < rows ? q_pos[q0 + rr / G] : 0;
  }
  query_range(q_pos, q0, nq, qrange);
  __syncthreads();
  const KeyTiles kt{kv_pos, kv_valid, Tk, causal, qrange[0], qrange[1], words};

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

  Walk wk;
  bool full;                              // (the SIMT kernel masks every tile)
  unsigned long long visited = 0;
  for (int j = next_tile<kBK, kThreads>(wk, kt, full); j >= 0;
       j = next_tile<kBK, kThreads>(wk, kt, full)) {
    const int t0 = j * kBK;
    const int nk = min(kBK, Tk - t0);
    ++visited;
    __syncthreads();                      // the last tile's reads are done
    if constexpr (kFixed) {
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
      stage_k(t0, nk, 0, min(kDS, dh));
      if (chunked) stage_q(0, kDS);
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

    float s[kRowsPer][kKeysPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
#pragma unroll
      for (int jj = 0; jj < kKeysPer; ++jj) s[i][jj] = 0.0f;
    }
    // One FMA chain a score, in ascending d, across the staged chunks.
    for (int c0 = 0; c0 < dh; c0 += kDS) {
      const int w = min(kDS, dh - c0);
      if (c0 > 0) {                       // the generic path past kDC columns
        __syncthreads();                  // the last chunk's reads are done
        stage_q(c0, w);
        stage_k(t0, nk, c0, w);
        __syncthreads();
      }
      if (active) {
#pragma unroll 8
        for (int d = 0; d < w; ++d) {
          float kv[kKeysPer];
#pragma unroll
          for (int jj = 0; jj < kKeysPer; ++jj) kv[jj] = ks[(cg + kGroups * jj) * kQS + d];
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i) {
            const float qv = qs[(r0 + i) * kQS + d];
#pragma unroll
            for (int jj = 0; jj < kKeysPer; ++jj) s[i][jj] = fmaf(qv, kv[jj], s[i][jj]);
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int jj = 0; jj < kKeysPer; ++jj) {
          const int kk = cg + kGroups * jj;
          const bool visible = kok[kk] && (!causal || kpos[kk] <= qpos[r0 + i]);
          s[i][jj] = visible ? __fmul_rn(s[i][jj], scale) : kNegInf;
          if (kk < nk) mx = fmaxf(mx, s[i][jj]);
        }
#pragma unroll
        for (int off = kGroups / 2; off > 0; off /= 2) {
          mx = fmaxf(mx, __shfl_xor_sync(half, mx, off));
        }
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        float sum = 0.0f;
#pragma unroll
        for (int jj = 0; jj < kKeysPer; ++jj) {
          const int kk = cg + kGroups * jj;
          const float p = kk < nk ? expf(s[i][jj] - m_new) : 0.0f;
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
      if (kFixed || d0 + d < Dv) store(o + d, acc[i][c] / denom);
    }
  }
  if (tiles_visited != nullptr && tid == 0) atomicAdd(tiles_visited, visited);
}

template <typename T, int DH, int DVC>
int launch_simt(const void* q, const void* k, const void* v, const int* q_pos,
                const int* kv_pos, const unsigned char* kv_valid, void* out, int B, int Sq,
                int Tk, int KV, int G, int causal, float scale, int Dh, int Dv,
                unsigned long long* tiles_visited, cudaStream_t stream) {
  const size_t smem = smem_bytes(DH > 0 ? DH : kDC, DVC);
  // Set at every launch: the attribute belongs to the current device.
  const cudaError_t err = cudaFuncSetAttribute(
      flash_simt_kernel<T, DH, DVC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bq = min(max(1, kRows / G), Sq);
  const int n_vc = (Dv + DVC - 1) / DVC;
  const long long nx = static_cast<long long>((Sq + bq - 1) / bq) * n_vc;
  if (nx > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nx), KV, B);
  flash_simt_kernel<T, DH, DVC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_pos,
      kv_pos, kv_valid, static_cast<T*>(out), Sq, Tk, KV, G, bq, causal, scale, Dh, Dv, n_vc,
      tiles_visited);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_simt_dims(const void* q, const void* k, const void* v, const int* q_pos,
                     const int* kv_pos, const unsigned char* kv_valid, void* out, int B,
                     int Sq, int Tk, int KV, int G, int Dh, int Dv, int causal, float scale,
                     unsigned long long* tiles_visited, cudaStream_t stream) {
  if (Dh == 64 && Dv == 64) {
    return launch_simt<T, 64, 64>(q, k, v, q_pos, kv_pos, kv_valid, out, B, Sq, Tk, KV, G,
                                  causal, scale, Dh, Dv, tiles_visited, stream);
  }
  if (Dh == 128 && Dv == 128) {
    return launch_simt<T, 128, 128>(q, k, v, q_pos, kv_pos, kv_valid, out, B, Sq, Tk, KV, G,
                                    causal, scale, Dh, Dv, tiles_visited, stream);
  }
  return launch_simt<T, 0, kGenericDv>(q, k, v, q_pos, kv_pos, kv_valid, out, B, Sq, Tk, KV,
                                       G, causal, scale, Dh, Dv, tiles_visited, stream);
}

// -------------------------------------------------------- tensor-core kernel

constexpr int kTcThreads = 128;           // one warpgroup
constexpr int kTcBK = 64;                 // keys per tile
constexpr int kTcStages = 2;              // K tiles in flight
constexpr int kAtomBytes = 64 * 128;      // 64 rows of one 128-byte swizzle row: 64 bf16 columns

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

// One box of 64 columns x 64 keys of K or V (coordinates innermost first:
// column, KV head, key, batch row) into shared memory, reported to `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A wgmma operand in shared memory under the 128-byte swizzle: start address,
// leading byte offset, stride byte offset 1024 (8 rows of 128 bytes), in
// 16-byte units.  K-major operands (Q, K) ignore the leading offset (1);
// the MN-major V takes the distance between its 64-column atoms.
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

// d (64 x 64, f32) = a·bᵀ (acc = 0) or d += a·bᵀ, a (64 x 16) and b (64 x 16)
// bf16 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64, f32) += a·b, a (64 x 16) bf16 in registers (the accumulator
// layout's fragment), b (16 x 64) bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) as three bf16 pairs whose sum is exactly (x0, x1): each the bf16
// rounding of what the earlier ones leave (the differences are exact in f32).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& a1, uint32_t& a2,
                                       uint32_t& a3) {
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(x0, x1);
  const float r0 = __fsub_rn(x0, __low2float(h1)), r1 = __fsub_rn(x1, __high2float(h1));
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(r0, r1);
  const float u0 = __fsub_rn(r0, __low2float(h2)), u1 = __fsub_rn(r1, __high2float(h2));
  a1 = bf16x2_bits(h1);
  a2 = bf16x2_bits(h2);
  a3 = bf16x2_bits(__floats2bfloat162_rn(u0, u1));
}

// 2^x on the special-function unit (exact at 0: 2^0 = 1; 0 far below).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

constexpr size_t tc_smem_bytes(int D) {
  return 1024 +                                          // alignment of the tiles
         static_cast<size_t>(64) * D * 2 * (2 + kTcStages) +   // Q, K stages, V
         kTcStages * kTcBK * (sizeof(int) + 1) +          // key positions and flags
         (kTcStages + 1) * sizeof(uint64_t) +             // mbarriers
         sizeof(unsigned) * 3 * (kTcThreads / 32) + 2 * sizeof(int);
}

// D = Dh = Dv (64 or 128), bf16.  Rows r of the block are (query q0 + r / G,
// head r % G); thread (warp w, lane l) holds rows 16w + l/4 and 16w + l/4 + 8
// and, for each 8 columns j, columns 8j + 2(l % 4) and one more (wgmma's
// accumulator layout): element 4j + 2·half + e of a 32-float fragment.
// K tiles sit in a ring of kTcStages, each behind an mbarrier, and arrive
// a tile ahead; V in one buffer behind its own, loaded as soon as the last
// tile's p·v is done, and waited for only after the next tile's scores and
// softmax.  So a block holds 64 KB at D = 128 and three share an SM.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 3)
flash_tc_kernel(const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __nv_bfloat16* __restrict__ q, const int* __restrict__ q_pos,
                const int* __restrict__ kv_pos, const unsigned char* __restrict__ kv_valid,
                __nv_bfloat16* __restrict__ out, int Sq, int Tk, int KV, int G, int bq,
                int n_qt, int causal, float scale, unsigned long long* tiles_visited) {
  constexpr int kAtoms = D / 64;          // 64-column atoms of a row
  constexpr int kTile = kAtoms * kAtomBytes;   // a Q, K or V tile in bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Tiles start on 1024 bytes of the shared window: the swizzle repeats there.
  unsigned char* sq = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sk = sq + kTile;                        // kTcStages tiles
  unsigned char* sv = sk + kTcStages * kTile;            // one tile
  int* kpos = reinterpret_cast<int*>(sv + kTile);        // [stage][key]
  unsigned char* kflag = reinterpret_cast<unsigned char*>(kpos + kTcStages * kTcBK);
  uint64_t* kbar = reinterpret_cast<uint64_t*>(kflag + kTcStages * kTcBK);
  uint64_t* vbar = kbar + kTcStages;
  unsigned* words = reinterpret_cast<unsigned*>(vbar + 1);
  int* qrange = reinterpret_cast<int*>(words + 3 * (kTcThreads / 32));

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const CUtensorMap* tmk = &map_k;
  const CUtensorMap* tmv = &map_v;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * bq;   // longest first
  const int nq = min(bq, Sq - q0);
  const int rows = nq * G;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s <= kTcStages; ++s) mbar_init(&kbar[s], 1);   // vbar too
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The Q tile, 16 bytes a thread at a time, in the layout TMA's 128-byte
  // swizzle gives: 16-byte group g of row r at g ^ (r % 8); zero past the rows.
  for (int e = tid; e < kRows * D / 8; e += kTcThreads) {
    const int rr = e / (D / 8), c8 = e % (D / 8);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (rr < rows) {
      const size_t row =
          ((static_cast<size_t>(b) * Sq + q0 + rr / G) * KV + hk) * G + rr % G;
      x = *reinterpret_cast<const uint4*>(q + row * D + c8 * 8);
    }
    *reinterpret_cast<uint4*>(sq + (c8 / 8) * kAtomBytes + rr * 128 + ((c8 % 8) ^ (rr % 8)) * 16) =
        x;
  }
  query_range(q_pos, q0, nq, qrange);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // Q, for wgmma
  __syncthreads();
  const KeyTiles kt{kv_pos, kv_valid, Tk, causal, qrange[0], qrange[1], words};

  // Key tile j into stage s: K by TMA (thread 0), positions and flags (0
  // past T, 1 masked by kv_valid, 2 valid) by the first 64 threads.
  auto load_k = [&](int s, int j) {
    if (tid == 0) {
      mbar_expect_tx(&kbar[s], kTile);
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) {
        tma_load(sk + s * kTile + a * kAtomBytes, tmk, &kbar[s], 64 * a, hk, j * kTcBK, b);
      }
    }
    if (tid < kTcBK) {
      const long long t = static_cast<long long>(j) * kTcBK + tid;
      int p = 0, f = 0;
      if (t < Tk) {
        p = kv_pos[t];
        f = kv_valid == nullptr || kv_valid[t] != 0 ? 2 : 1;
      }
      kpos[s * kTcBK + tid] = p;
      kflag[s * kTcBK + tid] = static_cast<unsigned char>(f);
    }
  };
  auto load_v = [&](int j) {
    if (tid == 0) {
      mbar_expect_tx(vbar, kTile);
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) {
        tma_load(sv + a * kAtomBytes, tmv, vbar, 64 * a, hk, j * kTcBK, b);
      }
    }
  };

  // The next kTcStages tiles to visit (-1: none) and whether each needs no mask.
  Walk wk;
  int tiles[kTcStages];
  bool fulls[kTcStages];
#pragma unroll
  for (int s = 0; s < kTcStages; ++s) {
    tiles[s] = next_tile<kTcBK, kTcThreads>(wk, kt, fulls[s]);
    if (tiles[s] >= 0) load_k(s, tiles[s]);
  }
  if (tiles[0] >= 0) load_v(tiles[0]);
  __syncthreads();                        // the first stages' positions

  int qp[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + lane / 4 + 8 * hh;
    qp[hh] = r < rows ? q_pos[q0 + r / G] : INT_MIN;
  }
  float o[kAtoms][32];
#pragma unroll
  for (int a = 0; a < kAtoms; ++a) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[a][i] = 0.0f;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  unsigned long long visited = 0;

  for (int it = 0; tiles[0] >= 0; ++it) {
    const int s = it % kTcStages;
    ++visited;
    mbar_wait(&kbar[s], static_cast<unsigned>((it / kTcStages) & 1));

    // scores = Q·Kᵀ, bf16 products summed in f32
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss(sc, sw128_desc(sq + a * kAtomBytes + 32 * kk, 16),
                 sw128_desc(sk + s * kTile + a * kAtomBytes + 32 * kk, 16), a > 0 || kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // Scale, mask and the online softmax, row by row.  A tile whose every
    // key every row sees takes no mask.  p = 2^((s - m)·log2 e): exactly 1
    // at s = m and 0 at the mask, so a fully masked tile still adds nothing.
    const int* kp = kpos + s * kTcBK;
    const unsigned char* kf = kflag + s * kTcBK;
    const bool open = fulls[0];
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = kNegInf;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j8 + 2 * (lane % 4) + e;
          float& x = sc[4 * j8 + 2 * hh + e];
          if (open) {
            x = __fmul_rn(x, scale);
            mx = fmaxf(mx, x);
          } else {
            const int f = kf[col];
            const bool visible = f == 2 && (!causal || kp[col] <= qp[hh]);
            x = visible ? __fmul_rn(x, scale) : kNegInf;
            if (f != 0) mx = fmaxf(mx, x);
          }
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      alpha[hh] = ex2(__fmul_rn(__fsub_rn(m[hh], m_new), kLog2e));
      float sum = 0.0f;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j8 + 2 * (lane % 4) + e;
          float& x = sc[4 * j8 + 2 * hh + e];
          x = open || kf[col] != 0 ? ex2(__fmul_rn(__fsub_rn(x, m_new), kLog2e)) : 0.0f;
          sum += x;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hh] = l[hh] * alpha[hh] + sum;
      m[hh] = m_new;
    }
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[a][i] *= alpha[(i / 2) % 2];
    }

    // p as three bf16 terms, in the A-fragment layout: for keys 16kk ..
    // 16kk + 15, register r holds row half r % 2 and columns 8(2kk + r / 2)
    // + 2(l % 4) + {0, 1}, the accumulator's elements 8kk + 2r and one more.
    uint32_t pa[3][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        split3(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], pa[0][kk][r], pa[1][kk][r],
               pa[2][kk][r]);
      }
    }

    // acc += p·V, the smallest terms first
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) fence_regs(o[a]);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pa[t][kk]);
    }
    mbar_wait(vbar, static_cast<unsigned>(it & 1));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int t = 2; t >= 0; --t) {
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) {
          wgmma_rs(o[a], pa[t][kk], sw128_desc(sv + a * kAtomBytes + kk * 16 * 128, kAtomBytes));
        }
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) fence_regs(o[a]);

    __syncthreads();                      // stage s and V are read: refill them
    bool fn;
    const int nn = next_tile<kTcBK, kTcThreads>(wk, kt, fn);
#pragma unroll
    for (int i = 0; i + 1 < kTcStages; ++i) {
      tiles[i] = tiles[i + 1];
      fulls[i] = fulls[i + 1];
    }
    tiles[kTcStages - 1] = nn;
    fulls[kTcStages - 1] = fn;
    if (nn >= 0) load_k(s, nn);
    if (tiles[0] >= 0) load_v(tiles[0]);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + lane / 4 + 8 * hh;
    if (r >= rows) continue;
    const float denom = fmaxf(l[hh], 1e-30f);
    __nv_bfloat16* orow =
        out + (((static_cast<size_t>(b) * Sq + q0 + r / G) * KV + hk) * G + r % G) * D;
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        const int col = 64 * a + 8 * j8 + 2 * (lane % 4);
        const __nv_bfloat162 x = __halves2bfloat162(
            __float2bfloat16(o[a][4 * j8 + 2 * hh] / denom),
            __float2bfloat16(o[a][4 * j8 + 2 * hh + 1] / denom));
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = x;
      }
    }
  }
  if (tiles_visited != nullptr && tid == 0) atomicAdd(tiles_visited, visited);
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

// The 4-D map of k or v (B, T, KV, D) bf16: boxes of 64 columns x 64 keys of
// one KV head and batch row, 128-byte swizzled, zero past T.
bool key_map(CUtensorMap* map, const void* x, int B, int Tk, int KV, int D) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(Tk), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row, row * KV, row * KV * Tk};
  const cuuint32_t box[4] = {64, 1, kTcBK, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const int* q_pos, const int* kv_pos,
              const unsigned char* kv_valid, void* out, int B, int Sq, int Tk, int KV, int G,
              int causal, float scale, unsigned long long* tiles_visited, cudaStream_t stream) {
  CUtensorMap map_k, map_v;
  if (!key_map(&map_k, k, B, Tk, KV, D) || !key_map(&map_v, v, B, Tk, KV, D)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  const size_t smem = tc_smem_bytes(D);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bq = min(max(1, kRows / G), Sq);
  const int n_qt = (Sq + bq - 1) / bq;
  const dim3 grid(static_cast<unsigned>(n_qt), KV, B);
  flash_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      map_k, map_v, static_cast<const __nv_bfloat16*>(q), q_pos, kv_pos, kv_valid,
      static_cast<__nv_bfloat16*>(out), Sq, Tk, KV, G, bq, n_qt, causal, scale, tiles_visited);
  return static_cast<int>(cudaGetLastError());
}

static_assert(tc_smem_bytes(128) <= kMaxSmem, "the tensor-core block fits");

}  // namespace

extern "C" {

// The SIMT kernel on `stream`: q (B, Sq, KV, G, Dh), k (B, T, KV, Dh), v (B,
// T, KV, Dv), out (B, Sq, KV, G, Dv), all contiguous, f32 (bf16 = 0) or bf16
// (bf16 = 1); q_pos (Sq,) and kv_pos (T,) int32; kv_valid (T,) bytes or
// null.  Any Dh >= 1 and Dv >= 1, 1 <= G <= 64.  tiles_visited, if not
// null, gains the number of key tiles the blocks visited.  Returns a CUDA
// error code (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v, const int* q_pos,
                           const int* kv_pos, const unsigned char* kv_valid, void* out,
                           int B, int Sq, int T, int KV, int G, int Dh, int Dv, int bf16,
                           int causal, float scale, unsigned long long* tiles_visited,
                           void* stream) {
  if (B < 1 || Sq < 1 || T < 1 || KV < 1 || G < 1 || G > kRows || B > 65535 ||
      KV > 65535 || Dh < 1 || Dv < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_simt_dims<__nv_bfloat16>(q, k, v, q_pos, kv_pos, kv_valid, out, B, Sq, T,
                                           KV, G, Dh, Dv, causal, scale, tiles_visited, s);
  }
  return launch_simt_dims<float>(q, k, v, q_pos, kv_pos, kv_valid, out, B, Sq, T, KV, G, Dh,
                                 Dv, causal, scale, tiles_visited, s);
}

// The tensor-core kernel on `stream`: as above with bf16 q, k, v and out,
// Dh = Dv = D in {64, 128}, q, k and v 16-byte aligned.  Returns a CUDA
// error code (0 = launched; cudaErrorNotSupported when cuTensorMapEncodeTiled
// is not found).
int flash_attention_tc_launch(const void* q, const void* k, const void* v, const int* q_pos,
                              const int* kv_pos, const unsigned char* kv_valid, void* out,
                              int B, int Sq, int T, int KV, int G, int D, int causal,
                              float scale, unsigned long long* tiles_visited, void* stream) {
  if (B < 1 || Sq < 1 || T < 1 || KV < 1 || G < 1 || G > kRows || B > 65535 ||
      KV > 65535 || (D != 64 && D != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return launch_tc<64>(q, k, v, q_pos, kv_pos, kv_valid, out, B, Sq, T, KV, G, causal,
                         scale, tiles_visited, s);
  }
  return launch_tc<128>(q, k, v, q_pos, kv_pos, kv_valid, out, B, Sq, T, KV, G, causal, scale,
                        tiles_visited, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
