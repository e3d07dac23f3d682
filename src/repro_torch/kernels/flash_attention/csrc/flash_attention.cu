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
// Three kernels.  The wrapper (ops.py, kernel_path) picks one by shape,
// never as a fallback.  The first two give a block 64 (query, head) rows of
// one KV head and one batch row: bq = 64 / G queries of all G heads, so each
// K/V tile is read once per KV head.  The third, for decode, gives a block
// every row of a KV head and a range of its keys:
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
// * flash_decode_kernel, split-KV decoding: f32 or bf16 with Dh = Dv in
//   {64, 128}, taken when Sq·G <= 16 (a decode step of up to 16 query heads
//   a KV head, or a few queries of fewer).  The grid is (splits, KV, B):
//   the keys' 32-key tiles are cut into `splits` contiguous ranges, one a
//   block, the number chosen by the wrapper from T and the card's SM count
//   (ops.split_count: at least two blocks an SM).  A block has up to four
//   warps, one a row up to four rows (a warp holds up to four rows) times
//   tile slots; warps take keys.  The split's tiles are copied in order by
//   TMA, n_slot a stage, into a ring of two stages, each behind an mbarrier
//   and issued by one thread: K and V (4-D maps, 128 bytes of a row x 32
//   keys a box, 128-byte swizzled, zero past T), the keys' positions and
//   flags (1-D maps), and with the first stage q (bulk copies); the next
//   stage is in flight while one is read.  For a row a warp forms 32
//   scores, one a lane, each one FMA chain over d in ascending order (f32,
//   q read from shared memory by all lanes at once), then the scale; the
//   tile's maximum and sum by shuffles; p in f32 in its lane; then acc[c]
//   += p·v with lane = columns, the 32 keys in order, p shuffled from its
//   lane.  The slots' (m, l, acc) fold in ascending order; with several
//   splits each block writes its (m, l, acc) in f32 to a workspace and the
//   last block of each (b, KV head) to finish (a counter that it resets to
//   0) folds them in ascending split order, as the slots: (m, l, acc) and a
//   part (m', l', acc') give M = max(m, m'), l·e^(m - M) + l'·e^(m' - M) and
//   the same for acc; out = acc / max(l, 1e-30), rounded once.  No float
//   atomics: two runs give the same bits.  A split whose keys are all
//   masked for a row has m' = -1e30, so e^(m' - M) = 0 where another split
//   saw a key, and a row with no visible key anywhere sums p = 1 over all T
//   keys: the mean of v.  The wrapper sends a kv_pos or kv_valid off a
//   16-byte boundary (which TMA cannot copy) to the SIMT kernel.  On the
//   host a launch reuses the tensor maps of an earlier launch on the same
//   tensors (cached_map) and sets the kernel's shared-memory limit once a
//   device.
// * flash_simt_kernel, every other case (f32 prefill, other head
//   dimensions, decode past 16 rows): 256 threads; K and V tiles of 32 keys are converted to f32 in
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
// The causal skip, in all three kernels: a block skips key tile j when no
// key in it is visible to any of its rows and every row has already met a
// visible key in an earlier tile (for the decode kernel: an earlier tile of
// its own split, so the rule runs on each split's keys alone).  After a
// row's first visible key, a fully masked tile adds p = exp(-1e30 - m) = 0
// with alpha = 1, so skipping it changes no bit (for finite inputs; a NaN
// or inf in a skipped v row is not read).  A row with no visible key at all
// keeps every tile, and comes out as the mean of v.  Positions need not
// ascend (ring buffers wrap): the prefill kernels read the keys' positions
// and flags, 32 tiles at a time (window_bits), before they load a tile.
// The decode kernel decides a tile's visit from the positions and flags
// copied with it, so it copies every tile of its split and reads only the
// visited ones: at decode the rule drops only tiles of empty or masked
// slots, and deciding before the copies cost a round trip to the positions
// first.  On causal prefill with ascending positions the rule keeps tiles
// 0 .. (q0 + bq + bk - 1) / bk - 1, flash_call's own loop range.
// ref.visited_tiles is the rule's plain version.
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
// by bytes, 0.0102 ms.  On the SIMT kernel a block had Sq·G = 2 of its 64
// rows, all in row group 0 (16 of 256 threads at work), over 32 blocks for
// 132 SMs, one tile at a time: 0.57 ms.  The decode kernel puts 9 splits x
// 32 blocks on the card, every lane on a key or on columns, a stage of
// copies always in flight (the ring: 2 x 2 tiles, 66 KB at Dh = 128 bf16,
// about 70 KB a block in all, three blocks an SM), and the combine costs
// the last block of each (b, h) a read of 9 x 2 x 130 floats.
#include <cuda.h>   // CUtensorMap and its enums; the encode is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
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

// What a tensor map encodes: its base, extents, element kind (0 bf16, 1
// f32, 2 int32, 3 bytes) and keys a box.  The map is a function of these
// alone, so equal keys may share one map.
struct MapKey {
  const void* x;
  int B, Tk, KV, D, kind, keys;
  bool operator==(const MapKey& o) const {
    return x == o.x && B == o.B && Tk == o.Tk && KV == o.KV && D == o.D && kind == o.kind &&
           keys == o.keys;
  }
};

struct MapSlot {
  CUtensorMap map;
  MapKey key;
  bool used;
};

// The maps this thread encoded last, in sets of four by the hash of their
// key (the oldest of a set gives way): a launch on the tensors of an earlier
// one (a model's caches, layer by layer, step after step) reuses its maps
// instead of encoding them anew.  Per thread, so without a lock (ctypes
// calls run outside Python's lock).
constexpr int kMapSets = 256, kMapWays = 4;
thread_local MapSlot map_cache[kMapSets][kMapWays];
thread_local unsigned char map_next[kMapSets];

// *map for `key`, from the cache or else from `encode(&slot.map)`.
template <typename Encode>
bool cached_map(CUtensorMap* map, const MapKey& key, Encode encode) {
  uint64_t h = reinterpret_cast<uintptr_t>(key.x) >> 4;
  const int fields[6] = {key.B, key.Tk, key.KV, key.D, key.kind, key.keys};
  for (const int f : fields) {
    h = (h ^ static_cast<uint32_t>(f)) * 0x100000001b3ull;
  }
  h = (h ^ (h >> 33)) * 0xff51afd7ed558ccdull;   // (MurmurHash3's finish)
  const int set = static_cast<int>((h ^ (h >> 33)) % kMapSets);
  for (MapSlot& slot : map_cache[set]) {
    if (slot.used && slot.key == key) {
      *map = slot.map;
      return true;
    }
  }
  MapSlot& slot = map_cache[set][map_next[set]];
  slot.used = false;
  if (!encode(&slot.map)) return false;
  slot.key = key;
  slot.used = true;
  map_next[set] = static_cast<unsigned char>((map_next[set] + 1) % kMapWays);
  *map = slot.map;
  return true;
}

// The 4-D map of k or v (B, T, KV, D), bf16 or f32: boxes of 128 bytes of
// columns x `keys` keys of one KV head and batch row, 128-byte swizzled,
// zero past T.
bool key_map(CUtensorMap* map, const void* x, int B, int Tk, int KV, int D, int bf16, int keys) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  return cached_map(map, MapKey{x, B, Tk, KV, D, bf16 ? 0 : 1, keys}, [&](CUtensorMap* m) {
    const cuuint64_t esz = bf16 ? 2 : 4;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(KV),
                                static_cast<cuuint64_t>(Tk), static_cast<cuuint64_t>(B)};
    const cuuint64_t row = static_cast<cuuint64_t>(D) * esz;
    const cuuint64_t strides[3] = {row, row * KV, row * KV * Tk};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / esz), 1,
                               static_cast<cuuint32_t>(keys), 1};
    const cuuint32_t step[4] = {1, 1, 1, 1};
    return encode(m, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  4, const_cast<void*>(x), dims, strides, box, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  });
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const int* q_pos, const int* kv_pos,
              const unsigned char* kv_valid, void* out, int B, int Sq, int Tk, int KV, int G,
              int causal, float scale, unsigned long long* tiles_visited, cudaStream_t stream) {
  CUtensorMap map_k, map_v;
  if (!key_map(&map_k, k, B, Tk, KV, D, 1, kTcBK) ||
      !key_map(&map_v, v, B, Tk, KV, D, 1, kTcBK)) {
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

// ------------------------------------------------------------- decode kernel

constexpr int kDecBK = 32;                // keys per tile: one a lane
constexpr int kDecMaxRows = 16;           // (query, head) rows the decode kernel takes
constexpr int kDecWarps = 4;              // warps a block has at most
constexpr int kDecStageBytes = 36864;     // K and V bytes a stage holds at most (2 stages)

// One key tile in shared memory as TMA's 128-byte swizzle leaves it: K then
// V, each in atoms of 128 bytes of every key's row (64 bf16 or 32 f32
// columns) x 32 keys, 16-byte group g of key r's row at g ^ (r % 8).  A lane
// reading its own key's row and the lanes of a warp reading one row
// together both hit 32 distinct banks.
template <typename T, int D>
struct DecTile {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kAtoms = kRowBytes / 128;
  static constexpr int kHalf = kDecBK * kRowBytes;     // K (or V) of a tile
  static constexpr int kBytes = 2 * kHalf;
  static constexpr int kCols = D / 32;                 // v columns a lane
  static_assert(kRowBytes % 128 == 0 && kHalf % 1024 == 0, "whole swizzle atoms");
};

// The byte at `off` of key r's row in a tile half at `base`.
__device__ __forceinline__ const unsigned char* swizzled(const unsigned char* base, int r,
                                                         int off) {
  return base + (off >> 7) * (kDecBK * 128) + r * 128 + ((off & 127) ^ ((r & 7) << 4));
}

// bf16 bits to f32, exactly: element 0 is the low half of a word.
__device__ __forceinline__ void bf16_pair(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// Elements 8c .. 8c + 7 of key r's row, as f32.
__device__ __forceinline__ void load8(const unsigned char* base, int r, int c,
                                      const __nv_bfloat16*, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(swizzled(base, r, 16 * c));
  bf16_pair(u.x, x[0], x[1]);
  bf16_pair(u.y, x[2], x[3]);
  bf16_pair(u.z, x[4], x[5]);
  bf16_pair(u.w, x[6], x[7]);
}
__device__ __forceinline__ void load8(const unsigned char* base, int r, int c, const float*,
                                      float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(swizzled(base, r, 32 * c));
  const float4 b = *reinterpret_cast<const float4*>(swizzled(base, r, 32 * c + 16));
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

// N (2 or 4) elements of key r's row from element e on, as f32.
template <int N>
__device__ __forceinline__ void load_cols(const unsigned char* base, int r, int e,
                                          const __nv_bfloat16*, float (&x)[N]) {
  const unsigned char* p = swizzled(base, r, 2 * e);
  if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    bf16_pair(u.x, x[0], x[1]);
    bf16_pair(u.y, x[2], x[3]);
  } else {
    bf16_pair(*reinterpret_cast<const uint32_t*>(p), x[0], x[1]);
  }
}
template <int N>
__device__ __forceinline__ void load_cols(const unsigned char* base, int r, int e, const float*,
                                          float (&x)[N]) {
  const unsigned char* p = swizzled(base, r, 4 * e);
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x, x[1] = a.y;
  }
}

// Over the 32 lanes, by an xor butterfly: every lane ends with the same bits
// (each step adds two equal pairs in either order).
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 1-D copies: `bytes` (a multiple of 16) from global to shared memory, and
// a box of 32 elements of a 1-D tensor map (zero past its end), each
// reported to `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// Eight consecutive elements of a row of q in shared memory (row-major, as
// in global memory), as f32.
__device__ __forceinline__ void load8_row(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  bf16_pair(u.x, x[0], x[1]);
  bf16_pair(u.y, x[2], x[3]);
  bf16_pair(u.z, x[4], x[5]);
  bf16_pair(u.w, x[6], x[7]);
}
__device__ __forceinline__ void load8_row(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

// One step of the online combine, in f32: the running (m, l, acc) and a
// part (mp, lp, ap) become (max, l·e^(m - max) + lp·e^(mp - max), the same
// for acc).  A part whose keys were all masked (mp = -1e30) beside a seen
// key weighs e^(-1e30 - m) = 0.
struct Fold {
  float m = kNegInf, l = 0.0f;
  __device__ void add(float mp, float lp, float& acc, float ap) {
    const float mx = fmaxf(m, mp);
    const float a = expf(m - mx), b = expf(mp - mx);
    l = fmaf(lp, b, l * a);
    acc = fmaf(ap, b, acc * a);
    m = mx;
  }
};

// A stage's key positions and flags, per slot (the flags' 32 bytes padded
// to 128, where TMA writes).
struct DecMeta {
  int pos[kDecBK];
  unsigned char valid[128];
};

// Split-KV decoding: block (split, KV head h, batch row b) takes the key
// tiles [n_tiles·split / n_split, n_tiles·(split + 1) / n_split) and every
// one of the rows = Sq·G (<= 16) (query, head) rows of head h, row r being
// query r / G, head r % G.  Its warps are n_rw row warps times n_slot tile
// slots: warp (slot, w) takes rows w, w + n_rw, ... (NR of them, the last
// repeated where rows run out) on the key tile of its slot.  The split's
// tiles are copied in order, n_slot a stage, into a ring of two stages by
// TMA, one thread issuing each stage's copies behind its mbarrier: K and V
// (128-byte swizzled), the keys' positions and flags, and with the first
// stage q.  Each tile's visit is decided from the stage's own positions, in
// order (the skip rule of window_bits on the split's keys alone): a tile
// is visited when a key in it is visible to the highest query position, or
// when no earlier tile of the split held a key visible to the lowest; a
// tile that is not visited was copied but is not read.  For each of its
// rows a warp forms 32 scores, one a lane (lane = key), each one FMA chain
// over d in ascending order from K and q in shared memory (q read by all
// lanes at once), then scaled; it takes the tile's maximum and sum by
// shuffles (the online softmax, p in f32); then p·v with lane = columns:
// acc[c] += p_key · v[key][c] over the 32 keys in order, p_key shuffled
// from its lane.  The slots' (m, l, acc) fold in ascending order (Fold);
// with one split the block writes the output, else it writes its (m, l,
// acc) to the workspace, and the last block of (b, h) to finish (a counter
// per (b, h), which it resets to 0) folds the splits in ascending order,
// as many at a time as its shared memory holds, each batch loaded at once.
template <typename T, int D, int NR>
__global__ void __launch_bounds__(kDecWarps * 32)
flash_decode_kernel(const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_pos,
                    const __grid_constant__ CUtensorMap map_valid, const T* __restrict__ q,
                    const int* __restrict__ q_pos, int has_valid, T* __restrict__ out,
                    float* __restrict__ work, unsigned* __restrict__ counters, int Sq, int Tk,
                    int KV, int G, int n_rw, int n_slot, int causal, float scale,
                    unsigned long long* tiles_visited) {
  using Tile = DecTile<T, D>;
  constexpr int kCols = Tile::kCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = Sq * G;
  const int ring_bytes = 2 * n_slot * Tile::kBytes;
  // Tiles start on 1024 bytes of the shared window: the swizzle repeats there.
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  DecMeta* meta = reinterpret_cast<DecMeta*>(ring + ring_bytes);   // [stage][slot]
  T* qs = reinterpret_cast<T*>(meta + 2 * n_slot);                 // rows x D, as in q
  float* fold = reinterpret_cast<float*>(qs + rows * D);           // rows x D; rows x (m, l)
  uint64_t* bar = reinterpret_cast<uint64_t*>(fold + rows * (D + 2));   // a stage's copies
  int* last = reinterpret_cast<int*>(bar + 2);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_split = static_cast<int>(gridDim.x), split = static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * KV + h;
  const int n_tiles = (Tk + kDecBK - 1) / kDecBK;
  const int j_begin = static_cast<int>(static_cast<long long>(split) * n_tiles / n_split);
  const int nt = static_cast<int>(static_cast<long long>(split + 1) * n_tiles / n_split) - j_begin;
  const int t_begin = j_begin * kDecBK;
  auto row_at = [&](int r) {              // where row r of (b, h) starts in q and out
    return ((static_cast<size_t>(b) * Sq + r / G) * KV + h) * G * D +
           static_cast<size_t>(r % G) * D;
  };

  // Stage st takes the split's tiles j0 .. j0 + n_slot - 1 (those that
  // exist), by TMA from thread 0, with q if `with_q`.
  auto fill = [&](int st, int j0, bool with_q) {
    if (tid != 0) return;
    const int n = min(n_slot, nt - j0);
    const unsigned q_row = static_cast<unsigned>(G * D * sizeof(T));
    mbar_expect_tx(&bar[st], n * (Tile::kBytes + kDecBK * 4 + (has_valid ? kDecBK : 0)) +
                                 (with_q ? Sq * q_row : 0));
    if (with_q) {
      for (int i = 0; i < Sq; ++i) bulk_load(qs + i * G * D, q + row_at(i * G), q_row, &bar[st]);
    }
    for (int s = 0; s < n; ++s) {
      unsigned char* kd = ring + (st * n_slot + s) * Tile::kBytes;
      const int key0 = t_begin + (j0 + s) * kDecBK;
#pragma unroll
      for (int a = 0; a < Tile::kAtoms; ++a) {
        const int col = a * 128 / static_cast<int>(sizeof(T));
        tma_load(kd + a * kDecBK * 128, &map_k, &bar[st], col, h, key0, b);
        tma_load(kd + Tile::kHalf + a * kDecBK * 128, &map_v, &bar[st], col, h, key0, b);
      }
      tma_load_1d(meta[st * n_slot + s].pos, &map_pos, &bar[st], key0);
      if (has_valid) tma_load_1d(meta[st * n_slot + s].valid, &map_valid, &bar[st], key0);
    }
  };
  if (tid < 4) {                          // the four maps, fetched side by side
    const CUtensorMap* maps[4] = {&map_k, &map_v, &map_pos, &map_valid};
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(maps[tid]))
                 : "memory");
  }
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (nt > 0) fill(0, 0, true);
    if (nt > n_slot) fill(1, n_slot, false);
  }
  __syncthreads();                        // the mbarriers are initialised
  // The queries' positions: loaded now, first used after the first stage.
  const int slot = warp / n_rw, wr = warp % n_rw;
  int row[NR], qp[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    row[i] = min(wr + i * n_rw, rows - 1);
    qp[i] = q_pos[row[i] / G];
  }
  const int qp_lane = q_pos[min(lane, Sq - 1)];

  float m[NR], l[NR], acc[NR][kCols];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }
  int qmin = 0, qmax = 0;
  bool met = false;                       // an earlier tile held a key visible to qmin
  unsigned long long visited = 0;
  for (int it = 0; it * n_slot < nt; ++it) {
    const int st = it & 1;
    mbar_wait(&bar[st], static_cast<unsigned>((it >> 1) & 1));
    if (it == 0) {
      qmin = __reduce_min_sync(0xffffffffu, qp_lane);
      qmax = __reduce_max_sync(0xffffffffu, qp_lane);
    }
    // The stage's visits, in order, the same in every thread.
    bool mine = false;
#pragma unroll
    for (int s = 0; s < kDecWarps; ++s) {
      const int j = it * n_slot + s;
      if (s < n_slot && j < nt) {
        const DecMeta& mt = meta[st * n_slot + s];
        const bool ok = t_begin + j * kDecBK + lane < Tk && (!has_valid || mt.valid[lane] != 0);
        const int p = mt.pos[lane];
        const bool seen = __ballot_sync(0xffffffffu, ok && (!causal || p <= qmax)) != 0;
        const bool to_all = __ballot_sync(0xffffffffu, ok && (!causal || p <= qmin)) != 0;
        const bool visit = seen || !met;
        met = met || to_all;
        visited += visit;
        mine = s == slot ? visit : mine;
      }
    }
    if (mine) {
      const int j = it * n_slot + slot;
      const unsigned char* kd = ring + (st * n_slot + slot) * Tile::kBytes;
      const unsigned char* vd = kd + Tile::kHalf;
      const DecMeta& mt = meta[st * n_slot + slot];
      const bool in = t_begin + j * kDecBK + lane < Tk;
      const bool ok = in && (!has_valid || mt.valid[lane] != 0);
      const int kp = mt.pos[lane];

      // scores: lane = key, one FMA chain a row in ascending d
      float s[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) s[i] = 0.0f;
#pragma unroll
      for (int c8 = 0; c8 < D / 8; ++c8) {
        float kf[8];
        load8(kd, lane, c8, static_cast<const T*>(nullptr), kf);
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          float qf[8];
          load8_row(qs + row[i] * D + 8 * c8, qf);
#pragma unroll
          for (int e = 0; e < 8; ++e) s[i] = fmaf(qf[e], kf[e], s[i]);
        }
      }
      // scale, mask and the online softmax; p stays in its lane, in f32
      float p[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const bool visible = ok && (!causal || kp <= qp[i]);
        const float x = visible ? __fmul_rn(s[i], scale) : kNegInf;
        const float m_new = fmaxf(m[i], warp_max(in ? x : kNegInf));
        const float alpha = expf(m[i] - m_new);
        p[i] = in ? expf(x - m_new) : 0.0f;
        l[i] = l[i] * alpha + warp_sum(p[i]);
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
      }
      // acc += p·v: lane = columns, the keys in order (V is zero past T)
#pragma unroll 8
      for (int kk = 0; kk < kDecBK; ++kk) {
        float vf[kCols];
        load_cols<kCols>(vd, kk, lane * kCols, static_cast<const T*>(nullptr), vf);
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const float pk = __shfl_sync(0xffffffffu, p[i], kk);
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pk, vf[c], acc[i][c]);
        }
      }
    }
    __syncthreads();                      // stage st is read: refill it
    if ((it + 2) * n_slot < nt) fill(st, (it + 2) * n_slot, false);
  }
  if (tiles_visited != nullptr && tid == 0) atomicAdd(tiles_visited, visited);

  // The slots' (m, l, acc) through shared memory, folded in ascending slot
  // order: output (r, d) by thread e = r·D + d (mod the block).
  float* ml = reinterpret_cast<float*>(ring);            // [slot][row] (m, l)
  float* as = ml + 2 * n_slot * rows;                   // [slot][row][D]
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    if (wr + i * n_rw < rows) {
      const int at = slot * rows + row[i];
      if (lane == 0) {
        ml[2 * at] = m[i];
        ml[2 * at + 1] = l[i];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) as[at * D + lane * kCols + c] = acc[i][c];
    }
  }
  __syncthreads();
  const size_t part = static_cast<size_t>(bh) * n_split;       // this (b, h)'s first split
  const size_t n_parts = static_cast<size_t>(gridDim.y) * gridDim.z * n_split;
  float* wacc = work;                                           // [bh][split][row][D]
  float* wml = work == nullptr ? nullptr : work + n_parts * rows * D;   // [bh][split][row] (m, l)
  for (int e = tid; e < rows * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    Fold f;
    float A = 0.0f;
    for (int s = 0; s < n_slot; ++s) {
      f.add(ml[2 * (s * rows + r)], ml[2 * (s * rows + r) + 1], A, as[(s * rows + r) * D + d]);
    }
    if (n_split == 1) {
      store(out + row_at(r) + d, A / fmaxf(f.l, 1e-30f));
    } else {
      const size_t pr = (part + split) * rows + r;
      wacc[pr * D + d] = A;
      if (d == 0) {
        wml[2 * pr] = f.m;
        wml[2 * pr + 1] = f.l;
      }
    }
  }
  if (n_split == 1) return;

  // The last block of (b, h) to finish folds the splits in ascending order,
  // `batch` at a time, each batch's (m, l) and acc loaded at once into
  // shared memory: first each row's fold of (m, l), which keeps its weights
  // e^(m - M) and e^(m' - M) for each split (wt), then each output's fold
  // of acc with them (the arithmetic of Fold, in two passes).  A row's
  // running (m, l) stays in rs, an output's acc in fold.
  __syncthreads();                        // the block's partials are written
  if (tid == 0) {
    // acq_rel: the block's partials before its count; the others' after it
    unsigned before;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(before) : "l"(counters + bh) : "memory");
    *last = before == static_cast<unsigned>(n_split - 1);
  }
  __syncthreads();
  if (*last == 0) return;
  const int batch = max(1, ring_bytes / (static_cast<int>(sizeof(float)) * rows * (D + 4)));
  float* bacc = reinterpret_cast<float*>(ring);         // [split][row][D]
  float* bml = bacc + batch * rows * D;                 // [split][row] (m, l)
  float* wt = bml + 2 * batch * rows;                   // [row][split] (a, b)
  float* rs = fold + rows * D;                          // [row] (m, l)
  for (int e = tid; e < rows * D; e += blockDim.x) fold[e] = 0.0f;
  for (int r = tid; r < rows; r += blockDim.x) {
    rs[2 * r] = kNegInf;
    rs[2 * r + 1] = 0.0f;
  }
  for (int s0 = 0; s0 < n_split; s0 += batch) {
    const int nb = min(batch, n_split - s0);
    const float4* src = reinterpret_cast<const float4*>(wacc + (part + s0) * rows * D);
    const float2* src_ml = reinterpret_cast<const float2*>(wml) + (part + s0) * rows;
    const int n4 = nb * rows * D / 4, step = static_cast<int>(blockDim.x);
    for (int e0 = tid; e0 < n4 + nb * rows; e0 += 8 * step) {   // 8 loads in flight a thread
      float4 x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * step;
        if (e < n4) {
          x[u] = __ldcg(src + e);
        } else if (e < n4 + nb * rows) {
          const float2 y = __ldcg(src_ml + e - n4);
          x[u] = make_float4(y.x, y.y, 0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * step;
        if (e < n4) {
          reinterpret_cast<float4*>(bacc)[e] = x[u];
        } else if (e < n4 + nb * rows) {
          reinterpret_cast<float2*>(bml)[e - n4] = make_float2(x[u].x, x[u].y);
        }
      }
    }
    __syncthreads();
    for (int r = tid; r < rows; r += blockDim.x) {
      float m0 = rs[2 * r], l0 = rs[2 * r + 1];
      for (int s = 0; s < nb; ++s) {
        const float mp = bml[2 * (s * rows + r)], mx = fmaxf(m0, mp);
        const float a = expf(m0 - mx), b = expf(mp - mx);
        l0 = fmaf(bml[2 * (s * rows + r) + 1], b, l0 * a);
        m0 = mx;
        wt[2 * (r * batch + s)] = a;
        wt[2 * (r * batch + s) + 1] = b;
      }
      rs[2 * r] = m0;
      rs[2 * r + 1] = l0;
    }
    __syncthreads();
    for (int e = tid; e < rows * D; e += blockDim.x) {
      const int r = e / D, d = e % D;
      float A = fold[e];
      for (int s = 0; s < nb; ++s) {
        A = fmaf(bacc[(s * rows + r) * D + d], wt[2 * (r * batch + s) + 1],
                 A * wt[2 * (r * batch + s)]);
      }
      fold[e] = A;
      if (s0 + nb == n_split) store(out + row_at(r) + d, A / fmaxf(rs[2 * r + 1], 1e-30f));
    }
    __syncthreads();
  }
  if (tid == 0) counters[bh] = 0;         // ready for the next launch
}

// The block's shape: row warps (one a row, up to 4), rows a warp, tile
// slots (so that a block has up to 4 warps and a stage up to
// kDecStageBytes), threads, and the shared memory: alignment, the ring, its
// positions and flags, q, the fold's scratch, the mbarriers and a flag.
template <typename T, int D>
void decode_shape(int rows, int& n_rw, int& nr, int& n_slot, int& threads, size_t& smem) {
  n_rw = min(rows, kDecWarps);
  nr = (rows + n_rw - 1) / n_rw;
  n_slot = max(1, min(kDecWarps / n_rw, kDecStageBytes / DecTile<T, D>::kBytes));
  threads = 32 * n_rw * n_slot;
  smem = 1024 + static_cast<size_t>(2) * n_slot * (DecTile<T, D>::kBytes + sizeof(DecMeta)) +
         sizeof(T) * rows * D + sizeof(float) * rows * (D + 2) + 2 * sizeof(uint64_t) +
         sizeof(int);
}

// The 1-D map of the positions (int32) or the flags (bytes) of T keys:
// boxes of 32, zero past T.
bool pos_map(CUtensorMap* map, const void* x, int Tk, bool bytes) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  return cached_map(map, MapKey{x, 0, Tk, 0, 0, bytes ? 3 : 2, kDecBK}, [&](CUtensorMap* m) {
    const cuuint64_t dims[1] = {static_cast<cuuint64_t>(Tk)};
    const cuuint64_t strides[1] = {0};    // (a rank-1 map has none)
    const cuuint32_t box[1] = {static_cast<cuuint32_t>(kDecBK)};
    const cuuint32_t step[1] = {1};
    return encode(m, bytes ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_INT32, 1,
                  const_cast<void*>(x), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  });
}

struct DecMaps {
  CUtensorMap k, v, pos, valid;
};

template <typename T, int D, int NR>
int launch_decode_nr(const DecMaps& maps, const void* q, const int* q_pos, int has_valid,
                     void* out, float* work, unsigned* counters, int B, int Sq, int Tk, int KV,
                     int G, int causal, float scale, int n_split,
                     unsigned long long* tiles_visited, cudaStream_t stream, int n_rw,
                     int n_slot, int threads, size_t smem) {
  // The shared memory any row count needs, allowed once a device (one bit
  // a device; a second thread setting the same value is harmless).
  static std::atomic<uint64_t> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if ((allowed.load(std::memory_order_relaxed) & bit) == 0) {
    size_t most = 0;
    for (int rows = 1; rows <= kDecMaxRows; ++rows) {
      int a, b, c, d;
      size_t bytes;
      decode_shape<T, D>(rows, a, b, c, d, bytes);
      if (bytes > most) most = bytes;
    }
    err = cudaFuncSetAttribute(flash_decode_kernel<T, D, NR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(most));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed.fetch_or(bit, std::memory_order_relaxed);
  }
  const dim3 grid(static_cast<unsigned>(n_split), KV, B);
  flash_decode_kernel<T, D, NR><<<grid, threads, smem, stream>>>(
      maps.k, maps.v, maps.pos, maps.valid, static_cast<const T*>(q), q_pos, has_valid,
      static_cast<T*>(out), work, counters, Sq, Tk, KV, G, n_rw, n_slot, causal, scale,
      tiles_visited);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_decode(const void* q, const void* k, const void* v, const int* q_pos,
                  const int* kv_pos, const unsigned char* kv_valid, void* out, float* work,
                  unsigned* counters, int B, int Sq, int Tk, int KV, int G, int causal,
                  float scale, int n_split, unsigned long long* tiles_visited,
                  cudaStream_t stream) {
  constexpr int bf16 = sizeof(T) == 2;
  DecMaps maps;
  if (!key_map(&maps.k, k, B, Tk, KV, D, bf16, kDecBK) ||
      !key_map(&maps.v, v, B, Tk, KV, D, bf16, kDecBK) || !pos_map(&maps.pos, kv_pos, Tk, false) ||
      (kv_valid != nullptr && !pos_map(&maps.valid, kv_valid, Tk, true))) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  if (kv_valid == nullptr) maps.valid = maps.pos;   // (never read)
  int n_rw, nr, n_slot, threads;
  size_t smem;
  decode_shape<T, D>(Sq * G, n_rw, nr, n_slot, threads, smem);
  // rows a warp: 1 up to 4 rows, 2 up to 8, else 4 (the last rows repeated)
  auto go = [&](auto launch) {
    return launch(maps, q, q_pos, kv_valid != nullptr, out, work, counters, B, Sq, Tk, KV, G,
                  causal, scale, n_split, tiles_visited, stream, n_rw, n_slot, threads, smem);
  };
  if (nr == 1) return go(launch_decode_nr<T, D, 1>);
  if (nr == 2) return go(launch_decode_nr<T, D, 2>);
  return go(launch_decode_nr<T, D, 4>);
}

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

// The split-KV decode kernel on `stream`: as the SIMT kernel with Dh = Dv =
// D in {64, 128}, Sq·G <= 16, k and v 16-byte aligned, and the keys cut
// into `splits` (>= 1) ranges of whole 32-key tiles.  With splits > 1,
// `work` holds B·KV·splits·Sq·G·(D + 2) floats (written before read) and
// `counters` B·KV unsigned zeros, which the launch leaves at zero.
// Returns a CUDA error code (0 = launched).
int flash_attention_decode_launch(const void* q, const void* k, const void* v,
                                  const int* q_pos, const int* kv_pos,
                                  const unsigned char* kv_valid, void* out, int B, int Sq,
                                  int T, int KV, int G, int D, int bf16, int causal, float scale,
                                  int splits, float* work, unsigned* counters,
                                  unsigned long long* tiles_visited, void* stream) {
  if (B < 1 || Sq < 1 || T < 1 || KV < 1 || G < 1 || Sq * G > kDecMaxRows || B > 65535 ||
      KV > 65535 || (D != 64 && D != 128) || splits < 1 ||
      (splits > 1 && (work == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(kv_pos) |
       reinterpret_cast<uintptr_t>(kv_valid)) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return D == 64 ? launch_decode<__nv_bfloat16, 64>(q, k, v, q_pos, kv_pos, kv_valid, out,
                                                      work, counters, B, Sq, T, KV, G, causal,
                                                      scale, splits, tiles_visited, s)
                   : launch_decode<__nv_bfloat16, 128>(q, k, v, q_pos, kv_pos, kv_valid, out,
                                                       work, counters, B, Sq, T, KV, G, causal,
                                                       scale, splits, tiles_visited, s);
  }
  return D == 64 ? launch_decode<float, 64>(q, k, v, q_pos, kv_pos, kv_valid, out, work,
                                            counters, B, Sq, T, KV, G, causal, scale, splits,
                                            tiles_visited, s)
                 : launch_decode<float, 128>(q, k, v, q_pos, kv_pos, kv_valid, out, work,
                                             counters, B, Sq, T, KV, G, causal, scale, splits,
                                             tiles_visited, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
