// Flooding peeling decode of B erasure patterns of a SEEDED code, in one
// launch: the fixed-D and the early-exit (adaptive) contracts, with no
// parity-check operand at all.  Each check row's (column, weight) pairs are
// regenerated from (seed, row) when the row acts.
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
// A round: every check row with exactly one erased neighbour proposes a
// value for it; the lowest such row of a coordinate wins ("lo"); a winning
// row sorts its r pairs by column in registers and sums its known
// neighbours in ascending column order with one rounded multiply and one
// rounded add per term, then one rounded divide, as seeded_check_rows sorts
// the table (src/repro/core/ldpc.py:551-559).  So on a make_seeded_ldpc code
// this kernel equals peel_decode.cu over the same code's table bit for bit,
// under the same stopping rules (fixed D; early exit under per-slot
// budgets, the no-progress probe round counted).
//
// What held the old design back (one block per pattern, 2.70 ms a launch
// at N = 32,768, 18.7 ms at N = 262,144 on an H100, PERF.md): every round
// regenerated all p·r edges twice, each by a 64-bit modulo, to count the
// erased neighbours of every row, though only the rows with one erased
// neighbour act; and past N ~ 46,000 its 5 bytes a coordinate of flags and
// bids went to device memory.  The design now:
//
// 1. Per-check erased counts, built once per launch (each row counts its
//    erased columns) and kept on chip, one byte a row while r <= 255 (two
//    past it).
// 2. A round touches what changes.  Phase A: each row whose count is 1
//    steps through its columns to find its erased one, pos; it wins pos if
//    no row of pos in a lower layer has count 1 (those rows are pos's other
//    proposers, and lower layers hold lower rows), found through the
//    layers' inverse permutations (row_of); a winner writes its proposal
//    straight to values_out at pos (no row reads an erased coordinate in
//    the round, and a coordinate has one winner) and marks pos in a bitmap
//    of this round's resolved coordinates.  Phase B: each resolved
//    coordinate leaves the erased bitmap and decrements the counts of its
//    `layers` rows.  This is the trajectory of recounting every row every
//    round: every row with count 1 had its one erased neighbour resolved,
//    and no other count changes.  No scratch, no bid array.
// 3. No 64-bit modulo in a loop: a row's first column is one 32-bit
//    reduction and each next slot one add and one conditional subtract; the
//    inverse map is one 64-bit product and a Barrett reduction.
// 4. Use more of the card: a pattern is spread over a thread-block cluster
//    of C = 8, 4 or 2 blocks, the largest that fits: row weight <= 255, a
//    block's share in its shared memory, and every pattern's cluster
//    resident at once (B·ceil(V / 4)·C <= the card's SMs), the layout the
//    card ran fastest (PERF.md).  Each block holds the
//    erased bitmap whole, the counts of its 1/C of the rows, and two
//    resolved bitmaps used in turn a round.  Phase A: a block acts on its
//    own rows, reading other blocks' counts for the winner test through
//    distributed shared memory.  Phase B: every block ORs all the blocks'
//    resolved bitmaps into its erased bitmap and decrements its own rows'
//    counts.  Two cluster barriers a round; every block takes the same
//    early-exit decision from its own copy.  Where a cluster does not fit,
//    one block a pattern: its state (2 bits a coordinate and a byte a row:
//    at N = 262,144 of the (4, 8) code 32 + 32 + 128 KB, where the old 1.25
//    MB went to device memory) in shared memory while it fits (the (4, 8)
//    code up to N ~ 370,000), in a device-memory scratch of one state per
//    block past that, initialised at every launch.  This is the dispatch by
//    shape of ops.seeded_layout; a launch the card refuses raises.
//
// What each step did (CUDA events at Path B's shapes, one pattern: N =
// 32,768, V = 2, D = 8, f = 0.25; PERF.md): 2.70 ms before; 1-3 on one
// block, each lane acting on its own rows, 0.95 ms (the warps ran the
// whole acting body for every slot of a lane's 4 rows, with 7 dependent
// value loads in each); warps gathering their acting rows into lists, the
// values loaded before the sum, 0.45; an 8-wide network for r <= 8 and
// multiply-high reciprocals for the divisions, 0.23 on one block, then
// clusters: 0.15 on 2 blocks, 0.09 on 4, 0.08 on 8 (chip_smoke.py phase 10
// times every layout).
//
// Bound on an H100 SXM (3.35 TB/s).  No table is read: the decode must
// move the values in and out (8 B·N·V), the masks (2 B·N) and, adaptive,
// the budgets and rounds.  At N = 32,768, V = 2, B = 1 that is 0.59 MB,
// 0.18 us; at N = 262,144, V = 1, 2.6 MB, 0.78 us.  What holds it back
// now: each round is a chain of dependent steps inside a few SMs (the
// acting rows' hashing, sort and value loads, two barriers), D rounds in
// turn, and the set-up; it stays latency-bound, hundreds of times its
// byte bound.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "seeded_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kCols = 4;
// A warp's list of rows of count 1: fewer than 32 left over, plus 32 words
// of at most 4 rows each.
constexpr int kListCap = 32 + 32 * 4;
constexpr size_t kListBytes = kThreads / 32 * kListCap * sizeof(int);
constexpr int kMaxCluster = 8;             // the portable cluster size

__device__ __forceinline__ size_t at(int row, int col, int width) {
  return static_cast<size_t>(row) * static_cast<size_t>(width) + col;
}

// Words of a bitmap of n coordinates, padded to 16 bytes.
__host__ __device__ inline int bitmap_words(int n) { return ((n + 31) / 32 + 3) & ~3; }

// Rows per 32-bit word of counts.
template <int CB>
constexpr int kPerWord = 4 / CB;

// Rows a block of a cluster of C owns: a whole number of count words.
__host__ __device__ inline int rows_per_block(int rows, int C) {
  const int per = (rows + C - 1) / C;
  return (per + 3) & ~3;
}

// Per-block state: the erased bitmap, `nrb` resolved bitmaps, then one count
// of CB bytes for each of `own` rows, padded to 16 bytes.  One block per
// pattern: nrb = 1, own = rows; a block of a cluster: nrb = 2 (one a round,
// in turn), own = rows_per_block.
__host__ __device__ inline size_t state_bytes(int N, int own, int CB, int nrb) {
  return 4 * static_cast<size_t>(1 + nrb) * bitmap_words(N) +
         ((static_cast<size_t>(own) * CB + 15) & ~static_cast<size_t>(15));
}

__device__ __forceinline__ bool bit(const unsigned* bm, unsigned j) {
  return (bm[j >> 5] >> (j & 31)) & 1u;
}

// Count q of a word of counts.
template <int CB>
__device__ __forceinline__ int count_in(unsigned w, int q) {
  return (w >> (8 * CB * q)) & (CB == 1 ? 0xFFu : 0xFFFFu);
}

// Row i, of count 1: finds its erased column pos; if no row of pos in a
// lower layer has count 1 (count(o) reads row o's count), i is pos's lowest
// proposer and writes its proposal for the block's payload columns to
// values_out at pos (its known neighbours in ascending column order, one
// rounded multiply and add a term, one rounded divide) and marks pos in
// rb.  With a network of 16 or fewer slots a column's r values are loaded
// before its sum starts.
template <int W, typename Count>
__device__ __forceinline__ void propose(const SeededSpec& sp, int i, const unsigned* eb,
                                        unsigned* rb, Count&& count, float* values_out,
                                        int c0, int nc, int V) {
  unsigned step;
  unsigned c = first_col(sp, i, step);
  unsigned pos = c;
  for (int s = 0; s < sp.r; ++s) {
    if (bit(eb, c)) pos = c;
    c = next_col(sp, c, step);
  }
  const int layer_i = layer_of(sp, i);
  for (int lt = 0; lt < layer_i; ++lt) {
    if (count(row_of(sp, pos, lt)) == 1) return;
  }
  if constexpr (W > 0 && W <= 16) {
    int col[W];
    float wt[W];
    sorted_row<W>(sp, i, col, wt);
    float coeff = 0.0f;
#pragma unroll
    for (int s = 0; s < W; ++s) {
      if (s < sp.r && col[s] == static_cast<int>(pos)) coeff = wt[s];
    }
    const float div = coeff == 0.0f ? 1.0f : coeff;
    for (int cc = 0; cc < nc; ++cc) {
      float x[W];
#pragma unroll
      for (int s = 0; s < W; ++s) {
        const bool known = s < sp.r && col[s] != static_cast<int>(pos);
        x[s] = known ? values_out[at(col[s], c0 + cc, V)] : 0.0f;
      }
      float sum = 0.0f;
#pragma unroll
      for (int s = 0; s < W; ++s) {
        if (s < sp.r && col[s] != static_cast<int>(pos)) {
          sum = __fadd_rn(sum, __fmul_rn(wt[s], x[s]));
        }
      }
      values_out[at(pos, c0 + cc, V)] = __fdiv_rn(-sum, div);
    }
  } else {
    float sum[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
    float coeff = 0.0f;
    for_sorted_row<W>(sp, i, [&](int j, float wt) {
      if (static_cast<unsigned>(j) == pos) {
        coeff = wt;
      } else {
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          if (cc < nc) {
            sum[cc] = __fadd_rn(sum[cc], __fmul_rn(wt, values_out[at(j, c0 + cc, V)]));
          }
        }
      }
    });
    const float div = coeff == 0.0f ? 1.0f : coeff;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      if (cc < nc) values_out[at(pos, c0 + cc, V)] = __fdiv_rn(-sum[cc], div);
    }
  }
  atomicOr(&rb[pos >> 5], 1u << (pos & 31));
}

// A barrier over the pattern's blocks: the cluster, or the one block.
template <bool kCluster>
__device__ __forceinline__ void pattern_sync() {
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// W: the sorting network's width (0: selection), as for_sorted_row takes
// it; CB: bytes of a row's count (1 while r <= 255, else 2); kCluster: the
// pattern is spread over a cluster of blocks, each holding the erased
// bitmap whole and the counts of its own rows (see the note).
template <bool kAdaptive, int W, int CB, bool kCluster>
__global__ void __launch_bounds__(kThreads)
seeded_decode_kernel(SeededSpec sp, const float* __restrict__ values_in,
                     const unsigned char* __restrict__ erased_in,
                     const int* __restrict__ budgets, float* values_out,
                     unsigned char* erased_out, int* rounds_out, unsigned char* state, int N,
                     int V, int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = sp.rows, r = sp.r;
  const int nw = (N + 31) / 32, bw = bitmap_words(N);
  int C = 1, rank = 0;
  if constexpr (kCluster) {
    C = static_cast<int>(cg::this_cluster().num_blocks());
    rank = static_cast<int>(cg::this_cluster().block_rank());
  }
  constexpr int kRb = kCluster ? 2 : 1;
  const int per = kCluster ? rows_per_block(p, C) : p;
  const int lo = rank * per, hi = min(p, lo + per);          // this block's rows
  const size_t bytes = state_bytes(N, per, CB, kRb);
  unsigned char* base =
      state == nullptr
          ? smem
          : state + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * bytes;
  unsigned* eb = reinterpret_cast<unsigned*>(base);            // erased coordinates
  unsigned* rbs = eb + bw;                                      // resolved in the round
  unsigned* cw = rbs + kRb * bw;                                // own counts, kPerWord a word
  const int n_cw = (hi - lo + kPerWord<CB> - 1) / kPerWord<CB>;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int* list = reinterpret_cast<int*>(smem + (state == nullptr ? bytes : 0)) +
              warp * kListCap;                                  // this warp's rows of count 1
  // Row o's count, wherever it lives.
  auto count = [&](int o) {
    const unsigned* words = cw;
    int q = o - lo;
    if constexpr (kCluster) {
      const int owner = o / per;
      q = o - owner * per;
      if (owner != rank) words = cg::this_cluster().map_shared_rank(cw, owner);
    }
    return count_in<CB>(words[q / kPerWord<CB>], q % kPerWord<CB>);
  };

  const int b = blockIdx.y;
  const int cblock = blockIdx.x / C;
  const int c0 = cblock * kCols;
  const int nc = min(kCols, V - c0);
  values_in += static_cast<size_t>(b) * N * V;
  values_out += static_cast<size_t>(b) * N * V;
  erased_in += static_cast<size_t>(b) * N;
  const int budget = (kAdaptive && budgets != nullptr) ? budgets[b] : iters;

  // The erased bitmap (every block of a cluster holds it whole), a word (32
  // mask bytes, two 16-byte loads where aligned) a thread; the payload
  // columns copied, 16 bytes a load where the block owns every column, the
  // blocks of a cluster in turn.
  const bool mask16 = reinterpret_cast<uintptr_t>(erased_in) % 16 == 0;
  for (int k = tid; k < nw; k += blockDim.x) {
    unsigned w = 0;
    if (mask16 && 32 * k + 32 <= N) {
      const uint4* src = reinterpret_cast<const uint4*>(erased_in + 32 * k);
      const uint4 lo4 = src[0], hi4 = src[1];
      const unsigned x[8] = {lo4.x, lo4.y, lo4.z, lo4.w, hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        w |= static_cast<unsigned>(((x[i / 4] >> (8 * (i % 4))) & 0xFFu) != 0) << i;
      }
    } else {
      for (int i = 0; i < 32 && 32 * k + i < N; ++i) {
        w |= static_cast<unsigned>(erased_in[32 * k + i] != 0) << i;
      }
    }
    eb[k] = w;
#pragma unroll
    for (int q = 0; q < kRb; ++q) rbs[q * bw + k] = 0;
  }
  const int first = rank * blockDim.x + tid, stride = C * blockDim.x;
  if (nc == V && reinterpret_cast<uintptr_t>(values_in) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(values_out) % 16 == 0) {
    const int n4 = N * V / 4;
    const float4* src = reinterpret_cast<const float4*>(values_in);
    float4* dst = reinterpret_cast<float4*>(values_out);
    for (int it = first; it < n4; it += stride) dst[it] = src[it];
    for (int it = 4 * n4 + first; it < N * V; it += stride) values_out[it] = values_in[it];
  } else {
    for (int it = first; it < N * nc; it += stride) {
      const int j = it / nc, c = c0 + it % nc;
      values_out[at(j, c, V)] = values_in[at(j, c, V)];
    }
  }
  __syncthreads();

  // 1. Each of the block's rows counts its erased columns, kPerWord rows a
  // word.
  for (int k = tid; k < n_cw; k += blockDim.x) {
    unsigned w = 0;
#pragma unroll
    for (int q = 0; q < kPerWord<CB>; ++q) {
      const int i = lo + k * kPerWord<CB> + q;
      if (i >= hi) break;
      unsigned step;
      unsigned c = first_col(sp, i, step);
      int n = 0;
      for (int s = 0; s < r; ++s) {
        n += bit(eb, c);
        c = next_col(sp, c, step);
      }
      w |= static_cast<unsigned>(n) << (8 * CB * q);
    }
    cw[k] = w;
  }
  int mine_erased = 0;
  for (int k = tid; k < nw; k += blockDim.x) mine_erased |= eb[k] != 0;
  int any_erased = kAdaptive ? __syncthreads_or(mine_erased) : 1;
  pattern_sync<kCluster>();
  int progressed = 1;
  // The layers that hold the block's rows.
  const int layer_lo = hi > lo ? layer_of(sp, lo) : 0;
  const int layer_hi = hi > lo ? layer_of(sp, hi - 1) : -1;

  int t = 0;
  for (; t < budget; ++t) {
    if (kAdaptive && !(progressed && any_erased)) break;
    unsigned* rb = rbs + (t % kRb) * bw;

    // A. Rows with one erased neighbour: the lowest row of each such
    // coordinate writes its proposal there, against the round's values.
    // Each warp gathers its rows of count 1 into its own list (32 words of
    // counts at a time, one a lane) and acts on them 32 at a time, one a
    // lane, so its lanes stay busy whatever share of rows acts.
    int n_list = 0;                                   // the same in every lane
    for (int k0 = 32 * warp;; k0 += blockDim.x) {
      const bool more = k0 < n_cw;
      if (more) {
        const int k = k0 + lane;
        const unsigned w = k < n_cw ? cw[k] : 0u;
#pragma unroll
        for (int q = 0; q < kPerWord<CB>; ++q) {
          const bool one = count_in<CB>(w, q) == 1;
          const unsigned m = __ballot_sync(0xFFFFFFFFu, one);
          if (one) list[n_list + __popc(m & ((1u << lane) - 1))] = lo + k * kPerWord<CB> + q;
          n_list += __popc(m);
        }
        __syncwarp();
      }
      while (n_list >= 32 || (!more && n_list > 0)) {
        const int take = min(n_list, 32);
        n_list -= take;
        if (lane < take) {
          propose<W>(sp, list[n_list + lane], eb, rb, count, values_out, c0, nc, V);
        }
        __syncwarp();
      }
      if (!more) break;
    }
    pattern_sync<kCluster>();

    // B. Resolved coordinates (marked by any block of the pattern) leave
    // the erased set and the counts of the block's rows that hold them.
    // The other resolved bitmap, last round's, is cleared for the next.
    int mine_resolved = 0;
    mine_erased = 0;
    for (int k = tid; k < nw; k += blockDim.x) {
      unsigned m = rb[k];
      if constexpr (kCluster) {
        for (int q = 0; q < C; ++q) {
          if (q != rank) m |= cg::this_cluster().map_shared_rank(rb, q)[k];
        }
        rbs[((t + 1) % kRb) * bw + k] = 0;
      } else {
        rb[k] = 0;
      }
      if (m != 0) {
        eb[k] &= ~m;
        mine_resolved = 1;
        while (m != 0) {
          const unsigned j = 32u * k + __ffs(m) - 1;
          m &= m - 1;
          for (int lt = layer_lo; lt <= layer_hi; ++lt) {
            const int o = row_of(sp, j, lt);
            if (o >= lo && o < hi) {
              const int q = o - lo;
              atomicSub(&cw[q / kPerWord<CB>], 1u << (8 * CB * (q % kPerWord<CB>)));
            }
          }
        }
      }
      mine_erased |= eb[k] != 0;
    }
    if (kAdaptive) {
      progressed = __syncthreads_or(mine_resolved);
      any_erased = __syncthreads_or(mine_erased);
    }
    pattern_sync<kCluster>();
  }

  if (cblock == 0 && rank == 0) {
    unsigned char* out = erased_out + static_cast<size_t>(b) * N;
    const bool out16 = reinterpret_cast<uintptr_t>(out) % 16 == 0;
    for (int k = tid; k < nw; k += blockDim.x) {
      const unsigned w = eb[k];
      if (out16 && 32 * k + 32 <= N) {
        unsigned x[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          x[q] = ((w >> (4 * q)) & 1u) | (((w >> (4 * q + 1)) & 1u) << 8) |
                 (((w >> (4 * q + 2)) & 1u) << 16) | (((w >> (4 * q + 3)) & 1u) << 24);
        }
        uint4* dst = reinterpret_cast<uint4*>(out + 32 * k);
        dst[0] = make_uint4(x[0], x[1], x[2], x[3]);
        dst[1] = make_uint4(x[4], x[5], x[6], x[7]);
      } else {
        for (int i = 0; i < 32 && 32 * k + i < N; ++i) out[32 * k + i] = (w >> i) & 1u;
      }
    }
    if (kAdaptive && tid == 0) rounds_out[b] = t;
  }
}

// Shared memory a block takes: its state (unless in device memory) and
// its warps' lists.
inline size_t smem_bytes(int N, int rows, int CB, int C, bool in_shared) {
  const size_t state = C > 1 ? state_bytes(N, rows_per_block(rows, C), CB, 2)
                             : state_bytes(N, rows, CB, 1);
  return (in_shared ? state : 0) + kListBytes;
}

template <bool kAdaptive, int W, int CB, bool kCluster>
int launch(const SeededSpec& sp, const float* values_in, const unsigned char* erased_in,
           const int* budgets, float* values_out, unsigned char* erased_out, int* rounds_out,
           unsigned char* state, int B, int N, int V, int iters, int C, cudaStream_t stream) {
  auto* kernel = &seeded_decode_kernel<kAdaptive, W, CB, kCluster>;
  const size_t smem = smem_bytes(N, sp.rows, CB, C, state == nullptr);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(C * ((V + kCols - 1) / kCols), B);
  if constexpr (kCluster) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, sp, values_in, erased_in, budgets,
                                               values_out, erased_out, rounds_out, state, N, V,
                                               iters);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    kernel<<<grid, kThreads, smem, stream>>>(sp, values_in, erased_in, budgets, values_out,
                                             erased_out, rounds_out, state, N, V, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

// Rows past 255 (two-byte counts) are past every network: selection, one
// block a pattern.
template <bool kAdaptive, int CB, bool kCluster>
int launch_width(const SeededSpec& sp, const float* values_in, const unsigned char* erased_in,
                 const int* budgets, float* values_out, unsigned char* erased_out,
                 int* rounds_out, unsigned char* state, int B, int N, int V, int iters, int C,
                 cudaStream_t stream) {
  const int w = CB == 1 ? network_width(sp.r) : 0;
  auto* go = w == 8    ? &launch<kAdaptive, CB == 1 ? 8 : 0, CB, kCluster>
             : w == 16 ? &launch<kAdaptive, CB == 1 ? 16 : 0, CB, kCluster>
             : w == 32 ? &launch<kAdaptive, CB == 1 ? 32 : 0, CB, kCluster>
             : w == 64 ? &launch<kAdaptive, CB == 1 ? 64 : 0, CB, kCluster>
                       : &launch<kAdaptive, 0, CB, kCluster>;
  return go(sp, values_in, erased_in, budgets, values_out, erased_out, rounds_out, state, B, N,
            V, iters, C, stream);
}

int count_bytes(int r) { return r <= 255 ? 1 : 2; }

}  // namespace

extern "C" {

// Per-block state of a code of length N with `rows` check rows of weight
// r, in bytes, one block a pattern: the erased and the resolved bitmaps
// (each padded to 16 bytes), then a count a row (one byte while r <= 255,
// else two), padded to 16 bytes.
size_t seeded_decode_state_bytes(int N, int rows, int r) {
  return state_bytes(N, rows, count_bytes(r), 1);
}

// Shared memory a block takes: with `cluster` = C > 1 blocks a pattern,
// the erased bitmap, two resolved bitmaps and the counts of rows / C rows;
// with C = 1 the state above when `in_shared`; either way its warps' lists.
size_t seeded_decode_smem_bytes(int N, int rows, int r, int cluster, int in_shared) {
  return smem_bytes(N, rows, count_bytes(r), cluster, in_shared != 0);
}

// Launches the decode of B patterns of the seeded code (rows x cols block,
// row weight r <= 65535, `layers` layers of rows / layers rows each, `layer`
// a device array of the layers' strides, offsets, inverse strides and
// strides mod cols) on `stream`: values (B, N, V) f32, erased (B, N) bytes,
// N == cols.  `cluster` = C: the blocks a pattern is spread over (1, or up
// to 8 with r <= 255; their state in shared memory, state null).  With C =
// 1, `state` null: the per-block state lives in shared memory; else a
// device buffer of ceil(V / 4) * B * seeded_decode_state_bytes(N, rows, r)
// bytes.  adaptive = 0: exactly `iters` rounds (budgets and rounds_out
// unused).  adaptive = 1: early exit under budgets (B,) int32, or `iters`
// for every slot where budgets is null; rounds_out (B,) int32.  Returns a
// CUDA error code (0 = launched).
int seeded_decode_launch(int rows, int cols, int r, int layers, unsigned int wseed,
                         const int* layer, const float* values_in,
                         const unsigned char* erased_in, const int* budgets, float* values_out,
                         unsigned char* erased_out, int* rounds_out, unsigned char* state,
                         int B, int N, int V, int iters, int adaptive, int cluster,
                         void* stream) {
  SeededSpec sp;
  if (N != cols || r > 65535 || cluster < 1 || cluster > kMaxCluster ||
      (cluster > 1 && (r > 255 || state != nullptr)) ||
      !make_spec(&sp, rows, cols, r, layers, wseed, layer)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster > 1) {
    return adaptive
               ? launch_width<true, 1, true>(sp, values_in, erased_in, budgets, values_out,
                                             erased_out, rounds_out, nullptr, B, N, V, iters,
                                             cluster, s)
               : launch_width<false, 1, true>(sp, values_in, erased_in, nullptr, values_out,
                                              erased_out, nullptr, nullptr, B, N, V, iters,
                                              cluster, s);
  }
  if (count_bytes(r) == 1) {
    return adaptive ? launch_width<true, 1, false>(sp, values_in, erased_in, budgets,
                                                   values_out, erased_out, rounds_out, state,
                                                   B, N, V, iters, 1, s)
                    : launch_width<false, 1, false>(sp, values_in, erased_in, nullptr,
                                                    values_out, erased_out, nullptr, state, B,
                                                    N, V, iters, 1, s);
  }
  return adaptive ? launch_width<true, 2, false>(sp, values_in, erased_in, budgets, values_out,
                                                 erased_out, rounds_out, state, B, N, V, iters,
                                                 1, s)
                  : launch_width<false, 2, false>(sp, values_in, erased_in, nullptr,
                                                  values_out, erased_out, nullptr, state, B, N,
                                                  V, iters, 1, s);
}

const char* seeded_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
