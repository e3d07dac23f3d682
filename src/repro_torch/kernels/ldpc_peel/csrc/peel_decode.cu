// Flooding peeling decode of B erasure patterns over a code's neighbour
// table, in one launch: the fixed-D contract and the early-exit (adaptive)
// contract.
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
// sparse neighbour table (check_idx / check_coeff, p x r, padding slots
// holding the sentinel N) and its column table (col_ptr / col_rows: each
// column's check rows in ascending order, CSR, built by the wrapper from
// check_idx, ref.column_table) from device memory, so one kernel serves
// every N that device memory holds.  The single-pattern contracts are the
// B = 1 case.
//
// What it computes.  In each round every check row with exactly one erased
// neighbour j proposes c_j = -(sum_known H c) / H_ij (its known neighbours
// in table order, one rounded multiply and one rounded add a term from +0,
// then one rounded divide; a zero coefficient is guarded to 1), against
// the state at the START of the round; when several checks resolve one
// coordinate the LOWEST check row wins (kernel.py:235-237).  Erased entries
// are never read.  Counts of erased neighbours are integers: solvability
// takes no tolerance.
//   fixed     exactly `iters` rounds for every slot.
//   adaptive  slot b stops before round d when d >= budget[b] (or `iters`
//             where no budgets are given), when round d-1 resolved nothing,
//             or when nothing is erased.  rounds[b] counts the rounds run,
//             the last no-progress probe round included (kernel.py:322-338
//             _adaptive_loop).  Budget 0, or nothing erased, returns the
//             slot untouched with 0 rounds.
// A round that resolves nothing leaves the state as it was, so the fixed
// contract stops there too: the rounds it skips would change nothing.
//
// What held the old design back (one block a pattern and 4 payload
// columns; on an H100 80GB HBM3 at 700 W, CUDA graphs, 0.40 ms at Path A's
// LDGM decode, N = 24,576, and 2.0 ms at N = 49,152, PERF.md): every round
// walked all p·r table entries twice, once to count each row's erased
// neighbours and once for every (row, payload column) pair, though only
// the rows with one erased neighbour act; four block barriers a round,
// with the proposals copied through a (B, p, V) scratch in device memory
// and all N coordinates swept to clear the bids; and 5 bytes of state a
// coordinate, in device memory past N ~ 46,000.  The design now (the
// counterpart of seeded_decode.cu's, with a column table in place of the
// layers' inverse permutations):
//
// 1. A column table, each column's rows ascending (ref.column_table, built
//    by the wrapper from check_idx), so a coordinate's rows are found
//    without a walk over the table.
// 2. Per-check erased counts and XORs, built once a launch and kept on
//    chip: a count a row (one byte while r <= 255, two past it) and the
//    XOR of the row's erased columns, so a row of count 1 holds its erased
//    column pos (the peeling of an invertible Bloom lookup table).  Phase
//    A: each row of count 1 wins pos if no lower row of pos has count 1,
//    writes its proposal straight to the values at pos (no row reads an
//    erased coordinate in the round, and a coordinate has one winner) and
//    lists pos.  Phase B: each listed coordinate leaves the erased bitmap
//    and its rows' counts and XORs, a thread each.  This is the trajectory
//    of recounting every row every round: every row with count 1 had its
//    one erased neighbour resolved, and no other count changes.  No
//    scratch, no bids, two block barriers a round; the stopping tests read
//    the round's count of resolved coordinates.
// 3. Warps act on lists of the acting rows: each warp gathers its rows of
//    count 1 (32 words of counts at a time) and acts on them 32 at a time,
//    a row a lane, so its lanes stay busy whatever share of rows acts.  A
//    lane loads 8 table slots, then their values and weights beside the
//    winner test.  The grid stays (ceil(V / 4), B): a block owns 4 payload
//    columns of one pattern and computes the trajectory itself, so at V =
//    32 eight blocks run side by side on 8 SMs.
// 4. On chip, in turn while they fit one block (the dispatch by shape of
//    ops.table_layout): the state (the erased and resolved bitmaps, the
//    counts and XORs: 2.75 bytes a coordinate for a (3, 6) code, so Path
//    A's and phase 15's fit); the block's payload columns (Path A's; the
//    rounds read and write them there); the table and the column table,
//    copied by asynchronous 16-byte copies (the blocked step's and the
//    serving wave's, N = 2048).  The placement is a template parameter, so
//    what lives on chip is reached by shared-memory loads and atomics.  A
//    state past shared memory lives in a device scratch of one state per
//    block, initialised at every launch.  A launch the card refuses raises.
//
// What each step did (CUDA graphs, the same card, time_checkouts.py --what
// table_decode; PERF.md §6): the counts, the lists and the state on
// chip took Path A's decode from 0.40 to 0.11 ms and N = 49,152 from 2.0
// to 0.31; the same kernel without the lists (a lane acting on the rows of
// its own count words) 0.17 and 0.60.  The values and tables on chip, the
// listed phase B and the loads issued together: 0.065 and 0.222, the
// blocked step's decode 0.114 to 0.030.  The XORs and the placement fixed
// at compile time: 0.056 and 0.222, the blocked step's 0.025, the adaptive
// step's 0.033 to 0.015.  On that kernel Path A's values on chip take
// 0.056 ms against 0.061 with them in device memory, the state on chip in
// both.  Two copies of the state, for one barrier a
// round, ran slower; so did the weights left in device memory, and blocks
// of 256 threads ran no faster.
//
// Bound on an H100 SXM (3.35 TB/s).  The decode must move the table once
// (8 B an entry), the values in and out (8 B·N·V a pattern) and the masks
// (2 B·N): at Path A's shape (p = 8192, r = 9, N = 24,576, V = 1) 0.84 MB,
// 0.25 us; at the blocked step's (p = 1024, r = 6, N = 2048, V = 32) 0.58
// MB, 0.17 us.  The column table (4 B a column and an entry) is this
// design's own cost, outside the bound.  A round is a chain of dependent
// shared-memory steps inside one SM a block (the acting row's slots, its
// erased column's rows and counts, its values, a division) and two
// barriers, so the kernel stays latency-bound, hundreds of times its byte
// bound.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kCols = 4;
// Table slots a lane loads before it sums them.
constexpr int kSlots = 8;
// A warp's list of rows of count 1 (or of set bits): fewer than 32 left
// over, plus 32 words of at most 4 rows each.
constexpr int kListCap = 32 + 32 * 4;
constexpr size_t kListBytes = kThreads / 32 * kListCap * sizeof(int);
// A round's resolved coordinates listed in shared memory; past that many
// they go to the resolved bitmap.
constexpr int kResCap = 2048;
// What a block keeps in shared memory whatever the shape: its warps'
// lists, three counters (the resolved coordinates of a round, two used in
// turn, and the erased ones; padded to 16 bytes) and the resolved list.
constexpr size_t kOwnBytes = kListBytes + 16 + kResCap * sizeof(int);

// Where a block's operands live (the wrapper's dispatch by shape,
// ops.table_layout): each flag puts one more of them in shared memory.
enum : int { kStateOnChip = 1, kValuesOnChip = 2, kTablesOnChip = 4 };

__host__ __device__ inline size_t pad16(size_t b) { return (b + 15) & ~static_cast<size_t>(15); }

// Words of a bitmap of n coordinates, padded to 16 bytes.
__host__ __device__ inline int bitmap_words(int n) { return ((n + 31) / 32 + 3) & ~3; }

// Rows per 32-bit word of counts.
template <int CB>
constexpr int kPerWord = 4 / CB;

// Per-block state: the erased bitmap, the resolved bitmap (for a round's
// coordinates past kResCap), one count of CB bytes a row, padded to 16
// bytes, then the XOR of each row's erased columns.
__host__ __device__ inline size_t state_bytes(int N, int p, int CB) {
  return 8 * static_cast<size_t>(bitmap_words(N)) + pad16(static_cast<size_t>(p) * CB) +
         pad16(static_cast<size_t>(p) * 4);
}

// Payload columns a block holds on chip: 1, 2 or kCols.
__host__ __device__ inline int col_width(int V) { return V == 1 ? 1 : V == 2 ? 2 : kCols; }

// The block's payload columns, col_width(V) floats a coordinate.
__host__ __device__ inline size_t values_bytes(int N, int V) {
  return pad16(static_cast<size_t>(N) * col_width(V) * sizeof(float));
}

// The table (columns, weights), the column table's rows (at most p·r) and
// its offsets.
inline size_t tables_bytes(int N, int p, int r) {
  return 3 * pad16(static_cast<size_t>(p) * r * 4) + pad16((static_cast<size_t>(N) + 1) * 4);
}

int count_bytes(int r) { return r <= 255 ? 1 : 2; }

size_t smem_bytes(int N, int p, int r, int V, int place) {
  return kOwnBytes + (place & kStateOnChip ? state_bytes(N, p, count_bytes(r)) : 0) +
         (place & kValuesOnChip ? values_bytes(N, V) : 0) +
         (place & kTablesOnChip ? tables_bytes(N, p, r) : 0);
}

__device__ __forceinline__ bool bit(const unsigned* bm, unsigned j) {
  return (bm[j >> 5] >> (j & 31)) & 1u;
}

__device__ __forceinline__ bool real(int j, int N) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(N);
}

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1; }

// Count q of a word of counts.
template <int CB>
__device__ __forceinline__ int count_in(unsigned w, int q) {
  return (w >> (8 * CB * q)) & (CB == 1 ? 0xFFu : 0xFFFFu);
}

template <int CB>
__device__ __forceinline__ int count_of(const unsigned* cw, int o) {
  return count_in<CB>(cw[o / kPerWord<CB>], o % kPerWord<CB>);
}

// n 32-bit words from device memory into shared memory, all at once:
// 16-byte asynchronous copies where both ends are 16-byte aligned (waited
// for by copies_done), plain ones for the rest.
__device__ __forceinline__ void copy_to_shared(unsigned* dst, const unsigned* src, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) % 16 == 0) {
    const int n4 = n / 4;
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16 * i),
                   "l"(src + 4 * i));
    }
    done = 4 * n4;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Closes a group of asynchronous copies.
__device__ __forceinline__ void copies_group() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits for every group of asynchronous copies but the last one closed.
__device__ __forceinline__ void copies_but_last_done() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void copies_done() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// One more (kAdd) or one fewer erased neighbour, j, for every row of
// column j: its count up or down by one, j into or out of its XOR; the
// rows loaded four at a time.
template <int CB, bool kAdd>
__device__ __forceinline__ void step_rows(unsigned* cw, int* xr, const int* col_ptr,
                                          const int* col_rows, int j) {
  const int end = col_ptr[j + 1];
  for (int q0 = col_ptr[j]; q0 < end; q0 += 4) {
    int o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) o[u] = q0 + u < end ? col_rows[q0 + u] : -1;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (o[u] < 0) continue;
      const unsigned one = 1u << (8 * CB * (o[u] % kPerWord<CB>));
      if constexpr (kAdd) {
        atomicAdd(&cw[o[u] / kPerWord<CB>], one);
      } else {
        atomicSub(&cw[o[u] / kPerWord<CB>], one);
      }
      atomicXor(&xr[o[u]], j);
    }
  }
}

// act(j) for every set bit j of the bitmap words [0, n_words) (word(k)
// reads word k), a set bit a lane, 32 at a time: the block's warps take 32
// words in turn and list their set bits.  act runs with the warp's lanes
// diverged, so it holds no warp-wide operation.
template <typename Word, typename Act>
__device__ __forceinline__ void for_each_bit(int* list, int n_words, Word word, Act act) {
  const int lane = threadIdx.x % 32;
  int n = 0;                                          // the same in every lane
  for (int k0 = 32 * (threadIdx.x / 32); k0 < n_words; k0 += blockDim.x) {
    const int k = k0 + lane;
    const unsigned w = k < n_words ? word(k) : 0u;
    if (__ballot_sync(0xFFFFFFFFu, w != 0) == 0) continue;
#pragma unroll 1
    for (int q = 0; q < 32; ++q) {
      const bool one = (w >> q) & 1u;
      const unsigned m = __ballot_sync(0xFFFFFFFFu, one);
      if (one) list[n + __popc(m & lanes_below(lane))] = 32 * k + q;
      n += __popc(m);
      if (n >= 32) {
        __syncwarp();
        n -= 32;
        act(list[n + lane]);
        __syncwarp();
      }
    }
  }
  __syncwarp();
  if (lane < n) act(list[lane]);
  __syncwarp();
}

// Row i, of count 1, whose one erased column is pos (the XOR of its erased
// columns): if no lower row of pos has count 1, i is pos's lowest
// proposer: it writes its proposal for the block's payload columns at pos
// (its known neighbours in table order, one rounded multiply and add a
// term, one rounded divide) and returns pos; else -1.  The first kSlots slots' values and weights are loaded before
// the winner test, so they wait together.  vals holds coordinate j's columns at
// j·vs + vc.
template <int CB, int NC>
__device__ __forceinline__ int propose(const int* check_idx, const float* check_coeff,
                                       const int* col_ptr, const int* col_rows, int i, int pos,
                                       int r, int N, const unsigned* cw, float* vals, int vs,
                                       int vc, int nc) {
  const int* nbr = check_idx + static_cast<size_t>(i) * r;
  const float* w = check_coeff + static_cast<size_t>(i) * r;
  int col[kSlots];
#pragma unroll
  for (int u = 0; u < kSlots; ++u) col[u] = u < r ? nbr[u] : -1;
  float sum[NC];
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) sum[cc] = 0.0f;
  float coeff = 0.0f;
  for (int s0 = 0;;) {
    float x[kSlots][NC];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const bool known = real(col[u], N) && col[u] != pos;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        x[u][cc] = known && cc < nc ? vals[static_cast<size_t>(col[u]) * vs + vc + cc] : 0.0f;
      }
    }
    float wt[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) wt[u] = s0 + u < r ? w[s0 + u] : 0.0f;
    if (s0 == 0) {                 // "lo": a lower row of pos with count 1 takes it
      const int end = col_ptr[pos + 1];
      for (int q0 = col_ptr[pos]; q0 < end; q0 += 4) {
        int o[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) o[u] = q0 + u < end ? col_rows[q0 + u] : INT_MAX;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (o[u] < i && count_of<CB>(cw, o[u]) == 1) return -1;
        }
        if (o[3] >= i) break;
      }
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      if (col[u] == pos) coeff = wt[u];
      if (real(col[u], N) && col[u] != pos) {
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) sum[cc] = __fadd_rn(sum[cc], __fmul_rn(wt[u], x[u][cc]));
      }
    }
    s0 += kSlots;
    if (s0 >= r) break;
#pragma unroll
    for (int u = 0; u < kSlots; ++u) col[u] = s0 + u < r ? nbr[s0 + u] : -1;
  }
  const float div = coeff == 0.0f ? 1.0f : coeff;
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) {
    if (cc < nc) vals[static_cast<size_t>(pos) * vs + vc + cc] = __fdiv_rn(-sum[cc], div);
  }
  return pos;
}

// CB: bytes of a row's count (1 while r <= 255, else 2); NC: payload
// columns a block holds (col_width(V)); kPlace: the kStateOnChip,
// kValuesOnChip and kTablesOnChip flags, fixed at compile time so that
// what lives in shared memory is reached by shared-memory instructions
// (loads and atomics through a pointer of unknown space are slower).
template <bool kAdaptive, int CB, int NC, int kPlace>
__global__ void __launch_bounds__(kThreads, 1)
peel_decode_kernel(const int* __restrict__ check_idx, const float* __restrict__ check_coeff,
                   const int* __restrict__ col_ptr, const int* __restrict__ col_rows, int p,
                   int r, int E, const float* __restrict__ values_in,
                   const unsigned char* __restrict__ erased_in, const int* __restrict__ budgets,
                   float* values_out, unsigned char* erased_out, int* rounds_out,
                   unsigned char* state, int N, int V, int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = (N + 31) / 32, bw = bitmap_words(N);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int* list = reinterpret_cast<int*>(smem) + warp * kListCap;  // this warp's rows of count 1
  int* counters = reinterpret_cast<int*>(smem + kListBytes);    // resolved (2, in turn), erased
  int* res_list = counters + 4;                                 // the round's resolved
  volatile int* seen = counters;
  unsigned char* next = smem + kOwnBytes;                       // the rest of shared memory

  const size_t bytes = state_bytes(N, p, CB);
  unsigned char* base;
  if constexpr ((kPlace & kStateOnChip) != 0) {
    base = next;
    next += bytes;
  } else {
    base = state + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * bytes;
  }
  unsigned* eb = reinterpret_cast<unsigned*>(base);            // erased coordinates
  unsigned* rb = eb + bw;                                       // resolved, past kResCap
  unsigned* cw = rb + bw;                                       // counts, kPerWord a word
  const int n_cw = (p + kPerWord<CB> - 1) / kPerWord<CB>;
  int* xr = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(cw) +
                                   pad16(static_cast<size_t>(p) * CB));  // erased columns' XOR

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCols;
  const int nc = min(kCols, V - c0);
  values_in += static_cast<size_t>(b) * N * V;
  values_out += static_cast<size_t>(b) * N * V;
  erased_in += static_cast<size_t>(b) * N;
  const int budget = (kAdaptive && budgets != nullptr) ? budgets[b] : iters;

  // Where the round reads and writes the values: the block's columns on
  // chip, NC floats a coordinate, or values_out.
  float* vals = values_out;
  int vs = V, vc = c0;
  if constexpr ((kPlace & kValuesOnChip) != 0) {
    vals = reinterpret_cast<float*>(next);
    vs = NC;
    vc = 0;
    next += values_bytes(N, V);
  }
  const int* idx = check_idx;
  const float* coeff = check_coeff;
  const int* cptr = col_ptr;
  const int* crows = col_rows;
  if constexpr ((kPlace & kTablesOnChip) != 0) {
    const size_t pr = pad16(static_cast<size_t>(p) * r * 4);
    idx = reinterpret_cast<const int*>(next);
    coeff = reinterpret_cast<const float*>(next + pr);
    crows = reinterpret_cast<const int*>(next + 2 * pr);
    cptr = reinterpret_cast<const int*>(next + 3 * pr);
    copy_to_shared(reinterpret_cast<unsigned*>(next),
                   reinterpret_cast<const unsigned*>(check_idx), p * r);
    copies_group();                // the counts wait for the table's columns alone
    copy_to_shared(reinterpret_cast<unsigned*>(next + pr),
                   reinterpret_cast<const unsigned*>(check_coeff), p * r);
    copy_to_shared(reinterpret_cast<unsigned*>(next + 2 * pr),
                   reinterpret_cast<const unsigned*>(col_rows), E);
    copy_to_shared(reinterpret_cast<unsigned*>(next + 3 * pr),
                   reinterpret_cast<const unsigned*>(col_ptr), N + 1);
  }

  // The erased bitmap, a word (32 mask bytes, two 16-byte loads where
  // aligned) a thread; a clear resolved bitmap and clear counts; the block's
  // payload columns copied to where the rounds use them.
  if (tid < 4) counters[tid] = 0;
  const bool mask16 = reinterpret_cast<uintptr_t>(erased_in) % 16 == 0;
  int mine = 0;
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
    rb[k] = 0;
    mine += __popc(w);
  }
  for (int k = tid; k < n_cw; k += blockDim.x) cw[k] = 0;
  for (int i = tid; i < p; i += blockDim.x) xr[i] = 0;
  // One contiguous run of N·V floats where the block owns every column and
  // holds them as values_out does.
  constexpr bool kValues = (kPlace & kValuesOnChip) != 0;
  const bool whole = nc == V && (!kValues || NC == V) &&
                     reinterpret_cast<uintptr_t>(values_in) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(values_out) % 16 == 0;
  if (kValues && whole) {
    copy_to_shared(reinterpret_cast<unsigned*>(vals),
                   reinterpret_cast<const unsigned*>(values_in), N * V);
  } else if (whole) {
    const float4* src = reinterpret_cast<const float4*>(values_in);
    float4* dst = reinterpret_cast<float4*>(values_out);
    const int n4 = N * V / 4;
#pragma unroll 4
    for (int it = tid; it < n4; it += blockDim.x) dst[it] = src[it];
    for (int it = 4 * n4 + tid; it < N * V; it += blockDim.x) values_out[it] = values_in[it];
  } else {
#pragma unroll 4
    for (int it = tid; it < N * nc; it += blockDim.x) {
      const int j = it / nc, c = it % nc;
      vals[static_cast<size_t>(j) * vs + vc + c] = values_in[static_cast<size_t>(j) * V + c0 + c];
    }
  }
  copies_group();
  copies_but_last_done();
  __syncthreads();

  // The counts and XORs.  With the table on chip each row counts its
  // erased neighbours, kPerWord rows a word, their first kSlots slots loaded
  // together; else each erased coordinate adds itself to its rows, the set
  // bits dealt a lane each (fewer dependent loads from device memory).
  mine = __reduce_add_sync(0xFFFFFFFFu, mine);
  if (lane == 0 && mine != 0) atomicAdd(&counters[2], mine);
  if constexpr ((kPlace & kTablesOnChip) != 0) {
    for (int k = tid; k < n_cw; k += blockDim.x) {
      int n[kPerWord<CB>], x[kPerWord<CB>];
#pragma unroll
      for (int q = 0; q < kPerWord<CB>; ++q) n[q] = x[q] = 0;
      for (int s0 = 0; s0 < r; s0 += kSlots) {
        int col[kPerWord<CB>][kSlots];
#pragma unroll
        for (int q = 0; q < kPerWord<CB>; ++q) {
          const int i = k * kPerWord<CB> + q;
#pragma unroll
          for (int u = 0; u < kSlots; ++u) {
            col[q][u] = i < p && s0 + u < r ? idx[static_cast<size_t>(i) * r + s0 + u] : -1;
          }
        }
#pragma unroll
        for (int q = 0; q < kPerWord<CB>; ++q) {
#pragma unroll
          for (int u = 0; u < kSlots; ++u) {
            if (real(col[q][u], N) && bit(eb, col[q][u])) {
              ++n[q];
              x[q] ^= col[q][u];
            }
          }
        }
      }
      unsigned w = 0;
#pragma unroll
      for (int q = 0; q < kPerWord<CB>; ++q) {
        w |= static_cast<unsigned>(n[q]) << (8 * CB * q);
        if (k * kPerWord<CB> + q < p) xr[k * kPerWord<CB> + q] = x[q];
      }
      cw[k] = w;
    }
  } else {
    for_each_bit(list, nw, [&](int k) { return eb[k]; },
                 [&](int j) { step_rows<CB, true>(cw, xr, cptr, crows, j); });
  }
  copies_done();
  __syncthreads();

  // `left` erased, `last` resolved by the last round (1 before the first):
  // a round runs while something is erased and the last round resolved
  // something.
  int left = seen[2], last = 1;
  int t = 0;
  for (; t < budget; ++t) {
    if (left == 0 || last == 0) break;
    int* n_res = counters + (t & 1);

    // A. Rows with one erased neighbour: the lowest row of each such
    // coordinate writes its proposal there, against the round's values,
    // and lists the coordinate.  Each warp gathers its rows of count 1 into
    // its own list (32 words of counts at a time, one a lane) and acts on
    // them 32 at a time, one a lane.
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
          if (one) list[n_list + __popc(m & lanes_below(lane))] = k * kPerWord<CB> + q;
          n_list += __popc(m);
        }
        __syncwarp();
      }
      while (n_list >= 32 || (!more && n_list > 0)) {
        const int take = min(n_list, 32);
        n_list -= take;
        int pos = -1;
        if (lane < take) {
          const int i = list[n_list + lane];
          pos = propose<CB, NC>(idx, coeff, cptr, crows, i, xr[i], r, N, cw, vals, vs, vc, nc);
        }
        // the warp's winners take consecutive places in the resolved list
        const unsigned won = __ballot_sync(0xFFFFFFFFu, pos >= 0);
        if (won != 0) {
          int first = 0;
          if (lane == 0) first = atomicAdd(n_res, __popc(won));
          first = __shfl_sync(0xFFFFFFFFu, first, 0);
          if (pos >= 0) {
            const int q = first + __popc(won & lanes_below(lane));
            if (q < kResCap) {
              res_list[q] = pos;
            } else {
              atomicOr(&rb[pos >> 5], 1u << (pos & 31));
            }
          }
        }
        __syncwarp();
      }
      if (!more) break;
    }
    __syncthreads();

    // B. Resolved coordinates leave the erased set and their rows' counts:
    // the listed ones a thread each, the rest from the resolved bitmap
    // (cleared for the next round).
    last = seen[t & 1];
    left -= last;
    if (tid == 0) counters[(t + 1) & 1] = 0;
    for (int q = tid; q < min(last, kResCap); q += blockDim.x) {
      const int j = res_list[q];
      atomicAnd(&eb[j >> 5], ~(1u << (j & 31)));
      step_rows<CB, false>(cw, xr, cptr, crows, j);
    }
    if (last > kResCap) {
      for_each_bit(list, nw,
                   [&](int k) {
                     const unsigned m = rb[k];
                     if (m != 0) rb[k] = 0;
                     return m;
                   },
                   [&](int j) {
                     atomicAnd(&eb[j >> 5], ~(1u << (j & 31)));
                     step_rows<CB, false>(cw, xr, cptr, crows, j);
                   });
    }
    __syncthreads();
  }

  if constexpr (kValues) {                           // the block's columns back out
    if (whole) {
      const float4* src = reinterpret_cast<const float4*>(vals);
      float4* dst = reinterpret_cast<float4*>(values_out);
      const int n4 = N * V / 4;
      for (int it = tid; it < n4; it += blockDim.x) dst[it] = src[it];
      for (int it = 4 * n4 + tid; it < N * V; it += blockDim.x) values_out[it] = vals[it];
    } else {
#pragma unroll 4
      for (int it = tid; it < N * nc; it += blockDim.x) {
        const int j = it / nc, c = it % nc;
        values_out[static_cast<size_t>(j) * V + c0 + c] = vals[static_cast<size_t>(j) * vs + c];
      }
    }
  }
  if (blockIdx.x == 0) {
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

template <bool kAdaptive, int CB, int NC, int kPlace>
int launch(const int* check_idx, const float* check_coeff, const int* col_ptr,
           const int* col_rows, int p, int r, int E, const float* values_in,
           const unsigned char* erased_in, const int* budgets, float* values_out,
           unsigned char* erased_out, int* rounds_out, unsigned char* state, int B, int N, int V,
           int iters, cudaStream_t stream) {
  auto* kernel = &peel_decode_kernel<kAdaptive, CB, NC, kPlace>;
  const size_t smem = smem_bytes(N, p, r, V, kPlace);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((V + kCols - 1) / kCols, B);
  kernel<<<grid, kThreads, smem, stream>>>(check_idx, check_coeff, col_ptr, col_rows, p, r, E,
                                           values_in, erased_in, budgets, values_out,
                                           erased_out, rounds_out, state, N, V, iters);
  return static_cast<int>(cudaGetLastError());
}

// The placements table_layout takes: nothing on chip, the state, the state
// and values, all three.
template <bool kAdaptive, int CB, int NC>
int launch_placed(const int* check_idx, const float* check_coeff, const int* col_ptr,
                  const int* col_rows, int p, int r, int E, const float* values_in,
                  const unsigned char* erased_in, const int* budgets, float* values_out,
                  unsigned char* erased_out, int* rounds_out, unsigned char* state, int B,
                  int N, int V, int iters, int place, cudaStream_t stream) {
  auto* go = place == 7   ? &launch<kAdaptive, CB, NC, 7>
             : place == 3 ? &launch<kAdaptive, CB, NC, 3>
             : place == 1 ? &launch<kAdaptive, CB, NC, 1>
                          : &launch<kAdaptive, CB, NC, 0>;
  return go(check_idx, check_coeff, col_ptr, col_rows, p, r, E, values_in, erased_in, budgets,
            values_out, erased_out, rounds_out, state, B, N, V, iters, stream);
}

template <bool kAdaptive, int CB>
int launch_cols(const int* check_idx, const float* check_coeff, const int* col_ptr,
                const int* col_rows, int p, int r, int E, const float* values_in,
                const unsigned char* erased_in, const int* budgets, float* values_out,
                unsigned char* erased_out, int* rounds_out, unsigned char* state, int B, int N,
                int V, int iters, int place, cudaStream_t stream) {
  const int w = col_width(V);
  auto* go = w == 1 ? &launch_placed<kAdaptive, CB, 1>
             : w == 2 ? &launch_placed<kAdaptive, CB, 2>
                      : &launch_placed<kAdaptive, CB, kCols>;
  return go(check_idx, check_coeff, col_ptr, col_rows, p, r, E, values_in, erased_in, budgets,
            values_out, erased_out, rounds_out, state, B, N, V, iters, place, stream);
}

}  // namespace

extern "C" {

// Per-block state of a code of length N with p check rows of table width r,
// in bytes: the erased and the resolved bitmaps (each padded to 16 bytes),
// then a count a row (one byte while r <= 255, else two), padded to 16
// bytes.
size_t peel_decode_state_bytes(int N, int p, int r) {
  return state_bytes(N, p, count_bytes(r));
}

// Shared memory a block takes for V payload columns under `place` (the
// kStateOnChip = 1, kValuesOnChip = 2 and kTablesOnChip = 4 flags): its
// lists, counters and resolved list, and each operand the flags put there
// (the state; the block's columns, col_width(V) floats a coordinate; the
// table, the column table's rows reserved at p·r and its N + 1 offsets).
size_t peel_decode_smem_bytes(int N, int p, int r, int V, int place) {
  return smem_bytes(N, p, r, V, place);
}

// Launches the decode of B patterns on `stream`: the table check_idx /
// check_coeff (p, r), r <= 65535, and its column table col_ptr (N + 1) /
// col_rows (E <= p·r entries, each column's rows ascending), values (B, N,
// V) f32, erased (B, N) bytes.  `place` as for peel_decode_smem_bytes
// (values on chip only with the state, the tables only with both); without
// kStateOnChip, `state` is a device buffer of ceil(V / 4) * B *
// peel_decode_state_bytes(N, p, r) bytes.  adaptive = 0: exactly `iters`
// rounds (budgets and rounds_out unused).  adaptive = 1: early exit under
// budgets (B,) int32, or `iters` for every slot where budgets is null;
// rounds_out (B,) int32.  Returns a CUDA error code (0 = launched).
int peel_decode_launch(const int* check_idx, const float* check_coeff, const int* col_ptr,
                       const int* col_rows, int p, int r, int E, const float* values_in,
                       const unsigned char* erased_in, const int* budgets, float* values_out,
                       unsigned char* erased_out, int* rounds_out, unsigned char* state, int B,
                       int N, int V, int iters, int adaptive, int place, void* stream) {
  const bool ordered = place == 0 || place == 1 || place == 3 || place == 7;
  if (p < 1 || r < 1 || r > 65535 || E < 0 || E > p * r || !ordered ||
      ((place & kStateOnChip) == 0 && state == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (count_bytes(r) == 1) {
    return adaptive ? launch_cols<true, 1>(check_idx, check_coeff, col_ptr, col_rows, p, r, E,
                                           values_in, erased_in, budgets, values_out,
                                           erased_out, rounds_out, state, B, N, V, iters, place, s)
                    : launch_cols<false, 1>(check_idx, check_coeff, col_ptr, col_rows, p, r, E,
                                            values_in, erased_in, nullptr, values_out,
                                            erased_out, nullptr, state, B, N, V, iters, place, s);
  }
  return adaptive ? launch_cols<true, 2>(check_idx, check_coeff, col_ptr, col_rows, p, r, E,
                                         values_in, erased_in, budgets, values_out, erased_out,
                                         rounds_out, state, B, N, V, iters, place, s)
                  : launch_cols<false, 2>(check_idx, check_coeff, col_ptr, col_rows, p, r, E,
                                          values_in, erased_in, nullptr, values_out, erased_out,
                                          nullptr, state, B, N, V, iters, place, s);
}

const char* peel_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
