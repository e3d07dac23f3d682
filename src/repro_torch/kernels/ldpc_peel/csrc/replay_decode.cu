// Straight-line replay of pre-solved peeling schedules, B slots in one
// launch: each slot applies the resolving checks of its own erasure pattern,
// round by round, with no solvability counting and no convergence test.
//
// Replaces the JAX package's Pallas TPU kernel
//   src/repro/kernels/ldpc_peel/kernel.py:1428 decode_replay
//   (with _replay_kernel, :1379, and _replay_edge_sum, :1357)
// and its XLA replay executors, which it computes bit for bit:
//   src/repro/core/decoder.py:693 _replay_fixed_ops   (one pattern, "hi")
//   src/repro/core/decoder.py:736-763 _replay_batch_fixed_ops,
//   _replay_batch_adaptive_ops, via _replay_slot_lo    (B patterns, "lo").
// The tie-break rule is not the kernel's business: the packed schedule
// already names the winning check of every resolved coordinate, under
// "hi" for the single-pattern contracts and "lo" for the batched ones.
//
// What it computes.  Slot b's schedule holds R_b rounds; the slot applies
// the first min(budget_b, R_b) of them (none for a budget below 1).  Each
// entry of a round is one resolving check: on each payload column it
// gathers ALL r_max neighbours (its own target, still erased, with weight
// 0; sentinel slots, column N, read +0.0), forms every product with one
// rounded multiply, and sums them in slot order with the Neumaier
// compensation of the JAX package's _edge_sum (core/decoder.py:384):
//   s = p[0], c = +0; for each later term x: t = s + x,
//   c += |s| >= |x| ? (s - t) + x : (x - t) + s, s = t;  result s + c;
// every step a rounded __fadd_rn / __fsub_rn, never contracted (this file
// must not be built with --use_fast_math).  The entry's value is
// __fdiv_rn(-result, coeff == 0 ? 1 : coeff).  Reading the target's own
// erased value times 0 is what the executors do: NaN or inf there
// propagate exactly as they do in JAX.  After the round's barrier the
// results move to their targets (a target at or past N writes nowhere),
// and at the end the applied targets leave the erased set.  rounds[b] =
// max(0, min(budget_b, probe_b)): the adaptive decode's count, probe round
// included (core/decoder.py:635 _replay_rounds_used).
//
// Design.  The grid is (ceil(V / kCols), B): a block owns up to kCols
// payload columns of one slot and replays that slot's whole schedule; the
// blocks share nothing (the erased flags are written by the first column
// block of each slot).  A block finds its slot's entries and round
// offsets by summing the (entries, R + 1) of the slots before it in
// `meta`.  Per round: phase 1, every (entry, column) pair computes its
// value into a device scratch (E x V) from the round-start values; a
// barrier; phase 2, each pair moves its value to the target; a barrier.
// Targets within a round are distinct, and no entry reads another entry's
// target of the same round (that target is erased at the round's start, and
// a resolving check has exactly one erased neighbour, its own), so the two
// phases are the executors' gather-then-scatter.
//
// Bound on an H100 SXM (3.35 TB/s).  The replay must read the packed
// schedule once (E·r_max·8 + E·8 bytes and the offsets), and the values
// and masks in and out (8·B·N·V + 2·B·N bytes): for the recurring-pattern
// stream (N = 8192, one slot, about 2,000 entries of r_max 6) about
// 0.2 MB, 0.07 us.  Each round costs two block barriers and a chain of
// dependent gathers, and the launch itself some microseconds, so the
// kernel is latency-bound; a simple, correct replay comes first.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;

__device__ __forceinline__ size_t at(long long row, int col, int width) {
  return static_cast<size_t>(row) * static_cast<size_t>(width) + col;
}

__global__ void __launch_bounds__(kThreads)
replay_decode_kernel(const int* __restrict__ nidx, const float* __restrict__ w,
                     const float* __restrict__ coeff, const int* __restrict__ tgt,
                     const int* __restrict__ roff, const int* __restrict__ meta,
                     int r_max, const float* __restrict__ values_in,
                     const unsigned char* __restrict__ erased_in,
                     const int* __restrict__ budgets, int iters, float* values_out,
                     unsigned char* erased_out, int* rounds_out, float* scratch,
                     int N, int V) {
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCols;
  const int nc = min(kCols, V - c0);

  // Where this slot's entries and round offsets start.
  long long ebase = 0;
  int rbase = 0;
  for (int q = 0; q < b; ++q) {
    ebase += meta[3 * q];
    rbase += meta[3 * q + 1] + 1;
  }
  const int n_rounds = meta[3 * b + 1];
  const int probe = meta[3 * b + 2];
  const int budget = budgets != nullptr ? budgets[b] : iters;
  const int applied = max(0, min(budget, n_rounds));

  values_in += static_cast<size_t>(b) * N * V;
  values_out += static_cast<size_t>(b) * N * V;
  unsigned char* e_out = erased_out + static_cast<size_t>(b) * N;
  for (int it = tid; it < N * nc; it += blockDim.x) {
    const int j = it / nc, c = c0 + it % nc;
    values_out[at(j, c, V)] = values_in[at(j, c, V)];
  }
  if (blockIdx.x == 0) {
    const unsigned char* e_in = erased_in + static_cast<size_t>(b) * N;
    for (int j = tid; j < N; j += blockDim.x) e_out[j] = e_in[j] ? 1 : 0;
  }
  __syncthreads();

  for (int k = 0; k < applied; ++k) {
    const long long e0 = ebase + roff[rbase + k];
    const int n = roff[rbase + k + 1] - roff[rbase + k];

    // 1. every entry's value, from the round-start values.  (32-bit loop
    // indices: a 64-bit division is a call into a software routine.)
    for (int it = tid; it < n * nc; it += blockDim.x) {
      const long long ent = e0 + it / nc;
      const int c = c0 + it % nc;
      const int* ni = nidx + ent * r_max;
      const float* wi = w + ent * r_max;
      float s = 0.0f, comp = 0.0f;
      for (int q = 0; q < r_max; ++q) {
        const int j = ni[q];
        const bool in = j >= 0 && j < N;
        const float x = __fmul_rn(in ? values_out[at(j, c, V)] : 0.0f, wi[q]);
        if (q == 0) {
          s = x;
          continue;
        }
        const float t = __fadd_rn(s, x);
        const float d = fabsf(s) >= fabsf(x) ? __fadd_rn(__fsub_rn(s, t), x)
                                             : __fadd_rn(__fsub_rn(x, t), s);
        comp = __fadd_rn(comp, d);
        s = t;
      }
      const float cf = coeff[ent];
      scratch[at(ent, c, V)] = __fdiv_rn(-__fadd_rn(s, comp), cf == 0.0f ? 1.0f : cf);
    }
    __syncthreads();

    // 2. the round's values move to their targets.
    for (int it = tid; it < n * nc; it += blockDim.x) {
      const long long ent = e0 + it / nc;
      const int c = c0 + it % nc;
      const int t = tgt[ent];
      if (t >= 0 && t < N) values_out[at(t, c, V)] = scratch[at(ent, c, V)];
    }
    __syncthreads();
  }

  if (blockIdx.x == 0) {
    const long long e_end = ebase + roff[rbase + applied];
    for (long long ent = ebase + tid; ent < e_end; ent += blockDim.x) {
      const int t = tgt[ent];
      if (t >= 0 && t < N) e_out[t] = 0;
    }
    if (tid == 0) rounds_out[b] = max(0, min(budget, probe));
  }
}

}  // namespace

extern "C" {

// Launches the replay of B packed schedules on `stream`.  nidx / w
// (E, r_max) int32 / f32, coeff / tgt (E,) f32 / int32, roff the slots'
// local round offsets (R_b + 1 each, concatenated), meta (B, 3) int32
// (entries, rounds, probe) per slot.  values (B, N, V) f32, erased (B, N)
// bytes, scratch (max(E, 1), V) f32, rounds_out (B,) int32.  budgets (B,)
// int32 on the device, or null for `iters` rounds in every slot.  Returns
// cudaGetLastError() (0 = launched).
int replay_decode_launch(const int* nidx, const float* w, const float* coeff,
                         const int* tgt, const int* roff, const int* meta,
                         int r_max, const float* values_in,
                         const unsigned char* erased_in, const int* budgets,
                         int iters, float* values_out, unsigned char* erased_out,
                         int* rounds_out, float* scratch, int B, int N, int V,
                         void* stream) {
  if (B < 1 || N < 1 || V < 1 || r_max < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((V + kCols - 1) / kCols, B);
  replay_decode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nidx, w, coeff, tgt, roff, meta, r_max, values_in, erased_in, budgets, iters,
      values_out, erased_out, rounds_out, scratch, N, V);
  return static_cast<int>(cudaGetLastError());
}

const char* replay_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
