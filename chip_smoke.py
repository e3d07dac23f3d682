#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one CUDA card, end to end, and check it.

    python3 chip_smoke.py [--seed 0]

Phases, each printing its own lines:

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
   TF32 off for float32 matrix products and convolutions;
2. the build: every CUDA kernel of the port, compiled from this checkout's
   sources (one nvcc per source, started together);
3. each kernel against its plain PyTorch version, on the card, over the
   (40, 20) code and the (3, 6) code at K = 1024, seeds 0-2;
4. the paper's setting (examples/quickstart.py): m = 2048, k = 400, the
   (40, 20) code, D = 12, 10 stragglers, 60 steps; the CUDA decode's run
   (one launch per step) against the dense reference and the same problem
   in float64 on the same masks, the kernel against its plain version on
   every step's erased worker products, and the uncoded baseline;
5. full width: k = 32768, the (3, 6) code at K = 1024 (N = 2048, 32
   blocks), D = 8, 512 stragglers per step, m = 32768, 20 steps, with the
   problem built on the card from --seed.  The decode kernel's launch count
   over the run must equal the step count;
6. the batched and early-exit contracts of the decode kernel against their
   plain versions: the (40, 20) code and the (3, 6) code at K = 1024,
   Gaussian and ±1 weights, B in {1, 8, 64}, V in {1, 32}, erasure
   fractions {0, 0.25, 0.45}, mixed per-slot budgets including 0;
7. the adaptive step: Scheme 2 with adaptive=True and a round budget of 32
   at k = K = 1024, N = 2048, 512 stragglers a step, 20 steps; the adaptive
   kernel's launches must equal the steps, and each step's unresolved count
   and rounds equal the dense backend's on the same masks;
8. coded-query serving at full width (benchmarks/decoder_scaling.py
   run_serving_sweep): 320 queries, 15% heavy at q = 0.42 and the rest at
   q = 0.08, 64 slots, round budget 32, 4 rounds per launch, Scheme 2 at
   k = K = 1024, through CodedQueryBatcher in continuous and lockstep mode,
   once on the CUDA kernels and once on the dense backend: every query's
   accounting must be identical between the two, every gradient within an
   anchored bound of the dense run's, and the decode kernel's launches must
   equal the batcher's.  Prints queries/s, launches, slot-rounds, the
   kernel's ms per launch and the device's busy share.  Phases 5, 7, 8, 11
   and 15 print the table decode's time beside its byte bound, its column
   table's bytes (outside the bound) and its plain version's time, and the
   grid and state placement it launched (ops.table_layout);
9. the seeded kernels against their plain versions: the four seeded decode
   contracts on make_seeded_ldpc codes at N in {2048, 32768}, B in
   {1, 8, 64}, V in {1, 2}, erasure fractions {0, 0.25, 0.45}, mixed
   per-slot budgets including 0 — masks, rounds and values bit-identical to
   the plain version and to the table kernel on the same code's table; the
   seeded encode over row windows (from row 0, across K, past N),
   bit-identical to its plain version; and codes past the kernels' old caps
   of 16 (row weights 24, 40, 64 and 80, 20 and 32 layers), decode and
   encode, bit-identical to the plain versions;
10. Path B, the large-N seeded decode (launch/steps.py:238-255 at the
   dryrun's default K = 16384 under --seeded): N = 32768, V = 2, D = 8,
   erasure fractions {0.25, 0.45}, CodedComputeEngine(backend="auto") on
   make_seeded_ldpc and on the structure-only SeededLDPC, all four
   contracts, bit-identical to each other and to the plain versions; then
   the structure-only decode at N = 262144, V = 1, D = 8 (H would be
   128 GiB), exactly against its plain version; each kernel timed with
   the grid or cluster it launched, and every layout a pattern can take
   (one block, clusters of 2, 4 and 8) held bit for bit and timed;
11. Path A, Scheme 2 with the on-the-fly seeded LDGM encode
   (Scheme2.build_seeded(encode_fused=True)): k = K = 16384,
   make_seeded_ldgm(16384, 8192, row_weight=8) so N = 24576 workers, M
   (1 GiB) built on the card from m = 32768 samples, 2458 stragglers (10%)
   a step, D = 8, 20 steps of run_pgd.  The encode and decode kernels
   launch once a step each, and the run with encode_fused=False (the table
   gather) on the same masks is bit-identical.  Prints ms per step, the
   device's busy share and the encode against torch.sparse.mm; then the
   table decode at the step's shape (N = 24,576, V = 1, D = 8, step 1's
   stragglers) bit for bit against its plain version, timed beside it and
   its bound, with the layout it launched;
12. the replay kernel against its plain version: the (40, 20) code and the
   (3, 6) code at K = 256 with Gaussian and ±1 weights, the four contracts
   under their rules ("hi" for one pattern, "lo" for a batch), B in
   {1, 8, 64}, V in {1, 32}, erasure fractions {0, 0.25, 0.45}, mixed
   per-slot budgets including 0, NaN and inf in erased entries: values bit
   for bit (NaNs by position), masks and rounds exact, and masks and
   rounds equal to the flooding kernel's;
13. the recurring-straggler stream (benchmarks/decoder_scaling.py:672
   run_replay_sweep): make_parity_only_ldpc(4096) (N = 8192), 8 patterns
   at q = 0.25 cycled over 64 queries, budget 32, through
   CodedComputeEngine(backend="replay", adaptive=True) over a cold
   ScheduleCache: hit rate 0.875, replay launches equal to the decodes,
   masks and rounds equal to the "cuda" adaptive decode's; prints µs per
   query for both;
14. replay serving at phase 8's configuration (320 queries, 64 slots,
   budget 32) with rounds_per_launch = 32 and the batcher's own schedule
   cache, against the "cuda" batcher at the same chunk: accounting
   identical, gradients within the anchored bound, replay launches equal
   to the batcher's; prints queries/s of cold runs (every query brings a
   new pattern, as in phase 8);
15. the table decode at N = 49,152 and past shared memory:
   make_parity_only_ldpc(24576) (N = 49,152, state in shared memory), and
   its columns spread over the fewest columns whose state is past a
   block's shared memory (the stride from the state's size, held to the
   library's), all four contracts at both against the table plain
   version, bit for bit; prints the kernel's ms at both, its bound and
   plain time, and where each state went;
16. the flash-attention kernels against their plain version: f32 and
   bf16, G in {1, 2, 8}, Dh in {64, 128}, prefill Sq = Sk in {17, 512,
   2048} causal and not, decode Sq = 1 over T in {1, 2080, 4096}, a wrapped
   ring buffer with kv_valid (bf16 with Sq·G >= 64 on the tensor-core
   kernel, every decode on the split-KV decode kernel, at its rule's split
   count and at 1 and 5 splits, each launch twice and bit for bit, the
   rest on the SIMT one); the tensor-core kernel at S in
   {300, 2048}, G in {1, 2, 8}, Dh in {64, 128}, causal and not, and with
   queries before every key (the mean of v); then (Dh, Dv) in {(192, 128),
   (48, 32), (96, 96), (40, 24), (559, 64)}, G in {1, 2}, prefill S = 300
   and decode T = 2080; f32 within 4 units of 2^-23 max|v|, bf16 within
   one bf16 ulp of the output beyond that.  On every tensor-path case, a
   control: the plain version with p rounded once to bf16 (one p·v
   product) must fail that comparison, so p's three bf16 terms are
   checked.  Dh in {576, 1024} with Dv in
   {64, 512} (past the old cap of 559) held to the float64 run of the
   plain version: within twice the plain version's distance from it plus
   4 units of 2^-23 max|v|.  Every launch's path is counted and its key
   tiles equal the skip rule's plain version (ref.tiles_visited).  Holds
   the kernels to the same tolerance at Qwen3-1.7B's prefill (B = 4, 16
   heads over 8 KV heads, Dh = 128, S = 2048; bf16 on the tensor-core
   kernel, f32 on the SIMT one) and decode (T = 2080) shapes, and times
   them there beside the plain version, torch's
   scaled_dot_product_attention (a yardstick only; CUDA events) and the
   bound (the bytes, or q·kᵀ and p·v as 1 + 3 bf16 tensor-core products,
   whichever is larger; the bound of the f32 p·v design beside it); the
   decode in CUDA graphs (the card's time alone), in turns over 4 sets of
   K and V (136 MB, past L2) and on one set, and by split count;
17. Qwen3-1.7B at full width (configs/qwen3_1p7b.py: 28 layers, d_model
   2048, vocab 151,936), bf16, RANDOM weights from --seed (the repository
   holds none): prefill of 4 prompts of 2048 tokens into a cache of 2080,
   then 32 greedy decode steps, the flash kernel launched 28 x 33 times,
   the 28 prefill launches on the tensor-core kernel and the 28 x 32
   decode launches on the decode kernel, none on the SIMT one (the counts
   by path);
   the prefill and 4 steps again with the attention on the plain version
   and in f32 on the same weights, the kernel's logits within 2x the plain
   version's distance from the f32 logits plus 1e-3 max|logit|; then the
   WaveBatcher serving 8 requests of 16-64 prompt tokens (max_new 16) on 4
   slots.  Prints prefill and decode times and tokens/s, the kernel's share
   of a decode step and of a prefill, the device's busy share and the
   peak memory;
18. the GEMM (the moment encode of phases 4, 5, 7 and 8, one launch of the
   product kernel and two of the split pass each, counted): the split pass
   against its plain version bit for bit (special values, phase 5's G and
   M); the GEMM against its plain version and float64: the JAX sweep's
   shapes in f32 and bf16, (100, 37, 65) and (300, 1029, 257) in f32, bf16
   and mixed, and the encodes of phases 4, 5 (each of its 32 blocks) and
   7, within K·2^-24·(|A|·|B|) of float64, at most twice torch.matmul's
   distance, two runs bit for bit; the card tests' short-K sweep ((1, 1,
   1), (1, 17, 3), (1, 64, 3) and (4, 63, 5) over 40 seeds) under the same
   gates; NaN and inf where torch.matmul puts them; HGMMA and TMA loads in the built library's SASS; timed at phase
   5's block and over its whole encode beside torch.matmul, the bf16
   tensor-core bound and the old f32 one, the split pass and the product
   kernel apart, and coded_matvec at phase 5's worker products beside
   torch.bmm;
19. Scheme 1 in the paper's setting on phase 4's masks against the same
   problem's float64 Scheme 1 run (the bound of phase 4), M θ within
   κ·k·2^-24 of float64 on every step whose surviving rows have full
   column rank; then 5 steps at full width on phase 5's C_blocks and masks,
   with ms a step split into the worker products and the solve;
20. the check pass against its plain version, bit for bit (NaNs by
   position), over tests/test_kernels.py's grids and the (40, 20) and
   K = 1024 codes (Gaussian and ±1, erasure fractions {0, 0.25, 0.45}, NaN
   and inf in erased entries); then phase 5's decode as D launches of
   peel_round_cuda, its masks those of peel_decode(backend="cuda") and its
   values within the anchored bound; one launch timed beside its plain
   version and its byte bound.

Then, as the last three lines: the card's name and power limit, one JSON
object with each kernel's launches, error and times, and
``{"ok": true, "device": {...}}``.  Any failed check raises and exits
non-zero.  Without a CUDA card, or without the rest of the repository
beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12                  # f32 outside the tensor cores, same sheet
BF16_FLOPS = 989e12                # bf16 tensor cores, dense, same sheet
# The f32 product's work in bf16 tensor-core products, for the GEMM's bound:
# three bf16 terms a side and every pair but the smallest, what an
# f32-accurate product takes on those cores; fixed across designs.
GEMM_BOUND_PRODUCTS = 8


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls, after
    two warm-up calls, from CUDA events."""
    for _ in range(2):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fns, per: int = 20, reps: int = 5) -> float:
    """Mean milliseconds a call of the card's work of ``fns`` (one callable
    per input set, taken in turns): ``per`` rounds of them captured in one
    CUDA graph and replayed ``reps`` times, timed by CUDA events, so the
    card runs them back to back and no host time enters."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up (workspaces, the libraries' state)
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(per):
            for fn in fns:
                fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (reps * per * len(fns))
    del graph
    return ms


def profile_steps(scheme, theta, masks, step_ms: float, n: int = 3) -> None:
    """Print the device time per step of the five busiest kernels over
    ``n`` steps (torch.profiler), and the device's busy share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            scheme.step(theta, masks[i])
        torch.cuda.synchronize()
    # kernels only: CPU ops also carry their kernels' device time, and
    # "Activity Buffer Request" is the profiler's own bookkeeping
    rows = [(ev.key, ev.self_device_time_total / 1e3 / n)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
            and not ev.key.startswith("Activity Buffer")]
    if not rows:
        print("[profile] the profiler recorded no device time")
        return
    rows.sort(key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in rows)
    print(f"[profile] device busy {busy:.4f} ms per step of {step_ms:.4f} ms "
          f"({100 * busy / step_ms:.1f}%), by kernel:")
    for name, ms in rows[:5]:
        print(f"[profile]   {ms:.4f} ms  {name[:100]}")


def device_busy(fn):
    """One call of ``fn()`` under torch.profiler: (wall ms by host clock
    after a synchronize, device-busy ms summed over kernels, [(kernel,
    ms)] busiest first, the number of kernels the device ran)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
           and not ev.key.startswith("Activity Buffer")]
    rows = sorted(((ev.key, ev.self_device_time_total / 1e3) for ev in evs),
                  key=lambda kv: -kv[1])
    return wall, sum(ms for _, ms in rows), rows, sum(ev.count for ev in evs)


def decode_bytes(p: int, r: int, B: int, N: int, V: int, extra: int = 0) -> int:
    """Bytes a decode must move once: the neighbour table (int32 columns and
    f32 weights), values in and out (f32), masks in and out (one byte each),
    and ``extra`` (budgets in, rounds out)."""
    return p * r * 8 + 2 * B * N * V * 4 + 2 * B * N + extra


def seeded_dispatch(st, B: int, V: int) -> str:
    """The grid the seeded decode launches for B patterns of V payload
    columns and where its per-block state lives (the wrapper's dispatch by
    shape, ``ops.seeded_layout``)."""
    from repro_torch.kernels.ldpc_peel import ops
    C, in_shared = ops.seeded_layout(st, B, V, torch.device("cuda"))
    grid = f"grid ({C * -(-V // 4)}, {B}) of 512-thread blocks"
    return (f"{grid} in clusters of {C}" if C > 1 else f"{grid}, one a pattern") + \
        f", state in {'shared' if in_shared else 'device'} memory"


def table_dispatch(tables, B: int, V: int) -> str:
    """The grid the table decode launches for B patterns of V payload
    columns, where its per-block state lives (the wrapper's dispatch by
    shape, ``ops.table_layout``), and its column table's bytes (this
    design's own cost, outside the bound)."""
    from repro_torch.kernels.ldpc_peel import ops
    lay = ops.table_layout(tables, B, V)
    col_ptr, col_rows = ops._column_table(tables.check_idx, tables.N)
    where = {True: "shared", False: "device"}
    return (f"grid {lay.grid} of 512-thread blocks, one a pattern and 4 payload columns, "
            f"in {where[lay.state]} memory the state, in {where[lay.values]} memory the "
            f"values, in {where[lay.tables]} memory the tables; column table "
            f"{(col_ptr.numel() + col_rows.numel()) * 4} B (outside the bound)")


def same_bits(a, b) -> bool:
    """Equal bit for bit: float tensors compared as their bit patterns
    (signed zeros and NaNs included), other tensors and numbers by value."""
    if not isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor):
        return type(a) is type(b) and a == b
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def same_bits_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, every NaN compared by position only: which input
    NaN an operation on two NaNs returns is the implementation's choice
    (IEEE 754)."""
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and same_bits(torch.where(nan, 0.0, a), torch.where(nan, 0.0, b)))


def all_same(xs, ys) -> bool:
    return len(xs) == len(ys) and all(same_bits(x, y) for x, y in zip(xs, ys))


def values_agree(weights: str, v, e, truth, kv, ke, pv, pe, dense64) -> float:
    """Kernel ``(kv, ke)`` against plain ``(pv, pe)`` on batched inputs
    ``v (B, N, V)`` / ``e (B, N)``: masks exact, unresolved entries
    untouched, values bit-exact on ±1 codes; on Gaussian codes, per slot,
    within 1e-4*max|c| + 4*max(|plain - c|, |dec64 - c|) over the resolved
    coordinates, with ``dense64()`` the float64 dense decode of the same
    inputs (called only when the plain version's own error does not cover
    the difference).  Returns max |kernel - plain|."""
    check(torch.equal(ke, pe), "kernel and plain masks differ")
    resolved = e & ~pe
    check(torch.equal(kv[~resolved], v[~resolved]), "unresolved values changed")
    err = float((kv - pv).abs().max()) if kv.numel() else 0.0
    if weights == "pm1":
        check(err == 0.0, f"pm1 values differ by {err}")
        return err
    d64 = None
    for b in range(v.shape[0]):
        res = resolved[b]
        if not bool(res.any()):
            continue
        diff = float((kv[b] - pv[b]).abs().max())
        scale = float(truth[b].abs().max())
        anchor = float((pv[b] - truth[b]).abs()[res].max())
        if diff > 1e-4 * scale + 4 * anchor:
            d64 = dense64() if d64 is None else d64
            anchor = max(anchor, float((d64[b] - truth[b].double()).abs()[res].max()))
        check(diff <= 1e-4 * scale + 4 * anchor,
              f"slot {b}: kernel vs plain {diff} > 1e-4*{scale} + 4*{anchor}")
    return err



def flash_phase(dev: torch.device, seed: int) -> dict:
    """Phase 16: the flash kernels against their plain version over the grid
    of the module docstring, every launch's key tiles against the skip
    rule's plain version, then timed at Qwen3-1.7B's prefill and decode
    shapes.  Returns the numbers of the kernels line."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import (forced_splits, kernel_path, sm_count,
                                                         split_count, tile_count)
    from repro_torch.kernels.flash_attention.ref import bf16_ulp, tiles_visited
    gen = torch.Generator(device=dev).manual_seed(seed + 16)
    f32_ulps = 4
    paths = {"tensor": 0, "decode": 0, "simt": 0}
    n_tiles = 0
    splits_seen: set[int] = set()

    def inputs(B, Sq, T, KV, G, Dh, dtype, Dv=None):
        q = torch.randn((B, Sq, KV, G, Dh), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, T, KV, Dh), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, T, KV, Dh if Dv is None else Dv), generator=gen,
                        device=dev).to(dtype)
        return q, k, v

    def by_path() -> tuple[int, ...]:
        return tuple(getattr(flash_attention_cuda, f"launches_{p}") for p in paths)

    def kernel(q, k, v, q_pos, kv_pos, what, causal=True, kv_valid=None, splits=None):
        """One launch, its path counted and its key tiles held to the rule; on
        the decode kernel a second launch, bit for bit the first."""
        nonlocal n_tiles
        path = kernel_path(q, k, v, kv_pos, kv_valid)
        B, _, KV, G, Dh = q.shape
        n_split = splits or split_count(k.shape[1], B, KV, sm_count(dev))
        forced = forced_splits(splits) if splits else contextlib.nullcontext()
        before = by_path()
        with forced, tile_count(dev) as tiles:
            got = flash_attention_cuda(q, k, v, q_pos, kv_pos, causal=causal, kv_valid=kv_valid)
        torch.cuda.synchronize()
        check(tuple(a - b for a, b in zip(by_path(), before)) ==
              tuple(int(p == path) for p in paths),
              f"{what}: the launch went elsewhere than the {path} kernel")
        want = tiles_visited(q_pos, kv_pos, B=B, KV=KV, G=G, Dh=Dh, Dv=v.shape[3], path=path,
                             causal=causal, kv_valid=kv_valid, splits=n_split)
        check(int(tiles) == want, f"{what}: {int(tiles)} key tiles visited, the rule keeps {want}")
        paths[path] += 1
        n_tiles += want
        if path == "decode":
            with forced_splits(n_split):
                again = flash_attention_cuda(q, k, v, q_pos, kv_pos, causal=causal,
                                             kv_valid=kv_valid)
            check(same_bits(got.view(torch.int16) if got.dtype == torch.bfloat16 else got,
                            again.view(torch.int16) if got.dtype == torch.bfloat16 else again),
                  f"{what}: two runs of the decode kernel differ")
            splits_seen.add(n_split)
        return got

    def within(got, want, v) -> torch.Tensor:
        """Per output: within 4 units of 2^-23 max|v| of want (f32), and one
        bf16 ulp of the output beyond that (bf16)."""
        err = (got.float() - want.float()).abs()
        tol = f32_ulps * 2.0 ** -23 * float(v.float().abs().max())
        if v.dtype == torch.bfloat16:
            return err <= bf16_ulp(torch.maximum(got.float().abs(), want.float().abs())) + tol
        return err <= tol

    def held(got, want, v, what) -> float:
        check(got.dtype == want.dtype == v.dtype and got.shape == want.shape,
              f"{what}: output {got.dtype} {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        check(bool(within(got, want, v).all()),
              f"{what}: " + ("beyond one bf16 ulp" if v.dtype == torch.bfloat16 else
                             f"{err:.3e} > {f32_ulps} units of 2^-23 max|v|"))
        return err

    # The control for the tensor path's p·v: the plain version with p rounded
    # once to bf16 (one product, as scaled_dot_product_attention takes it),
    # which the same comparison must reject wherever the kernel is held, so a
    # kernel that dropped p's two lower bf16 terms would fail.
    control = {"cases": 0, "beyond": 1.0, "apart": 1.0, "kernel_apart": 0.0}

    def one_term_rejected(got, want, q, k, v, q_pos, kv_pos, what, causal=True) -> tuple:
        one = attention_ref(q, k, v, q_pos, kv_pos, causal=causal, p_terms=1)
        beyond = float((~within(one, want, v)).float().mean())
        check(beyond > 0, f"{what}: p rounded once to bf16 is held as well; the comparison "
                          f"cannot tell it from the kernel's three terms")
        control["cases"] += 1
        control["beyond"] = min(control["beyond"], beyond)
        control["apart"] = min(control["apart"], float((one != want).float().mean()))
        kernel_apart = float((got != want).float().mean())
        control["kernel_apart"] = max(control["kernel_apart"], kernel_apart)
        return beyond, float((one != want).float().mean()), kernel_apart

    t0 = time.perf_counter()
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    dec_err = 0.0
    imax = torch.iinfo(torch.int32).max
    for dtype in errs:
        for G in (1, 2, 8):
            for Dh in (64, 128):
                for S in (17, 512, 2048):
                    q, k, v = inputs(1, S, S, 2, G, Dh, dtype)
                    pos = torch.arange(S, dtype=torch.int32, device=dev)
                    for causal in (True, False):
                        what = f"prefill {dtype} G={G} Dh={Dh} S={S} causal={causal}"
                        got = kernel(q, k, v, pos, pos, what, causal=causal)
                        want = attention_ref(q, k, v, pos, pos, causal=causal)
                        torch.cuda.synchronize()
                        errs[dtype] = max(errs[dtype], held(got, want, v, what))
                        n += 1
                for T in (1, 2080, 4096):
                    q, k, v = inputs(2, 1, T, 2, G, Dh, dtype)
                    kv_pos = torch.arange(T, dtype=torch.int32, device=dev)
                    q_pos = torch.full((1,), T - 1, dtype=torch.int32, device=dev)
                    cases = [(kv_pos, kv_pos <= T - 1)]
                    if T > 1:      # a wrapped ring buffer with two empty slots
                        ring = torch.roll(kv_pos + 7, 611).to(torch.int32)
                        ring[[3, T // 2]] = imax
                        cases.append((ring, ring <= T + 6))
                    check(kernel_path(q, k, v) == "decode", f"decode G={G} Dh={Dh}: not the "
                          f"decode kernel")
                    for kvp, valid in cases:
                        qp = q_pos + (7 if kvp is not kv_pos else 0)
                        # the rule's split count, and 1 and 5 splits forced
                        for splits in (None, 1, 5):
                            what = f"decode {dtype} G={G} Dh={Dh} T={T} splits={splits}"
                            got = kernel(q, k, v, qp, kvp, what, kv_valid=valid, splits=splits)
                            want = attention_ref(q, k, v, qp, kvp, kv_valid=valid)
                            torch.cuda.synchronize()
                            err = held(got, want, v, what)
                            errs[dtype] = max(errs[dtype], err)
                            dec_err = max(dec_err, err)
                            n += 1
    print(f"[flash] {n} cases (f32 and bf16; G in (1, 2, 8); Dh in (64, 128); prefill "
          f"S in (17, 512, 2048) causal and not; decode T in (1, 2080, 4096) on the decode "
          f"kernel at the rule's split count and at 1 and 5, each launch twice, bit for bit; "
          f"wrapped rings with kv_valid): max |kernel - plain| f32 {errs[torch.float32]:.3e}, "
          f"bf16 {errs[torch.bfloat16]:.3e} (decode {dec_err:.3e}), within 4 units of 2^-23 "
          f"max|v| (f32) and one bf16 ulp beyond it (bf16); launches by path {paths}; splits "
          f"by the rule on {sm_count(dev)} SMs: {sorted(splits_seen)} "
          f"({time.perf_counter() - t0:.1f} s)")

    # The tensor-core kernel past one tile and at the model's length: bf16,
    # S in (300, 2048), causal and not; then rows before every key on it.
    t0 = time.perf_counter()
    n_tc, tc_err = 0, 0.0
    for G in (1, 2, 8):
        for Dh in (64, 128):
            for S in (300, 2048):
                q, k, v = inputs(2, S, S, 2, G, Dh, torch.bfloat16)
                pos = torch.arange(S, dtype=torch.int32, device=dev)
                check(kernel_path(q, k, v) == "tensor", f"S={S} G={G}: not the tensor path")
                for causal in (True, False):
                    what = f"tensor path G={G} Dh={Dh} S={S} causal={causal}"
                    got = kernel(q, k, v, pos, pos, what, causal=causal)
                    want = attention_ref(q, k, v, pos, pos, causal=causal)
                    torch.cuda.synchronize()
                    tc_err = max(tc_err, held(got, want, v, what))
                    one_term_rejected(got, want, q, k, v, pos, pos, what, causal=causal)
                    n_tc += 1
    for G in (1, 8):
        Sq, T = 70, 200                   # the first three queries before every key
        q, k, v = inputs(1, Sq, T, 2, G, 128, torch.bfloat16)
        q_pos = torch.arange(-3, Sq - 3, dtype=torch.int32, device=dev) * 3
        kv_pos = torch.arange(T, dtype=torch.int32, device=dev)
        what = f"tensor path, rows before every key, G={G}"
        check(kernel_path(q, k, v) == "tensor", f"{what}: not the tensor path")
        got = kernel(q, k, v, q_pos, kv_pos, what)
        want = attention_ref(q, k, v, q_pos, kv_pos)
        torch.cuda.synchronize()
        tc_err = max(tc_err, held(got, want, v, what))
        one_term_rejected(got, want, q, k, v, q_pos, kv_pos, what)
        mean = v.float().mean(1)[0]       # (KV, Dv)
        check(all(bool(torch.allclose(got[0, i, :, g].float(), mean,
                                      atol=float(bf16_ulp(mean).max())))
                  for i in range(3) for g in range(G)), f"{what}: not the mean of v")
        n_tc += 1
    errs[torch.bfloat16] = max(errs[torch.bfloat16], tc_err)
    print(f"[flash] {n_tc} tensor-path cases (bf16; G in (1, 2, 8); Dh in (64, 128); S in "
          f"(300, 2048) causal and not; queries before every key, G in (1, 8), the mean of v): "
          f"max |kernel - plain| {tc_err:.3e}, within one bf16 ulp beyond 4 units of 2^-23 "
          f"max|v| ({time.perf_counter() - t0:.1f} s)")
    print(f"[flash] control: the plain version with p rounded once to bf16 (one p·v "
          f"product) is rejected by the same comparison in all {control['cases']} "
          f"tensor-path cases, beyond it at a share of the outputs of at least "
          f"{control['beyond']:.4f}, its bf16 values apart from the plain version's at "
          f"{control['apart']:.4f} or more; the kernel's apart at most "
          f"{control['kernel_apart']:.4f}")

    # Head dimensions off the dense family's: Dv apart from Dh (MLA's 192 / 128
    # at deepseek-v2's width, 48 / 32 reduced), odd Dh, and 559, the largest
    # Dh before the q·k columns were staged in chunks; the generic path.
    t0 = time.perf_counter()
    n_dims = 0
    dims = ((192, 128), (48, 32), (96, 96), (40, 24), (559, 64))
    for dtype in (torch.float32, torch.bfloat16):
        for Dh, Dv in dims:
            for G in (1, 2):
                for Sq, T in ((300, 300), (1, 2080)):
                    q, k, v = inputs(1, Sq, T, 2, G, Dh, dtype, Dv=Dv)
                    kv_pos = torch.arange(T, dtype=torch.int32, device=dev)
                    q_pos = kv_pos[T - Sq:].contiguous()
                    what = f"{dtype} Dh={Dh} Dv={Dv} G={G} Sq={Sq} T={T}"
                    got = kernel(q, k, v, q_pos, kv_pos, what)
                    want = attention_ref(q, k, v, q_pos, kv_pos)
                    torch.cuda.synchronize()
                    errs[dtype] = max(errs[dtype], held(got, want, v, what))
                    n_dims += 1
    print(f"[flash] {n_dims} cases at other head dimensions ((Dh, Dv) in {dims}; G in (1, 2); "
          f"prefill S = 300 and decode T = 2080; f32 and bf16), same tolerances: max |kernel - "
          f"plain| f32 {errs[torch.float32]:.3e}, bf16 {errs[torch.bfloat16]:.3e} "
          f"({time.perf_counter() - t0:.1f} s)")

    # Past the old cap: Dh = 576 (MLA's absorbed q·k width) and 1024, held to
    # the float64 run of the plain version on the same inputs: the kernel
    # within twice the plain version's distance from it plus 4 units of
    # 2^-23 max|v| (and one bf16 ulp of the output for bf16).
    t0 = time.perf_counter()
    wide = []
    for dtype in (torch.float32, torch.bfloat16):
        for Dh in (576, 1024):
            for Dv in (64, 512):
                for Sq, T in ((37, 37), (1, 300)):
                    q, k, v = inputs(2, Sq, T, 2, 2, Dh, dtype, Dv=Dv)
                    kv_pos = torch.arange(T, dtype=torch.int32, device=dev)
                    q_pos = kv_pos[T - Sq:].contiguous()
                    what = f"{dtype} Dh={Dh} Dv={Dv} Sq={Sq} T={T}"
                    got = kernel(q, k, v, q_pos, kv_pos, what)
                    want = attention_ref(q, k, v, q_pos, kv_pos)
                    exact = attention_ref(q.double(), k.double(), v.double(), q_pos, kv_pos)
                    torch.cuda.synchronize()
                    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
                          f"{what}: output {tuple(got.shape)}, or non-finite")
                    kd = (got.double() - exact).abs()
                    pd = float((want.double() - exact).abs().max())
                    tol = 2 * pd + f32_ulps * 2.0 ** -23 * float(v.float().abs().max())
                    if dtype == torch.bfloat16:
                        ok = bool((kd <= bf16_ulp(got.float()).double() + tol).all())
                    else:
                        ok = float(kd.max()) <= tol
                    check(ok, f"{what}: {float(kd.max()):.3e} from float64, plain {pd:.3e}")
                    wide.append(f"{str(dtype)[6:]} Dh={Dh} Dv={Dv} Sq={Sq}: "
                                f"{float(kd.max()):.3e} / {pd:.3e}")
    print(f"[flash] {len(wide)} cases past the old q·k cap of 559 (Dh in (576, 1024), Dv in "
          f"(64, 512), prefill Sq = 37 and decode T = 300, f32 and bf16), held to float64 "
          f"(kernel within 2 x the plain version's distance + 4 units of 2^-23 max|v|); "
          f"|kernel - f64| / |plain - f64|: {'; '.join(wide)} ({time.perf_counter() - t0:.1f} s)")
    print(f"[flash] every launch above: launches by path {paths}, {n_tiles} key tiles visited, "
          f"each launch's count equal to the skip rule's plain version (ref.tiles_visited)")

    # Timing at Qwen3-1.7B's shapes: the bf16 prefill (the tensor path) and
    # decode (the decode path), and the f32 prefill (the SIMT path), each
    # first held against the plain version as the grid above is.  The decode
    # reads 34 MB of K and V, which L2 (50 MB) would hold: it is timed in
    # turns over 4 sets of inputs (136 MB; each layer of the model has its
    # own cache), and on one set beside it.
    B, KV, G, Dh = 4, 8, 2, 128
    H = KV * G
    out = {"max_abs_err": max(errs.values()), "decode_max_abs_err": dec_err}
    for shape, Sq, T, dtype in (("prefill", 2048, 2048, torch.bfloat16),
                                ("decode", 1, 2080, torch.bfloat16),
                                ("simt_prefill", 2048, 2048, torch.float32)):
        q, k, v = inputs(B, Sq, T, KV, G, Dh, dtype)
        kv_pos = torch.arange(T, dtype=torch.int32, device=dev)
        q_pos = kv_pos[T - Sq:].contiguous()
        valid = None if Sq > 1 else kv_pos <= T - 1
        path = kernel_path(q, k, v)
        kern = lambda: flash_attention_cuda(q, k, v, q_pos, kv_pos, kv_valid=valid)  # noqa: E731
        plain = lambda: attention_ref(q, k, v, q_pos, kv_pos, kv_valid=valid)  # noqa: E731
        qh = q.reshape(B, Sq, H, Dh).transpose(1, 2).contiguous()
        kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        causal = Sq > 1                    # decode: every key is visible
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, is_causal=causal, enable_gqa=True)
        what = f"{shape} at Qwen3-1.7B's shapes (B={B} H={H} KV={KV} Dh={Dh} Sq={Sq} T={T})"
        mine = kernel(q, k, v, q_pos, kv_pos, what, kv_valid=valid)
        want, ref_lib = plain(), library()
        torch.cuda.synchronize()
        err = held(mine, want, v, what)
        if path == "tensor":
            beyond, apart, kernel_apart = one_term_rejected(mine, want, q, k, v, q_pos,
                                                            kv_pos, what)
            print(f"[flash] control at the {shape} shape: p rounded once to bf16 beyond the "
                  f"comparison at a share {beyond:.4f} of the outputs, apart from the plain "
                  f"version's bf16 values at {apart:.4f}; the kernel held, apart at "
                  f"{kernel_apart:.4f}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        lib_err = float((ref_lib.transpose(1, 2).reshape(mine.shape).float()
                         - mine.float()).abs().max())
        check(lib_err <= 0.1 * float(mine.float().abs().max()),
              f"{shape}: the library call computes another function ({lib_err:.3e} away)")
        del want, ref_lib
        warm = {}
        if path == "decode":
            sets = [(q, k, v)] + [inputs(B, Sq, T, KV, G, Dh, dtype) for _ in range(3)]
            lsets = [(x.reshape(B, Sq, H, Dh).transpose(1, 2).contiguous(),
                      y.transpose(1, 2).contiguous(), z.transpose(1, 2).contiguous())
                     for x, y, z in sets]
            kfns = [lambda x=x: flash_attention_cuda(*x, q_pos, kv_pos, kv_valid=valid)
                    for x in sets]
            lfns = [lambda x=x: F.scaled_dot_product_attention(*x, is_causal=False,
                                                               enable_gqa=True)
                    for x in lsets]
            pfns = [lambda x=x: attention_ref(*x, q_pos, kv_pos, kv_valid=valid) for x in sets]

            def in_turns(fns, reps):         # eager, CUDA events (the plain version is not
                return cuda_ms(lambda: [fn() for fn in fns], reps) / len(fns)   # capturable)

            # the kernel, SDPA, SDPA, the kernel (in graphs); the plain version eagerly
            ms, lib_ms = graph_ms(kfns), graph_ms(lfns)
            lib_ms, ms = (lib_ms + graph_ms(lfns)) / 2, (ms + graph_ms(kfns)) / 2
            plain_ms = in_turns(pfns, 10)
            warm = {"warm_ms": graph_ms(kfns[:1], per=80), "library_warm_ms":
                    graph_ms(lfns[:1], per=80), "plain_warm_ms": cuda_ms(pfns[0], 20),
                    "eager_ms": in_turns(kfns, 50), "library_eager_ms": in_turns(lfns, 50)}
            sweep = {}
            for n in (1, 2, 4, 6, 9, 12, 18):
                with forced_splits(n):
                    sweep[n] = graph_ms(kfns)
            rule = split_count(T, B, KV, sm_count(dev))
            print(f"[flash] decode at Qwen3-1.7B's shape in CUDA graphs, in turns over 4 sets "
                  f"of K and V (136 MB, past L2) / on one set (L2-warm): the kernel "
                  f"{ms:.4f} / {warm['warm_ms']:.4f} ms ({rule} splits, the rule's on "
                  f"{sm_count(dev)} SMs), scaled_dot_product_attention {lib_ms:.4f} / "
                  f"{warm['library_warm_ms']:.4f} ms; the plain version (eager) "
                  f"{plain_ms:.4f} / {warm['plain_warm_ms']:.4f} ms; eager calls, host time "
                  f"included: the kernel {warm['eager_ms']:.4f}, SDPA "
                  f"{warm['library_eager_ms']:.4f} ms")
            print("[flash] decode by split count (4 sets, graphs): " +
                  ", ".join(f"{n}: {t:.4f} ms" for n, t in sweep.items()))
            del sets, lsets, kfns, lfns, pfns
        else:
            ms = cuda_ms(kern, 20)
            plain_ms = cuda_ms(plain, 3)
            lib_ms = cuda_ms(library, 20)
        pairs = int((kv_pos[None, :] <= q_pos[:, None]).sum())     # visible, per head
        flops = 2 * B * H * Dh * pairs                 # one product, 2 FLOP an FMA
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, mine, q_pos, kv_pos))
        nbytes += 0 if valid is None else valid.numel()
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # The same f32-accurate work at the least: on bf16 inputs q·kᵀ is one
        # bf16 tensor-core product and p·v three (p split into three bf16
        # terms, v exact); on f32 inputs both products run at the f32 rate.
        # The old bound, of the f32 design, took p·v at the f32 rate beside q·kᵀ on the
        # tensor cores.
        if dtype == torch.bfloat16:
            ops_ms = 4 * flops / BF16_FLOPS * 1e3
        else:
            ops_ms = 2 * flops / F32_FLOPS * 1e3
        old_ms = max(bytes_ms, (flops / BF16_FLOPS + flops / F32_FLOPS) * 1e3)
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        print(f"[flash] {shape} B={B} H={H} KV={KV} Dh={Dh} Sq={Sq} T={T} {str(dtype)[6:]} on "
              f"the {path} kernel: {ms:.4f} ms ({err:.3e} from the plain version, within the "
              f"grid's tolerance), plain version {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention {lib_ms:.4f} ms (enable_gqa, CUDA events; "
              f"{lib_err:.2e} from the kernel; it rounds p to bf16 for one p·v product, so it "
              f"may run under the bound); bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B at "
              f"3.35 TB/s = {bytes_ms:.4f} ms; {flops} FLOP a product, "
              + ("q·kᵀ and p·v as 1 + 3 bf16 tensor-core products at 989 TFLOP/s"
                 if dtype == torch.bfloat16 else "q·kᵀ and p·v at the f32 67 TFLOP/s")
              + f" = {ops_ms:.4f} ms); the old bound (p·v at the f32 rate) "
              f"{old_ms:.4f} ms")
        out[shape] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "old_bound_ms": old_ms,
                      "path": path, **warm}
    return out


def model_phase(dev: torch.device, seed: int, reset_counts, read_counts) -> dict:
    """Phase 17: Qwen3-1.7B at full width in bf16 on random weights."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda, plain_version
    from repro_torch.models import Model
    from repro_torch.serving import Request, WaveBatcher

    cfg = get_config("qwen3-1.7b")
    held_before = torch.cuda.memory_allocated()     # what earlier phases still hold
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed + 17))
    torch.cuda.synchronize()
    n_params = model.param_count()
    print(f"[model] {cfg.name} at full width ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, head_dim {cfg.hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}), {cfg.dtype}: {n_params} parameters, RANDOM "
          f"weights from --seed (the repository holds none), built in "
          f"{time.perf_counter() - t0:.1f} s")
    B, S, steps, cmp_steps = 4, 2048, 32, 4
    g = torch.Generator(device=dev).manual_seed(seed + 170)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)
    warm = model.init_cache(B, 64)                      # cuBLAS handles, allocator
    wl, warm = model.prefill({"tokens": tokens[:, :32]}, warm)
    model.decode_step(wl[:, -1].argmax(-1)[:, None], 32, warm)
    torch.cuda.synchronize()
    del warm, wl

    torch.cuda.reset_peak_memory_stats()
    cache = model.init_cache(B, S + steps)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": tokens}, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    fed = [logits[:, -1].argmax(-1)[:, None]]
    kernel_logits = [logits]
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = model.decode_step(fed[-1], S + i, cache)
        if i < cmp_steps:
            kernel_logits.append(logits)
        fed.append(logits[:, -1].argmax(-1)[:, None])
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = read_counts("full-width serving", flash_call=cfg.n_layers * (1 + steps))
    by_path = (flash_attention_cuda.launches_tensor, flash_attention_cuda.launches_decode,
               flash_attention_cuda.launches_simt)
    check(by_path == (cfg.n_layers, cfg.n_layers * steps, 0),
          f"flash launches by path (tensor, decode, simt) {by_path}: want the prefill's "
          f"{cfg.n_layers} on the tensor kernel, the decode's {cfg.n_layers * steps} on the "
          f"decode kernel and none on the SIMT one")
    peak = torch.cuda.max_memory_allocated() - held_before
    check(all(bool(torch.isfinite(x).all()) for x in kernel_logits), "non-finite logits")
    print(f"[model] prefill {B} x {S} tokens: {prefill_ms:.1f} ms ({B * S / prefill_ms * 1e3:.0f} "
          f"tokens/s); {steps} greedy decode steps: {decode_ms:.3f} ms a step "
          f"({B / decode_ms * 1e3:.1f} tokens/s); flash kernel launches {counts['flash_call']} "
          f"= {cfg.n_layers} x (1 + {steps}), by path: {by_path[0]} on the tensor kernel "
          f"(the prefill), {by_path[1]} on the decode kernel, {by_path[2]} on the SIMT one; "
          f"peak device memory of "
          f"the model, its cache and the run {peak / 2**30:.2f} GiB (host clock after a "
          f"synchronize)")

    # The kernel's share of a decode step and the device's busy share, over
    # two steps that rewrite the last two positions; then one prefill.
    def is_flash(name: str) -> bool:
        return any(f"flash_{k}_kernel" in name for k in ("tc", "decode", "simt"))

    wall, busy, rows, n_kernels = device_busy(
        lambda: [model.decode_step(fed[i], S + i, cache) for i in (steps - 2, steps - 1)])
    flash_dev = sum(ms for name, ms in rows if is_flash(name))
    print(f"[model] two decode steps under the profiler: {wall:.3f} ms wall, device busy "
          f"{busy:.3f} ms ({100 * busy / wall:.1f}%), the flash kernel {flash_dev:.3f} ms "
          f"({100 * flash_dev / max(busy, 1e-9):.1f}% of the busy time); {n_kernels // 2} "
          f"kernels a step ({n_kernels / 2 / cfg.n_layers:.1f} a layer); busiest:")
    for name, ms in rows[:4]:
        print(f"[model]   {ms / 2:.4f} ms a step  {name[:90]}")
    del cache
    wall, busy, rows, n_kernels = device_busy(
        lambda: model.prefill({"tokens": tokens}, model.init_cache(B, S + steps)))
    flash_dev = sum(ms for name, ms in rows if is_flash(name))
    print(f"[model] one prefill under the profiler: {wall:.3f} ms wall, device busy {busy:.3f} "
          f"ms ({100 * busy / wall:.1f}%), the flash kernel {flash_dev:.3f} ms "
          f"({100 * flash_dev / max(busy, 1e-9):.1f}% of the busy time); {n_kernels} kernels; "
          f"busiest:")
    for name, ms in rows[:5]:
        print(f"[model]   {ms:.4f} ms  {name[:90]}")

    # The same prefill and first steps with the attention on the plain
    # version, and in f32 on the same weights, fed the same tokens.
    def rerun(m, route_plain: bool) -> list[torch.Tensor]:
        c = m.init_cache(B, S + cmp_steps)
        with (plain_version() if route_plain else contextlib.nullcontext()):
            out, c = m.prefill({"tokens": tokens}, c)
            outs = [out]
            for i in range(cmp_steps):
                out, c = m.decode_step(fed[i], S + i, c)
                outs.append(out)
        torch.cuda.synchronize()
        return outs

    before = flash_attention_cuda.launches
    plain_logits = rerun(model, True)
    check(flash_attention_cuda.launches == before, "the plain run launched the kernel")
    m32 = Model(dataclasses.replace(cfg, dtype="float32"), device=dev)
    m32.load_state_dict(model.state_dict())
    f32_logits = rerun(m32, False)
    del m32
    scale = max(float(x.abs().max()) for x in f32_logits)
    kd = max(float((a - b).abs().max()) for a, b in zip(kernel_logits, f32_logits))
    pd = max(float((a - b).abs().max()) for a, b in zip(plain_logits, f32_logits))
    tol = 2 * pd + 1e-3 * scale
    check(kd <= tol, f"kernel logits {kd:.4e} from the f32 run, beyond 2 x {pd:.4e} + "
          f"1e-3 x {scale:.3f}")
    n_clear = n_same = 0
    for a, b in zip(kernel_logits, plain_logits):
        top2 = b[:, -1].topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > tol
        same = a[:, -1].argmax(-1) == b[:, -1].argmax(-1)
        check(bool(same[clear].all()), "greedy tokens of the kernel and plain runs differ "
              "where the plain run's top-2 margin is clear")
        n_clear += int(clear.sum())
        n_same += int(same.sum())
    print(f"[model] prefill and {cmp_steps} steps: max |kernel - f32| {kd:.4e}, max |plain - "
          f"f32| {pd:.4e}, max |logit| {scale:.3f}; bound 2 x plain + 1e-3 x max|logit| = "
          f"{tol:.4e}; greedy tokens equal in {n_same} of {B * (1 + cmp_steps)} picks "
          f"({n_clear} with a clear margin, all equal)")

    # The WaveBatcher at full width: 8 requests of 16-64 prompt tokens.
    gh = torch.Generator().manual_seed(seed + 171)
    wb = WaveBatcher(model, n_slots=4, max_len=128)
    for rid in range(8):
        L = 16 + int(torch.randint(0, 49, (1,), generator=gh))
        wb.submit(Request(rid=rid, prompt=torch.randint(0, cfg.vocab, (L,),
                                                        generator=gh).tolist(), max_new=16))
    reset_counts()
    t0 = time.perf_counter()
    done = wb.run()
    torch.cuda.synchronize()
    wave_ms = (time.perf_counter() - t0) * 1e3
    read_counts("wave batcher", flash_call=cfg.n_layers * wb.ticks)
    check(len(done) == 8 and all(r.done and len(r.out) == 16 for r in done),
          "the WaveBatcher left a request unfinished")
    print(f"[model] WaveBatcher, 4 slots: 8 requests (prompts of 16-64 tokens, 16 new each) "
          f"in {wb.ticks} ticks, {wave_ms:.1f} ms ({8 * 16 / wave_ms * 1e3:.1f} generated "
          f"tokens/s, {wave_ms / wb.ticks:.3f} ms a tick)")
    return {"launches": counts["flash_call"], "launches_tensor": by_path[0],
            "launches_decode": by_path[1], "launches_simt": by_path[2],
            "prefill_ms": prefill_ms, "decode_ms": decode_ms}


# The rules of phase 8's gradient anchor (serving_anchors): the float64
# decode under the kernel's tie-break (the lowest check row) and the dense
# backend's (the highest), and the f32 decode under the kernel's by dense
# rounds of its own.
ANCHOR_RULES = ("lo", "hi", "lo32")


def serving_anchors(dense, mom, thetas, smasks, budget: int,
                    B: int) -> tuple[torch.Tensor, dict]:
    """The anchors of phase 8's gradient bound, on ``dense``'s device: the
    float64 gradients ``M θ - b`` (nq, k), and for each of
    :data:`ANCHOR_RULES` each query's gradient from its worker products as the batcher forms them in
    f32 ((B, k) @ (k, N)), decoded in ``budget`` rounds: "lo" and "hi" in
    float64 under the kernel's tie-break (the lowest check row) and the
    dense backend's (the highest), "lo32" in f32 under the kernel's by
    dense rounds of its own (matrix-product sums: not the kernel's order).

    "lo32" is there because a lowest-row chain can amplify f32 rounding
    far more than the dense backend's highest-row chains do, and neither
    float64 term sees it: tests/test_torch_serving_anchor.py runs this
    traffic on the CPU, where the served gradients pass the bound with it
    and fail it without."""
    from repro_torch.core import decoder
    from repro_torch.kernels.ldpc_peel import decode_fused_batch_ref, dense_h
    code, dev = dense.code, dense.C.device
    th_d = torch.from_numpy(thetas).to(dev)
    m_d = torch.from_numpy(smasks).to(dev)
    g_exact = th_d.double() @ mom.M.double().T - mom.b.double()
    tables = decoder.code_tables(code, dev)
    H = dense_h(tables.check_idx, tables.check_coeff, code.N)

    def lo_dense32(z, mk):
        """``budget`` dense flooding rounds in f32, the lowest check row
        kept where several resolve one coordinate, sums by torch.matmul."""
        Hb, rows = (H != 0).float(), torch.arange(H.shape[0], device=dev)
        v, e = z.clone(), mk.clone()
        for _ in range(budget):
            cnt = e.float() @ Hb.T
            sums = torch.where(e, 0.0, v) @ H.T
            pos = torch.argmax((Hb.bool() & e[:, None, :]).to(torch.uint8), dim=-1)
            coeff = H[rows, pos]
            new = -sums / torch.where(coeff == 0.0, 1.0, coeff)
            at = torch.where(cnt == 1.0, pos, code.N)
            win = torch.full((z.shape[0], code.N + 1), H.shape[0], dtype=torch.long,
                             device=dev)
            win.scatter_reduce_(1, at, rows.expand_as(at), reduce="amin")
            win = win[:, :code.N]
            res = win < H.shape[0]
            v = torch.where(res, torch.gather(new, 1, win.clamp(max=H.shape[0] - 1)), v)
            e = e & ~res
        return v[..., None], e

    g64 = {rule: [] for rule in ANCHOR_RULES}
    for i in range(0, len(thetas), B):
        mk = m_d[i:i + B]
        z32 = dense.engine.erase(th_d[i:i + B] @ dense.C.T, mk)
        z = z32.double()
        for rule, (vals, er) in (
                ("lo", decode_fused_batch_ref(H.double(), z[..., None], mk, budget)),
                ("hi", decoder.peel_decode_batch(code, z, mk, budget, backend="dense")[:2]),
                ("lo32", lo_dense32(z32, mk))):
            vals = vals.reshape(z.shape).double()
            c64, u64 = dense.engine.systematic(decoder.DecodeResult(vals, er, budget))
            g64[rule].append(c64 - torch.where(u64, 0.0, mom.b.double()))
    return g_exact, {rule: torch.cat(g) for rule, g in g64.items()}


def serving_bound(gd: torch.Tensor, ex: torch.Tensor, anchors) -> float:
    """Phase 8's bound on a served gradient's distance from the dense
    backend's ``gd``: 1e-4·max|gd| + 4·anchor, the anchor the largest
    distance from the float64 gradient ``ex``, over the coordinates the
    dense backend resolves, of ``gd`` and of each of ``anchors``."""
    nz = gd != 0.0
    anchor = max(float((gd.double() - ex).abs()[nz].max()),
                 *(float((a - ex).abs()[nz].max()) for a in anchors))
    return 1e-4 * float(gd.abs().max()) + 4 * anchor


def exact_blocks(code, prob) -> dict:
    """``C_blocks`` and ``b`` of the problem in float64, the encode by the
    plain version (``torch.matmul`` in float64): the float64 reference
    runs' scheme fields, independent of the GEMM kernel."""
    from repro_torch.core import second_moment
    from repro_torch.kernels.block_matmul import block_matmul_ref
    mom = second_moment(prob.X.double(), prob.y.double())
    G = torch.as_tensor(code.G, dtype=torch.float64, device=mom.M.device)
    k = mom.M.shape[0]
    return {"C_blocks": block_matmul_ref(G, mom.M.reshape(k // code.K, code.K, k)),
            "b": mom.b}


def gemm_phase(dev: torch.device, seed: int, paper4: dict, full5: dict) -> tuple[dict, dict]:
    """Phase 18: the split pass against its plain version bit for bit; the
    GEMM against its plain version and float64 over the JAX sweep's shapes
    (and mixed f32 and bf16 inputs) and the encode shapes of phases 4, 5
    and 7, NaN and inf where torch.matmul puts them; the built library's
    tensor-core and TMA instructions (SASS); then timed at phase 5's shapes,
    the split pass and the product kernel apart and together.  Returns the
    numbers of the kernels line: the GEMM's and the split pass's."""
    from repro_torch.kernels import build
    from repro_torch.kernels.block_matmul import (block_matmul, block_matmul_ref, coded_matvec,
                                                  products_of_terms, split_terms,
                                                  split_terms_ref)
    from repro_torch.kernels.block_matmul.ref import product_pairs
    gen = torch.Generator(device=dev).manual_seed(seed + 18)

    def held(got, A, B, what, exact=None) -> tuple[float, float]:
        """Within K·2⁻²⁴·(|A|·|B|) of float64 entry by entry and no more than
        twice torch.matmul's distance; returns (max |kernel - plain|, the
        kernel's max distance from float64 over torch.matmul's)."""
        A64, B64 = A.double(), B.double()
        exact = torch.matmul(A64, B64) if exact is None else exact
        bound = A.shape[-1] * 2.0 ** -24 * torch.matmul(A64.abs(), B64.abs())
        err = (got.double() - exact).abs()
        check(bool((err <= bound).all()), f"{what}: beyond K·2^-24·(|A|·|B|) of float64 "
              f"({float((err - bound).max()):.3e} over)")
        plain = block_matmul_ref(A, B)
        lib = float((plain.double() - exact).abs().max())
        check(float(err.max()) <= 2 * lib + 1e-30, f"{what}: {float(err.max()):.3e} from "
              f"float64, more than 2x torch.matmul's {lib:.3e}")
        return float((got - plain).abs().max()), float(err.max()) / max(lib, 1e-30)

    split_err = 0.0

    def same_terms(a, b) -> bool:
        """Bit for bit; the largest |kernel term - plain term| goes to split_err."""
        nonlocal split_err
        if a.shape != b.shape:
            return False
        same = a.view(torch.int16) == b.view(torch.int16)
        diff = torch.where(same, 0.0, (a.float() - b.float()).abs())
        split_err = max(split_err, float(diff.max()))
        return bool(same.all())

    # the split pass against its plain version, bit for bit: values across
    # the exponent range, bf16's overflow edge, subnormals, inf, NaN, -0
    t0 = time.perf_counter()
    specials = torch.tensor([3.4028235e38, -3.4028235e38, 3.39e38, float("inf"),
                             -float("inf"), float("nan"), -0.0, 1e-45, 2.0 ** -126,
                             2.0 ** -111 + 2.0 ** -134], device=dev)
    n_split = 0
    for shape in ((1, 1), (37, 65), (300, 1029), (3, 70, 33)):
        x = torch.randn(shape, generator=gen, device=dev) * torch.exp2(
            torch.randint(-140, 128, shape, generator=gen, device=dev).float())
        n = min(specials.numel(), x.numel())
        x.view(-1)[:n] = specials[:n]
        for xx in (x, x.bfloat16()):
            for tr in (False, True):
                check(same_terms(split_terms(xx, tr), split_terms_ref(xx, tr)),
                      f"split pass {tuple(shape)} {xx.dtype} transpose={tr}: kernel and plain "
                      f"version differ")
                n_split += 1
    code5 = full5["code"]
    G5 = torch.as_tensor(code5.G, dtype=torch.float32, device=dev)
    M5, C5 = full5["M"], full5["scheme"].C_blocks
    nb, K5, k5 = C5.shape[0], code5.K, M5.shape[1]
    Mb5 = M5.reshape(nb, K5, k5)
    check(same_terms(split_terms(G5), split_terms_ref(G5)), "split pass of phase 5's G differs")
    tB = split_terms(Mb5, transpose=True)
    for i in range(nb):                       # block by block: the plain version's temporaries
        check(same_terms(tB[i:i + 1], split_terms_ref(Mb5[i], transpose=True)),
              f"split pass of phase 5's block {i} differs")
    del tB
    n_split += 1 + nb
    print(f"[gemm] split pass: {n_split} tensors (4 shapes with special values, f32 and bf16, "
          f"both layouts; phase 5's G and its {nb} blocks of M, transposed) equal to the plain "
          f"version bit for bit, max |kernel - plain| {split_err:.3e} "
          f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    worst, ratio, n = 0.0, 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for Mm, Kk, Nn in ((8, 8, 8), (128, 128, 128), (100, 37, 65), (256, 512, 128),
                           (40, 200, 1)):
            A = torch.randn((Mm, Kk), generator=gen, device=dev).to(dtype)
            B = torch.randn((Kk, Nn), generator=gen, device=dev).to(dtype)
            got, again = block_matmul(A, B), block_matmul(A, B)
            torch.cuda.synchronize()
            check(same_bits(got, again), f"({Mm}, {Kk}, {Nn}) {dtype}: two runs differ")
            e, r = held(got, A, B, f"({Mm}, {Kk}, {Nn}) {dtype}")
            worst, ratio, n = max(worst, e), max(ratio, r), n + 1
    # the card tests' largest shape, and mixed inputs (one or three terms a side)
    for Mm, Kk, Nn in ((100, 37, 65), (300, 1029, 257)):
        for da, db in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                       (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
            A = torch.randn((Mm, Kk), generator=gen, device=dev).to(da)
            B = torch.randn((Kk, Nn), generator=gen, device=dev).to(db)
            got = block_matmul(A, B)
            check(same_bits(got, block_matmul(A, B)), f"({Mm}, {Kk}, {Nn}) {da} x {db}: two "
                  f"runs differ")
            e, r = held(got, A, B, f"({Mm}, {Kk}, {Nn}) {da} x {db}")
            worst, ratio, n = max(worst, e), max(ratio, r), n + 1
    # the encode shapes: phase 4 (20 blocks of the (40, 20) code over k = 400)
    # and phase 7 (K = k = 1024), from their own moments
    code4, M4 = paper4["code"], paper4["mom"].M
    G4 = torch.as_tensor(code4.G, dtype=torch.float32, device=dev)
    Mb4 = M4.reshape(-1, code4.K, M4.shape[1])
    got = block_matmul(G4, Mb4)
    check(same_bits(got, block_matmul(G4, Mb4)), "phase 4 encode: two runs differ")
    e, r = held(got, G4.expand(Mb4.shape[0], *G4.shape), Mb4, "phase 4 encode")
    worst, ratio, n = max(worst, e), max(ratio, r), n + 1
    M7 = full5["M7"]
    got = block_matmul(G5, M7)
    check(same_bits(got, block_matmul(G5, M7)), "phase 7 encode: two runs differ")
    e, r = held(got, G5, M7, "phase 7 encode")
    worst, ratio, n = max(worst, e), max(ratio, r), n + 1
    # phase 5: the 32 blocks phase 5's scheme holds, each against float64
    again = block_matmul(G5, Mb5)
    torch.cuda.synchronize()
    check(same_bits(C5, again), "phase 5 encode: a second run differs from the first")
    del again
    worst5, ratio5 = 0.0, 0.0
    for i in range(nb):
        e, r = held(C5[i], G5, Mb5[i], f"phase 5 encode block {i}")
        worst5, ratio5 = max(worst5, e), max(ratio5, r)
    worst, ratio, n = max(worst, worst5), max(ratio, ratio5), n + nb
    # short K over 40 seeds, as the card tests run it: one chunk holds the
    # whole sum, so the leads' product must reach the output uncut
    t1 = time.perf_counter()
    short = {}
    for Mm, Kk, Nn in ((1, 1, 1), (1, 17, 3), (1, 64, 3), (4, 63, 5)):
        worst_short = 0.0
        for sd in range(40):
            g = torch.Generator(device=dev).manual_seed(1000 * sd + Mm * Kk + Nn)
            A = torch.randn((Mm, Kk), generator=g, device=dev)
            B = torch.randn((Kk, Nn), generator=g, device=dev)
            e, r = held(block_matmul(A, B), A, B, f"short K ({Mm}, {Kk}, {Nn}) seed {sd}")
            worst_short = max(worst_short, r)
        short[(Mm, Kk, Nn)] = worst_short
    print(f"[gemm] short K over 40 seeds (the card tests' sweep): "
          + ", ".join(f"{s_} at most {r_:.3f}x" for s_, r_ in short.items())
          + f" torch.matmul's distance from float64 (bound 2x) "
          f"({time.perf_counter() - t1:.1f} s)")
    # non-finite inputs: NaN and inf where torch.matmul puts them
    A = torch.randn((70, 40), generator=gen, device=dev)
    B = torch.randn((40, 90), generator=gen, device=dev)
    A[3, 5], A[10, 7], A[30, 7], A[20, 9] = float("inf"), float("nan"), -float("inf"), 0.0
    B[5, 2], B[9, 11], B[7, 50] = 0.0, -float("inf"), float("inf")
    got, want = block_matmul(A, B), torch.matmul(A, B)
    for what, f in (("NaN", torch.isnan), ("+inf", lambda t: t == float("inf")),
                    ("-inf", lambda t: t == -float("inf"))):
        check(torch.equal(f(got), f(want)), f"non-finite inputs: {what} not where torch.matmul "
              f"puts it")
    print(f"[gemm] {n} products (the JAX sweep's 5 shapes in f32 and bf16; (100, 37, 65) and "
          f"(300, 1029, 257) in f32, bf16 and mixed; the encodes of phases 4 and 7; phase 5's "
          f"{nb} blocks of ({G5.shape[0]} x {K5}) @ ({K5} x {k5})): all within "
          f"K·2^-24·(|A|·|B|) of float64, at most {ratio:.3f}x torch.matmul's distance from "
          f"float64 (bound 2x; phase 5's blocks {ratio5:.3f}x), two runs bit for bit; max "
          f"|kernel - plain| {worst:.3e} (phase 5 {worst5:.3e}); NaN "
          f"({int(torch.isnan(want).sum())}) and inf ({int(torch.isinf(want).sum())}) where "
          f"torch.matmul puts them "
          f"({time.perf_counter() - t0:.1f} s)")

    # the built library: its products on the tensor cores, its operands by TMA
    lib_path = build.build_all(["block_matmul"])["block_matmul"]
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    n_hgmma, n_tma = sass.count("HGMMA"), sass.count("UTMALDG")
    check(n_hgmma > 0 and n_tma > 0, f"the library's SASS has {n_hgmma} HGMMA and {n_tma} "
          f"UTMALDG instructions")
    print(f"[gemm] SASS of {lib_path.name}: {n_hgmma} HGMMA (wgmma) and {n_tma} UTMALDG (TMA "
          f"loads) instructions")

    # timing at phase 5's shapes, TF32 off (phase 1).  The product kernel runs
    # the term products of ref.product_pairs on the bf16 tensor cores.  The
    # bound counts the f32 product as GEMM_BOUND_PRODUCTS bf16 products,
    # whatever the kernel runs, so that a design running more shows as a
    # larger share of it; the design's own count is printed beside it.
    n_prod = len(product_pairs(4, 4))
    out = {"max_abs_err": worst}
    A1, B1 = G5, Mb5[0]
    flops1 = 2 * G5.shape[0] * K5 * k5
    for what, kern, plain, lib, flops, nbytes in (
            (f"one block ({G5.shape[0]} x {K5}) @ ({K5} x {k5})", lambda: block_matmul(A1, B1),
             lambda: block_matmul_ref(A1, B1), lambda: torch.matmul(A1, B1), flops1,
             (A1.numel() + B1.numel() + G5.shape[0] * k5) * 4),
            (f"the whole {nb}-block encode", lambda: block_matmul(G5, Mb5),
             lambda: block_matmul_ref(G5, Mb5), lambda: torch.matmul(G5, Mb5), flops1 * nb,
             (G5.numel() + M5.numel() + C5.numel()) * 4)):
        ms = cuda_ms(kern, 3)
        plain_ms = cuda_ms(plain, 3)
        lib_ms = cuda_ms(lib, 3)
        ops_ms, bytes_ms = (GEMM_BOUND_PRODUCTS * flops / BF16_FLOPS * 1e3,
                            nbytes / HBM_BYTES_PER_S * 1e3)
        design_ms = n_prod * flops / BF16_FLOPS * 1e3
        f32_ms = flops / F32_FLOPS * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        note = ("; torch.matmul beats the f32 bound: it cannot at f32, so it is not computing in "
                "f32 FMAs (TF32?)" if lib_ms < f32_ms else "")
        print(f"[gemm] {what}: kernels {ms:.4f} ms ({flops / ms / 1e9:.1f} f32-TFLOP/s, "
              f"{'faster' if ms < lib_ms else 'slower'} than torch.matmul), plain version "
              f"(torch.matmul, f32) {plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms by {bound_by} ({GEMM_BOUND_PRODUCTS} bf16 products of {flops} "
              f"FLOP at 989 TFLOP/s = {ops_ms:.4f} ms; {nbytes} B at 3.35 TB/s = "
              f"{bytes_ms:.4f} ms); this design's {n_prod} products {design_ms:.4f} ms; "
              f"the f32 bound of the SIMT design {f32_ms:.4f} ms ({flops} FLOP at 67 TFLOP/s)"
              f"{note}")
        out.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                   bound_by=bound_by, f32_bound_ms=f32_ms, design_ms=design_ms)
    # the two kernels apart, at the whole encode
    split_ms = cuda_ms(lambda: (split_terms(G5), split_terms(Mb5, transpose=True)), 3)
    split_plain_ms = cuda_ms(lambda: [split_terms_ref(G5)]
                             + [split_terms_ref(Mb5[i], transpose=True) for i in range(nb)], 1)
    split_bytes = (G5.numel() + M5.numel()) * (4 + 4 * 2)
    split_bound_ms = split_bytes / HBM_BYTES_PER_S * 1e3
    tA, tB = split_terms(G5), split_terms(Mb5, transpose=True)
    main_ms = cuda_ms(lambda: products_of_terms(tA, tB), 3)
    main_bytes = (tA.numel() + tB.numel()) * 2 + C5.numel() * 4
    main_ops_ms = GEMM_BOUND_PRODUCTS * flops1 * nb / BF16_FLOPS * 1e3
    main_bytes_ms = main_bytes / HBM_BYTES_PER_S * 1e3
    main_bound_ms = max(main_ops_ms, main_bytes_ms)
    del tA, tB
    print(f"[gemm] the whole encode's two kernels apart: the split pass (G and the {nb} blocks "
          f"of M) {split_ms:.4f} ms, its plain version (block by block) {split_plain_ms:.4f} "
          f"ms, bound {split_bound_ms:.4f} ms by bytes ({split_bytes} B: f32 read, four bf16 "
          f"terms written); the product kernel {main_ms:.4f} ms "
          f"({n_prod * flops1 * nb / main_ms / 1e9:.1f} bf16-TFLOP/s), bound "
          f"{main_bound_ms:.4f} ms by {'operations' if main_ops_ms >= main_bytes_ms else 'bytes'}"
          f" ({GEMM_BOUND_PRODUCTS} bf16 products {main_ops_ms:.4f} ms; its {main_bytes} B "
          f"{main_bytes_ms:.4f} ms; this design's {n_prod} products "
          f"{n_prod * flops1 * nb / BF16_FLOPS * 1e3:.4f} ms)")
    out.update(split_ms=split_ms, main_ms=main_ms, main_bound_ms=main_bound_ms)
    split = {"max_abs_err": split_err, "ms": split_ms, "plain_ms": split_plain_ms,
             "bound_ms": split_bound_ms, "bound_by": "bytes", "library_ms": None}
    # coded_matvec at phase 5's worker-product shape: all 32 blocks' rows
    theta = full5["theta"]
    C2 = C5.reshape(-1, k5)
    z = coded_matvec(C2, theta)
    ref_z = full5["scheme"].worker_products(theta).T.reshape(-1)
    torch.cuda.synchronize()
    mv_err = float((z - ref_z).abs().max())
    mv_ms = cuda_ms(lambda: coded_matvec(C2, theta), 3)
    bmm_ms = cuda_ms(lambda: full5["scheme"].worker_products(theta), 10)
    mv_bound = (C2.numel() + k5 + C2.shape[0]) * 4 / HBM_BYTES_PER_S * 1e3
    print(f"[gemm] coded_matvec at phase 5's worker products (({C2.shape[0]} x {k5}) @ "
          f"({k5},)): kernels {mv_ms:.4f} ms, torch.bmm (the scheme's worker products) "
          f"{bmm_ms:.4f} ms, bound {mv_bound:.4f} ms by bytes; max |kernel - bmm| "
          f"{mv_err:.3e} (a 128-wide tile for one column: this shape stays on torch.bmm)")
    return out, split


def scheme1_phase(dev: torch.device, seed: int, paper4: dict, full5: dict) -> None:
    """Phase 19: Scheme 1 in the paper's setting against its float64 run on
    phase 4's masks, and at full width on phase 5's C_blocks."""
    from repro_torch.core import Scheme1, run_pgd
    prob, code, masks, steps = (paper4[k] for k in ("prob", "code", "masks", "steps"))
    t0 = time.perf_counter()
    s1 = Scheme1.build(code, paper4["mom"], lr=prob.lr)
    exact = Scheme1(code=code, **exact_blocks(code, prob), lr=prob.lr)
    theta0 = torch.zeros(prob.X.shape[1], device=dev)
    res = run_pgd(s1, theta0, None, steps, masks=masks, theta_star=prob.theta_star)
    ref = run_pgd(exact, theta0.double(), None, steps, masks=masks,
                  theta_star=prob.theta_star.double())
    torch.cuda.synchronize()
    check(bool(torch.isfinite(res.errors).all()), "Scheme 1: non-finite error")
    ex = ref.errors
    above = ex >= 1e-2 * ex[0]
    rel = (res.errors.double() - ex).abs() / ex
    check(bool((rel[above] <= 2e-2).all()), f"Scheme 1: |error - float64 error| / float64 "
          f"error {float(rel[above].max()):.3e} > 2e-2")
    # each step's recovery along the f32 run: rank of the surviving rows, and on
    # full-rank steps M θ within κ·k·2^-24 (2-norm, relative) of float64
    exact_M = paper4["mom"].M.double()
    theta, full, worst, n_full = theta0, 0, 0.0, 0
    for t in range(steps):
        rec, rank = s1.solve(s1.worker_products(theta), masks[t])
        if int(rank) == code.K:
            n_full += 1
            want = exact_M @ theta.double()
            G = torch.as_tensor(code.G, dtype=torch.float64, device=dev)[~masks[t]]
            sv = torch.linalg.svdvals(G)
            kappa = float(sv[0] / sv[-1])
            off = float(torch.linalg.vector_norm(rec.double() - want))
            size = float(torch.linalg.vector_norm(want))
            check(off <= kappa * prob.X.shape[1] * 2.0 ** -24 * size,
                  f"Scheme 1 step {t + 1}: full rank but M θ off by {off:.3e} of "
                  f"{size:.3e} (κ = {kappa:.2f})")
            worst = max(worst, off / max(size, 1e-300) / kappa)
        theta, _ = s1.step(theta, masks[t])
    print(f"[scheme1] paper setting (m = {prob.X.shape[0]}, k = {prob.X.shape[1]}, the (40, 20) "
          f"code, {int(masks[0].sum())} stragglers, {steps} steps, phase 4's masks): final rel. "
          f"error {float(res.errors[-1]) / float(torch.linalg.vector_norm(prob.theta_star)):.6e} "
          f"(float64 {float(ex[-1]) / float(torch.linalg.vector_norm(prob.theta_star)):.6e}); "
          f"|error - float64 error| / float64 error at most {float(rel[above].max()):.3e} over "
          f"the {int(above.sum())} steps above 1e-2 of the start (bound 2e-2); {n_full} of "
          f"{steps} steps had surviving rows of full column rank {code.K}, and there M θ was "
          f"within κ·k·2^-24 of float64 (at most {worst:.3e}·κ) "
          f"({time.perf_counter() - t0:.1f} s)")

    # full width on phase 5's C_blocks (no second encode)
    sch5, masks5, code5 = full5["scheme"], full5["masks"], full5["code"]
    wide = Scheme1(code=code5, C_blocks=sch5.C_blocks, b=sch5.b, lr=sch5.lr)
    steps19 = 5
    k5 = sch5.C_blocks.shape[2]
    res19 = run_pgd(wide, torch.zeros(k5, device=dev), None, steps19, masks=masks5[:steps19],
                    theta_star=full5["theta_star"])
    torch.cuda.synchronize()
    errs = res19.errors.tolist()
    check(all(math.isfinite(x) for x in errs) and errs[-1] < errs[0],
          f"Scheme 1 at full width: error {errs[0]} -> {errs[-1]}")
    th = res19.theta
    ranks = [int(wide.solve(wide.worker_products(th), m)[1]) for m in masks5[:steps19]]
    rec, _ = wide.solve(wide.worker_products(th), masks5[0])
    want = (full5["M"].double() @ th.double())
    rel0 = float(torch.linalg.vector_norm(rec.double() - want) / torch.linalg.vector_norm(want))
    t = [0]

    def one_step():
        wide.step(th, masks5[t[0] % steps19])
        t[0] += 1

    step_ms = cuda_ms(one_step, steps19)
    prod_ms = cuda_ms(lambda: wide.worker_products(th), 10)
    Z = wide.worker_products(th)
    solve_ms = cuda_ms(lambda: wide.solve(Z, masks5[0]), steps19)
    print(f"[scheme1] full width (k = {k5}, the (3, 6) code at K = {code5.K}, N = {code5.N}, "
          f"{int(masks5[0].sum())} stragglers, phase 5's C_blocks and masks): {steps19} steps, "
          f"||theta - theta*|| {errs[0]:.6f} -> {errs[-1]:.6f}; ranks of the surviving rows "
          f"{ranks} (K = {code5.K}); step 1's M θ within {rel0:.3e} (2-norm, relative) of "
          f"float64; {step_ms:.4f} ms a step (CUDA events): worker products {prod_ms:.4f} ms "
          f"(torch.bmm), the solve (one SVD of the surviving G, {code5.N} x {code5.K}) "
          f"{solve_ms:.4f} ms")


def check_pass_phase(dev: torch.device, seed: int, codes: dict, full5: dict,
                     reset_counts, read_counts) -> dict:
    """Phase 20: the check pass against its plain version, then phase 5's
    decode as D launches of peel_round_cuda.  Returns the numbers of the
    kernels line."""
    from repro_torch.core import decoder, make_regular_ldpc
    from repro_torch.kernels.ldpc_peel import check_pass_cuda, check_pass_ref, peel_round_cuda
    t0 = time.perf_counter()
    n, worst = 0, 0.0

    def both(H, v, e, what) -> None:
        nonlocal n, worst
        got = check_pass_cuda(H, v, e)
        want = check_pass_ref(H, v, e.float()[:, None])
        torch.cuda.synchronize()
        check(all(same_bits_nan(a.float(), b.float()) for a, b in zip(got, want)),
              f"check pass {what}: kernel and plain version differ")
        fin = torch.isfinite(want[0])
        if bool(fin.any()):
            worst = max(worst, float((got[0] - want[0])[fin].abs().max()))
        n += 1

    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    for p, N, V in ((8, 16, 1), (32, 64, 4), (128, 256, 128), (130, 260, 7), (64, 128, 200)):
        H = torch.randn((p, N), generator=gen, device=dev)
        H = torch.where(torch.rand((p, N), generator=gen, device=dev) < 0.8, 0.0, H)
        v = torch.randn((N, V), generator=gen, device=dev)
        e = torch.rand(N, generator=gen, device=dev) < 0.3
        both(H.contiguous(), v, e, f"p={p} N={N} V={V}")
    for K in (20, 40, 100):
        code = make_regular_ldpc(K, l=3, r=6, seed=K)
        H = torch.as_tensor(code.H, dtype=torch.float32, device=dev).contiguous()
        for V in (1, 8, 64):
            e = torch.rand(code.N, generator=gen, device=dev) < 0.25
            v = torch.randn((code.N, V), generator=gen, device=dev)
            both(H, torch.where(e[:, None], 0.0, v), e, f"K={K} V={V}")
    for (weights, K, cseed), code in codes.items():
        if cseed != 0:
            continue
        H = torch.as_tensor(code.H, dtype=torch.float32, device=dev).contiguous()
        for f in (0.0, 0.25, 0.45):
            for bad in (None, float("nan"), float("inf")):
                e = torch.rand(code.N, generator=gen, device=dev) < f
                v = torch.randn((code.N, 32), generator=gen, device=dev)
                if weights == "pm1":
                    v = v.round()
                if bad is not None and bool(e.any()):
                    v[int(torch.nonzero(e)[0])] = bad
                both(H, v, e, f"{weights} N={code.N} f={f} bad={bad}")
    print(f"[check-pass] {n} cases (test_kernels.py's (p, N, V) grid and its K in (20, 40, 100) "
          f"x V in (1, 8, 64); the (40, 20) and K = 1024 codes, Gaussian and ±1, f in (0, 0.25, "
          f"0.45), NaN and inf in an erased entry): cnt, pos, coeff and sums bit for bit with "
          f"the plain version, NaNs by position; max |kernel - plain| {worst:.3e} "
          f"({time.perf_counter() - t0:.1f} s)")

    # phase 5's decode as D launches of the one-round entry point
    code5, D = full5["code"], full5["D"]
    H5 = torch.as_tensor(code5.H, dtype=torch.float32, device=dev).contiguous()
    mask = full5["masks"][0]
    Z = full5["scheme"].worker_products(full5["theta"] + 1.0)
    values = full5["scheme"].engine.erase(Z, mask).contiguous()
    ref = decoder.peel_decode(code5, values, mask, D, backend="cuda")
    v, e = values, mask
    reset_counts()                             # this path's run
    for _ in range(D):
        v, e = peel_round_cuda(H5, v, e)
    torch.cuda.synchronize()
    launches = read_counts("peel rounds", check_pass=D)["check_pass"]
    check(torch.equal(e, ref.erased), "peel_round_cuda x D: erasure masks differ from "
          "peel_decode(backend='cuda')")
    d64 = decoder.peel_decode(code5, values.double(), mask, D, backend="dense").values
    resolved = mask & ~e
    diff = float((v - ref.values).abs().max())
    anchor = max(float((ref.values - Z).abs()[resolved].max()),
                 float((d64 - Z.double()).abs()[resolved].max())) if bool(resolved.any()) else 0.0
    tol = 1e-4 * float(Z.abs().max()) + 4 * anchor
    check(diff <= tol, f"peel_round_cuda x D vs peel_decode: {diff:.3e} > {tol:.3e}")
    check(torch.equal(v[~resolved], values[~resolved]), "unresolved values changed")
    ms = cuda_ms(lambda: check_pass_cuda(H5, values, mask), 100)
    plain_ms = cuda_ms(lambda: check_pass_ref(H5, values, mask.float()[:, None]), 3)
    p5, N5 = H5.shape
    V5 = values.shape[1]
    nbytes = p5 * N5 * 4 + N5 * V5 * 4 + N5 + p5 * V5 * 4 + p5 * 12
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * p5 * N5 * V5 / F32_FLOPS * 1e3
    print(f"[check-pass] phase 5's decode (N = {N5}, V = {V5}, D = {D}, phase 5's first mask, "
          f"{int(resolved.sum())} of {int(mask.sum())} erased resolved) as {launches} launches "
          f"of peel_round_cuda: masks identical to peel_decode(backend='cuda'); values "
          f"{diff:.3e} from it (bound 1e-4·max|Z| + 4·anchor = {tol:.3e}); one check pass "
          f"(p = {p5}) {ms:.4f} ms, plain version {plain_ms:.4f} ms; bound {bound_ms:.6f} ms by "
          f"bytes ({nbytes} B at 3.35 TB/s; {2 * p5 * N5 * V5} FLOP at 67 TFLOP/s = "
          f"{ops_ms:.6f} ms)")
    return {"launches": launches, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_ms, ops_ms),
            "bound_by": "bytes" if bound_ms >= ops_ms else "operations", "library_ms": None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import (CodedComputeEngine, FixedCountStragglers, Scheme2,
                                  Scheme2Blocked, make_parity_only_ldpc,
                                  make_regular_ldpc, run_pgd, second_moment)
    from repro_torch.core import decoder, encoding
    from repro_torch.core.ldpc import SeededLDPC, make_seeded_ldgm, make_seeded_ldpc
    from repro_torch.core.schemes import Uncoded
    from repro_torch.data import make_linear_problem
    from repro_torch.kernels import build
    from repro_torch.kernels.ldpc_peel import (decode_fused_adaptive_ref,
                                               decode_fused_batch_adaptive_ref,
                                               decode_fused_batch_ref, decode_fused_ref,
                                               decode_seeded_adaptive_ref,
                                               decode_seeded_batch_adaptive_ref,
                                               decode_seeded_batch_ref, decode_seeded_ref,
                                               dense_h, encode_seeded_fused_cuda,
                                               encode_seeded_ref, peel_decode_adaptive_cuda,
                                               peel_decode_adaptive_seeded_cuda,
                                               peel_decode_batch_adaptive_cuda,
                                               peel_decode_batch_adaptive_seeded_cuda,
                                               peel_decode_batch_cuda,
                                               peel_decode_batch_seeded_cuda, peel_decode_cuda,
                                               peel_decode_replay_cuda, peel_decode_seeded_cuda,
                                               replay_ref)
    from repro_torch.kernels.ldpc_peel.ref import (decode_table_adaptive_ref,
                                                   decode_table_batch_adaptive_ref,
                                                   decode_table_batch_ref, decode_table_ref)
    from repro_torch.core import ScheduleCache
    from repro_torch.kernels.ldpc_peel import ops as peel_ops
    from repro_torch.serving import CodedQuery, CodedQueryBatcher
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.block_matmul import block_matmul, split_terms
    from repro_torch.kernels.ldpc_peel import check_pass_cuda

    wrappers = {"decode_fused": peel_decode_cuda, "decode_fused_batch": peel_decode_batch_cuda,
                "decode_fused_adaptive": peel_decode_adaptive_cuda,
                "decode_fused_batch_adaptive": peel_decode_batch_adaptive_cuda,
                "decode_seeded": peel_decode_seeded_cuda,
                "decode_seeded_batch": peel_decode_batch_seeded_cuda,
                "decode_seeded_adaptive": peel_decode_adaptive_seeded_cuda,
                "decode_seeded_batch_adaptive": peel_decode_batch_adaptive_seeded_cuda,
                "encode_seeded_fused": encode_seeded_fused_cuda,
                "decode_replay": peel_decode_replay_cuda,
                "flash_call": flash_attention_cuda,
                "matmul_kernel_call": block_matmul, "split_terms": split_terms,
                "check_pass": check_pass_cuda}

    def reset_counts() -> None:
        for w in wrappers.values():
            w.launches = 0
        flash_attention_cuda.launches_tensor = flash_attention_cuda.launches_simt = 0
        flash_attention_cuda.launches_decode = 0

    def read_counts(what: str, **want: int) -> dict[str, int]:
        """The launch counts after a path's run: each kernel named in
        ``want`` launched that many times, every other kernel not at all."""
        counts = {n: w.launches for n, w in wrappers.items()}
        check(all(c == want.get(n, 0) for n, c in counts.items()),
              f"{what}: kernel launches {counts}, want {want} and no other")
        return {n: counts[n] for n in want}

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ------------------------------------------------------------ 1. card
    card = card_line()
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"[build] {len(built)} librar{'y' if len(built) == 1 else 'ies'} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in build.build_logs.items():
        for line in log.strip().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {name}: {line.strip()}")

    # ---------------------------------------------- 3. kernel vs plain
    t0 = time.perf_counter()
    codes = {}
    for K in (20, 1024):
        for seed in range(3):
            codes["gaussian", K, seed] = make_regular_ldpc(K, seed=seed)
            codes["pm1", K, seed] = make_parity_only_ldpc(K, seed=seed, values="pm1")
    print(f"[kernel] built {len(codes)} codes in {time.perf_counter() - t0:.1f} s")
    max_abs_err = 0.0
    n_cases = 0
    for (weights, K, seed), code in codes.items():
        tables = decoder.code_tables(code, dev)
        H = dense_h(tables.check_idx, tables.check_coeff, code.N)
        worst = 0.0
        for V in (1, 32):
            for f in (0.0, 0.25, 0.45):
                for D in (0, 1, 8):
                    rng = np.random.default_rng([K, seed, V, int(f * 100), D])
                    erased = rng.random(code.N) < f
                    if weights == "gaussian":
                        truth = (code.G @ rng.standard_normal((K, V))).astype(np.float32)
                    else:   # integer payloads: every f32 step is exact
                        truth = rng.integers(-8, 9, (code.N, V)).astype(np.float32)
                    garbage = (1e3 * rng.standard_normal((code.N, V))).astype(np.float32)
                    v = torch.from_numpy(np.where(erased[:, None], garbage, truth)).to(dev)
                    e = torch.from_numpy(erased).to(dev)
                    kv, ke = peel_decode_cuda(tables, v, e, D)
                    pv, pe = decode_fused_ref(H, v, e, D)
                    torch.cuda.synchronize()
                    check(torch.equal(ke, pe), f"masks differ: {weights} K={K} "
                          f"seed={seed} V={V} f={f} D={D}")
                    resolved = e & ~pe
                    check(torch.equal(kv[~resolved], v[~resolved]),
                          "unresolved values changed")
                    err = float((kv - pv).abs().max())
                    worst = max(worst, err)
                    if weights == "pm1":
                        check(err == 0.0, f"pm1 values differ by {err}")
                    elif bool(resolved.any()):
                        t = torch.from_numpy(truth).to(dev)
                        scale = float(t.abs().max())
                        anchor = float((pv - t).abs()[resolved].max())
                        tol = 1e-4 * scale + 4 * anchor
                        check(err <= tol, f"values differ by {err} > {tol}: "
                              f"K={K} seed={seed} V={V} f={f} D={D}")
                    n_cases += 1
        max_abs_err = max(max_abs_err, worst)
        print(f"[kernel] ldpc_peel.decode_fused vs plain: {weights} N={code.N} "
              f"seed={seed}: 18 cases, masks identical, max |diff| {worst:.3e}")
    print(f"[kernel] {n_cases} cases passed; tolerance: exact on pm1 codes, "
          f"1e-4*max|c| + 4*max|plain - c| on Gaussian codes")

    def decode_vs_plain(code, Z: torch.Tensor, mask: torch.Tensor, D: int,
                        what: str) -> float:
        """Hold the kernel against its plain version on the main path's
        erased worker products ``Z`` (N, V): masks exact, values within
        1e-4*max|Z| + 4*max|plain - Z| over the resolved coordinates."""
        tables = decoder.code_tables(code, dev)
        values = torch.where(mask[:, None], torch.zeros_like(Z), Z).contiguous()
        kv, ke = peel_decode_cuda(tables, values, mask, D)
        pv, pe = decode_fused_ref(dense_h(tables.check_idx, tables.check_coeff,
                                          code.N), values, mask, D)
        torch.cuda.synchronize()
        check(torch.equal(ke, pe), f"{what}: kernel and plain masks differ")
        resolved = mask & ~pe
        err = float((kv - pv).abs().max())
        anchor = float((pv - Z).abs()[resolved].max()) if bool(resolved.any()) else 0.0
        check(err <= 1e-4 * float(Z.abs().max()) + 4 * anchor,
              f"{what}: kernel vs plain {err} (anchor {anchor})")
        return err

    # ------------------------------------------- 4. the paper's setting
    steps4 = 60
    prob = make_linear_problem(2048, 400, seed=0, device=dev)
    mom = second_moment(prob.X, prob.y)
    code = codes["gaussian", 20, 0]
    reset_counts()                             # the encode: one launch of the GEMM kernel
    coded = Scheme2Blocked.build(code, mom, lr=prob.lr, decode_iters=12,
                                 decode_backend="cuda")
    torch.cuda.synchronize()
    read_counts("paper setting encode", matmul_kernel_call=1, split_terms=2)
    dense = dataclasses.replace(coded, decode_backend="dense")
    # the same problem in float64: the trajectory without f32 rounding (its
    # encode by torch.matmul in float64, apart from the kernel under test)
    exact = Scheme2Blocked(code=code, **exact_blocks(code, prob), lr=prob.lr,
                           decode_iters=12, decode_backend="dense")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    masks = torch.stack([FixedCountStragglers(10).sample(gen, 40, dev)
                         for _ in range(steps4)])
    theta0 = torch.zeros(400, device=dev)
    reset_counts()                             # this path's run
    runs = {"cuda": run_pgd(coded, theta0, None, steps4, masks=masks,
                            theta_star=prob.theta_star)}
    torch.cuda.synchronize()
    read_counts("paper setting", decode_fused=steps4)
    print(f"[paper] decode launches {peel_decode_cuda.launches} for {steps4} steps")
    runs["dense"] = run_pgd(dense, theta0, None, steps4, masks=masks,
                            theta_star=prob.theta_star)
    runs["float64"] = run_pgd(exact, theta0.double(), None, steps4, masks=masks,
                              theta_star=prob.theta_star.double())
    runs["uncoded"] = run_pgd(Uncoded(prob.X, prob.y, w=40, lr=prob.lr), theta0,
                              None, steps4, masks=masks, theta_star=prob.theta_star)
    for name in ("dense", "float64"):
        check(torch.equal(runs["cuda"].unresolved, runs[name].unresolved),
              f"paper setting: per-step unresolved differs between cuda and {name}")
    norm = float(torch.linalg.vector_norm(prob.theta_star))
    for name, res in runs.items():
        errs = (res.errors.double() / norm).tolist()
        curve = "  ".join(f"t={t}: {errs[t]:.3e}" for t in (0, 5, 10, 20, 40, 59))
        print(f"[paper] {name:8s} rel. error {curve}")
        check(all(math.isfinite(x) for x in errs), f"{name}: non-finite error")
    # Each step's error against the float64 run's at that step, relative to
    # that step's own error, within 2e-2, over the steps whose float64 error
    # is still at least a hundredth of the starting one.  Further down, f32
    # cannot compute the gradient Mθ - b much more finely than its rounding,
    # and an f32 run of either backend may stray from the float64 run by as
    # much as the error itself; there, the per-step kernel-vs-plain check
    # below holds the decode's values.
    ex = runs["float64"].errors
    above = ex >= 1e-2 * ex[0]
    rel = {n: (runs[n].errors.double() - ex).abs() / ex for n in ("cuda", "dense")}
    worst = int(torch.argmax(torch.where(above, rel["cuda"], 0.0)))
    check(bool((rel["cuda"][above] <= 2e-2).all()), f"paper setting: step "
          f"{worst + 1}: cuda error {float(runs['cuda'].errors[worst]):.6e} vs "
          f"float64 {float(ex[worst]):.6e}")
    print(f"[paper] |error - float64 error| / float64 error over the "
          f"{int(above.sum())} steps above 1e-2 of the starting error: cuda at most "
          f"{float(rel['cuda'][above].max()):.3e}, dense {float(rel['dense'][above].max()):.3e}"
          f" (bound 2e-2); over all {steps4} steps: cuda "
          f"{float(rel['cuda'].max()):.3e}, dense {float(rel['dense'].max()):.3e}")
    rc, rd, r64, ru = (float(runs[n].errors[-1]) / norm
                       for n in ("cuda", "dense", "float64", "uncoded"))
    check(rc < float(runs["cuda"].errors[0]) / norm, "paper setting: no descent")
    print(f"[paper] unresolved per step identical (total "
          f"{int(runs['cuda'].unresolved.sum())}); final rel. error cuda {rc:.6e}, "
          f"dense {rd:.6e}, float64 {r64:.6e}, uncoded {ru:.6e}")
    # The kernel against its plain version at this path's shapes (N=40,
    # V=k/K=20, D=12), on every step's erased worker products along the
    # cuda run's own trajectory.
    theta, err4 = theta0, 0.0
    for t in range(steps4):
        err4 = max(err4, decode_vs_plain(code, coded.worker_products(theta),
                                         masks[t], 12, f"paper setting step {t + 1}"))
        theta, _ = coded.step(theta, masks[t])
    max_abs_err = max(max_abs_err, err4)
    print(f"[paper] kernel vs plain on all {steps4} steps' erased worker products "
          f"(N=40 V=20 D=12): masks identical, max |diff| {err4:.3e}")
    paper4 = {"prob": prob, "mom": mom, "code": code, "masks": masks, "steps": steps4}
    del coded, dense, exact, runs

    # ------------------------------------------------------ 5. full width
    k, K, D, s, m, steps = 32768, 1024, 8, 512, 32768, 20
    code = codes["gaussian", K, 0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    X = torch.randn(m, k, generator=gen, device=dev) / math.sqrt(m)
    theta_star = torch.randn(k, generator=gen, device=dev)
    mom = second_moment(X, X @ theta_star)
    del X
    v = torch.randn(k, generator=gen, device=dev)
    for _ in range(100):                      # power iteration for λ_max(M)
        v = mom.M @ v
        v /= torch.linalg.vector_norm(v)
    lam = float(v @ (mom.M @ v))
    lr = 0.9 / lam
    reset_counts()                             # the encode: one launch for all 32 blocks
    torch.cuda.synchronize()
    pre_peak, enc_held = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_enc = time.perf_counter()
    scheme = Scheme2Blocked.build(code, mom, lr=lr, decode_iters=D,
                                  decode_backend="cuda")
    torch.cuda.synchronize()
    enc_secs = time.perf_counter() - t_enc
    enc_peak = torch.cuda.max_memory_allocated()
    enc_launches = read_counts("full-width encode", matmul_kernel_call=1,
                               split_terms=2)
    M5 = mom.M                                 # kept for phases 18-20
    del mom, v
    masks = torch.stack([FixedCountStragglers(s).sample(gen, code.N, dev)
                         for _ in range(steps)])
    torch.cuda.synchronize()
    print(f"[full] k={k} m={m} N={code.N} K={K} blocks={k // K} D={D} "
          f"stragglers={s}: problem built on the card in "
          f"{time.perf_counter() - t0:.1f} s; lambda_max ~ {lam:.6f} "
          f"(100 power steps), lr = 0.9/lambda = {lr:.6f}; the encode (the GEMM "
          f"kernel, {enc_launches['matmul_kernel_call']} launch for {k // K} blocks, "
          f"{enc_launches['split_terms']} of the split pass) {enc_secs:.3f} s; peak device "
          f"memory during the encode {enc_peak / 2**30:.2f} GiB ({enc_held / 2**30:.2f} GiB "
          f"held before it)")
    theta0 = torch.zeros(k, device=dev)

    reset_counts()                             # the main path's run
    res = run_pgd(scheme, theta0, None, steps, masks=masks, theta_star=theta_star)
    torch.cuda.synchronize()
    launches = read_counts("full width", decode_fused=steps)["decode_fused"]

    ref = run_pgd(dataclasses.replace(scheme, decode_backend="dense"), theta0,
                  None, steps, masks=masks, theta_star=theta_star)
    check(torch.equal(res.unresolved, ref.unresolved),
          "full width: per-step unresolved differs between cuda and dense")
    errs = res.errors.tolist()
    check(all(math.isfinite(x) for x in errs), "full width: non-finite error")
    check(errs[-1] < errs[0], f"full width: error at step {steps} "
          f"({errs[-1]}) not below step 1 ({errs[0]})")
    check(res.theta.shape == (k,) and bool(torch.isfinite(res.theta).all()),
          "full width: bad final iterate")
    full5 = {"code": code, "M": M5, "scheme": scheme, "masks": masks, "theta": res.theta,
             "theta_star": theta_star, "D": D}
    print(f"[full] decode launches {launches} for {steps} steps; unresolved per "
          f"step identical to dense: {res.unresolved.tolist()}")
    print(f"[full] ||theta - theta*|| step 1 {errs[0]:.6f} -> step {steps} "
          f"{errs[-1]:.6f} (dense: {float(ref.errors[-1]):.6f})")
    del ref

    t = [0]

    def one_step():
        scheme.step(res.theta, masks[t[0] % steps])
        t[0] += 1

    step_ms = cuda_ms(one_step, 10)
    peak_gib = max(pre_peak, torch.cuda.max_memory_allocated()) / 2**30
    step_bound_ms = scheme.C_blocks.numel() * 4 / HBM_BYTES_PER_S * 1e3
    products_ms = cuda_ms(lambda: scheme.worker_products(res.theta), 10)
    matmul_ms = cuda_ms(lambda: torch.matmul(scheme.C_blocks, res.theta), 10)
    print(f"[full] {step_ms:.4f} ms per step (CUDA events, 10 steps after 2 "
          f"warm-up); reading C_blocks bounds it at {step_bound_ms:.4f} ms; "
          f"the worker products alone take {products_ms:.4f} ms (as one "
          f"torch.matmul: {matmul_ms:.4f} ms); peak device memory "
          f"{peak_gib:.2f} GiB")
    profile_steps(scheme, res.theta, masks, step_ms)

    # The decode at the main path's shapes: step 1's erased worker products.
    Z = scheme.worker_products(theta0 + 1.0)          # a codeword per block
    err = decode_vs_plain(code, Z, masks[0], D, "full width")
    max_abs_err = max(max_abs_err, err)
    tables = decoder.code_tables(code, dev)
    values = scheme.engine.erase(Z, masks[0]).contiguous()
    H = dense_h(tables.check_idx, tables.check_coeff, code.N)
    kernel_ms = cuda_ms(lambda: peel_decode_cuda(tables, values, masks[0], D), 200)
    plain_ms = cuda_ms(lambda: decode_fused_ref(H, values, masks[0], D), 20)
    p, r = tables.check_idx.shape
    V = values.shape[1]
    once = p * r * 8 + 2 * (code.N * V * 4 + code.N)
    per_round = (p * r * 8 + 2 * code.N * V * 4) * D
    bound_ms = once / HBM_BYTES_PER_S * 1e3
    print(f"[full] decode kernel {kernel_ms:.4f} ms, plain version {plain_ms:.4f} "
          f"ms at N={code.N} V={V} D={D}; bound {bound_ms:.6f} ms ({once} B once) "
          f"or {per_round / HBM_BYTES_PER_S * 1e3:.6f} ms ({per_round} B, "
          f"tables and values every round); max |kernel - plain| {err:.3e}")
    print(f"[full] decode kernel layout: {table_dispatch(tables, 1, V)}")
    # ------------------------ 6. batched and early-exit contracts vs plain
    t0 = time.perf_counter()
    gen6 = torch.Generator(device=dev).manual_seed(args.seed + 6)
    new_err = {"decode_fused_batch": 0.0, "decode_fused_adaptive": 0.0,
               "decode_fused_batch_adaptive": 0.0}
    bit_same = {n: 0 for n in new_err}
    n_new = 0
    for (weights, K, seed), code in codes.items():
        if seed != 0:
            continue
        N = code.N
        tables = decoder.code_tables(code, dev)
        H = dense_h(tables.check_idx, tables.check_coeff, N)
        H64 = H.double()
        G = (torch.as_tensor(code.G, dtype=torch.float64, device=dev)
             if weights == "gaussian" else None)
        worst = {n: 0.0 for n in new_err}
        for B in (1, 8, 64):
            for V in (1, 32):
                for fi, f in enumerate((0.0, 0.25, 0.45)):
                    e = torch.rand((B, N), generator=gen6, device=dev) < f
                    if G is not None:
                        truth = (G @ torch.randn((B, K, V), generator=gen6, device=dev,
                                                 dtype=torch.float64)).float()
                    else:   # integer payloads: every f32 step is exact
                        truth = torch.randint(-8, 9, (B, N, V), generator=gen6,
                                              device=dev).float()
                    garbage = 1e3 * torch.randn((B, N, V), generator=gen6, device=dev)
                    v = torch.where(e[..., None], garbage, truth).contiguous()
                    if B == 1:
                        budgets = torch.tensor([(0, 8, N)[fi]], dtype=torch.int32, device=dev)
                    else:   # mixed per-slot budgets, slot 0 inert
                        pick = torch.randint(0, 5, (B,), generator=gen6, device=dev)
                        budgets = torch.tensor([0, 1, 3, 8, N], dtype=torch.int32,
                                               device=dev)[pick]
                        budgets[0] = 0
                    cases = {
                        "decode_fused_batch": (
                            lambda: peel_decode_batch_cuda(tables, v, e, 8),
                            lambda: decode_fused_batch_ref(H, v, e, 8),
                            lambda: decode_fused_batch_ref(H64, v.double(), e, 8)[0], v, e),
                        "decode_fused_batch_adaptive": (
                            lambda: peel_decode_batch_adaptive_cuda(tables, v, e, budgets),
                            lambda: decode_fused_batch_adaptive_ref(H, v, e, budgets),
                            lambda: decode_fused_batch_adaptive_ref(H64, v.double(), e,
                                                                    budgets)[0], v, e),
                        "decode_fused_adaptive": (
                            lambda: [x[None] for x in peel_decode_adaptive_cuda(
                                tables, v[0], e[0], int(budgets[0]))],
                            lambda: [x[None] for x in decode_fused_adaptive_ref(
                                H, v[0], e[0], int(budgets[0]))],
                            lambda: decode_fused_adaptive_ref(
                                H64, v[0].double(), e[0], int(budgets[0]))[0][None],
                            v[:1], e[:1]),
                    }
                    for name, (kern, plain, d64, vv, ee) in cases.items():
                        kout, pout = kern(), plain()
                        torch.cuda.synchronize()
                        if len(kout) == 3:
                            check(torch.equal(kout[2], pout[2]),
                                  f"{name}: rounds differ {kout[2].tolist()} vs "
                                  f"{pout[2].tolist()}")
                        tt = truth[:vv.shape[0]]
                        err = values_agree(weights, vv, ee, tt, kout[0], kout[1],
                                           pout[0], pout[1], d64)
                        worst[name] = max(worst[name], err)
                        bit_same[name] += int(torch.equal(kout[0], pout[0]))
                        n_new += 1
        for name in new_err:
            new_err[name] = max(new_err[name], worst[name])
        print(f"[contracts] {weights} N={N}: batch, adaptive, batch-adaptive vs plain "
              f"over B in (1, 8, 64), V in (1, 32), f in (0, 0.25, 0.45): masks and "
              f"rounds identical; max |diff| "
              + ", ".join(f"{worst[n]:.3e}" for n in new_err))
    print(f"[contracts] {n_new} cases passed in {time.perf_counter() - t0:.1f} s; values "
          f"bit-identical to the plain version in "
          + ", ".join(f"{bit_same[n]} of {n_new // 3} ({n})" for n in new_err)
          + "; tolerance: exact on pm1 codes, 1e-4*max|c| + 4*max(|plain - c|, "
          "|float64 plain - c|) on Gaussian codes")

    # ------------------------------------------------ 7. the adaptive step
    k7, s7, steps7, budget7 = 1024, 512, 20, 32
    code = codes["gaussian", 1024, 0]
    t0 = time.perf_counter()
    prob7 = make_linear_problem(4 * k7, k7, seed=args.seed, device=dev)
    mom7 = second_moment(prob7.X, prob7.y)
    reset_counts()                             # the encode: one launch of the GEMM kernel
    adaptive = Scheme2.build(code, mom7, lr=prob7.lr, decode_iters=budget7, adaptive=True,
                             decode_backend="cuda")
    torch.cuda.synchronize()
    read_counts("adaptive step encode", matmul_kernel_call=1, split_terms=2)
    gen7 = torch.Generator(device=dev).manual_seed(args.seed + 7)
    masks7 = torch.stack([FixedCountStragglers(s7).sample(gen7, code.N, dev)
                          for _ in range(steps7)])
    theta0 = torch.zeros(k7, device=dev)
    torch.cuda.synchronize()
    print(f"[adaptive] k=K={k7} m={4 * k7} N={code.N} round budget {budget7}, "
          f"{s7} stragglers a step, {steps7} steps: problem built in "
          f"{time.perf_counter() - t0:.1f} s")
    reset_counts()                             # this path's run
    res7 = run_pgd(adaptive, theta0, None, steps7, masks=masks7,
                   theta_star=prob7.theta_star)
    torch.cuda.synchronize()
    launches7 = read_counts("adaptive step", decode_fused_adaptive=steps7)[
        "decode_fused_adaptive"]
    ref7 = run_pgd(dataclasses.replace(adaptive, decode_backend="dense"), theta0, None,
                   steps7, masks=masks7, theta_star=prob7.theta_star)
    check(torch.equal(res7.unresolved, ref7.unresolved),
          "adaptive step: per-step unresolved differs between cuda and dense")
    zeros = torch.zeros((code.N, 1), device=dev)
    rounds7 = {b: [int(decoder.peel_decode_adaptive(code, zeros, m, budget7,
                                                     backend=b).rounds_used)
                   for m in masks7] for b in ("cuda", "dense")}
    check(rounds7["cuda"] == rounds7["dense"],
          f"adaptive step: rounds differ: {rounds7}")
    errs7 = res7.errors.tolist()
    check(all(math.isfinite(x) for x in errs7) and errs7[-1] < errs7[0],
          f"adaptive step: error {errs7[0]} -> {errs7[-1]} does not fall")
    print(f"[adaptive] decode launches {launches7} for {steps7} steps; rounds per step "
          f"identical to dense: {rounds7['cuda']}; unresolved identical: "
          f"{res7.unresolved.tolist()}")
    print(f"[adaptive] ||theta - theta*|| step 1 {errs7[0]:.6f} -> step {steps7} "
          f"{errs7[-1]:.6f} (dense: {float(ref7.errors[-1]):.6f})")
    tables = decoder.code_tables(code, dev)
    H = dense_h(tables.check_idx, tables.check_coeff, code.N)
    z7 = (adaptive.C @ prob7.theta_star)[:, None]
    v7 = adaptive.engine.erase(z7, masks7[0]).contiguous()
    kout = peel_decode_adaptive_cuda(tables, v7, masks7[0], budget7)
    pout = decode_fused_adaptive_ref(H, v7, masks7[0], budget7)
    torch.cuda.synchronize()
    check(int(kout[2]) == int(pout[2]), "adaptive step: kernel and plain rounds differ")
    err7 = values_agree("gaussian", v7[None], masks7[0][None], z7[None], kout[0][None],
                        kout[1][None], pout[0][None], pout[1][None],
                        lambda: decode_fused_adaptive_ref(
                            H.double(), v7.double(), masks7[0], budget7)[0][None])
    new_err["decode_fused_adaptive"] = max(new_err["decode_fused_adaptive"], err7)
    adaptive_ms = cuda_ms(lambda: peel_decode_adaptive_cuda(tables, v7, masks7[0], budget7),
                          200)
    adaptive_plain_ms = cuda_ms(lambda: decode_fused_adaptive_ref(H, v7, masks7[0], budget7),
                                20)
    p, r = tables.check_idx.shape
    used7 = int(kout[2])
    once7 = decode_bytes(p, r, 1, code.N, 1, extra=4)
    adaptive_bound_ms = once7 / HBM_BYTES_PER_S * 1e3
    reread7 = (p * r * 8 + 2 * code.N * 4) * used7
    print(f"[adaptive] decode kernel {adaptive_ms:.4f} ms, plain version "
          f"{adaptive_plain_ms:.4f} ms at N={code.N} V=1, {used7} rounds of {budget7}; "
          f"bound {adaptive_bound_ms:.6f} ms ({once7} B once) or "
          f"{reread7 / HBM_BYTES_PER_S * 1e3:.6f} ms ({reread7} B, tables and values "
          f"every round); max |kernel - plain| {err7:.3e}")
    print(f"[adaptive] decode kernel layout: {table_dispatch(tables, 1, 1)}")
    del prob7
    full5["M7"] = mom7.M

    # ------------------------------------------------- 8. serving at full width
    B8, nq, chunk, budget8 = 64, 320, 4, 32
    reset_counts()                             # the encode: one launch of the GEMM kernel
    scheme8 = Scheme2.build(code, mom7, lr=adaptive.lr, decode_iters=budget8,
                            decode_backend="cuda")
    torch.cuda.synchronize()
    read_counts("serving encode", matmul_kernel_call=1, split_terms=2)
    dense8 = dataclasses.replace(scheme8, decode_backend="dense")
    rng8 = np.random.default_rng(args.seed)
    thetas = rng8.standard_normal((nq, k7)).astype(np.float32)
    heavy = rng8.random(nq) < 0.15
    smasks = rng8.random((nq, code.N)) < np.where(heavy, 0.42, 0.08)[:, None]

    def serve(sch, mode, hook=None):
        bat = CodedQueryBatcher(sch, n_slots=B8, mode=mode,
                                rounds_per_launch=chunk if mode == "continuous" else None)
        for i in range(nq):
            bat.submit(CodedQuery(i, thetas[i], smasks[i]))
        if hook is not None:
            hook(bat)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = bat.run()
        torch.cuda.synchronize()
        return bat, sorted(done, key=lambda q: q.qid), time.perf_counter() - t0

    def attribute_stages(sch, mode):
        """Host-clock seconds of each serving stage over one run of ``sch``
        (a fresh copy of the scheme, so the timers go with it), each stage
        ended by a synchronize so that its device work counts to it; "rest"
        is the run's time outside the named stages (continuous: the
        per-launch stats sync and the gathers of retired gradients;
        lockstep: each wave's assembly, uploads and download; both: the
        batcher's own loop)."""
        acc = {}

        def timed(obj, attr, name):
            fn = getattr(obj, attr)

            def stage(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
                return out
            object.__setattr__(obj, attr, stage)

        def hook(bat):
            eng = sch.engine
            timed(eng, "decode_batch", "decode (budgets up, kernel)")
            timed(eng, "systematic", "epilogue")
            timed(sch, "finish_gradient", "epilogue")
            if mode == "continuous":
                timed(bat, "_admit", "admit (host)")
                timed(bat, "_encode_fresh", "uploads and worker products")
                timed(bat.pool, "launch_budgets", "SlotPool (host)")
                timed(bat.pool, "account", "SlotPool (host)")
            else:
                timed(sch, "gradient_batch", "gradient_batch")

        _, _, secs = serve(sch, mode, hook)
        if "gradient_batch" in acc:      # its products: the part not decode or epilogue
            acc["worker products"] = (
                acc.pop("gradient_batch") - acc["decode (budgets up, kernel)"]
                - acc["epilogue"])
        acc["rest"] = secs - sum(acc.values())
        return acc, secs

    g_exact, g64 = serving_anchors(dense8, mom7, thetas, smasks, budget8, B8)
    fields = ("rounds", "launches", "admitted_launch", "finished_launch", "unresolved")
    serving = {}
    for mode, kname in (("continuous", "decode_fused_batch_adaptive"),
                        ("lockstep", "decode_fused_batch")):
        serve(scheme8, mode)                   # warm-up
        reset_counts()                         # this path's run
        bat, done, secs = serve(scheme8, mode)
        n_launch = read_counts(f"serving {mode}", **{kname: bat.launches})[kname]
        _, ref_done, ref_secs = serve(dense8, mode)
        worst_ratio = 0.0
        for q, w in zip(done, ref_done):
            check(q.qid == w.qid and all(getattr(q, f) == getattr(w, f) for f in fields),
                  f"serving {mode}: query {q.qid} accounting differs: "
                  f"{[getattr(q, f) for f in fields]} vs {[getattr(w, f) for f in fields]}")
            g, gd = torch.from_numpy(q.gradient), torch.from_numpy(w.gradient)
            zero = gd == 0.0
            check(bool((g[zero] == 0.0).all()),
                  f"serving {mode}: query {q.qid} zero-fills other coordinates")
            if bool(zero.all()):
                continue
            bound = serving_bound(gd, g_exact[q.qid].cpu(),
                                  [g64[rule][q.qid].cpu() for rule in ANCHOR_RULES])
            diff = float((g - gd).abs().max())
            check(diff <= bound, f"serving {mode}: query {q.qid} gradient differs by "
                  f"{diff} > {bound}")
            worst_ratio = max(worst_ratio, diff / bound if bound > 0 else 0.0)
        slot_rounds = (sum(q.rounds for q in done) if mode == "continuous"
                       else bat.launches * B8 * budget8)
        serving[mode] = {"launches": n_launch, "secs": secs, "dense_secs": ref_secs,
                         "slot_rounds": slot_rounds}
        print(f"[serving] {mode}: {nq} queries in {secs * 1e3:.2f} ms = "
              f"{nq / secs:.1f} queries/s, {secs / nq * 1e6:.1f} us/query (host clock "
              f"after synchronize; dense backend {ref_secs * 1e3:.1f} ms); {n_launch} "
              f"decode launches = batcher launches; slot-rounds {slot_rounds}; "
              f"accounting identical to dense for all {nq} queries; unresolved total "
              f"{sum(q.unresolved for q in done)}; worst gradient diff / bound "
              f"{worst_ratio:.3f}")
        wall, busy, rows, _ = device_busy(lambda: serve(scheme8, mode))
        print(f"[serving] {mode}: torch.profiler over one run: device busy {busy:.3f} ms "
              f"of {wall:.3f} ms ({100 * busy / wall:.1f}%); busiest kernels:")
        for name, ms in rows[:4]:
            print(f"[serving]   {ms:.4f} ms  {name[:100]}")
        attributed, total = attribute_stages(dataclasses.replace(scheme8), mode)
        print(f"[serving] {mode}: host clock by stage over one run, each stage ended by "
              f"a synchronize ({total * 1e3:.3f} ms in all): " + ", ".join(
                  f"{name} {sec * 1e3:.3f} ms" for name, sec in attributed.items()))
    print(f"[serving] per-query cost continuous / lockstep: "
          f"{serving['continuous']['secs'] / serving['lockstep']['secs']:.3f}")

    # The two decode kernels at the serving shape: the first 64 queries'
    # erased worker products, as the first launch of each mode sees them.
    z8 = (torch.from_numpy(thetas[:B8]).to(dev) @ scheme8.C.T).contiguous()
    m8 = torch.from_numpy(smasks[:B8]).to(dev)
    v8 = scheme8.engine.erase(z8, m8)[..., None].contiguous()
    g8 = torch.full((B8,), chunk, dtype=torch.int32, device=dev)
    serve_kernels = {
        "decode_fused_batch_adaptive": (
            lambda: peel_decode_batch_adaptive_cuda(tables, v8, m8, g8),
            lambda: decode_fused_batch_adaptive_ref(H, v8, m8, g8),
            lambda: decode_fused_batch_adaptive_ref(H.double(), v8.double(), m8, g8)[0],
            B8 * 8),
        "decode_fused_batch": (
            lambda: peel_decode_batch_cuda(tables, v8, m8, budget8),
            lambda: decode_fused_batch_ref(H, v8, m8, budget8),
            lambda: decode_fused_batch_ref(H.double(), v8.double(), m8, budget8)[0], 0),
    }
    times = {"decode_fused_adaptive": (adaptive_ms, adaptive_plain_ms, adaptive_bound_ms)}
    for name, (kern, plain, d64, extra) in serve_kernels.items():
        kout, pout = kern(), plain()
        torch.cuda.synchronize()
        if len(kout) == 3:
            check(torch.equal(kout[2], pout[2]), f"{name}: serving-shape rounds differ")
        err = values_agree("gaussian", v8, m8, z8[..., None], kout[0], kout[1], pout[0],
                           pout[1], d64)
        new_err[name] = max(new_err[name], err)
        k_ms, p_ms = cuda_ms(kern, 200), cuda_ms(plain, 5)
        rounds = int(kout[2].max()) if len(kout) == 3 else budget8
        once = decode_bytes(p, r, B8, code.N, 1, extra=extra)
        reread = (p * r * 8 + 2 * B8 * code.N * 4) * rounds
        times[name] = (k_ms, p_ms, once / HBM_BYTES_PER_S * 1e3)
        print(f"[serving] {name} kernel {k_ms:.4f} ms per launch (CUDA events), plain "
              f"version {p_ms:.4f} ms at B={B8} N={code.N} V=1, {rounds} rounds; bound "
              f"{times[name][2]:.6f} ms ({once} B once) or "
              f"{reread / HBM_BYTES_PER_S * 1e3:.6f} ms ({reread} B, tables and values "
              f"every round); max |kernel - plain| {err:.3e}; {table_dispatch(tables, B8, 1)}")
    # ------------------------------------------- 9. seeded kernels vs plain
    t0 = time.perf_counter()
    seeded_codes = {N: make_seeded_ldpc(N // 2, seed=0) for N in (2048, 32768)}
    t_ldpc = time.perf_counter() - t0
    t0 = time.perf_counter()
    K11, p11 = 16384, 8192
    ldgm = make_seeded_ldgm(K11, p11, row_weight=8, seed=0)
    print(f"[seeded] built make_seeded_ldpc at N in {tuple(seeded_codes)} in {t_ldpc:.1f} s, "
          f"make_seeded_ldgm({K11}, {p11}, row_weight=8) (N = {ldgm.N}) in "
          f"{time.perf_counter() - t0:.1f} s (host numpy, H and G materialized)")
    t0 = time.perf_counter()
    gen9 = torch.Generator(device=dev).manual_seed(args.seed + 9)
    n9 = {"decode_seeded": 0, "decode_seeded_batch": 0, "decode_seeded_adaptive": 0,
          "decode_seeded_batch_adaptive": 0}
    for N, code in seeded_codes.items():
        st = decoder.seeded_spec(code)
        tables = decoder.code_tables(code, dev)
        for B in (1, 8, 64):
            for V in (1, 2):
                for fi, f in enumerate((0.0, 0.25, 0.45)):
                    e = torch.rand((B, N), generator=gen9, device=dev) < f
                    v = torch.randn((B, N, V), generator=gen9, device=dev)
                    v = torch.where(e[..., None], 1e3 * v, v).contiguous()
                    if B == 1:
                        budgets = torch.tensor([(0, 8, N)[fi]], dtype=torch.int32,
                                               device=dev)
                    else:   # mixed per-slot budgets, slot 0 inert
                        pick = torch.randint(0, 5, (B,), generator=gen9, device=dev)
                        budgets = torch.tensor([0, 1, 3, 8, N], dtype=torch.int32,
                                               device=dev)[pick]
                        budgets[0] = 0
                    cases = {
                        "decode_seeded_batch": (
                            lambda: peel_decode_batch_seeded_cuda(st, v, e, 8),
                            lambda: decode_seeded_batch_ref(st, v, e, 8),
                            lambda: peel_decode_batch_cuda(tables, v, e, 8)),
                        "decode_seeded_batch_adaptive": (
                            lambda: peel_decode_batch_adaptive_seeded_cuda(st, v, e, budgets),
                            lambda: decode_seeded_batch_adaptive_ref(st, v, e, budgets),
                            lambda: peel_decode_batch_adaptive_cuda(tables, v, e, budgets)),
                    }
                    if B == 1:
                        mi = int(budgets[0])
                        cases["decode_seeded"] = (
                            lambda: peel_decode_seeded_cuda(st, v[0], e[0], 8),
                            lambda: decode_seeded_ref(st, v[0], e[0], 8),
                            lambda: peel_decode_cuda(tables, v[0], e[0], 8))
                        cases["decode_seeded_adaptive"] = (
                            lambda: peel_decode_adaptive_seeded_cuda(st, v[0], e[0], mi),
                            lambda: decode_seeded_adaptive_ref(st, v[0], e[0], mi),
                            lambda: peel_decode_adaptive_cuda(tables, v[0], e[0], mi))
                    for name, (kern, plain, table) in cases.items():
                        kout, pout, tout = kern(), plain(), table()
                        torch.cuda.synchronize()
                        check(all_same(kout, pout), f"{name} N={N} B={B} V={V} f={f}: "
                              f"kernel and plain version differ")
                        check(all_same(kout, tout), f"{name} N={N} B={B} V={V} f={f}: "
                              f"seeded and table kernels differ")
                        n9[name] += 1
    print(f"[seeded] decode contracts on make_seeded_ldpc codes at N in {tuple(seeded_codes)}, "
          f"B in (1, 8, 64), V in (1, 2), f in (0, 0.25, 0.45), mixed budgets with 0: "
          + ", ".join(f"{n} {c} cases" for n, c in n9.items())
          + f"; masks, rounds and values bit-identical to the plain version and to "
          f"the table kernel on the same code ({time.perf_counter() - t0:.1f} s)")
    st11 = encoding.generator_structure_of(ldgm)
    n_enc = 0
    for V in (1, 2):
        y = torch.randn((K11, V), generator=gen9, device=dev)
        y[0, 0] = -0.0
        for row0, n_out in ((0, ldgm.N), (K11 - K11 // 4, K11 // 2), (ldgm.N - 300, 1000)):
            got = encode_seeded_fused_cuda(st11, y, row0, n_out)
            want = encode_seeded_ref(st11, y, row0, n_out)
            torch.cuda.synchronize()
            check(same_bits(got, want), f"encode V={V} rows [{row0}, {row0 + n_out}): "
                  f"kernel and plain version differ")
            n_enc += 1
    print(f"[seeded] encode_seeded_fused over row windows [0, N), [3K/4, 5K/4), "
          f"[N - 300, N + 700), V in (1, 2): {n_enc} cases bit-identical to the plain "
          f"version")

    # Past the old caps of 16: each sorting-network width (32, 64) and the
    # selection past 64, and 20 and 32 layers.
    t0 = time.perf_counter()
    n_wide = 0
    for K, l, r in ((64, 20, 24), (160, 20, 40), (720, 8, 80)):
        code = make_seeded_ldpc(K, l=l, r=r, seed=1)
        st = decoder.seeded_spec(code)
        check((st.row_weight, st.layers) == (r, l), f"({l}, {r}) code: {st.layers} layers")
        tables = decoder.code_tables(code, dev)
        for f in (0.02, 0.1, 0.3):
            e = torch.rand((8, code.N), generator=gen9, device=dev) < f
            v = torch.randn((8, code.N, 2), generator=gen9, device=dev)
            v = torch.where(e[..., None], 1e3 * v, v).contiguous()
            budgets = torch.tensor([0, 1, 3, 8, code.N, 2, 5, code.N], dtype=torch.int32,
                                   device=dev)
            for kern, plain, table in (
                    (lambda: peel_decode_batch_seeded_cuda(st, v, e, 8),
                     lambda: decode_seeded_batch_ref(st, v, e, 8),
                     lambda: peel_decode_batch_cuda(tables, v, e, 8)),
                    (lambda: peel_decode_batch_adaptive_seeded_cuda(st, v, e, budgets),
                     lambda: decode_seeded_batch_adaptive_ref(st, v, e, budgets),
                     lambda: peel_decode_batch_adaptive_cuda(tables, v, e, budgets)),
                    (lambda: peel_decode_seeded_cuda(st, v[4], e[4], 8),
                     lambda: decode_seeded_ref(st, v[4], e[4], 8),
                     lambda: peel_decode_cuda(tables, v[4], e[4], 8))):
                kout, pout, tout = kern(), plain(), table()
                torch.cuda.synchronize()
                check(all_same(kout, pout) and all_same(kout, tout),
                      f"({l}, {r}) code f={f}: seeded kernel, plain version and table "
                      f"kernel differ")
                n_wide += 1
    for K, p_rows, rw in ((192, 96, 24), (64, 160, 8), (128, 64, 64), (160, 40, 80)):
        st = encoding.generator_structure_of(make_seeded_ldgm(K, p_rows, row_weight=rw,
                                                              seed=2))
        y = torch.randn((K, 3), generator=gen9, device=dev)
        y[0, 0] = -0.0
        for row0, n_out in ((0, K + p_rows), (K - 5, 40), (K + p_rows - 3, 9)):
            got = encode_seeded_fused_cuda(st, y, row0, n_out)
            want = encode_seeded_ref(st, y, row0, n_out)
            torch.cuda.synchronize()
            check(same_bits(got, want), f"encode row weight {rw}, {st.layers} layers, rows "
                  f"[{row0}, {row0 + n_out}): kernel and plain version differ")
            n_wide += 1
    print(f"[seeded] past the old caps of 16: make_seeded_ldpc (l, r) in ((20, 24), (20, 40), "
          f"(8, 80)) decodes and make_seeded_ldgm row weights (24, 8 over 20 layers, 64, 80) "
          f"encodes: {n_wide} cases bit-identical to the plain versions and the table "
          f"kernel ({time.perf_counter() - t0:.1f} s)")

    # ---------------------------------------- 10. Path B: large-N seeded decode
    N10, V10, D10, B10 = 32768, 2, 8, 8
    code_m = seeded_codes[N10]
    code_s = SeededLDPC(N=N10, K=N10 // 2, l=4, r=8, seed=0)
    big = SeededLDPC(N=262144, K=131072, l=4, r=8, seed=0)
    gen10 = torch.Generator(device=dev).manual_seed(args.seed + 10)
    inputs10 = {}
    for f in (0.25, 0.45):
        e = torch.rand((B10, N10), generator=gen10, device=dev) < f
        v = torch.where(e[..., None], 0.0, torch.randn((B10, N10, V10), generator=gen10,
                                                       device=dev))
        budgets = torch.tensor([0, 1, 3, 8, 8, 3, 1, 8], dtype=torch.int32, device=dev)
        inputs10[f] = (v, e, budgets)
    eb = torch.rand(big.N, generator=gen10, device=dev) < 0.25
    vb = torch.where(eb[:, None], 0.0, torch.randn((big.N, 1), generator=gen10, device=dev))

    def path_b(code):
        fixed = CodedComputeEngine(code, decode_iters=D10)
        early = CodedComputeEngine(code, decode_iters=D10, adaptive=True)
        out = {}
        for f, (v, e, budgets) in inputs10.items():
            out[f] = (fixed.decode(v[0], e[0]), fixed.decode_batch(v, e),
                      early.decode(v[0], e[0]), early.decode_batch(v, e, budgets=budgets))
        return out

    reset_counts()                             # this path's run
    t0 = time.perf_counter()
    runs10 = {"make_seeded_ldpc": path_b(code_m), "SeededLDPC": path_b(code_s)}
    big_out = decoder.peel_decode(big, vb, eb, D10)
    torch.cuda.synchronize()
    secs10 = time.perf_counter() - t0
    launches10 = read_counts("Path B", decode_seeded=5, decode_seeded_batch=4,
                             decode_seeded_adaptive=4, decode_seeded_batch_adaptive=4)
    st10 = decoder.seeded_spec(code_s)
    err10 = 0.0
    for f, (v, e, budgets) in inputs10.items():
        plain = (decode_seeded_ref(st10, v[0], e[0], D10),
                 decode_seeded_batch_ref(st10, v, e, D10),
                 decode_seeded_adaptive_ref(st10, v[0], e[0], D10),
                 decode_seeded_batch_adaptive_ref(st10, v, e, budgets))
        for a, b, c in zip(runs10["make_seeded_ldpc"][f], runs10["SeededLDPC"][f], plain):
            check(all_same(a, b), f"Path B f={f}: make_seeded_ldpc and SeededLDPC differ")
            check(all_same(tuple(a)[:2], c[:2]) and (len(c) == 2 or same_bits(a[2], c[2])),
                  f"Path B f={f}: kernel and plain version differ")
            err10 = max(err10, float((a[0] - c[0]).abs().max()))
        unres = [int(x.erased.sum()) for x in runs10["SeededLDPC"][f]]
        print(f"[pathB] N={N10} V={V10} D={D10} f={f}: engine decode, decode_batch (B={B10}), "
              f"adaptive decode and decode_batch (budgets {budgets.tolist()}) identical on "
              f"make_seeded_ldpc and SeededLDPC and to the plain versions; unresolved "
              f"{unres}")
    big_plain = decode_seeded_ref(decoder.seeded_spec(big), vb, eb, D10)
    torch.cuda.synchronize()
    check(all_same(tuple(big_out)[:2], big_plain), "N=262144: kernel and plain differ")
    print(f"[pathB] structure-only SeededLDPC N={big.N} V=1 D={D10} f=0.25: "
          f"{int(eb.sum())} erased -> {int(big_out.erased.sum())} unresolved, bit-identical "
          f"to the plain version; the whole path ran in {secs10:.2f} s (host clock); "
          f"launches {launches10}")
    # The four kernels at Path B's shapes (f = 0.25), and at N = 262144.
    v, e, budgets = inputs10[0.25]
    v0, e0 = v[0].contiguous(), e[0].contiguous()
    seeded_times, seeded_plain = {}, {}
    for name, kern, plain, B, extra in (
            ("decode_seeded", lambda: peel_decode_seeded_cuda(st10, v0, e0, D10),
             lambda: decode_seeded_ref(st10, v0, e0, D10), 1, 0),
            ("decode_seeded_batch", lambda: peel_decode_batch_seeded_cuda(st10, v, e, D10),
             lambda: decode_seeded_batch_ref(st10, v, e, D10), B10, 0),
            ("decode_seeded_adaptive",
             lambda: peel_decode_adaptive_seeded_cuda(st10, v0, e0, D10),
             lambda: decode_seeded_adaptive_ref(st10, v0, e0, D10), 1, 8),
            ("decode_seeded_batch_adaptive",
             lambda: peel_decode_batch_adaptive_seeded_cuda(st10, v, e, budgets),
             lambda: decode_seeded_batch_adaptive_ref(st10, v, e, budgets), B10, 8 * B10)):
        k_ms, p_ms = cuda_ms(kern, 50), cuda_ms(plain, 5)
        seeded_plain[name] = plain()
        once = 2 * B * N10 * V10 * 4 + 2 * B * N10 + extra
        seeded_times[name] = (k_ms, p_ms, once / HBM_BYTES_PER_S * 1e3)
        print(f"[pathB] {name} kernel {k_ms:.4f} ms, plain version {p_ms:.4f} ms at "
              f"N={N10} B={B} V={V10} D={D10} f=0.25; bound "
              f"{seeded_times[name][2]:.6f} ms ({once} B once, no table); launched "
              f"{seeded_dispatch(st10, B, V10)}")
    st_big = decoder.seeded_spec(big)
    big_ms = cuda_ms(lambda: peel_decode_seeded_cuda(st_big, vb, eb, D10), 5)
    big_once = 2 * big.N * 4 + 2 * big.N
    print(f"[pathB] decode_seeded at N={big.N} V=1 D={D10}: kernel {big_ms:.4f} ms; bound "
          f"{big_once / HBM_BYTES_PER_S * 1e3:.6f} ms ({big_once} B once); launched "
          f"{seeded_dispatch(st_big, 1, 1)}")
    # The dispatch by shape: each layout a pattern can take (one block, or a
    # cluster of 2, 4 or 8), bit for bit against the plain version, timed.
    # And B = 64, where 64 clusters of 8 (or 4) would not all be resident.
    e64 = torch.rand((64, N10), generator=gen10, device=dev) < 0.25
    v64 = torch.where(e64[..., None], 0.0, torch.randn((64, N10, V10), generator=gen10,
                                                       device=dev))
    plain64 = decode_seeded_batch_ref(st10, v64, e64, D10)
    by_cluster = {}
    for C in (1, 2, 4, 8):
        with peel_ops.forced_cluster(C):
            row = []
            for stc, fn, plain, reps in (
                    (st10, lambda: peel_decode_seeded_cuda(st10, v0, e0, D10),
                     seeded_plain["decode_seeded"], 20),
                    (st10, lambda: peel_decode_batch_seeded_cuda(st10, v, e, D10),
                     seeded_plain["decode_seeded_batch"], 20),
                    (st10, lambda: peel_decode_batch_seeded_cuda(st10, v64, e64, D10), plain64,
                     10),
                    (st_big, lambda: peel_decode_seeded_cuda(st_big, vb, eb, D10), big_plain, 5)):
                if not peel_ops.seeded_cluster_fits(stc, C):
                    row.append(None)
                    continue
                check(all_same(tuple(fn())[:2], plain[:2]), f"Path B, a cluster of {C}: "
                      f"kernel and plain version differ")
                row.append(cuda_ms(fn, reps))
            by_cluster[C] = row
    print(f"[pathB] by blocks a pattern (1: one block; 2, 4, 8: a cluster), bit for bit: "
          + "; ".join(f"{C}: " + ", ".join("does not fit" if x is None else f"{x:.4f}"
                                           for x in row) for C, row in by_cluster.items())
          + f" ms (decode_seeded B=1, decode_seeded_batch B={B10} and B=64, decode_seeded "
          f"N={big.N}); the dispatch takes "
          + ", ".join(f"{peel_ops.seeded_layout(stc, B, Vc, dev)[0]} at {what}" for stc, B, Vc, what in
                      ((st10, 1, V10, "B=1"), (st10, B10, V10, f"B={B10}"),
                       (st10, 64, V10, "B=64"), (st_big, 1, 1, f"N={big.N}"))))
    del e64, v64, plain64
    del runs10, big_out, big_plain, vb, eb

    # ----------------------- 11. Path A: Scheme 2 with the fused seeded encode
    k, D11, s11, m11, steps11 = K11, 8, 2458, 32768, 20
    t0 = time.perf_counter()
    gen11 = torch.Generator(device=dev).manual_seed(args.seed + 11)
    X = torch.randn(m11, k, generator=gen11, device=dev) / math.sqrt(m11)
    theta_star = torch.randn(k, generator=gen11, device=dev)
    mom = second_moment(X, X @ theta_star)
    del X
    v = torch.randn(k, generator=gen11, device=dev)
    for _ in range(100):                      # power iteration for λ_max(M)
        v = mom.M @ v
        v /= torch.linalg.vector_norm(v)
    lr = 0.9 / float(v @ (mom.M @ v))
    fused = Scheme2.build_seeded(ldgm, mom, lr=lr, decode_iters=D11, encode_fused=True)
    table = dataclasses.replace(fused, encode_fused=False)
    masks = torch.stack([FixedCountStragglers(s11).sample(gen11, ldgm.N, dev)
                         for _ in range(steps11)])
    theta0 = torch.zeros(k, device=dev)
    torch.cuda.synchronize()
    print(f"[pathA] k=K={k} m={m11} N={ldgm.N} D={D11} stragglers={s11}: M "
          f"({mom.M.numel() * 4 / 2**30:.2f} GiB) built on the card in "
          f"{time.perf_counter() - t0:.1f} s, lr = {lr:.6f}")
    reset_counts()                             # the main path's run
    res11 = run_pgd(fused, theta0, None, steps11, masks=masks, theta_star=theta_star)
    torch.cuda.synchronize()
    launches11 = read_counts("Path A", encode_seeded_fused=steps11, decode_fused=steps11)
    ref11 = run_pgd(table, theta0, None, steps11, masks=masks, theta_star=theta_star)
    torch.cuda.synchronize()
    check(all_same(res11, ref11), "Path A: fused-encode and table-gather runs differ")
    errs11 = res11.errors.tolist()
    check(all(math.isfinite(x) for x in errs11) and errs11[-1] < errs11[0],
          f"Path A: error {errs11[0]} -> {errs11[-1]} does not fall")
    print(f"[pathA] launches {launches11} in {steps11} steps; iterates, errors and "
          f"unresolved bit-identical to the table-gather run; unresolved per step "
          f"{res11.unresolved.tolist()}")
    print(f"[pathA] ||theta - theta*|| step 1 {errs11[0]:.6f} -> step {steps11} "
          f"{errs11[-1]:.6f}")
    t = [0]

    def step11():
        fused.step(res11.theta, masks[t[0] % steps11])
        t[0] += 1

    step11_ms = cuda_ms(step11, 10)
    mv_ms = cuda_ms(lambda: mom.M @ res11.theta, 20)
    print(f"[pathA] {step11_ms:.4f} ms per step (CUDA events, 10 steps after 2 warm-up); "
          f"reading M once bounds it at {mom.M.numel() * 4 / HBM_BYTES_PER_S * 1e3:.4f} ms; "
          f"the product M theta alone takes {mv_ms:.4f} ms")
    profile_steps(fused, res11.theta, masks, step11_ms)
    # The encode at the step's shape: y = M theta, the whole codeword.
    y11 = (mom.M @ res11.theta)[:, None].contiguous()
    got, want = encode_seeded_fused_cuda(st11, y11), encode_seeded_ref(st11, y11, 0, ldgm.N)
    torch.cuda.synchronize()
    check(same_bits(got, want), "Path A encode: kernel and plain version differ")
    enc_err = float((got - want).abs().max())
    idx, coeff = encoding.generator_gather_tables(ldgm, dev)
    rw = idx.shape[1]          # the generator as CSR: identity rows, then P's rows
    crow = torch.cat([torch.arange(K11 + 1, device=dev),
                      K11 + rw * torch.arange(1, p11 + 1, device=dev)])
    G_csr = torch.sparse_csr_tensor(
        crow, torch.cat([torch.arange(K11, device=dev), idx[K11:].reshape(-1).long()]),
        torch.cat([torch.ones(K11, device=dev), coeff[K11:].reshape(-1)]),
        (ldgm.N, K11))
    lib_out = torch.sparse.mm(G_csr, y11)
    check(bool(torch.allclose(lib_out, got, rtol=1e-5, atol=1e-5 * float(y11.abs().max()))),
          "Path A encode: torch.sparse.mm disagrees beyond f32 summation order")
    enc_ms = cuda_ms(lambda: encode_seeded_fused_cuda(st11, y11), 200)
    enc_plain_ms = cuda_ms(lambda: encode_seeded_ref(st11, y11, 0, ldgm.N), 20)
    enc_lib_ms = cuda_ms(lambda: torch.sparse.mm(G_csr, y11), 200)
    enc_once = (K11 + ldgm.N) * 4
    enc_bound_ms = enc_once / HBM_BYTES_PER_S * 1e3
    print(f"[pathA] encode_seeded_fused kernel {enc_ms:.4f} ms, plain version "
          f"{enc_plain_ms:.4f} ms, torch.sparse.mm on the CSR generator {enc_lib_ms:.4f} "
          f"ms at K={K11} N={ldgm.N} V=1; bound {enc_bound_ms:.6f} ms ({enc_once} B "
          f"once); kernel bit-identical to the plain version")
    # The table decode at the step's shape: the whole codeword of M theta,
    # step 1's 2458 stragglers erased, D = 8, bit for bit against its plain
    # version, timed.
    tables11 = decoder.code_tables(ldgm, dev)
    v11 = torch.where(masks[0][:, None], 0.0, got).contiguous()
    kout11 = peel_decode_cuda(tables11, v11, masks[0], D11)
    pout11 = decode_table_ref(tables11.check_idx, tables11.check_coeff, v11, masks[0], D11)
    torch.cuda.synchronize()
    check(all_same(kout11, pout11), "Path A decode: kernel and plain version differ")
    dec11_ms = cuda_ms(lambda: peel_decode_cuda(tables11, v11, masks[0], D11), 200)
    dec11_plain_ms = cuda_ms(lambda: decode_table_ref(tables11.check_idx, tables11.check_coeff,
                                                      v11, masks[0], D11), 20)
    p11r, r11 = tables11.check_idx.shape
    dec11_once = decode_bytes(p11r, r11, 1, ldgm.N, 1)
    dec11_bound_ms = dec11_once / HBM_BYTES_PER_S * 1e3
    print(f"[pathA] decode_fused kernel {dec11_ms:.4f} ms, plain version {dec11_plain_ms:.4f} "
          f"ms at N={ldgm.N} p={p11r} r={r11} V=1 D={D11}, {int(masks[0].sum())} erased, "
          f"{int((masks[0] & ~kout11[1]).sum())} resolved; bound {dec11_bound_ms:.6f} ms "
          f"({dec11_once} B once); bit-identical to the plain version; "
          f"{table_dispatch(tables11, 1, 1)}")
    del mom, fused, table, res11, ref11, G_csr

    # ------------------------------------------- 12. replay kernel vs plain
    t0 = time.perf_counter()
    gen12 = torch.Generator(device=dev).manual_seed(args.seed + 12)
    replay_codes = {"gaussian N=40": codes["gaussian", 20, 0],
                    "gaussian N=512": make_parity_only_ldpc(256, seed=0),
                    "pm1 N=512": make_parity_only_ldpc(256, seed=0, values="pm1")}
    n12 = {"fixed": 0, "adaptive": 0, "batch": 0, "batch_adaptive": 0}
    nan_cases = nan_payload_same = 0
    err12 = 0.0
    for cname, code in replay_codes.items():
        N = code.N
        tables = decoder.code_tables(code, dev)
        for B in (1, 8, 64):
            for V in (1, 32):
                for fi, f in enumerate((0.0, 0.25, 0.45)):
                    e = torch.rand((B, N), generator=gen12, device=dev) < f
                    if cname.startswith("pm1"):     # integer payloads: every step exact
                        v = torch.randint(-8, 9, (B, N, V), generator=gen12, device=dev).float()
                    else:
                        v = torch.randn((B, N, V), generator=gen12, device=dev)
                    v = torch.where(e[..., None], 1e3 * v, v)
                    pos = torch.nonzero(e[0])[:2, 0]
                    v[0, pos] = torch.tensor([float("nan"), float("inf")],
                                             device=dev)[:len(pos), None]
                    v = v.contiguous()
                    if B == 1:
                        budgets = torch.tensor([(0, 8, N)[fi]], dtype=torch.int32, device=dev)
                    else:   # mixed per-slot budgets, slot 0 inert
                        pick = torch.randint(0, 5, (B,), generator=gen12, device=dev)
                        budgets = torch.tensor([0, 1, 3, 8, N], dtype=torch.int32,
                                               device=dev)[pick]
                        budgets[0] = 0
                    eh = e.cpu().numpy()
                    scheds = [decoder.compile_peel_schedule(code, eh[b]) for b in range(B)]
                    hi1 = decoder.replay_operands(scheds[:1], "hi", dev)
                    lo = decoder.replay_operands(scheds, "lo", dev)
                    one = int(budgets[0])
                    cases = {
                        "fixed": (hi1, v[:1], e[:1], 8,
                                  lambda: peel_decode_batch_cuda(tables, v[:1], e[:1], 8)),
                        "adaptive": (hi1, v[:1], e[:1], one,
                                     lambda: [x[None] for x in peel_decode_adaptive_cuda(
                                         tables, v[0], e[0], one)]),
                        "batch": (lo, v, e, 8,
                                  lambda: peel_decode_batch_cuda(tables, v, e, 8)),
                        "batch_adaptive": (lo, v, e, budgets,
                                           lambda: peel_decode_batch_adaptive_cuda(
                                               tables, v, e, budgets)),
                    }
                    for name, (pack, vv, ee, bud, flood) in cases.items():
                        kout = peel_decode_replay_cuda(pack, vv, ee, bud)
                        pout = replay_ref(*pack, vv, ee, bud)
                        fout = flood()
                        torch.cuda.synchronize()
                        what = f"replay {name} {cname} B={B} V={V} f={f}"
                        check(same_bits_nan(kout[0], pout[0]) and torch.equal(kout[1], pout[1])
                              and torch.equal(kout[2], pout[2]),
                              f"{what}: kernel and plain version differ")
                        check(torch.equal(kout[1], fout[1]),
                              f"{what}: masks differ from the flooding kernel's")
                        if "adaptive" in name:
                            check(torch.equal(kout[2], fout[2]),
                                  f"{what}: rounds differ from the flooding kernel's")
                        if bool(torch.isnan(pout[0]).any()):
                            nan_cases += 1
                            nan_payload_same += int(same_bits(kout[0], pout[0]))
                        fin = ~torch.isnan(pout[0])
                        if bool(fin.any()):
                            err12 = max(err12, float((kout[0][fin] - pout[0][fin]).abs().max()))
                        n12[name] += 1
    print(f"[replay] kernel vs plain on the (40, 20) code and the (3, 6) code at K = 256 "
          f"(Gaussian and pm1), B in (1, 8, 64), V in (1, 32), f in (0, 0.25, 0.45), "
          f"mixed budgets with 0, NaN and inf in erased entries: "
          + ", ".join(f"{n} {c} cases" for n, c in n12.items())
          + f"; values bit-identical (NaNs by position; NaN payloads too in "
          f"{nan_payload_same} of {nan_cases} cases with NaNs), masks and rounds "
          f"identical, and equal to the flooding kernel's; max |diff| {err12:.3e} "
          f"({time.perf_counter() - t0:.1f} s)")

    # --------------------------------- 13. the recurring-straggler stream
    N13, P13, Q13, budget13 = 8192, 8, 64, 32
    t0 = time.perf_counter()
    code13 = make_parity_only_ldpc(N13 // 2, seed=args.seed)
    rng13 = np.random.default_rng(args.seed)
    pats13 = rng13.random((P13, N13)) < 0.25
    vals13 = rng13.standard_normal((Q13, N13)).astype(np.float32)
    erased13 = pats13[np.arange(Q13) % P13]
    rx13 = torch.from_numpy(np.where(erased13, 0.0, vals13)).to(dev)
    er13 = torch.from_numpy(erased13).to(dev)
    cache13 = ScheduleCache()
    replay13 = CodedComputeEngine(code13, decode_iters=budget13, backend="replay",
                                  adaptive=True, schedule_cache=cache13)
    flood13 = CodedComputeEngine(code13, decode_iters=budget13, backend="cuda",
                                 adaptive=True)
    torch.cuda.synchronize()
    print(f"[stream] make_parity_only_ldpc({N13 // 2}) (N = {N13}) built in "
          f"{time.perf_counter() - t0:.1f} s; {P13} patterns at q = 0.25 cycled over "
          f"{Q13} queries, budget {budget13}")
    reset_counts()                             # this path's run: a cold cache
    t0 = time.perf_counter()
    out13 = [replay13.decode(rx13[i], er13[i]) for i in range(Q13)]
    torch.cuda.synchronize()
    cold13 = time.perf_counter() - t0
    launches13 = read_counts("replay stream", decode_replay=Q13)["decode_replay"]
    st13 = cache13.stats()
    check(st13["misses"] == P13 and st13["hit_rate"] == 1 - P13 / Q13,
          f"replay stream: cold-cache stats {st13}")
    fl13 = [flood13.decode(rx13[i], er13[i]) for i in range(Q13)]
    torch.cuda.synchronize()
    for i in range(Q13):
        check(torch.equal(out13[i].erased, fl13[i].erased)
              and int(out13[i].rounds_used) == int(fl13[i].rounds_used),
              f"replay stream: query {i} masks or rounds differ from the cuda decode's")
        check(bool(torch.isfinite(out13[i].values).all()), "replay stream: non-finite values")
    for i in range(P13):                       # the kernel against its plain version
        pack = decoder.replay_operands([cache13.get(code13, erased13[i])], "hi", dev)
        vv, ee = rx13[i][None, :, None].contiguous(), er13[i][None].contiguous()
        kout = peel_decode_replay_cuda(pack, vv, ee, budget13)
        pout = replay_ref(*pack, vv, ee, budget13)
        torch.cuda.synchronize()
        check(all_same(kout, pout) and same_bits(kout[0][0, :, 0], out13[i].values),
              f"replay stream: pattern {i}: kernel, plain version and engine differ")

    def stream13(eng):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(Q13):
            eng.decode(rx13[i], er13[i])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    secs13 = {"replay": [], "cuda": []}
    for _ in range(3):                         # turns: replay, cuda, cuda, replay, ...
        for name in ("replay", "cuda"):
            secs13[name].append(stream13(replay13 if name == "replay" else flood13))
    us13 = {n: float(np.median(t)) / Q13 * 1e6 for n, t in secs13.items()}
    rounds13 = [int(d.rounds_used) for d in out13[:P13]]
    entries13 = [cache13.get(code13, erased13[i]).n_resolved for i in range(P13)]
    print(f"[stream] cold cache: {launches13} replay launches for {Q13} decodes, cache "
          f"{st13}; masks and rounds identical to the cuda adaptive decode's (rounds per "
          f"pattern {rounds13}, resolved {entries13}); {cold13 / Q13 * 1e6:.1f} us/query cold")
    print(f"[stream] warm cache, median of 3 runs of {Q13} queries (host clock after "
          f"synchronize): replay {us13['replay']:.1f} us/query, cuda adaptive "
          f"{us13['cuda']:.1f} us/query, ratio {us13['cuda'] / us13['replay']:.3f}")
    pack13 = decoder.replay_operands([cache13.get(code13, erased13[0])], "hi", dev)
    vv13, ee13 = rx13[0][None, :, None].contiguous(), er13[0][None].contiguous()
    stream_k_ms = cuda_ms(lambda: peel_decode_replay_cuda(pack13, vv13, ee13, budget13), 200)
    stream_f_ms = cuda_ms(lambda: peel_decode_adaptive_cuda(decoder.code_tables(code13, dev),
                                                            rx13[0][:, None].contiguous(),
                                                            er13[0], budget13), 200)
    print(f"[stream] one pattern: replay kernel {stream_k_ms:.4f} ms, cuda adaptive kernel "
          f"{stream_f_ms:.4f} ms (CUDA events, {rounds13[0]} rounds)")
    del out13, fl13

    # ------------------------------------------- 14. replay serving at full width
    code = codes["gaussian", 1024, 0]
    budget14 = budget8
    # The scheme brings no schedule cache, so each batcher keeps its own of
    # the default size: every run serves phase 8's traffic cold, where each
    # query brings a pattern no earlier query had.
    scheme14 = Scheme2.build(code, mom7, lr=adaptive.lr, decode_iters=budget14,
                             decode_backend="replay")
    flood14 = dataclasses.replace(scheme14, decode_backend="cuda")

    def serve14(sch):
        bat = CodedQueryBatcher(sch, n_slots=B8, rounds_per_launch=budget14)
        for i in range(nq):
            bat.submit(CodedQuery(i, thetas[i], smasks[i]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = bat.run()
        torch.cuda.synchronize()
        return bat, sorted(done, key=lambda q: q.qid), time.perf_counter() - t0

    reset_counts()                             # the main path's run
    bat14, done14, _ = serve14(scheme14)
    launches14 = read_counts("replay serving", decode_replay=bat14.launches)["decode_replay"]
    st14 = bat14.schedule_cache.stats()
    check(st14["capacity"] == ScheduleCache().capacity,
          f"replay serving: the batcher's own cache {st14}")
    serve14(flood14)                           # warm-up
    runs14 = {"replay": [], "cuda": []}
    for _ in range(3):                         # turns: replay, cuda, replay, cuda, ...
        for name, sch in (("replay", scheme14), ("cuda", flood14)):
            bat, out, secs = serve14(sch)
            runs14[name].append(secs)
            if name == "cuda":
                bat_f, ref14 = bat, out
    med14 = {n: float(np.median(t)) for n, t in runs14.items()}
    check(bat_f.launches == bat14.launches, "replay serving: launches differ from cuda's")
    worst14 = 0.0
    for q, w in zip(done14, ref14):
        check(q.qid == w.qid and all(getattr(q, f) == getattr(w, f) for f in fields),
              f"replay serving: query {q.qid} accounting differs from cuda's")
        g, gd = torch.from_numpy(q.gradient), torch.from_numpy(w.gradient)
        zero = gd == 0.0
        check(bool((g[zero] == 0.0).all()), f"replay serving: query {q.qid} zero-fill")
        if bool(zero.all()):
            continue
        ex = g_exact[q.qid].cpu()
        anchor = max(float((gd.double() - ex).abs()[~zero].max()),
                     float((g64["lo"][q.qid].cpu() - ex).abs()[~zero].max()))
        bound = 1e-4 * float(gd.abs().max()) + 4 * anchor
        diff = float((g - gd).abs().max())
        check(diff <= bound, f"replay serving: query {q.qid} gradient differs by {diff} > "
              f"{bound}")
        worst14 = max(worst14, diff / bound if bound > 0 else 0.0)
    print(f"[replay-serving] {nq} queries, {B8} slots, budget {budget14}, rounds_per_launch "
          f"{budget14}, the batcher's own cache: median of 3 cold runs {med14['replay'] * 1e3:.2f}"
          f" ms = {nq / med14['replay']:.1f} queries/s; cuda batcher at the same chunk "
          f"{med14['cuda'] * 1e3:.2f} ms = {nq / med14['cuda']:.1f} queries/s (host clock "
          f"after synchronize, turns replay, cuda; runs {runs14}); {launches14} replay "
          f"launches = batcher launches; cache {st14}; accounting identical to cuda's for all "
          f"{nq} queries; worst gradient diff / bound {worst14:.3f}")
    def stages14():
        """Host clock of one cold replay-serving run by stage, each stage
        ended by a synchronize: the schedule solves, the rest of the cache
        lookups (the slots' masks read to the host, keys, hits), the rest of
        the engine's decode (packs uploaded and joined, the kernel), and the
        rest of the run (admission, worker products,
        epilogue, SlotPool, the stats sync)."""
        from repro_torch.core import schedule_cache as sc_mod
        sch = dataclasses.replace(scheme14, schedule_cache=ScheduleCache())
        acc = {}

        def timed(fn, name):
            def stage(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
                return out
            return stage

        solve = sc_mod.compile_peel_schedule
        sc_mod.compile_peel_schedule = timed(solve, "solves")
        try:
            cache = sch.schedule_cache
            object.__setattr__(cache, "get_batch", timed(cache.get_batch, "lookups"))
            object.__setattr__(sch.engine, "decode_batch",
                               timed(sch.engine.decode_batch, "decode"))
            _, _, secs = serve14(sch)
        finally:
            sc_mod.compile_peel_schedule = solve
        acc["decode"] -= acc["lookups"]
        acc["lookups"] -= acc["solves"]
        acc["rest"] = secs - sum(acc.values())
        return acc, secs

    acc14, secs14 = stages14()
    print(f"[replay-serving] host clock by stage over one cold run ({secs14 * 1e3:.3f} ms in "
          f"all): schedule solves {acc14['solves'] * 1e3:.3f} ms ({nq} patterns), the rest "
          f"of the cache lookups (masks to the host, keys) {acc14['lookups'] * 1e3:.3f} ms, "
          f"the rest of the decode (packs up and joined, kernel) "
          f"{acc14['decode'] * 1e3:.3f} ms, the rest of the run {acc14['rest'] * 1e3:.3f} ms")
    wall, busy, rows, _ = device_busy(lambda: serve14(scheme14))
    print(f"[replay-serving] torch.profiler over one cold run: device busy {busy:.3f} ms of "
          f"{wall:.3f} ms ({100 * busy / wall:.1f}%); busiest kernels:")
    for name, ms in rows[:4]:
        print(f"[replay-serving]   {ms:.4f} ms  {name[:100]}")
    # The kernel at the serving shape: the first 64 queries' erased worker
    # products with their patterns' schedules, as the first launch sees them.
    pack14 = decoder.replay_operands([decoder.compile_peel_schedule(code, m) for m in m8],
                                     "lo", dev)
    g14 = torch.full((B8,), budget14, dtype=torch.int32, device=dev)
    kout, pout = peel_decode_replay_cuda(pack14, v8, m8, g14), replay_ref(*pack14, v8, m8, g14)
    torch.cuda.synchronize()
    check(all_same(kout, pout), "replay at the serving shape: kernel and plain version differ")
    replay_ms = cuda_ms(lambda: peel_decode_replay_cuda(pack14, v8, m8, g14), 200)
    replay_plain_ms = cuda_ms(lambda: replay_ref(*pack14, v8, m8, g14), 3)
    E14, r14 = pack14.nidx.shape
    replay_once = (E14 * r14 * 8 + E14 * 8 + pack14.roff.numel() * 4 + pack14.meta.numel() * 4
                   + 2 * B8 * code.N * 4 + 2 * B8 * code.N + 8 * B8)
    replay_bound_ms = replay_once / HBM_BYTES_PER_S * 1e3
    err14 = float((kout[0] - pout[0]).abs().max())
    print(f"[replay-serving] decode_replay kernel {replay_ms:.4f} ms per launch (CUDA "
          f"events), plain version {replay_plain_ms:.4f} ms at B={B8} N={code.N} V=1, "
          f"{E14} entries of r_max {r14}, {int(pack14.meta[:, 1].max())} rounds at most; "
          f"bound {replay_bound_ms:.6f} ms ({replay_once} B once); max |kernel - plain| "
          f"{err14:.3e}")

    # ------------------- 15. the table decode at N = 49,152 and past shared memory
    t0 = time.perf_counter()
    code15 = make_parity_only_ldpc(24576, seed=args.seed)
    build15 = time.perf_counter() - t0
    N15, B15, V15, D15 = code15.N, 4, 2, 8
    tables15 = decoder.code_tables(code15, dev)
    del code15                                 # H is 4.5 GiB on the host
    p15, r15 = tables15.check_idx.shape
    lib15 = peel_ops._lib()
    # the stride that spreads the code's columns past a block's shared
    # memory comes from the library's sizes; the wrapper's mirror of them,
    # which the CPU tests read, is the library's
    stride15 = 1
    while lib15.peel_decode_smem_bytes(N15 * stride15, p15, r15, 1, 1) <= peel_ops.MAX_SMEM_BYTES:
        stride15 += 1
    for n in (N15, N15 * stride15):
        check(all(peel_ops._smem_bytes(n, p15, r15, V, place)
                  == lib15.peel_decode_smem_bytes(n, p15, r15, V, place)
                  for V in (1, 2, 3, 32) for place in (0, 1, 3, 7))
              and peel_ops._state_bytes(n, p15, r15)
              == lib15.peel_decode_state_bytes(n, p15, r15),
              f"N={n}: the wrapper's shared-memory sizes are not the library's")
    wide15 = tables15._replace(check_idx=(tables15.check_idx * stride15).contiguous(),
                               N=N15 * stride15)
    check(peel_ops.table_layout(tables15, B15, V15)[1], f"N={N15}: the state is not on chip")
    check(not peel_ops.table_layout(wide15, B15, V15)[1],
          f"N={wide15.N}: the state fits in shared memory")
    gen15 = torch.Generator(device=dev).manual_seed(args.seed + 15)
    n15 = 0
    for tabs in (tables15, wide15):
        N, (idx15, w15) = tabs.N, tabs[:2]
        for f in (0.25, 0.45):
            e = torch.zeros((B15, N), dtype=torch.bool, device=dev)
            e[:, ::N // N15] = torch.rand((B15, N15), generator=gen15, device=dev) < f
            v = torch.randn((B15, N, V15), generator=gen15, device=dev)
            v = torch.where(e[..., None], 1e3 * v, v).contiguous()
            budgets = torch.tensor([0, 3, D15, N], dtype=torch.int32, device=dev)
            for kern, plain in (
                    (lambda: peel_decode_cuda(tabs, v[1], e[1], D15),
                     lambda: decode_table_ref(idx15, w15, v[1], e[1], D15)),
                    (lambda: peel_decode_batch_cuda(tabs, v, e, D15),
                     lambda: decode_table_batch_ref(idx15, w15, v, e, D15)),
                    (lambda: peel_decode_adaptive_cuda(tabs, v[3], e[3], N),
                     lambda: decode_table_adaptive_ref(idx15, w15, v[3], e[3], N)),
                    (lambda: peel_decode_batch_adaptive_cuda(tabs, v, e, budgets),
                     lambda: decode_table_batch_adaptive_ref(idx15, w15, v, e, budgets))):
                kout, pout = kern(), plain()
                torch.cuda.synchronize()
                check(all_same(kout, pout), f"N={N} f={f}: table kernel and plain differ")
                n15 += 1
            if f == 0.25:
                v1, e1 = v[1].contiguous(), e[1].contiguous()
                ms = cuda_ms(lambda: peel_decode_cuda(tabs, v1, e1, D15), 20)
                plain_ms15 = cuda_ms(lambda: decode_table_ref(idx15, w15, v1, e1, D15), 3)
                res15 = int((e1 & ~peel_decode_cuda(tabs, v1, e1, D15)[1]).sum())
                once15 = decode_bytes(p15, r15, 1, N, V15)
                print(f"[large-table] decode_fused at N={N} V={V15} D={D15} f=0.25 ({res15} "
                      f"resolved): kernel {ms:.4f} ms, plain version {plain_ms15:.4f} ms; "
                      f"bound {once15 / HBM_BYTES_PER_S * 1e3:.6f} ms ({once15} B once); "
                      f"{table_dispatch(tabs, 1, V15)}")
                if tabs is tables15:
                    big_table_ms, big_table_plain_ms = ms, plain_ms15
                    big_bound_ms = once15 / HBM_BYTES_PER_S * 1e3
    print(f"[large-table] make_parity_only_ldpc(24576): N = {N15}, built in {build15:.1f} s "
          f"(host numpy, dense H); per-block shared memory "
          f"{lib15.peel_decode_smem_bytes(N15, p15, r15, 1, 1)} B <= {peel_ops.MAX_SMEM_BYTES} B, "
          f"so its state on chip; spread over N = {wide15.N} columns (stride {stride15}, from "
          f"the state's size) {lib15.peel_decode_smem_bytes(wide15.N, p15, r15, 1, 1)} B > "
          f"{peel_ops.MAX_SMEM_BYTES} B, so in device memory; all four contracts at both N, "
          f"B={B15} V={V15} D={D15}, f in (0.25, 0.45), budgets (0, 3, 8, N): {n15} cases "
          f"bit-identical to the table plain version")
    del tables15, wide15

    # ---------------------------------- 16. the flash kernel against its plain version
    flash = flash_phase(dev, args.seed)

    # ----------------------------------------- 17. Qwen3-1.7B at full width, bf16
    served = model_phase(dev, args.seed, reset_counts, read_counts)

    # -------------------------- 18. the GEMM against its plain version and float64
    gemm, split = gemm_phase(dev, args.seed, paper4, full5)
    gemm["launches"] = enc_launches["matmul_kernel_call"]
    split["launches"] = enc_launches["split_terms"]

    # ------------------------------------------------------------- 19. Scheme 1
    scheme1_phase(dev, args.seed, paper4, full5)

    # --------------------------------------- 20. the check pass and peel_round_cuda
    cpass = check_pass_phase(dev, args.seed, codes, full5, reset_counts, read_counts)

    print(f"[done] {time.perf_counter() - t_start:.1f} s")

    source = "src/repro_torch/kernels/ldpc_peel/csrc/peel_decode.cu"
    tpu = "src/repro/kernels/ldpc_peel/kernel.py:"
    kernels = [{
        "name": "ldpc_peel.decode_fused", "route": "cuda", "source": source,
        "replaces": tpu + "353", "also_replaces": tpu + "600",
        "launches": launches, "max_abs_err": max_abs_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None, "path_a_launches": launches11["decode_fused"],
        "path_a_ms": dec11_ms, "path_a_plain_ms": dec11_plain_ms,
        "path_a_bound_ms": dec11_bound_ms, "n49152_ms": big_table_ms,
        "n49152_plain_ms": big_table_plain_ms, "n49152_bound_ms": big_bound_ms,
    }]
    for name, line, tiled, n in (
            ("decode_fused_batch", "402", "651", serving["lockstep"]["launches"]),
            ("decode_fused_adaptive", "459", "705", launches7),
            ("decode_fused_batch_adaptive", "514", "761",
             serving["continuous"]["launches"])):
        k_ms, p_ms, b_ms = times[name]
        kernels.append({
            "name": f"ldpc_peel.{name}", "route": "cuda", "source": source,
            "replaces": tpu + line, "also_replaces": tpu + tiled, "launches": n,
            "max_abs_err": new_err[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": "bytes", "library_ms": None})
    seeded_src = "src/repro_torch/kernels/ldpc_peel/csrc/seeded_decode.cu"
    for name, line in (("decode_seeded", "1069"), ("decode_seeded_batch", "1122"),
                       ("decode_seeded_adaptive", "1172"),
                       ("decode_seeded_batch_adaptive", "1223")):
        k_ms, p_ms, b_ms = seeded_times[name]
        kernels.append({
            "name": f"ldpc_peel.{name}", "route": "cuda", "source": seeded_src,
            "replaces": tpu + line, "launches": launches10[name], "max_abs_err": err10,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": "bytes",
            "library_ms": None})
    kernels.append({
        "name": "ldpc_peel.encode_seeded_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/ldpc_peel/csrc/seeded_encode.cu",
        "replaces": tpu + "1316", "launches": launches11["encode_seeded_fused"],
        "max_abs_err": enc_err, "ms": enc_ms, "plain_ms": enc_plain_ms,
        "bound_ms": enc_bound_ms, "bound_by": "bytes", "library_ms": enc_lib_ms})
    kernels.append({
        "name": "ldpc_peel.decode_replay", "route": "cuda",
        "source": "src/repro_torch/kernels/ldpc_peel/csrc/replay_decode.cu",
        "replaces": tpu + "1428", "also_replaces": "src/repro/core/decoder.py:693",
        "launches": launches14, "max_abs_err": max(err12, err14), "ms": replay_ms,
        "plain_ms": replay_plain_ms, "bound_ms": replay_bound_ms, "bound_by": "bytes",
        "library_ms": None})
    flash_src = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
    kernels.append({
        "name": "flash_attention.flash_call", "route": "cuda", "source": flash_src,
        "replaces": "src/repro/kernels/flash_attention/kernel.py:70",
        "also_replaces": "src/repro/models/attention.py:29",
        "launches": served["launches_tensor"] + served["launches_simt"],
        "launches_tensor": served["launches_tensor"], "launches_simt": served["launches_simt"],
        "max_abs_err": flash["max_abs_err"],
        **{k: v for k, v in flash["prefill"].items() if k != "path"},
        "prefill_path": flash["prefill"]["path"],
        **{f"simt_prefill_{k}": v for k, v in flash["simt_prefill"].items()}})
    kernels.append({
        "name": "flash_attention.flash_decode", "route": "cuda", "source": flash_src,
        "replaces": "src/repro/kernels/flash_attention/kernel.py:70",
        "also_replaces": "src/repro/models/attention.py:29",
        "launches": served["launches_decode"], "max_abs_err": flash["decode_max_abs_err"],
        **{k: v for k, v in flash["decode"].items() if k != "path"}})
    kernels.append({
        "name": "block_matmul.matmul_kernel_call", "route": "cuda",
        "source": "src/repro_torch/kernels/block_matmul/csrc/block_matmul.cu",
        "replaces": "src/repro/kernels/block_matmul/kernel.py:36", **gemm})
    kernels.append({
        "name": "block_matmul.split_terms", "route": "cuda",
        "source": "src/repro_torch/kernels/block_matmul/csrc/block_matmul.cu",
        "replaces": "src/repro/kernels/block_matmul/kernel.py:36", **split})
    kernels.append({
        "name": "ldpc_peel.check_pass", "route": "cuda",
        "source": "src/repro_torch/kernels/ldpc_peel/csrc/check_pass.cu",
        "replaces": tpu + "169", **cpass})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
