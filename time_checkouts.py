"""Time one workload on one card for one or more checkouts of the port, in
alternating runs.

    python3 time_checkouts.py ROOT [ROOT ...]
                              --what encode|decode_step|seeded_decode|table_decode|serving
                              [--rounds 2] [--reps 5] [--steps 32] [--seed 0]

Each ROOT is the root of a checkout whose ``src/`` holds ``repro_torch``
(for example this one, ``.``, and another commit unpacked with ``git
archive``).  The script first builds each checkout's library for the
workload (one ``nvcc`` each, all started together), then runs the roots in
order and in reverse, ``--rounds`` times (A B B A A B B A for two roots and
two rounds), each run a process of its own.  The workloads:

* ``encode``: ``chip_smoke.py`` phase 5's moment encode, ``C = G @ M``
  through ``encode_gm`` with G the (3, 6) code's generator at K = 1024
  (``make_regular_ldpc(1024, seed=0)``, 2048 x 1024) over 32 blocks of a
  (1024 x 32768) M drawn from ``--seed``, then ``torch.matmul`` on the same
  inputs (f32, TF32 off), each call timed by CUDA events, ``--reps`` calls
  after one warm-up, and the encode's largest distance from
  ``torch.matmul``.
* ``seeded_decode``: ``chip_smoke.py`` phase 10's seeded decodes, the
  four contracts at Path B's shapes (the structure of
  ``make_seeded_ldpc(16384)``, N = 32768, V = 2, D = 8, erasure fraction
  0.25 from ``--seed``; one pattern, and 8 under the budgets 0, 1, 3, 8, 8,
  3, 1, 8 for the batched early exit), then the fixed-D decode of one
  pattern at N = 262144, V = 1, and both fixed-D decodes with D = 0 (the
  set-up and write-back alone), each call timed by CUDA events, ``--reps``
  calls after one warm-up; each contract's output is checked bit for bit
  against its first call.
* ``table_decode``: the table decode (``peel_decode*_cuda``) at the shapes
  ``chip_smoke.py`` drives it: phase 5's blocked step (the (3, 6) code at
  K = 1024, ``make_regular_ldpc(1024, seed=0)``, N = 2048, V = 32, D = 8,
  512 stragglers), phase 8's serving wave (64 slots, V = 1, 10 heavy at q
  = 0.42 and the rest at q = 0.08: the lockstep launch's 32 fixed rounds
  and the continuous launch's budget of 4 a slot), phase 7's adaptive step
  (V = 1, budget 32, 512 stragglers), Path A's decode
  (``make_seeded_ldgm(16384, 8192, row_weight=8)``, N = 24,576, V = 1, D =
  8, 2458 stragglers; and with D = 0, the set-up and write-back alone) and
  phase 15's (``make_parity_only_ldpc(24576)``, N = 49,152, V = 2, D = 8,
  erasure fraction 0.25).  The codes and inputs are made once, from
  ``--seed``, by the calling process (with this checkout's ``repro_torch``)
  and saved under ``build/``, so every root decodes the very same tensors.
  Each call is timed by CUDA events three ways, ``--reps`` times after one
  warm-up: 20 calls back to back (``*_ms``, the measure of ``chip_smoke.py``
  and PERF.md's kernel table), each call alone with the wrapper's host time
  inside (``*_call_ms``), and 20 calls replayed from one CUDA graph
  (``*_graph_ms``, the card's time alone); its output is checked bit for
  bit against its first call.
* ``serving``: ``chip_smoke.py`` phase 8's coded-query serving, Scheme 2
  on the (3, 6) code at K = 1024 (``make_regular_ldpc(1024, seed=0)``, the
  moment of a 4096 x 1024 linear problem from ``--seed``) behind a
  ``CodedQueryBatcher`` of 64 slots, 320 queries from ``--seed`` (15%
  heavy at q = 0.42, the rest at q = 0.08), the continuous mode (4 rounds
  a launch, per-slot budgets, the batch-adaptive table decode) and the
  lockstep mode (32 fixed rounds a wave, the batched table decode): each
  mode's queries/s on the host clock after a synchronize, ``--reps`` runs
  after one warm-up, and its decode launches a run.
* ``decode_step``: Qwen3-1.7B at full width in bf16 on random weights from
  ``--seed``, a prefill of 4 prompts of 2048 tokens, then three spans of
  ``--steps`` greedy decode steps, each timed on the host clock after a
  synchronize, the flash kernel's launches by path; then the host time of
  one call of the flash wrapper and of ``scaled_dot_product_attention`` at
  the decode shape.

A run prints its numbers; then each root's medians over its runs; the last
line is one JSON object of every run's numbers.  Cards, hosts and calls
differ, so compare roots only within one call.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

BATCH, PROMPT, SPANS = 4, 2048, 3            # decode_step
BLOCKS, K, COLS = 32, 1024, 32768             # encode
PATH_B, BIG = 32768, 262144                    # seeded_decode
LIBRARY = {"encode": ("block_matmul",), "decode_step": ("flash_attention",),
           "seeded_decode": ("seeded_decode",), "table_decode": ("peel_decode",),
           "serving": ("block_matmul", "peel_decode")}
SLOTS, QUERIES, CHUNK, BUDGET = 64, 320, 4, 32  # serving
# table_decode: the inputs every root decodes, relative to the calling checkout
TABLE_INPUTS = Path("build") / "table_decode_inputs.pt"


def event_times(fn, reps: int) -> list[float]:
    """``reps`` calls of ``fn`` after one warm-up, each timed by CUDA events (ms)."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop))
    return out


def seeded_decode(args) -> dict:
    """One seeded-decode run in this process, on the ``repro_torch`` that
    ``sys.path`` finds."""
    import torch

    from repro_torch.core import decoder
    from repro_torch.core.ldpc import SeededLDPC
    from repro_torch.kernels.ldpc_peel import (peel_decode_adaptive_seeded_cuda,
                                               peel_decode_batch_adaptive_seeded_cuda,
                                               peel_decode_batch_seeded_cuda,
                                               peel_decode_seeded_cuda)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed + 10)
    st = decoder.seeded_spec(SeededLDPC(N=PATH_B, K=PATH_B // 2, l=4, r=8, seed=0))
    big = decoder.seeded_spec(SeededLDPC(N=BIG, K=BIG // 2, l=4, r=8, seed=0))
    e = torch.rand((8, PATH_B), generator=g, device=dev) < 0.25
    v = torch.where(e[..., None], 0.0, torch.randn((8, PATH_B, 2), generator=g, device=dev))
    budgets = torch.tensor([0, 1, 3, 8, 8, 3, 1, 8], dtype=torch.int32, device=dev)
    v0, e0 = v[0].contiguous(), e[0].contiguous()
    eb = torch.rand(BIG, generator=g, device=dev) < 0.25
    vb = torch.where(eb[:, None], 0.0, torch.randn((BIG, 1), generator=g, device=dev))
    calls = {"decode_seeded_ms": lambda: peel_decode_seeded_cuda(st, v0, e0, 8),
             "decode_seeded_batch_ms": lambda: peel_decode_batch_seeded_cuda(st, v, e, 8),
             "decode_seeded_adaptive_ms": lambda: peel_decode_adaptive_seeded_cuda(st, v0, e0, 8),
             "decode_seeded_batch_adaptive_ms":
                 lambda: peel_decode_batch_adaptive_seeded_cuda(st, v, e, budgets),
             "decode_seeded_N262144_ms": lambda: peel_decode_seeded_cuda(big, vb, eb, 8),
             # no rounds: the set-up and the write-back alone
             "decode_seeded_D0_ms": lambda: peel_decode_seeded_cuda(st, v0, e0, 0),
             "decode_seeded_N262144_D0_ms": lambda: peel_decode_seeded_cuda(big, vb, eb, 0)}
    out = {}
    for name, fn in calls.items():
        first = fn()
        out[name] = event_times(fn, args.reps)
        again = fn()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise RuntimeError(f"{name}: two calls differ")
    unresolved = int(peel_decode_seeded_cuda(big, vb, eb, 8)[1].sum())
    return {**out, "unresolved_N262144": unresolved, "card": torch.cuda.get_device_name(0)}


def loop_times(fn, reps: int, per: int = 20) -> list[float]:
    """``reps`` timings of ``per`` calls of ``fn`` issued back to back, each
    the mean ms a call between two CUDA events (the host's time a call
    hides behind the card's where the card is the slower)."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(per):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / per)
    return out


def graph_times(fn, reps: int, per: int = 20) -> list[float]:
    """``reps`` timings of ``per`` calls of ``fn`` captured in one CUDA graph
    and replayed, each the mean ms a call between two CUDA events: the
    card's time alone, no host time inside.  Empty if the calls cannot be
    captured."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=side):
            for _ in range(per):
                fn()
    except RuntimeError:
        torch.cuda.synchronize()
        return []
    graph.replay()
    out = []
    for _ in range(reps):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / per)
    return out


def table_inputs(seed: int) -> dict:
    """The table decode's codes and inputs (see the module docstring), made
    on the card from ``seed`` with the calling checkout's ``repro_torch``."""
    import torch

    from repro_torch.core import FixedCountStragglers, decoder, make_parity_only_ldpc
    from repro_torch.core import make_regular_ldpc
    from repro_torch.core.ldpc import make_seeded_ldgm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 29)

    def inputs(n: int, shape: tuple, erased: torch.Tensor) -> torch.Tensor:
        v = torch.randn((*shape[:-1], n, shape[-1]), generator=g, device=dev)
        return torch.where(erased[..., None], 0.0, v).contiguous()

    def table(code) -> tuple:
        t = decoder.code_tables(code, dev)
        return t.check_idx, t.check_coeff, t.N

    out = {}
    reg = make_regular_ldpc(1024, seed=0)
    out["reg"] = table(reg)
    m5 = FixedCountStragglers(512).sample(g, reg.N, dev)
    out["step"] = (inputs(reg.N, (32,), m5), m5)
    m7 = FixedCountStragglers(512).sample(g, reg.N, dev)
    out["adaptive"] = (inputs(reg.N, (1,), m7), m7)
    q = torch.where(torch.arange(64, device=dev) < 10, 0.42, 0.08)
    m8 = torch.rand((64, reg.N), generator=g, device=dev) < q[:, None]
    out["wave"] = (inputs(reg.N, (64, 1), m8), m8,
                   torch.full((64,), 4, dtype=torch.int32, device=dev))
    ldgm = make_seeded_ldgm(16384, 8192, row_weight=8, seed=0)
    out["ldgm"] = table(ldgm)
    mA = FixedCountStragglers(2458).sample(g, ldgm.N, dev)
    out["path_a"] = (inputs(ldgm.N, (1,), mA), mA)
    del ldgm
    big = make_parity_only_ldpc(24576, seed=seed)
    out["big"] = table(big)
    m15 = torch.rand(big.N, generator=g, device=dev) < 0.25
    out["n49152"] = (inputs(big.N, (2,), m15), m15)
    return out


def table_decode(args) -> dict:
    """One table-decode run in this process, on the ``repro_torch`` that
    ``sys.path`` finds, over the inputs the calling process saved."""
    import torch

    from repro_torch.kernels.ldpc_peel import (CodeTables, peel_decode_adaptive_cuda,
                                               peel_decode_batch_adaptive_cuda,
                                               peel_decode_batch_cuda, peel_decode_cuda)

    x = torch.load(args.inputs, map_location="cuda")
    reg, ldgm, big = (CodeTables(*x[k]) for k in ("reg", "ldgm", "big"))
    (v5, m5), (v7, m7), (v8, m8, g8) = x["step"], x["adaptive"], x["wave"]
    (vA, mA), (v15, m15) = x["path_a"], x["n49152"]
    calls = {"row2_step_ms": lambda: peel_decode_cuda(reg, v5, m5, 8),
             "row3_wave_lockstep_ms": lambda: peel_decode_batch_cuda(reg, v8, m8, 32),
             "row4_adaptive_ms": lambda: peel_decode_adaptive_cuda(reg, v7, m7, 32),
             "row5_wave_continuous_ms":
                 lambda: peel_decode_batch_adaptive_cuda(reg, v8, m8, g8),
             "path_a_ms": lambda: peel_decode_cuda(ldgm, vA, mA, 8),
             # no rounds: the set-up and the write-back alone
             "path_a_D0_ms": lambda: peel_decode_cuda(ldgm, vA, mA, 0),
             "n49152_ms": lambda: peel_decode_cuda(big, v15, m15, 8)}
    out = {}
    for name, fn in calls.items():
        first = fn()
        out[name] = loop_times(fn, args.reps)
        out[name.replace("_ms", "_call_ms")] = event_times(fn, args.reps)
        out[name.replace("_ms", "_graph_ms")] = graph_times(fn, args.reps)
        again = fn()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise RuntimeError(f"{name}: two calls differ")
    resolved = {"path_a_resolved": int((mA & ~peel_decode_cuda(ldgm, vA, mA, 8)[1]).sum()),
                "n49152_resolved": int((m15 & ~peel_decode_cuda(big, v15, m15, 8)[1]).sum())}
    return {**out, **resolved, "card": torch.cuda.get_device_name(0)}


def serving(args) -> dict:
    """One serving run in this process, on the ``repro_torch`` that
    ``sys.path`` finds."""
    import numpy as np
    import torch

    from repro_torch.core import Scheme2, make_regular_ldpc, second_moment
    from repro_torch.data import make_linear_problem
    from repro_torch.kernels.ldpc_peel import (peel_decode_batch_adaptive_cuda,
                                               peel_decode_batch_cuda)
    from repro_torch.serving import CodedQuery, CodedQueryBatcher

    dev = torch.device("cuda")
    k = 1024
    code = make_regular_ldpc(k, seed=0)
    prob = make_linear_problem(4 * k, k, seed=args.seed, device=dev)
    scheme = Scheme2.build(code, second_moment(prob.X, prob.y), lr=prob.lr,
                           decode_iters=BUDGET, decode_backend="cuda")
    rng = np.random.default_rng(args.seed)
    thetas = rng.standard_normal((QUERIES, k)).astype(np.float32)
    heavy = rng.random(QUERIES) < 0.15
    masks = rng.random((QUERIES, code.N)) < np.where(heavy, 0.42, 0.08)[:, None]
    out = {}
    for mode, kernel in (("continuous", peel_decode_batch_adaptive_cuda),
                         ("lockstep", peel_decode_batch_cuda)):
        rates = []
        for rep in range(args.reps + 1):              # the first run warms up
            bat = CodedQueryBatcher(scheme, n_slots=SLOTS, mode=mode,
                                    rounds_per_launch=CHUNK if mode == "continuous" else None)
            for i in range(QUERIES):
                bat.submit(CodedQuery(i, thetas[i], masks[i]))
            before = kernel.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = bat.run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if len(done) != QUERIES:
                raise RuntimeError(f"{mode}: {len(done)} of {QUERIES} queries served")
            if rep:
                rates.append(QUERIES / secs)
        out[f"{mode}_queries_per_s"] = rates
        out[f"{mode}_launches"] = kernel.launches - before
    return {**out, "card": torch.cuda.get_device_name(0)}


def encode(args) -> dict:
    """One encode run in this process, on the ``repro_torch`` that
    ``sys.path`` finds."""
    import torch

    from repro_torch.core import make_regular_ldpc
    from repro_torch.kernels.block_matmul import encode_gm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    G = torch.as_tensor(make_regular_ldpc(K, seed=0).G, dtype=torch.float32, device=dev)
    Mb = torch.randn((BLOCKS, K, COLS),
                     generator=torch.Generator(device=dev).manual_seed(args.seed), device=dev)

    enc = event_times(lambda: encode_gm(G, Mb), args.reps)
    matmul = event_times(lambda: torch.matmul(G, Mb), args.reps)
    dist = float((encode_gm(G, Mb) - torch.matmul(G, Mb)).abs().max())
    return {"encode_ms": enc, "matmul_ms": matmul, "max_abs_diff_vs_matmul": dist,
            "card": torch.cuda.get_device_name(0)}


def decode_step(args) -> dict:
    """One decode-step run in this process, on the ``repro_torch`` that
    ``sys.path`` finds."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import Model

    steps, seed = args.steps, args.seed
    dev = torch.device("cuda")
    cfg = get_config("qwen3-1.7b")
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(seed + 17))
    g = torch.Generator(device=dev).manual_seed(seed + 170)
    tokens = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=g, device=dev)
    warm = model.init_cache(BATCH, 64)                  # cuBLAS handles, allocator
    wl, warm = model.prefill({"tokens": tokens[:, :32]}, warm)
    model.decode_step(wl[:, -1].argmax(-1)[:, None], 32, warm)
    del warm, wl
    cache = model.init_cache(BATCH, PROMPT + SPANS * steps)
    logits, cache = model.prefill({"tokens": tokens}, cache)
    tok = logits[:, -1].argmax(-1)[:, None]
    paths = ("tensor", "decode", "simt")
    before = [getattr(flash_attention_cuda, f"launches_{p}", 0) for p in paths]
    spans = []
    for s in range(SPANS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache = model.decode_step(tok, PROMPT + s * steps + i, cache)
            tok = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        spans.append((time.perf_counter() - t0) * 1e3 / steps)
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits")
    launches = {p: getattr(flash_attention_cuda, f"launches_{p}", 0) - b
                for p, b in zip(paths, before)}
    return {"ms_per_step": spans, "launches": launches, **host_us(dev, g)}


def host_us(dev, g, calls: int = 200) -> dict:
    """Host microseconds a call of the flash wrapper and of
    ``scaled_dot_product_attention`` at the model's decode shape (B = 4, 16
    heads over 8 KV heads, Dh = 128, T = 2080, bf16): ``calls`` calls issued
    without a synchronize, on the host clock (the card's queue holds them)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_cuda

    B, T, KV, G, Dh = BATCH, 2080, 8, 2, 128
    q = torch.randn((B, 1, KV, G, Dh), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, T, KV, Dh), generator=g, device=dev).bfloat16() for _ in "kv")
    kv_pos = torch.arange(T, dtype=torch.int32, device=dev)
    q_pos, valid = kv_pos[-1:].contiguous(), kv_pos <= T - 1
    qh, kh, vh = (q.reshape(B, 1, KV * G, Dh).transpose(1, 2).contiguous(),
                  k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())
    fns = {"flash_host_us": lambda: flash_attention_cuda(q, k, v, q_pos, kv_pos, kv_valid=valid),
           "sdpa_host_us": lambda: F.scaled_dot_product_attention(qh, kh, vh, enable_gqa=True)}
    out = {}
    for name, fn in fns.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - t0) * 1e6 / calls
        torch.cuda.synchronize()
    return out


WORKERS = {"encode": encode, "decode_step": decode_step, "seeded_decode": seeded_decode,
           "table_decode": table_decode, "serving": serving}


def run(root: Path, args) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker",
                           "--what", args.what, "--reps", str(args.reps),
                           "--steps", str(args.steps), "--seed", str(args.seed),
                           "--inputs", str(args.inputs)],
                          cwd=root, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: run failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def medians(runs: list[dict]) -> dict:
    """The median over a root's runs of each list of times or rates
    (``*_ms``, ``ms_per_step``, ``*_queries_per_s``) and of each host time
    (``*_us``)."""
    out = {}
    for key, val in runs[0].items():
        if isinstance(val, list):
            vals = [x for r in runs for x in r[key]]
            if vals:
                out[key] = statistics.median(vals)
        elif key.endswith("_us"):
            out[key] = statistics.median(r[key] for r in runs)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--what", choices=sorted(WORKERS), required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5,
                    help="timed calls a run (serving: timed runs a mode)")
    ap.add_argument("--steps", type=int, default=32, help="decode_step: steps a span")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(WORKERS[args.what](args)))
        return 0
    roots = [r.resolve() for r in args.roots] or [Path(__file__).resolve().parent]
    tag = f"[{args.what}]"
    t0 = time.perf_counter()
    if args.what == "table_decode":          # one set of inputs for every root
        import torch

        here = Path(__file__).resolve().parent
        sys.path.insert(0, str(here / "src"))
        args.inputs = here / TABLE_INPUTS
        args.inputs.parent.mkdir(parents=True, exist_ok=True)
        torch.save(table_inputs(args.seed), args.inputs)
        print(f"{tag} inputs made in {time.perf_counter() - t0:.1f} s", flush=True)
    builds = [subprocess.Popen([sys.executable, "-c", "from repro_torch.kernels import build; "
                                f"build.build_all({list(LIBRARY[args.what])!r})"], cwd=r,
                               env=dict(os.environ, PYTHONPATH=str(r / "src")))
              for r in roots]
    if any(p.wait() != 0 for p in builds):
        print("a build failed", file=sys.stderr)
        return 1
    print(f"{tag} built {', '.join(LIBRARY[args.what])} for {len(roots)} roots in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    order = [r for _ in range(args.rounds) for r in roots + roots[::-1]]
    results: dict[str, list] = {str(r): [] for r in roots}
    for root in order:
        got = run(root, args)
        results[str(root)].append(got)
        print(f"{tag} {root}: {json.dumps(got)}", flush=True)
    for root, runs in results.items():
        print(f"{tag} {root}: medians over {len(runs)} runs: "
              + ", ".join(f"{k} {v:.4f}" for k, v in medians(runs).items()), flush=True)
    print(json.dumps({"what": args.what, "order": [str(r) for r in order], "runs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
