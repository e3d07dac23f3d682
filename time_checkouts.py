"""Time one workload on one card for one or more checkouts of the port, in
alternating runs.

    python3 time_checkouts.py ROOT [ROOT ...] --what encode|decode_step|seeded_decode
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
LIBRARY = {"encode": "block_matmul", "decode_step": "flash_attention",
           "seeded_decode": "seeded_decode"}


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


WORKERS = {"encode": encode, "decode_step": decode_step, "seeded_decode": seeded_decode}


def run(root: Path, args) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker",
                           "--what", args.what, "--reps", str(args.reps),
                           "--steps", str(args.steps), "--seed", str(args.seed)],
                          cwd=root, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: run failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def medians(runs: list[dict]) -> dict:
    """The median over a root's runs of each list of times (``*_ms``,
    ``ms_per_step``) and of each host time (``*_us``)."""
    out = {}
    for key, val in runs[0].items():
        if isinstance(val, list):
            out[key] = statistics.median(x for r in runs for x in r[key])
        elif key.endswith("_us"):
            out[key] = statistics.median(r[key] for r in runs)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--what", choices=sorted(WORKERS), required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5,
                    help="encode, seeded_decode: timed calls a run")
    ap.add_argument("--steps", type=int, default=32, help="decode_step: steps a span")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(WORKERS[args.what](args)))
        return 0
    roots = [r.resolve() for r in args.roots] or [Path(__file__).resolve().parent]
    tag = f"[{args.what}]"
    t0 = time.perf_counter()
    builds = [subprocess.Popen([sys.executable, "-c", "from repro_torch.kernels import build; "
                                f"build.build_all([{LIBRARY[args.what]!r}])"], cwd=r,
                               env=dict(os.environ, PYTHONPATH=str(r / "src")))
              for r in roots]
    if any(p.wait() != 0 for p in builds):
        print("a build failed", file=sys.stderr)
        return 1
    print(f"{tag} built {len(roots)} {LIBRARY[args.what]} libraries in "
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
