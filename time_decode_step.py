"""Time Qwen3-1.7B's greedy decode step on one card, for one or more
checkouts of the port, in alternating runs.

    python3 time_decode_step.py ROOT [ROOT ...] [--rounds 2] [--steps 32]

Each ROOT is the root of a checkout whose ``src/`` holds ``repro_torch``
(for example this one, ``.``, and another commit unpacked with ``git
archive``).  The script first builds each checkout's flash-attention
library (one ``nvcc`` each, all started together), then runs the roots in
order and in reverse, ``--rounds`` times (A B B A A B B A for two roots
and two rounds), each run a process of its own: Qwen3-1.7B at full width
in bf16 on random weights from ``--seed``, a prefill of 4 prompts of 2048
tokens, then three spans of ``--steps`` greedy decode steps, each timed on
the host clock after a synchronize; then the host time of one call of
the flash wrapper and of ``scaled_dot_product_attention`` at the decode
shape.  A run prints its ms a step for each span, the flash kernel's
launches by path and those host times; the last line is one JSON object
of every run's numbers.  The host's speed varies between machines
and calls, so compare roots only within one call.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BATCH, PROMPT, SPANS = 4, 2048, 3


def worker(steps: int, seed: int) -> dict:
    """One run in this process, on the ``repro_torch`` that ``sys.path`` finds."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import Model

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


def run(root: Path, steps: int, seed: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker",
                           "--steps", str(steps), "--seed", str(seed)],
                          cwd=root, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: run failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.steps, args.seed)))
        return 0
    roots = [r.resolve() for r in args.roots] or [Path(__file__).resolve().parent]
    t0 = time.perf_counter()
    builds = [subprocess.Popen([sys.executable, "-c", "from repro_torch.kernels import build; "
                                "build.build_all(['flash_attention'])"], cwd=r,
                               env=dict(os.environ, PYTHONPATH=str(r / "src")))
              for r in roots]
    if any(p.wait() != 0 for p in builds):
        print("a build failed", file=sys.stderr)
        return 1
    print(f"[decode-step] built {len(roots)} flash-attention libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    order = [r for _ in range(args.rounds) for r in roots + roots[::-1]]
    results: dict[str, list] = {str(r): [] for r in roots}
    for root in order:
        got = run(root, args.steps, args.seed)
        results[str(root)].append(got)
        print(f"[decode-step] {root}: ms a step "
              + ", ".join(f"{ms:.3f}" for ms in got["ms_per_step"])
              + f"; flash launches {got['launches']}; host us a call at the decode shape: "
              f"flash {got['flash_host_us']:.1f}, SDPA {got['sdpa_host_us']:.1f}", flush=True)
    print(json.dumps({"order": [str(r) for r in order], "runs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
