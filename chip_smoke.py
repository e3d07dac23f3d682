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
   over the run must equal the step count.

Then, as the last three lines: the card's name and power limit, one JSON
object with each kernel's launches, error and times, and
``{"ok": true, "device": {...}}``.  Any failed check raises and exits
non-zero.  Without a CUDA card, or without the rest of the repository
beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import (FixedCountStragglers, Scheme2Blocked,
                                  make_parity_only_ldpc, make_regular_ldpc,
                                  run_pgd, second_moment)
    from repro_torch.core import decoder
    from repro_torch.core.schemes import Uncoded
    from repro_torch.data import make_linear_problem
    from repro_torch.kernels import build
    from repro_torch.kernels.ldpc_peel import decode_fused_ref, dense_h, peel_decode_cuda

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
    coded = Scheme2Blocked.build(code, mom, lr=prob.lr, decode_iters=12,
                                 decode_backend="cuda")
    dense = dataclasses.replace(coded, decode_backend="dense")
    # the same problem in float64: the trajectory without f32 rounding
    exact = Scheme2Blocked.build(code, second_moment(prob.X.double(), prob.y.double()),
                                 lr=prob.lr, decode_iters=12, decode_backend="dense")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    masks = torch.stack([FixedCountStragglers(10).sample(gen, 40, dev)
                         for _ in range(steps4)])
    theta0 = torch.zeros(400, device=dev)
    peel_decode_cuda.launches = 0              # this path's run
    runs = {"cuda": run_pgd(coded, theta0, None, steps4, masks=masks,
                            theta_star=prob.theta_star)}
    torch.cuda.synchronize()
    check(peel_decode_cuda.launches == steps4, f"paper setting: decode launches "
          f"{peel_decode_cuda.launches} != steps {steps4}")
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
    del prob, mom, coded, dense, exact, runs

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
    scheme = Scheme2Blocked.build(code, mom, lr=lr, decode_iters=D,
                                  decode_backend="cuda")
    del mom, v
    masks = torch.stack([FixedCountStragglers(s).sample(gen, code.N, dev)
                         for _ in range(steps)])
    torch.cuda.synchronize()
    print(f"[full] k={k} m={m} N={code.N} K={K} blocks={k // K} D={D} "
          f"stragglers={s}: problem built on the card in "
          f"{time.perf_counter() - t0:.1f} s; lambda_max ~ {lam:.6f} "
          f"(100 power steps), lr = 0.9/lambda = {lr:.6f}")
    theta0 = torch.zeros(k, device=dev)

    peel_decode_cuda.launches = 0              # the main path's run
    res = run_pgd(scheme, theta0, None, steps, masks=masks, theta_star=theta_star)
    torch.cuda.synchronize()
    launches = peel_decode_cuda.launches
    check(launches == steps, f"decode launches {launches} != steps {steps}")

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
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
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
    print(f"[done] {time.perf_counter() - t_start:.1f} s")

    kernels = [{
        "name": "ldpc_peel.decode_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/ldpc_peel/csrc/peel_decode.cu",
        "replaces": "src/repro/kernels/ldpc_peel/kernel.py:353",
        "also_replaces": "src/repro/kernels/ldpc_peel/kernel.py:600",
        "launches": launches, "max_abs_err": max_abs_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None,
    }]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
