"""Serving launcher: batched prefill, then decode, on a reduced config of
the dense family (the port of the JAX package's ``launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --batch 4 --prompt-len 16 --gen 16 [--device cpu]

The weights are random (seed 0): the repository holds none.  Runs on the
card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.data.batches import make_batch
from repro_torch.device import resolve_device
from repro_torch.models import Model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> torch.Tensor:
    """Runs the demo; returns the generated tokens ``(batch, gen)``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--window", type=int, default=0, help="sliding window (0=full)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = Model(cfg, attn_chunk=16, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))

    total = args.prompt_len + args.gen
    batch = make_batch(cfg, args.batch, args.prompt_len,
                       generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    cache = model.init_cache(args.batch, total, window=args.window or None)
    t0 = time.time()
    logits, cache = model.prefill(batch, cache)
    _sync(dev)
    print(f"prefill({args.prompt_len} tok x {args.batch}): {time.time()-t0:.2f}s")

    pos0 = batch["tokens"].shape[1]
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    out_tokens = [tok]
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(1)
    for i in range(args.gen - 1):
        logits, cache = model.decode_step(tok, pos0 + i, cache)
        if args.temperature > 0:
            probs = torch.softmax(logits[:, -1] / args.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)
        else:
            tok = logits[:, -1].argmax(dim=-1)[:, None]
        out_tokens.append(tok)
    _sync(dev)
    dt = time.time() - t0
    gen_tokens = torch.cat(out_tokens, dim=1)
    print(f"decoded {args.gen - 1} steps x {args.batch} seqs in {dt:.2f}s "
          f"({(args.gen - 1) * args.batch / max(dt, 1e-9):.1f} tok/s)")
    print("sample token ids:", gen_tokens[0][:16].tolist())
    return gen_tokens


if __name__ == "__main__":
    main()
