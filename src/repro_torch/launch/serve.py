"""End-to-end serving launcher: batched requests through the slot engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --requests 8 --max-tokens 16                  # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b
      (or recurrentgemma-9b; with --smoke --device cpu on the CPU)

The port of ``repro.launch.serve``, with the same flags plus ``--device``
(the card by default; it raises without one).  Weights are drawn from a
``torch.Generator`` seeded with 0 on the device; no checkpoint is read.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.proxies import resolve_device
from ..models.model import LM
from ..serve.engine import EngineConfig, Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    model = LM(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    eng = ServeEngine(model, EngineConfig(
        n_slots=args.slots, cache_len=args.cache_len, eos=-1))

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        reqs.append(Request(i, rng.integers(
            3, cfg.vocab, size=plen).astype(np.int32),
            max_tokens=args.max_tokens))
        eng.submit(reqs[-1])
    t0 = time.monotonic()
    ticks = eng.run()
    dt = time.monotonic() - t0
    n_tok = sum(len(r.out_tokens) for r in reqs)
    print(f"[serve] {len(reqs)} requests, {n_tok} tokens in {ticks} ticks, "
          f"{dt:.1f}s -> {n_tok/max(dt,1e-9):.1f} tok/s "
          f"(all done: {all(r.done for r in reqs)}) on {model.device}")


if __name__ == "__main__":
    main()
