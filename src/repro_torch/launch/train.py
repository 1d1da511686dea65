"""End-to-end training launcher, the port of ``repro.launch.train``.

Builds the model of ``--arch`` (``--smoke``: its reduced config) from a
seeded ``torch.Generator``, AdamW, the train step and the synthetic token
stream, and runs the fault-tolerant loop (``train.loop.run``), which
resumes from the newest committed checkpoint in ``--ckpt-dir``.  It runs
on the card unless ``--device cpu`` is given; one device only
(``--model-par`` > 1 needs the sharding rules, ROADMAP queue 1 item
15e-3).
It logs every ``--log-every`` steps (10, but at least once in a run of
fewer steps) and ends with the reference's ``[train] done: ...`` line.

    PYTHONPATH=src python -m repro_torch.launch.train --smoke \\
        --device cpu --steps 30 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ..configs import get_config
from ..core.proxies import resolve_device
from ..data.pipeline import DataConfig, TokenStream
from ..models.model import LM
from ..train.loop import LoopConfig, run
from ..train.optimizer import OptConfig
from ..train.step import build_train_step, init_state

DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build"
                       / "repro_torch" / "train_ckpt")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-int8", action="store_true")
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--log-every", type=int, default=10)
    return ap.parse_args(argv)


def main(argv=None, log=print):
    """Parse ``argv``, train, print the done line; returns (state,
    loop_state)."""
    args = parse(argv)
    if args.model_par > 1:
        raise NotImplementedError(
            "--model-par > 1 shards the model over a mesh: the sharding "
            "rules wait for ROADMAP queue 1 item 15e-3")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    gen = torch.Generator(device).manual_seed(0)
    model = LM(cfg, device, gen)
    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(args.steps // 20, 5),
                        compress_int8=args.compress_int8)
    step = build_train_step(model, opt_cfg, microbatches=args.microbatches)
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch),
                         device=device)
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every,
                          log_every=max(1, min(args.log_every, args.steps)))
    # The fresh state goes straight to the loop: a name bound to it here
    # would keep its optimizer moments (8 bytes a parameter) alive beside
    # every later step's for the whole run.
    state, ls = run(loop_cfg, state=init_state(model, opt_cfg),
                    train_step=step, stream=stream, log=log)
    if ls.history:
        log(f"[train] done: step {ls.step}, "
            f"loss {ls.history[0][1]:.3f} -> {ls.history[-1][1]:.3f}, "
            f"stragglers {ls.n_stragglers}")
    return state, ls


if __name__ == "__main__":
    main()
