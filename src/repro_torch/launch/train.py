"""End-to-end training launcher, the port of ``repro.launch.train``.

Builds the model of ``--arch`` (``--smoke``: its reduced config) from a
seeded ``torch.Generator``, AdamW, the train step and the synthetic token
stream, and runs the fault-tolerant loop (``train.loop.run``), which
resumes from the newest committed checkpoint in ``--ckpt-dir``.  It runs
on the card unless ``--device cpu`` is given.
It logs every ``--log-every`` steps (10, but at least once in a run of
fewer steps) and ends with the reference's ``[train] done: ...`` line.

One process is the plain path.  Under ``torchrun`` (``WORLD_SIZE`` > 1)
the launcher joins the process group (gloo on the CPU, NCCL on the
cards), builds a (world / ``--model-par``, ``--model-par``) mesh with axes
("data", "model") (``launch.mesh.make_host_mesh``), lays the parameters
and the AdamW state out by the sharding rules and trains the DTensor step
(:func:`sharded_training`); rank 0 logs and writes the checkpoints.
``--model-par`` must divide the ranks (one process and ``--model-par 2``
fail on the reference's assertion).

    PYTHONPATH=src python -m repro_torch.launch.train --smoke \\
        --device cpu --steps 30 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --smoke --device cpu --model-par 2
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from pathlib import Path

import torch
import torch.distributed as dist

from ..configs import get_config
from ..core.proxies import resolve_device
from ..data.pipeline import DataConfig, TokenStream
from ..models.model import LM
from ..sharding import rules
from ..sharding.partition import MeshInfo, axis_names
from ..train.loop import LoopConfig, run
from ..train.optimizer import OptConfig
from ..train.step import (build_sharded_train_step, build_train_step,
                          init_state, shard_state)
from .mesh import make_host_mesh

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


def sharded_training(model: LM, opt_cfg: OptConfig, mesh, *,
                     microbatches: int = 1):
    """The model-parallel state and step on ``mesh`` (a ``DeviceMesh``
    with axes ("data", "model")), as the reference's launcher builds them:
    ``MeshInfo(dp=("data",), tp="model")``, the rules' context, the
    parameters and AdamW state laid out by ``param_pspecs`` (the step
    count replicated).  On a mesh with a "pod" axis before them, as the
    dry run's multi-pod cells: the batch split over ("pod", "data"), the
    parameters FSDP-split over "data" alone and the AdamW state over
    ("pod", "data").  The model's parameters become DTensors.  Returns
    (state, train_step, shardings)."""
    dp = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
    mi = MeshInfo(mesh=mesh, dp=dp, tp="model", fsdp_over=("data",))
    ctx = rules.make_ctx(model.cfg, mi)
    state, shardings = shard_state(
        model, opt_cfg, mi, dataclasses.replace(mi, fsdp_over=dp))
    step = build_sharded_train_step(model, opt_cfg, ctx, shardings,
                                    microbatches=microbatches)
    return state, step, shardings


def main(argv=None, log=print):
    """Parse ``argv``, train, print the done line; returns (state,
    loop_state)."""
    args = parse(argv)
    joined = False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 \
            and not dist.is_initialized():
        cuda = args.device is None or torch.device(args.device).type == "cuda"
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if cuda else "gloo")
        joined = True
    try:
        return _train(args, log)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args, log):
    world = dist.get_world_size() if dist.is_initialized() else 1
    sharded = world > 1 or args.model_par > 1
    mesh = make_host_mesh(args.model_par) if sharded else None
    if sharded and dist.get_rank() != 0:
        log = _quiet
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    gen = torch.Generator(device).manual_seed(0)
    model = LM(cfg, device, gen)
    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(args.steps // 20, 5),
                        compress_int8=args.compress_int8)
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch),
                         device=device)
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every,
                          log_every=max(1, min(args.log_every, args.steps)))
    if sharded:
        state, step, shardings = sharded_training(
            model, opt_cfg, mesh, microbatches=args.microbatches)
        return _done(run(loop_cfg, state=state, train_step=step,
                         stream=stream, state_shardings=shardings, log=log),
                     log)
    step = build_train_step(model, opt_cfg, microbatches=args.microbatches)
    # The fresh state goes straight to the loop: a name bound to it here
    # would keep its optimizer moments (8 bytes a parameter) alive beside
    # every later step's for the whole run.
    return _done(run(loop_cfg, state=init_state(model, opt_cfg),
                     train_step=step, stream=stream, log=log), log)


def _quiet(*_args, **_kw) -> None:
    pass


def _done(result, log):
    state, ls = result
    if ls.history:
        log(f"[train] done: step {ls.step}, "
            f"loss {ls.history[0][1]:.3f} -> {ls.history[-1][1]:.3f}, "
            f"stragglers {ls.n_stragglers}")
    return state, ls


if __name__ == "__main__":
    main()
