"""Fault-tolerant training loop: checkpoint and restart, a straggler
watermark, preemption-safe saves.  The port of ``repro.train.loop``.

* restart     — the loop opens with ``ckpt.restore`` of the newest
                committed step and copies it into the state in place (the
                parameters are the model's own); the data cursor rides in
                the checkpoint's extras, so a restart replays nothing and
                skips nothing.
* atomicity   — saves go through a temporary directory, a rename and a
                marker; a kill mid-save cannot corrupt the newest step.
* stragglers  — each step's wall time feeds an EWMA watermark; steps
                slower than ``straggler_factor`` times it are counted and
                logged.
* preemption  — SIGTERM sets a flag; the loop checkpoints and stops at the
                next step boundary.

A step's time ``dt`` ends with one device synchronisation (the
reference's ``block_until_ready``).  A model-parallel state (DTensors)
restores onto ``state_shardings`` (``train.step.shard_state``'s), which
may lie on another mesh than the checkpoint's writer's; every rank runs
the loop, and ``ckpt.save`` gathers each leaf for rank 0 to write.
"""
from __future__ import annotations

import math
import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from ..ckpt import checkpoint as ckpt


@dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 100
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 2.0
    ewma: float = 0.9


@dataclass
class LoopState:
    step: int = 0
    watermark_s: float = 0.0
    n_stragglers: int = 0
    preempted: bool = False
    history: list = field(default_factory=list)


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


@torch.no_grad()
def _load_into(state, restored) -> None:
    """Copy a restored tree into ``state``'s tensors in place."""
    if isinstance(state, dict):
        for key, val in state.items():
            _load_into(val, restored[key])
    else:
        state.copy_(restored)


def _sync(metrics: dict) -> None:
    loss = metrics["loss"]
    if loss.is_cuda:
        torch.cuda.synchronize(loss.device)


def run(loop_cfg: LoopConfig, *, state, train_step: Callable, stream,
        state_shardings=None, log: Callable = print
        ) -> tuple[Any, LoopState]:
    """Run (or resume) training.  Returns (final_state, loop_state)."""
    ls = LoopState()

    # ---- restart path ----------------------------------------------------
    last = ckpt.latest_step(loop_cfg.ckpt_dir)
    if last is not None:
        restored, step, extras = ckpt.restore(
            loop_cfg.ckpt_dir, state, device=_first_leaf(state).device,
            shardings=state_shardings)
        _load_into(state, restored)
        del restored
        ls.step = step
        if "cursor" in extras and hasattr(stream, "from_cursor"):
            stream.step = int(extras["cursor"].get("step", step))
        log(f"[loop] resumed from step {step}")

    # ---- preemption hook ---------------------------------------------------
    def _on_sigterm(signum, frame):
        ls.preempted = True
    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:              # not the main thread (tests)
        prev_handler = None

    def save(step):
        ckpt.save(loop_cfg.ckpt_dir, step, state,
                  extras={"cursor": stream.cursor()
                          if hasattr(stream, "cursor") else {}},
                  keep=loop_cfg.keep)

    try:
        while ls.step < loop_cfg.total_steps:
            batch = stream.batch_at(ls.step) if hasattr(stream, "batch_at") \
                else next(stream)
            if hasattr(stream, "step"):
                stream.step = ls.step + 1
            t0 = time.monotonic()
            state, metrics = train_step(state, batch)
            _sync(metrics)
            dt = time.monotonic() - t0
            ls.step += 1
            # ---- straggler watermark ----------------------------------
            if ls.watermark_s == 0.0:
                ls.watermark_s = dt
            slow = dt > loop_cfg.straggler_factor * ls.watermark_s
            if slow:
                ls.n_stragglers += 1
            ls.watermark_s = (loop_cfg.ewma * ls.watermark_s
                              + (1 - loop_cfg.ewma) * dt)
            if ls.step % loop_cfg.log_every == 0 or slow:
                loss = float(metrics["loss"]) if "loss" in metrics \
                    else math.nan
                ls.history.append((ls.step, loss, dt))
                log(f"[loop] step {ls.step} loss {loss:.4f} "
                    f"dt {dt*1e3:.0f}ms wm {ls.watermark_s*1e3:.0f}ms"
                    + (" STRAGGLER" if slow else ""))
            if ls.step % loop_cfg.ckpt_every == 0 \
                    or ls.step == loop_cfg.total_steps or ls.preempted:
                save(ls.step)
            if ls.preempted:
                log(f"[loop] preempted; checkpointed at step {ls.step}")
                break
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
    return state, ls
