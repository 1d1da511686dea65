"""Walls of the smoke's homog64 placeit sweep, stacked and unstacked, in
turns on one card.

    python3 src/repro_torch/launch/sweep_walls.py [--turns 3] [--profile] \\
        [--out sweep_walls.json]

Runs ``kernel_timing.sweep_configs`` (``chip_smoke.py``'s sweep phase)
through ``run_sweep`` once unstacked to warm the caches (not reported),
then ``--turns`` rounds of both modes, the order alternating (stacked,
unstacked; unstacked, stacked; ...).  Each run prints its wall (host clock
around work ending in a synchronize), evaluations/s of the searches,
scorer calls, blocked-FW launches, and where the wall went: inside the
scorer calls (``Evaluator.score_batch``), in the stacking around them
(``optimize.score_stacked`` less its scorer call: concatenation, per-row
vectors, the split), in building the Evaluators (``api.make_evaluator``,
the norm samples), in stacking the host graph lists
(``optimize._request_parts``), and the rest (the searches' own host
work), each timed here by a wrapper, exclusive of the wrapped calls it
makes.  With ``--profile``, one more run of each mode under
``torch.profiler``: the device busy share, device time by kernel and the
copies by direction.  Needs a card; prints the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from repro_torch.core import api, optimize  # noqa: E402
from repro_torch.core.optimize import Evaluator  # noqa: E402
from repro_torch.kernels import fw_counts_tiled as fwt  # noqa: E402
from repro_torch.launch import kernel_timing as kt  # noqa: E402

MODES = {"stacked": {}, "unstacked": {"stack_scoring": False}}
SPLIT = ("score_s", "stacking_s", "evaluators_s", "request_parts_s",
         "rest_s")


class _Timers:
    """Wall seconds spent inside each wrapped function, exclusive of the
    wrapped functions it calls (calls that end in a device-to-host copy
    include the device's work)."""

    def __init__(self, targets: dict):
        self.targets = targets            # name -> (owner, attribute)
        self.seconds = dict.fromkeys(targets, 0.0)
        self._orig = {k: getattr(o, a) for k, (o, a) in targets.items()}
        self._active: list[str] = []

    def __enter__(self):
        for name, (owner, attr) in self.targets.items():
            setattr(owner, attr, self._wrap(name, self._orig[name]))
        return self

    def _wrap(self, name, fn):
        def timed(*a, **k):
            self._active.append(name)
            t0 = time.monotonic()
            try:
                return fn(*a, **k)
            finally:
                dt = time.monotonic() - t0
                self._active.pop()
                self.seconds[name] += dt
                if self._active:            # not the caller's own time
                    self.seconds[self._active[-1]] -= dt
        return timed

    def __exit__(self, *exc):
        for name, (owner, attr) in self.targets.items():
            setattr(owner, attr, self._orig[name])


def _targets() -> dict:
    return {"score_batch": (Evaluator, "score_batch"),
            "score_stacked": (optimize, "score_stacked"),
            "make_evaluator": (api, "make_evaluator"),
            "request_parts": (optimize, "_request_parts")}


def run_mode(mode: str, dev) -> dict:
    configs = kt.sweep_configs(api)
    launches = fwt.launches
    with _Timers(_targets()) as tm:
        t0 = time.monotonic()
        res = api.run_sweep(configs, device=dev, **MODES[mode])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    n = res.stats.n_evaluated
    sec = tm.seconds
    split = {"score_s": sec["score_batch"],
             "stacking_s": sec["score_stacked"],
             "evaluators_s": sec["make_evaluator"],
             "request_parts_s": sec["request_parts"]}
    split["rest_s"] = wall - sum(split.values())
    return {"mode": mode, "wall_s": wall, "evaluations": n,
            "evaluations_per_s": n / wall,
            "score_calls": res.stats.score_calls,
            "stacked_groups": res.stats.stacked_groups,
            "fw_counts_tiled_launches": fwt.launches - launches,
            "records_s": {f"{r.algorithm} {r.repetition} {i}": r.seconds
                          for i, r in enumerate(res.records)},
            **split}


def profile_mode(mode: str, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        api.run_sweep(kt.sweep_configs(api), device=dev, **MODES[mode])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    return {"mode": mode, "wall_s": wall, "device_ms": total,
            "busy": total / 1e3 / wall,
            "top": [(k[:90], ms, n) for k, ms, n in rows[:8]],
            "copies": [(k, ms, n) for k, ms, n in rows
                       if k.startswith("Memcpy")]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: sweep_walls.py runs only on a card")
    dev = torch.device("cuda", 0)
    card = kt.card_line()
    print(card)
    run_mode("unstacked", dev)                      # warm-up, not reported
    runs = []
    for turn in range(args.turns):
        order = list(MODES) if turn % 2 == 0 else list(MODES)[::-1]
        for mode in order:
            r = run_mode(mode, dev)
            runs.append(r)
            print(f"  {mode:9s} wall {r['wall_s']:.3f} s, "
                  f"{r['evaluations_per_s']:.1f} evaluations/s, score_calls "
                  f"{r['score_calls']}, fw_counts_tiled launches "
                  f"{r['fw_counts_tiled_launches']}; "
                  + ", ".join(f"{k[:-2]} {r[k]:.3f} s" for k in SPLIT),
                  flush=True)
            print("    record seconds: " + ", ".join(
                f"{k} {v:.3f}" for k, v in r["records_s"].items()))
    keys = ("wall_s", "evaluations_per_s") + SPLIT
    summary = {m: {k: statistics.median(r[k] for r in runs
                                        if r["mode"] == m) for k in keys}
               for m in MODES}
    for m, v in summary.items():
        print(f"median {m:9s} wall {v['wall_s']:.3f} s, "
              f"{v['evaluations_per_s']:.1f} evaluations/s; "
              + ", ".join(f"{k[:-2]} {v[k]:.3f} s" for k in SPLIT))
    out = {"card": card, "runs": runs, "median": summary}
    if args.profile:
        out["profiles"] = []
        for mode in MODES:
            p = profile_mode(mode, dev)
            out["profiles"].append(p)
            print(f"profile {mode}: wall {p['wall_s']:.3f} s under the "
                  f"profiler, device {p['device_ms']:.1f} ms "
                  f"({100 * p['busy']:.2f} % busy)")
            for k, ms, n in p["top"]:
                print(f"  {ms:10.3f} ms {n:6d} x  {k}")
            for k, ms, n in p["copies"]:
                print(f"  copies: {ms:10.3f} ms {n:6d} x  {k}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
