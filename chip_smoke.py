"""End-to-end smoke of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. device — the card's name, the device count and its power limit;
2. build  — the CUDA kernels from the sources in ``src/repro_torch``;
3. parity — the FW kernel against its plain PyTorch version on the card,
   bit for bit (``torch.equal`` on D and N), on random, disconnected,
   count-clip and real homog32/homog64 score graphs;
4. timing — the kernel (CUDA events, median over launches after warm-up)
   at the main path's shapes, beside its bound and the plain version;
5. main path — the quickstart experiment (homog32 baseline, GA) and
   homog64 placeit (GA at paper defaults) through ``run_experiment`` and
   ``baseline_cost`` on the card, with the kernel's launch count and the
   plain version's call count reset just before and read just after; the
   homog32 winner is re-scored with the plain version and must agree.

The second-to-last line is a JSON object listing the kernels; the last is
``{"ok": true, "device": {...}}``.  There is no CPU mode.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import testing  # noqa: E402
from repro_torch.core.api import (Budget, ExperimentConfig,  # noqa: E402
                                  GAParams, baseline_cost, make_rep,
                                  run_experiment)
from repro_torch.core.chiplets import paper_arch  # noqa: E402
from repro_torch.core.objective import norms_vec  # noqa: E402
from repro_torch.core.proxies import make_scorer  # noqa: E402
from repro_torch.core.topology import stack_graphs  # noqa: E402
from repro_torch.kernels import fw_counts as fwc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as fw_ref  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# add, mul, min, three compares, add, two selects, min
FW_OPS_PER_RELAXATION = 10
# (B = the scorer's chunk, arch, config): V = 216 and V = 480.
TIMED = ((16, "homog32", "baseline"), (16, "homog64", "placeit"))


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def device_phase() -> str:
    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs only on a card")
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip())
    # No float32 product on the path may run in TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def build_phase() -> None:
    phase("build")
    t0 = time.monotonic()
    log = fwc.build(force=True)
    print(log.strip())
    print(f"build: {fwc.LIB_PATH.name} in {time.monotonic() - t0:.2f} s")


def parity_phase(dev) -> float:
    phase("parity: fw_counts kernel vs plain version (bitwise)")
    worst = 0.0
    for name, make in testing.kernel_cases().items():
        W = torch.from_numpy(make()).to(dev)
        D1, N1 = ops.fw_counts(W)
        D2, N2 = fw_ref.fw_counts_ref(W)
        torch.cuda.synchronize()
        err = max(float((D1 - D2).abs().max()), float((N1 - N2).abs().max()))
        worst = max(worst, err)
        same = torch.equal(D1, D2) and torch.equal(N1, N2)
        print(f"  {name:32s} {'equal' if same else 'DIFFERS'} "
              f"(max abs err {err})")
        if not same:
            raise SystemExit(f"fw_counts kernel differs from the plain "
                             f"version on {name}")
    return worst


def _median_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def fw_bound_ms(B: int, V: int) -> tuple[float, str]:
    ops_s = FW_OPS_PER_RELAXATION * B * V * (V - 1) ** 2 / PEAK_F32_OPS
    bytes_s = 3 * B * V * V * 4 / PEAK_BYTES
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


def timing_phase(dev) -> list[dict]:
    phase("timing: fw_counts at the main path's shapes")
    rows = []
    for B, arch_name, config in TIMED:
        W = torch.from_numpy(testing.score_graphs(arch_name, config,
                                                  B)).to(dev)
        V = W.shape[-1]
        ms = _median_ms(lambda: ops.fw_counts(W), reps=30)
        plain_ms = _median_ms(lambda: fw_ref.fw_counts_ref(W), reps=3,
                              warmup=1)
        bound_ms, bound_by = fw_bound_ms(B, V)
        rows.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        print(f"  B={B} V={V}: kernel {ms:.4f} ms (median of 30), bound "
              f"{1e3 * bound_ms:.2f} us ({bound_by}), {bound_ms / ms:.4f} "
              f"of bound; plain version {plain_ms:.3f} ms; library call: "
              f"none")
    return rows


def _run(cfg: ExperimentConfig, dev) -> tuple:
    launches0 = fwc.launches
    t0 = time.monotonic()
    rec = run_experiment(cfg, device=dev)[0]     # returns host numpy
    wall = time.monotonic() - t0
    launches1 = fwc.launches
    t1 = time.monotonic()
    base_cost, base = baseline_cost(cfg, device=dev)
    base_wall = time.monotonic() - t1
    res = rec.result
    n_scored = res.n_evaluated + cfg.norm_samples
    print(f"  {cfg.arch} {cfg.config}: best cost {res.best_cost:.4f} vs 2D "
          f"mesh {base_cost:.4f}; run_experiment {wall:.2f} s wall "
          f"({n_scored} placements scored incl. {cfg.norm_samples} norm "
          f"samples, {n_scored / wall:.1f} evaluations/s; search alone "
          f"{res.n_evaluated / rec.seconds:.1f} evaluations/s); "
          f"baseline_cost {base_wall:.2f} s; kernel launches: run "
          f"{launches1 - launches0}, baseline {fwc.launches - launches1}")
    print("  metric            placeit   2D-mesh   delta")
    for t in ("c2c", "c2m", "c2i", "m2i"):
        o, b = res.best_metrics[f"lat_{t}"], base[f"lat_{t}"]
        print(f"  lat_{t} [cyc]     {o:8.1f}  {b:8.1f}  {100*(o/b-1):+6.1f}%")
    for t in ("c2c", "c2m", "c2i", "m2i"):
        o, b = res.best_metrics[f"thr_{t}"], base[f"thr_{t}"]
        print(f"  thr_{t} [frac]    {o:8.3f}  {b:8.3f}  {100*(o/b-1):+6.1f}%")
    costs = [res.best_cost, base_cost] + [c for _, _, c in res.history]
    if not all(np.isfinite(c) for c in costs):
        raise SystemExit(f"non-finite cost in {cfg.arch} {cfg.config}")
    if not (res.best_metrics["connected"] and base["connected"]):
        raise SystemExit(f"disconnected result in {cfg.arch} {cfg.config}")
    arch = paper_arch(cfg.arch, cfg.config)
    kinds, counts = np.unique(res.best_sol[0][res.best_sol[0] >= 0],
                              return_counts=True)
    if tuple(counts) != arch.counts() or tuple(kinds) != (0, 1, 2):
        raise SystemExit(f"best placement holds {counts}, not "
                         f"{arch.counts()} chiplets")
    return rec


def _rescore_plain(cfg: ExperimentConfig, rec, dev) -> None:
    """The run's best placement re-scored with the plain FW version on the
    card must reproduce the run's metrics (rtol 1e-6: the kernel is
    bitwise, only the chunk's float32 reductions may differ)."""
    arch = paper_arch(cfg.arch, cfg.config)
    rep = make_rep(arch, cfg.arch, cfg.mutation_mode)
    scorer = make_scorer(rep.layout, fw_impl=ops.fw_impl_ref,
                         chunk=cfg.chunk, objective=cfg.objective,
                         device=dev)
    res = rec.result
    got = scorer(stack_graphs([rep.score_graph(res.best_sol)]),
                 norms_vec(res.normalizers))
    for k, want in res.best_metrics.items():
        np.testing.assert_allclose(float(got[k][0]), want, rtol=1e-6,
                                   err_msg=k)
    print(f"  re-scored the {cfg.arch} winner with the plain version: "
          f"{len(res.best_metrics)} metrics agree (rtol 1e-6)")


def main_path_phase(dev) -> int:
    phase("main path: run_experiment + baseline_cost on the card")
    quick = ExperimentConfig(
        arch="homog32", config="baseline", algorithms=("ga",),
        budget=Budget(evals=240), norm_samples=32,
        params={"ga": GAParams(population=24, elitism=5, tournament=5)})
    big = ExperimentConfig(
        arch="homog64", config="placeit", algorithms=("ga",),
        budget=Budget(evals=300), norm_samples=100,
        params={"ga": GAParams(population=50, elitism=8, tournament=8)})
    fwc.launches = 0
    fw_ref.calls = 0
    rec = _run(quick, dev)
    _run(big, dev)
    launches, plain_calls = fwc.launches, fw_ref.calls
    print(f"  fw_counts kernel launches {launches}, plain FW calls "
          f"{plain_calls}")
    if launches <= 0 or plain_calls != 0:
        raise SystemExit("the main path did not go through the kernel alone")
    _rescore_plain(quick, rec, dev)
    return launches


def main() -> None:
    name = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    max_err = parity_phase(dev)
    timing = timing_phase(dev)
    launches = main_path_phase(dev)
    t = timing[0]                     # the quickstart's shape, V = 216
    print(json.dumps({"kernels": [{
        "name": "fw_counts", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fw_counts.cu",
        "replaces": "src/repro/kernels/minplus.py:104",
        "launches": launches, "max_abs_err": max_err, "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "parity": "bitwise"}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
