"""End-to-end smoke of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. device — the card's name, the device count and its power limit;
2. build  — every CUDA kernel from the sources in ``src/repro_torch`` (one
   nvcc per source, started together, then one link), with ptxas's
   registers and spills per kernel instance;
3. parity — each kernel against its plain PyTorch version on the card.
   The FW and min-plus kernels bit for bit (``torch.equal``): the FW
   kernel on random, disconnected, count-clip and real homog32/homog64
   score graphs; the blocked FW kernel against the plain blocked FW, the
   plain FW and the FW kernel on graphs at the tile edges, disconnected
   graphs, the count-clip graph and score graphs of the four
   100+-chiplet families; the min-plus kernel on ragged shapes and on
   sums above its 1e9 ceiling; APSP against the plain FW's distances on
   homog256 graphs.  The attention kernels to the JAX tests' tolerances
   (flash 2e-5, decode 3e-5 in float32, both 2e-2 in bfloat16) on
   ``testing.attention_cases`` / ``decode_cases`` in both dtypes, and at
   the full qwen3-1.7b shapes in bfloat16 to a limit scaled to the
   outputs (two bfloat16 ulps of each entry plus 1e-5, ``FULL_LIMIT``);
4. timing — each kernel (CUDA events, median over launches after warm-up)
   at the main path's shapes, beside its bound and the plain version; the
   FW kernel and the blocked FW kernel side by side at every (B, V) the
   scorer uses for the large families and at V = 216 and 480 (the
   measurement behind ``ops.FW_TILED_FROM_V``).  Every timed output is
   held bit for bit against the plain version's output on the same input,
   so the kernels are also checked at the main path's full shapes
   (min-plus at 1536^3, APSP at V = 1536).  The attention kernels at
   qwen3-1.7b's shapes in bfloat16 (flash: B = 1, Sq = Sk in {512, 2048},
   causal; decode: B = 8, S = 4096, every length 4096 and lengths drawn
   from the seed), each beside its plain version, its bound and one
   PyTorch call that computes the same function
   (``scaled_dot_product_attention``, timed for comparison only; the port
   never calls it), every output held to ``FULL_LIMIT`` against the plain
   version;
5. main path — each path driven through ``run_experiment`` and
   ``baseline_cost`` on the card, with every kernel's launch count and
   every plain version's call count set to 0 just before each run and read
   just after:
   - slice 1, backend "fw-cuda": the quickstart experiment (homog32
     baseline, GA) and homog64 placeit (GA at paper defaults);
   - slice 2, backend "fw-tiled": homog256 placeit (V = 1536) and hex127
     baseline (V = 702), GA at the large families' defaults;
   - ``ops.apsp`` on the homog256 winner's score graph (min-plus kernel);
   the homog32 and homog256 winners are re-scored with the plain FW, and
   the APSP distances must equal the plain FW's;
   - slice 3, the LM serving path: qwen3-1.7b at full width (28 layers,
     d_model 2048, bfloat16, weights from a ``torch.Generator`` seeded 0
     on the card) through ``ServeEngine`` (8 slots, cache 4096, no EOS):
     16 requests with prompts of 256 to 2048 tokens drawn from the seed,
     64 tokens each.  It prints wall time, prefill and decode tokens/s,
     the median time to first token, ticks, and the attention kernels'
     launches (28 per prefill, 28 per tick; no plain call); then the
     decode step's logits for request 0's second token against a
     re-prefill of (prompt + first token);
6. profile — ``torch.profiler`` over one blocked FW call at homog256
   (device time by kernel) and one homog256 placeit run (device busy
   share); one qwen3-1.7b prefill of 1024 tokens and 8 decode ticks of
   the 8-slot pool (device busy share, time by kernel).

The second-to-last line is a JSON object listing the kernels; the last is
``{"ok": true, "device": {...}}``.  There is no CPU mode.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import testing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.api import (Budget, ExperimentConfig,  # noqa: E402
                                  GAParams, baseline_cost, make_rep,
                                  run_experiment)
from repro_torch.core.chiplets import resolve_arch  # noqa: E402
from repro_torch.core.objective import norms_vec  # noqa: E402
from repro_torch.core.proxies import (make_scorer,  # noqa: E402
                                      max_pair_elems, scorer_chunk)
from repro_torch.core.topology import stack_graphs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import fw_counts as fwc  # noqa: E402
from repro_torch.kernels import fw_counts_tiled as fwt  # noqa: E402
from repro_torch.kernels import minplus as mp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as plain  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serve.engine import (EngineConfig, Request,  # noqa: E402
                                      ServeEngine)

# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores, bfloat16 on the dense tensor cores, and HBM3 bandwidth.
PEAK_F32_OPS = 67e12
PEAK_BF16_OPS = 989e12
PEAK_BYTES = 3.35e12
# add, mul, min, three compares, add, two selects, min
FW_OPS_PER_RELAXATION = 10
# (B = the scorer's chunk, arch, config): V = 216 and V = 480.
TIMED = ((16, "homog32", "baseline"), (16, "homog64", "placeit"))
# Random graphs below the paper's sizes, to place the dispatch point.
TIMED_SMALL_V = (40, 96, 130, 160, 192)
KERNELS = {"fw_counts": fwc, "fw_counts_tiled": fwt, "minplus": mp,
           "flash_attention": tfa, "decode_attention": tda}
# Attention tolerances (the JAX kernel tests'), by kernel and dtype.
ATTN_TOL = {"flash_attention": {"float32": 2e-5, "bfloat16": 2e-2},
            "decode_attention": {"float32": 3e-5, "bfloat16": 2e-2}}
# The arch whose score graphs time min-plus and check APSP (V = 1536).
APSP_ARCH = "homog256"

# The main path's runs.  Slice 1: the quickstart and homog64 placeit on
# backend "fw-cuda"; slice 2: homog256 placeit and hex127 baseline on
# backend "fw-tiled", GA at the large families' defaults.
QUICKSTART = ExperimentConfig(
    arch="homog32", config="baseline", algorithms=("ga",),
    budget=Budget(evals=240), norm_samples=32,
    params={"ga": GAParams(population=24, elitism=5, tournament=5)})
HOMOG64 = ExperimentConfig(
    arch="homog64", config="placeit", algorithms=("ga",),
    budget=Budget(evals=300), norm_samples=100,
    params={"ga": GAParams(population=50, elitism=8, tournament=8)})
_LARGE = dict(algorithms=("ga",), budget=Budget(evals=100), norm_samples=20,
              backend="fw-tiled",
              params={"ga": GAParams(population=50, elitism=8,
                                     tournament=8)})
HOMOG256 = ExperimentConfig(arch="homog256", config="placeit", **_LARGE)
HEX127 = ExperimentConfig(arch="hex127", config="baseline", **_LARGE)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return smi.stdout.strip()


def device_phase() -> str:
    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs only on a card")
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(card_line())
    # No float32 product on the path may run in TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def build_phase() -> None:
    phase("build")
    t0 = time.monotonic()
    log = build.build(force=True)
    # ptxas's summary, one line per kernel: registers, barriers, spills.
    kernel = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(
                r"([a-z_]+_kernel)(?:ILi(\d+)E(13__nv_bfloat16|f)?)?", line)
            args = [a for a in (m.group(2), {"f": "f32"}.get(
                m.group(3), m.group(3) and "bf16")) if a]
            kernel = m.group(1) + (f"<{', '.join(args)}>" if args else "")
        elif "Used" in line and kernel is not None:
            print(f"  {kernel:34s} {line.split(':', 1)[1].strip()}")
        elif "spill" in line and " 0 bytes spill stores" not in line:
            print(f"  {line.strip()}")
    print(f"build: {build.LIB_PATH.name} ({len(build.SOURCES)} sources) in "
          f"{time.monotonic() - t0:.2f} s")


def _max_err(pairs) -> float:
    return max(float((a - b).abs().max()) if a.numel() else 0.0
               for a, b in pairs)


def _require_equal(what: str, name: str, got, want) -> float:
    """Max abs error of ``got`` against ``want``; exits unless equal."""
    err = _max_err(zip(got, want))
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise SystemExit(f"{what} differs on {name} (max abs err {err})")
    return err


def parity_phase(dev) -> dict:
    worst = dict.fromkeys(KERNELS, 0.0)
    phase("parity: fw_counts kernel vs plain version (bitwise)")
    for name, make in testing.kernel_cases().items():
        W = torch.from_numpy(make()).to(dev)
        got = ops.fw_counts(W)
        torch.cuda.synchronize()
        worst["fw_counts"] = max(worst["fw_counts"], _require_equal(
            "fw_counts vs plain", name, got, plain.fw_counts_ref(W)))
        print(f"  {name:34s} equal")

    phase("parity: fw_counts_tiled kernel vs plain blocked FW, plain FW "
          "and fw_counts (bitwise)")
    for name, make in testing.tiled_cases(fwt.BT).items():
        W = torch.from_numpy(make()).to(dev)
        got = fwt.fw_counts_tiled(W)
        torch.cuda.synchronize()
        err = max(
            _require_equal("tiled vs plain tiled", name, got,
                           plain.fw_counts_tiled_ref(W, fwt.BT)),
            _require_equal("tiled vs plain FW", name, got,
                           plain.fw_counts_ref(W)),
            _require_equal("tiled vs fw_counts", name, got, ops.fw_counts(W)))
        worst["fw_counts_tiled"] = max(worst["fw_counts_tiled"], err)
        print(f"  {name:34s} equal to all three")

    phase("parity: minplus kernel vs plain version (bitwise), apsp vs "
          "plain FW distances")
    for name, make in testing.minplus_cases().items():
        A, B = (torch.from_numpy(x).to(dev) for x in make())
        got = ops.minplus(A, B)
        torch.cuda.synchronize()
        worst["minplus"] = max(worst["minplus"], _require_equal(
            "minplus vs plain", name, [got], [plain.minplus_ref(A, B)]))
        print(f"  minplus {name:34s} equal")
    for cfg in ("baseline", "placeit"):
        W = torch.from_numpy(testing.score_graphs(APSP_ARCH, cfg, 1)[0])
        W = W.to(dev)
        worst["minplus"] = max(worst["minplus"], _require_equal(
            "apsp vs plain FW distances", f"{APSP_ARCH} {cfg}",
            [ops.apsp(W)], [plain.fw_counts_ref(W)[0]]))
        print(f"  apsp {APSP_ARCH} {cfg} V={W.shape[-1]:<22d} equal to the "
              f"plain FW's distances")
    return worst


def _median_ms(fns: dict, reps: int, warmup: int = 1) -> tuple[dict, dict]:
    """Median CUDA-event time of each callable, the callables taking
    turns in every repetition, and each callable's last output."""
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    times = {k: [] for k in fns}
    outs = {}
    for _ in range(reps):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outs[k] = fn()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return {k: statistics.median(v) for k, v in times.items()}, outs


def _bound(ops_n: float, bytes_n: float,
           peak_ops: float = PEAK_F32_OPS) -> tuple[float, str]:
    ops_s, bytes_s = ops_n / peak_ops, bytes_n / PEAK_BYTES
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


def fw_bound_ms(B: int, V: int) -> tuple[float, str]:
    return _bound(FW_OPS_PER_RELAXATION * B * V * (V - 1) ** 2,
                  3 * B * V * V * 4)


def minplus_bound_ms(M: int, K: int, N: int) -> tuple[float, str]:
    return _bound(2 * M * N * K, (M * K + K * N + M * N) * 4)


def _scorer_batch(arch_name: str, config: str) -> int:
    """The scorer's placements per FW call for this arch (default chunk
    16 after the clamp)."""
    arch = resolve_arch(arch_name, config)
    rep = make_rep(arch, arch_name)
    g = rep.score_graph(rep.random(np.random.default_rng(0)))
    return scorer_chunk(max_pair_elems(rep.layout), g.W.shape[-1],
                        g.edges.shape[0], 16)


def timing_phase(dev, worst: dict) -> dict:
    """Times the kernels; every timed output must equal the plain
    version's, and its error is folded into ``worst``."""
    phase("timing: fw_counts vs fw_counts_tiled (the dispatch measurement; "
          "outputs bitwise vs the plain FW)")
    shapes = [(f"random V={V}", 16,
               lambda V=V: testing.random_graph(V, 3 * V, seed=V, batch=16))
              for V in TIMED_SMALL_V]
    shapes += [(f"{a} {c}", B, lambda a=a, c=c, B=B: testing.score_graphs(
        a, c, B)) for B, a, c in TIMED]
    for a in testing.LARGE_ARCHS:
        for c in ("baseline", "placeit"):
            B = _scorer_batch(a, c)
            shapes.append((f"{a} {c}", B, lambda a=a, c=c, B=B:
                           testing.score_graphs(a, c, B)))
    rows = {}
    print(f"  {'shape':22s} {'B':>3s} {'V':>5s} {'fw_counts':>11s} "
          f"{'tiled':>10s} {'plain':>10s} {'bound':>9s}  (ms)")
    for name, B, make in shapes:
        W = torch.from_numpy(make()).to(dev)
        V = W.shape[-1]
        t, out = _median_ms({"fw_counts": lambda: ops.fw_counts(W),
                             "tiled": lambda: fwt.fw_counts_tiled(W)},
                            reps=3 if V > 700 else 10)
        p, want = _median_ms({"p": lambda: plain.fw_counts_ref(W)}, reps=2)
        for k in ("fw_counts", "tiled"):
            kernel = "fw_counts_tiled" if k == "tiled" else k
            worst[kernel] = max(worst[kernel], _require_equal(
                f"timed {kernel} vs plain FW", name, out[k], want["p"]))
        t["plain"] = p["p"]
        t["bound"], t["bound_by"] = fw_bound_ms(B, V)
        t["B"], t["V"] = B, V
        rows[name] = t
        print(f"  {name:22s} {B:3d} {V:5d} {t['fw_counts']:11.4f} "
              f"{t['tiled']:10.4f} {t['plain']:10.3f} {t['bound']:9.4f}  "
              f"({t['bound_by']}) equal")

    phase(f"timing: minplus (M = N = K = V) and apsp on a {APSP_ARCH} "
          f"placeit score graph (outputs bitwise vs the plain versions)")
    W = torch.from_numpy(testing.score_graphs(APSP_ARCH, "placeit", 1)[0])
    W = W.to(dev)
    V = W.shape[-1]
    t, out = _median_ms({"kernel": lambda: ops.minplus(W, W)}, reps=20,
                        warmup=3)
    p, want = _median_ms({"p": lambda: plain.minplus_ref(W, W)}, reps=3)
    worst["minplus"] = max(worst["minplus"], _require_equal(
        "timed minplus vs plain", f"{APSP_ARCH} placeit W x W",
        [out["kernel"]], [want["p"]]))
    t["plain"] = p["p"]
    t["bound"], t["bound_by"] = minplus_bound_ms(V, V, V)
    rows["minplus"] = t
    n = plain.apsp_squarings(V)
    a, out = _median_ms({"kernel": lambda: ops.apsp(W)}, reps=5)
    p, want = _median_ms({"p": lambda: plain.apsp_ref(W)}, reps=2)
    worst["minplus"] = max(worst["minplus"], _require_equal(
        "timed apsp vs plain", f"{APSP_ARCH} placeit", [out["kernel"]],
        [want["p"]]))
    a["plain"] = p["p"]
    b_ms, b_by = minplus_bound_ms(V, V, V)
    a["bound"], a["bound_by"] = n * b_ms, b_by
    rows["apsp"] = a
    for k in ("minplus", "apsp"):
        r = rows[k]
        print(f"  {k} V={V}: kernel {r['kernel']:.4f} ms, bound "
              f"{r['bound']:.4f} ms ({r['bound_by']}), "
              f"{r['bound'] / r['kernel']:.4f} of bound; plain version "
              f"{r['plain']:.3f} ms; library call: none; output equal to "
              f"the plain version's")
    return rows

# -- attention (slice 3) ----------------------------------------------------

def _on_card(arrays, dev, dtype=torch.bfloat16):
    return [torch.from_numpy(a).to(dev).to(dtype) for a in arrays]


def _require_close(what: str, name: str, got, want, rtol: float,
                   atol: float | None = None) -> tuple[float, float]:
    """Max abs error of ``got`` against ``want`` and the largest share of
    the limit an entry uses; exits unless every entry is within
    ``atol + rtol * |want|`` (``atol`` defaults to ``rtol``)."""
    atol = rtol if atol is None else atol
    g, w = got.float(), want.float()
    if not g.numel():
        return 0.0, 0.0
    diff = (g - w).abs()
    share = float((diff / (atol + rtol * w.abs())).max())
    err = float(diff.max())
    if share > 1:
        raise SystemExit(f"{what} differs on {name} beyond {atol} + {rtol} "
                         f"|plain| (max abs err {err}, {share:.3g} of the "
                         f"limit)")
    return err, share


def attention_parity_phase(dev, worst: dict) -> None:
    phase("parity: flash_attention and decode_attention kernels vs plain "
          "versions (allclose: flash 2e-5, decode 3e-5 in float32; 2e-2 in "
          "bfloat16)")
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        tol = ATTN_TOL["flash_attention"][dtype]
        for name, make in testing.attention_cases().items():
            *qkv, kw = make()
            q, k, v = _on_card(qkv, dev, dt)
            err, _ = _require_close("flash_attention vs plain", name,
                                    tfa.flash_attention(q, k, v, **kw),
                                    plain.attention_ref(q, k, v, **kw), tol)
            worst["flash_attention"] = max(worst["flash_attention"], err)
        tol = ATTN_TOL["decode_attention"][dtype]
        for name, make in testing.decode_cases().items():
            *arrays, lens, kw = make()
            q, kc, vc = _on_card(arrays, dev, dt)
            lens = torch.from_numpy(lens).to(dev)
            err, _ = _require_close(
                "decode_attention vs plain", name,
                tda.decode_attention(q, kc, vc, lens, **kw),
                plain.decode_attention_ref(q, kc, vc, lens, **kw), tol)
            worst["decode_attention"] = max(worst["decode_attention"], err)
        print(f"  {dtype}: {len(testing.attention_cases())} flash and "
              f"{len(testing.decode_cases())} decode cases within tolerance "
              f"(worst so far: flash {worst['flash_attention']:.3g}, decode "
              f"{worst['decode_attention']:.3g})")


# qwen3-1.7b's attention: 16 query heads on 8 KV heads, head dim 128.
QWEN3_HEADS = dict(Hq=16, Hkv=8, d=128)
# The limit at those shapes, scaled to the outputs.  There an output row
# averages hundreds to thousands of V rows (decode at S = 4096: RMS about
# 0.026), so the cases' fixed 2e-2 would pass a kernel that drops a tail
# tile.  Kernel and plain version compute in float32 from the same
# bfloat16 inputs and round once to bfloat16, so an entry may differ by
# one bfloat16 ulp, at most 2^-7 of its size; the limit allows two ulps,
# plus 1e-5 for outputs near 0 (float32 sums of terms below 4 differ by
# well under 1e-6).  Measured on the H100: flash 1.95e-3 at S = 2048
# (one ulp of an output in [0.25, 0.5)), decode 3.05e-5.
FULL_RTOL, FULL_ATOL = 2.0 ** -6, 1e-5
FULL_LIMIT = f"|kernel - plain| <= {FULL_ATOL:g} + {FULL_RTOL:g} |plain|"
FLASH_TIMED_S = (512, 2048)
DECODE_TIMED = dict(B=8, S=4096)


def flash_bound_ms(B, Sq, Sk, Hq, Hkv, d, causal=True, itemsize=2):
    pairs = Sq * Sk / 2 if causal else Sq * Sk
    return _bound(4 * B * Hq * d * pairs,
                  itemsize * d * (2 * B * Sq * Hq + 2 * B * Sk * Hkv),
                  PEAK_BF16_OPS)


def decode_bound_ms(B, Hq, Hkv, d, lengths, itemsize=2):
    """Only the valid K and V rows are read, plus q and the output."""
    rows = int(lengths.sum())
    return _bound(4 * rows * Hq * d,
                  itemsize * d * (2 * rows * Hkv + 2 * B * Hq),
                  PEAK_BF16_OPS)


def attention_timing_phase(dev, worst: dict) -> dict:
    """Times the attention kernels at qwen3-1.7b's shapes in bfloat16;
    every timed output is held to ``FULL_LIMIT`` against the plain
    version's."""
    F = torch.nn.functional
    rows = {}
    phase(f"timing: flash_attention at qwen3-1.7b prefill shapes (bf16, "
          f"causal; outputs {FULL_LIMIT})")
    for S in FLASH_TIMED_S:
        shape = dict(B=1, Sq=S, Sk=S, **QWEN3_HEADS)
        q, k, v = _on_card(testing.attention_operands(**shape, seed=S),
                             dev)
        t, out = _median_ms({
            "kernel": lambda: tfa.flash_attention(q, k, v),
            "plain": lambda: plain.attention_ref(q, k, v),
            "library": lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)}, reps=10, warmup=2)
        err, share = _require_close("timed flash_attention vs plain",
                                    f"S={S}", out["kernel"], out["plain"],
                                    FULL_RTOL, FULL_ATOL)
        worst["flash_attention"] = max(worst["flash_attention"], err)
        t["bound"], t["bound_by"] = flash_bound_ms(**shape)
        t["max_abs_err"], t["limit_share"] = err, share
        t["max_abs_out"] = float(out["plain"].float().abs().max())
        rows[f"flash S={S}"] = t
        print(f"  B=1 Sq=Sk={S:5d}: kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms, sdpa {t['library']:.4f} ms, bound "
              f"{t['bound']:.4f} ms ({t['bound_by']}), "
              f"{t['bound'] / t['kernel']:.4f} of bound; max abs err vs "
              f"plain {err:.3g} (max |out| {t['max_abs_out']:.3g}; "
              f"{share:.3f} of the limit)")

    phase(f"timing: decode_attention at the serve run's decode shape (bf16; "
          f"outputs {FULL_LIMIT})")
    B, S = DECODE_TIMED["B"], DECODE_TIMED["S"]
    rng = np.random.default_rng(0)
    for label, lens in ((f"every length {S}", np.full(B, S)),
                        ("lengths from the seed",
                         rng.integers(1, S + 1, size=B))):
        q, kc, vc, lens_np = testing.decode_operands(
            B, S, **QWEN3_HEADS, lengths=lens, seed=1)
        q, kc, vc = _on_card((q, kc, vc), dev)
        lens = torch.from_numpy(lens_np).to(dev)
        mask = (torch.arange(S, device=dev)[None] < lens[:, None])
        t, out = _median_ms({
            "kernel": lambda: tda.decode_attention(q, kc, vc, lens),
            "plain": lambda: plain.decode_attention_ref(q, kc, vc, lens),
            "library": lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=mask[:, None, None], enable_gqa=True)},
            reps=20, warmup=2)
        err, share = _require_close("timed decode_attention vs plain",
                                    label, out["kernel"], out["plain"],
                                    FULL_RTOL, FULL_ATOL)
        worst["decode_attention"] = max(worst["decode_attention"], err)
        t["bound"], t["bound_by"] = decode_bound_ms(B, **QWEN3_HEADS,
                                                    lengths=lens_np)
        t["max_abs_err"], t["limit_share"] = err, share
        t["max_abs_out"] = float(out["plain"].float().abs().max())
        rows[f"decode {label}"] = t
        print(f"  B={B} S={S} ({label}, {int(lens_np.sum())} valid rows): "
              f"kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
              f"sdpa {t['library']:.4f} ms, bound {t['bound']:.4f} ms "
              f"({t['bound_by']}), {t['bound'] / t['kernel']:.4f} of bound; "
              f"max abs err vs plain {err:.3g} (max |out| "
              f"{t['max_abs_out']:.3g}; {share:.3f} of the limit)")
    return rows


# -- the LM serving path (slice 3) -----------------------------------------

SERVE_ARCH = "qwen3-1.7b"
SERVE_ENGINE = EngineConfig(n_slots=8, cache_len=4096, eos=-1)
SERVE_REQUESTS, SERVE_PROMPT, SERVE_MAX_TOKENS = 16, (256, 2048), 64
# Request 0's decode-step logits against a re-prefill of (prompt + token
# 1), both in bfloat16 on the card: the two paths round the K/V cache and
# the attention sums differently (another kernel, other matmul shapes), a
# few bfloat16 ulps of logits of magnitude < 8 (0.03 each) after 28
# layers.
CONSISTENCY_TOL = 0.125
PROFILE_PREFILL = 1024


def serve_phase(dev) -> tuple[dict, tuple]:
    """The serve run, with the counts set to 0 just before it and read just
    after; returns the launch counts and (model, engine, prompt lengths)
    for the profile."""
    phase(f"main path, slice 3: {SERVE_ARCH} at full width through "
          f"ServeEngine on the card")
    cfg = get_config(SERVE_ARCH)
    t0 = time.monotonic()
    model = LM(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {model.param_count() / 1e9:.4f} B "
          f"parameters, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}, initialised from torch.Generator seed 0 in "
          f"{time.monotonic() - t0:.2f} s")
    eng = ServeEngine(model, SERVE_ENGINE)
    # One short request first, so that the run below finds cuBLAS and the
    # allocator warm; then the engine's counters start from zero.
    eng.submit(Request(-1, np.arange(3, 35, dtype=np.int32), max_tokens=2))
    eng.run()
    eng.stats = dict.fromkeys(eng.stats, 0)
    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1,
                        size=SERVE_REQUESTS)
    reqs = [Request(i, rng.integers(3, cfg.vocab, size=int(n)).astype(
        np.int32), max_tokens=SERVE_MAX_TOKENS) for i, n in enumerate(lens)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.monotonic()
    ticks = eng.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, plain_calls = read_counts()
    st = eng.stats
    ttft = statistics.median(r.t_first - t0 for r in reqs)
    print(f"  {len(reqs)} requests, prompts {int(lens.min())}-"
          f"{int(lens.max())} tokens ({int(lens.sum())} in all), "
          f"{SERVE_MAX_TOKENS} tokens each; {SERVE_ENGINE.n_slots} slots, "
          f"cache {SERVE_ENGINE.cache_len}")
    print(f"  wall {wall:.3f} s, {ticks} ticks; prefill "
          f"{st['prefill_tokens']} tokens in {st['prefill_s']:.3f} s "
          f"({st['prefill_tokens'] / st['prefill_s']:.1f} tokens/s); decode "
          f"{st['decode_tokens']} tokens in {st['decode_s']:.3f} s "
          f"({st['decode_tokens'] / st['decode_s']:.1f} tokens/s, "
          f"{1e3 * st['decode_s'] / ticks:.2f} ms per tick); time to first "
          f"token median {ttft:.3f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"  launches: flash_attention {launches['flash_attention']} "
          f"(expected {cfg.n_layers} x {len(reqs)} = "
          f"{cfg.n_layers * len(reqs)}), decode_attention "
          f"{launches['decode_attention']} (expected {cfg.n_layers} x "
          f"{ticks} = {cfg.n_layers * ticks}); plain calls {plain_calls}")
    if not all(r.done and len(r.out_tokens) == SERVE_MAX_TOKENS
               for r in reqs):
        raise SystemExit("the serve run left requests unfinished")
    if not all(0 <= t < cfg.vocab_padded for r in reqs
               for t in r.out_tokens):
        raise SystemExit("the serve run emitted tokens out of range")
    if (launches["flash_attention"] != cfg.n_layers * len(reqs)
            or launches["decode_attention"] != cfg.n_layers * ticks
            or plain_calls != 0):
        raise SystemExit("the serve run did not go through the attention "
                         "kernels alone")

    # Request 0's second token: the decode step's logits against a
    # re-prefill of (prompt + first token).
    r0 = reqs[0]
    ext = torch.as_tensor(np.concatenate([r0.prompt, r0.out_tokens[:1]])[
        None], dtype=torch.long, device=dev)
    pre, _ = model.prefill({"tokens": ext}, SERVE_ENGINE.cache_len)
    _, caches = model.prefill({"tokens": ext[:, :-1]}, SERVE_ENGINE.cache_len)
    dec = model.decode_step({
        "tokens": ext[:, -1:], "lengths": torch.tensor(
            [len(r0.prompt)], dtype=torch.int32, device=dev)}, caches)
    if not (torch.isfinite(dec).all() and torch.isfinite(pre).all()):
        raise SystemExit("non-finite logits")
    err = float((dec - pre).abs().max())
    print(f"  consistency, request 0 (prompt {len(r0.prompt)}): decode-step "
          f"logits vs re-prefill max abs err {err:.4f} (logits up to "
          f"{float(pre.abs().max()):.2f}; tolerance {CONSISTENCY_TOL}); "
          f"argmax {int(dec.argmax())} / {int(pre.argmax())}, engine's "
          f"token 2 {r0.out_tokens[1]}")
    if err > CONSISTENCY_TOL:
        raise SystemExit("the decode step disagrees with a re-prefill")
    return launches, (model, eng, lens)


def serve_profile_phase(dev, state: tuple) -> None:
    """torch.profiler over one prefill of ``PROFILE_PREFILL`` tokens and
    over 8 decode ticks of the full pool (lengths: the serve run's first 8
    prompts)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    model, eng, lens = state
    cfg = model.cfg
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        3, cfg.vocab, size=(1, PROFILE_PREFILL)), dtype=torch.long,
        device=dev)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(2).integers(
        3, cfg.vocab, size=(SERVE_ENGINE.n_slots, 1)), device=dev),
        "lengths": torch.as_tensor(lens[:SERVE_ENGINE.n_slots],
                                   dtype=torch.int32, device=dev)}
    for what, fn in (
            (f"one prefill of {PROFILE_PREFILL} tokens", lambda: model.prefill(
                {"tokens": toks}, SERVE_ENGINE.cache_len)),
            (f"8 decode ticks of the {SERVE_ENGINE.n_slots}-slot pool",
             lambda: [model.decode_step(batch, eng.caches)
                      for _ in range(8)])):
        phase(f"profile: {cfg.name} {what}")
        fn()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        rows, total = _kernel_times(prof)
        print(f"  wall {1e3 * wall:.3f} ms under the profiler, device kernel "
              f"time {total:.3f} ms ({100 * total / 1e3 / wall:.2f} % busy)")
        for name, ms, n in rows[:8]:
            print(f"  {ms:10.3f} ms {n:6d} x  {name[:90]}")


def reset_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
    plain.calls.clear()


def read_counts() -> tuple[dict, int]:
    return ({k: mod.launches for k, mod in KERNELS.items()},
            sum(plain.calls.values()))


def _run(cfg: ExperimentConfig, dev) -> tuple:
    """One experiment and its baseline, with the counts reset before and
    read after.  Returns the record and the kernel launch counts."""
    reset_counts()
    t0 = time.monotonic()
    rec = run_experiment(cfg, device=dev)[0]     # returns host numpy
    wall = time.monotonic() - t0
    t1 = time.monotonic()
    base_cost, base = baseline_cost(cfg, device=dev)
    base_wall = time.monotonic() - t1
    launches, plain_calls = read_counts()
    res = rec.result
    n_scored = res.n_evaluated + cfg.norm_samples
    print(f"  {cfg.arch} {cfg.config} ({cfg.backend}): best cost "
          f"{res.best_cost:.4f} vs 2D mesh {base_cost:.4f}; run_experiment "
          f"{wall:.2f} s wall ({n_scored} placements scored incl. "
          f"{cfg.norm_samples} norm samples, {n_scored / wall:.1f} "
          f"evaluations/s; search alone {res.n_evaluated / rec.seconds:.1f} "
          f"evaluations/s); baseline_cost {base_wall:.2f} s; kernel "
          f"launches {launches}, plain calls {plain_calls}")
    print("  metric            placeit   2D-mesh   delta")
    for t in ("c2c", "c2m", "c2i", "m2i"):
        o, b = res.best_metrics[f"lat_{t}"], base[f"lat_{t}"]
        print(f"  lat_{t} [cyc]     {o:8.1f}  {b:8.1f}  {100*(o/b-1):+6.1f}%")
    for t in ("c2c", "c2m", "c2i", "m2i"):
        o, b = res.best_metrics[f"thr_{t}"], base[f"thr_{t}"]
        print(f"  thr_{t} [frac]    {o:8.3f}  {b:8.3f}  {100*(o/b-1):+6.1f}%")
    if plain_calls != 0:
        raise SystemExit(f"{cfg.arch} {cfg.config} called a plain version")
    costs = [res.best_cost, base_cost] + [c for _, _, c in res.history]
    if not all(np.isfinite(c) for c in costs):
        raise SystemExit(f"non-finite cost in {cfg.arch} {cfg.config}")
    if not (res.best_metrics["connected"] and base["connected"]):
        raise SystemExit(f"disconnected result in {cfg.arch} {cfg.config}")
    arch = resolve_arch(cfg.arch, cfg.config)
    kinds, counts = np.unique(res.best_sol[0][res.best_sol[0] >= 0],
                              return_counts=True)
    if tuple(counts) != arch.counts() or tuple(kinds) != (0, 1, 2):
        raise SystemExit(f"best placement holds {counts}, not "
                         f"{arch.counts()} chiplets")
    return rec, launches


def _winner_graph(cfg: ExperimentConfig, rec):
    arch = resolve_arch(cfg.arch, cfg.config)
    rep = make_rep(arch, cfg.arch, cfg.mutation_mode)
    return rep, rep.score_graph(rec.result.best_sol)


def _rescore_plain(cfg: ExperimentConfig, rec, dev) -> None:
    """The run's best placement re-scored with the plain FW version on the
    card must reproduce the run's metrics (rtol 1e-6: the kernels are
    bitwise, only the chunk's float32 reductions may differ)."""
    rep, g = _winner_graph(cfg, rec)
    scorer = make_scorer(rep.layout, fw_impl=ops.fw_impl_ref,
                         chunk=cfg.chunk, objective=cfg.objective,
                         device=dev)
    res = rec.result
    got = scorer(stack_graphs([g]), norms_vec(res.normalizers))
    for k, want in res.best_metrics.items():
        np.testing.assert_allclose(float(got[k][0]), want, rtol=1e-6,
                                   err_msg=k)
    print(f"  re-scored the {cfg.arch} winner with the plain version: "
          f"{len(res.best_metrics)} metrics agree (rtol 1e-6)")


def main_path_phase(dev) -> dict:
    total = dict.fromkeys(KERNELS, 0)

    def add(launches: dict) -> None:
        for k, n in launches.items():
            total[k] += n

    phase("main path, slice 1 (backend fw-cuda): run_experiment + "
          "baseline_cost on the card")
    for cfg in (QUICKSTART, HOMOG64):
        rec, launches = _run(cfg, dev)
        add(launches)
        if launches["fw_counts"] <= 0:
            raise SystemExit(f"{cfg.arch} did not go through fw_counts")
        if cfg is QUICKSTART:
            _rescore_plain(cfg, rec, dev)

    phase("main path, slice 2 (backend fw-tiled): run_experiment + "
          "baseline_cost on the card")
    rec256, launches = _run(HOMOG256, dev)
    add(launches)
    if launches["fw_counts_tiled"] <= 0:
        raise SystemExit(f"{HOMOG256.arch} did not go through "
                         f"fw_counts_tiled")
    _, launches = _run(HEX127, dev)
    add(launches)
    if launches["fw_counts_tiled"] + launches["fw_counts"] <= 0:
        raise SystemExit(f"{HEX127.arch} did not go through an FW kernel")
    _rescore_plain(HOMOG256, rec256, dev)

    phase(f"main path: ops.apsp on the {HOMOG256.arch} winner's score "
          f"graph")
    _, g = _winner_graph(HOMOG256, rec256)
    W = torch.from_numpy(g.W).to(dev)
    reset_counts()
    D = ops.apsp(W)
    torch.cuda.synchronize()
    launches, plain_calls = read_counts()
    add(launches)
    print(f"  apsp V={W.shape[-1]}: kernel launches {launches}, plain calls "
          f"{plain_calls}")
    if launches["minplus"] <= 0 or plain_calls != 0:
        raise SystemExit("apsp did not go through the minplus kernel alone")
    if not torch.equal(D, plain.fw_counts_ref(W)[0]):
        raise SystemExit("apsp of the winner differs from the plain FW's "
                         "distances")
    print("  apsp distances equal the plain FW's")
    return total


def _kernel_times(prof) -> tuple[list, float]:
    """(name, device ms, calls) of each CUDA kernel in a profile, largest
    first, and their total in ms."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return rows, sum(r[1] for r in rows)


def profile_phase(dev) -> None:
    """torch.profiler over one blocked FW call at homog256 placeit (time
    by phase kernel) and over one homog256 placeit run (device busy
    share).  Profiling adds host time, so the run's wall here is longer
    than the main path's."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    phase("profile: one fw_counts_tiled call at homog256 placeit")
    W = torch.from_numpy(testing.score_graphs(HOMOG256.arch, HOMOG256.config,
                                              1)).to(dev)
    fwt.fw_counts_tiled(W)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fwt.fw_counts_tiled(W)
        torch.cuda.synchronize()
    rows, total = _kernel_times(prof)
    print(f"  device kernel time {total:.4f} ms in {len(rows)} kernels")
    for name, ms, n in rows[:8]:
        print(f"  {ms:10.4f} ms {n:5d} x  {name[:90]}")
    phase(f"profile: one {HOMOG256.arch} {HOMOG256.config} run_experiment "
          f"(device busy share)")
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        run_experiment(HOMOG256, device=dev)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rows, total = _kernel_times(prof)
    print(f"  wall {wall:.3f} s under the profiler, device kernel time "
          f"{total / 1e3:.4f} s ({100 * total / 1e3 / wall:.2f} % busy)")
    for name, ms, n in rows[:10]:
        print(f"  {ms:10.3f} ms {n:6d} x  {name[:90]}")


def main() -> None:
    name = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    max_err = parity_phase(dev)
    attention_parity_phase(dev, max_err)
    timing = timing_phase(dev, max_err)
    timing.update(attention_timing_phase(dev, max_err))
    launches = main_path_phase(dev)
    serve_launches, serve_state = serve_phase(dev)
    for k in ("flash_attention", "decode_attention"):
        launches[k] += serve_launches[k]
    profile_phase(dev)
    serve_profile_phase(dev, serve_state)
    t1 = timing["homog32 baseline"]        # the quickstart's shape, V = 216
    t2 = timing["homog256 placeit"]        # B = 1, V = 1536
    t3 = timing["minplus"]                 # 1536^3
    t4 = timing["flash S=2048"]            # the longest serve prompt
    t5 = timing["decode lengths from the seed"]
    full = {k: [t for key, t in timing.items() if key.startswith(pre)]
            for k, pre in (("flash_attention", "flash S="),
                           ("decode_attention", "decode "))}

    def attn(k: str, f32_tol: str) -> str:
        err = max(t["max_abs_err"] for t in full[k])
        share = max(t["limit_share"] for t in full[k])
        return (f"cases allclose rtol=atol={f32_tol} (f32), 2e-2 (bf16); "
                f"qwen3-1.7b shapes {FULL_LIMIT}: max abs err {err:.3g}, "
                f"{share:.3f} of the limit")
    rows = [
        ("fw_counts", "fw_counts.cu", "minplus.py:104", t1["fw_counts"], t1,
         "bitwise"),
        ("fw_counts_tiled", "fw_counts_tiled.cu", "minplus.py:305",
         t2["tiled"], t2, "bitwise"),
        ("minplus", "minplus.cu", "minplus.py:419", t3["kernel"], t3,
         "bitwise"),
        ("flash_attention", "flash_attention.cu", "flash_attention.py:92",
         t4["kernel"], t4, attn("flash_attention", "2e-5")),
        ("decode_attention", "decode_attention.cu", "decode_attention.py:74",
         t5["kernel"], t5, attn("decode_attention", "3e-5"))]
    print(card_line())
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}",
        "replaces": f"src/repro/kernels/{where}",
        "launches": launches[k], "max_abs_err": max_err[k], "ms": ms,
        "plain_ms": t["plain"], "bound_ms": t["bound"],
        "bound_by": t["bound_by"], "library_ms": t.get("library"),
        "parity": parity}
        for k, src, where, ms, t, parity in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
