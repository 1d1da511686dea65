"""How the port's kernels are timed and their floors counted on a card,
shared by ``chip_smoke.py`` and ``launch/kernel_compare.py``.

This module imports only the standard library and torch, never the rest
of ``repro_torch``, so that ``kernel_compare.py`` can load it by path and
time another checkout's kernels (one without this module) the same way.

* :func:`batched_ms`: device time of one call, ``launches`` calls back to
  back between one pair of CUDA events behind a spin kernel, so the
  host's enqueue is not timed; :func:`median_ms` times single calls.
* :func:`loop_issues`: the single-issue instructions a relaxation (or a
  min-plus update, or a scan's (step, state) or (step, channel)) costs in
  a kernel's inner loop, counted from the SASS of the library just built
  (``cuobjdump -sass``), and :func:`issue_rate`, the card's instructions
  a second; their quotient is the issue floor.
* :data:`BWD_TIMED` and :func:`bwd_limit_share`: the flash-attention
  backward's timed training shapes and its ``BWD_LIMIT``, and
  :func:`ptxas_usage`, registers and spills per kernel from ptxas's log
  (``kernel_compare.py --bwd``, ``kernel_variants.py --set bwd``).
* :data:`RUNS` and :func:`experiment_config`: the ``run_experiment``
  configurations whose walls both scripts time; :func:`sweep_configs`, the
  ``run_sweep`` configurations of the smoke's sweep phase (timed in turns
  by ``launch/sweep_walls.py``).
"""
from __future__ import annotations

import re
import shutil
import statistics
import subprocess
import time

import torch

# Lanes that issue one instruction a clock on each SM of an H100.
LANES_PER_SM = 128


def batched_ms(fns: dict, launches: int, rounds: int, warmup: int = 2
               ) -> tuple[dict, dict]:
    """Device time of one call of each callable: ``launches`` calls back
    to back between one pair of CUDA events, divided by ``launches``; the
    median over ``rounds`` rounds, the callables taking turns in each.
    Before the start event the stream is held by a spin kernel long
    enough for the host to enqueue all the calls (1.5x their host time
    in the warm-up, at 2 GHz), so the events time the device's work and
    not the host's enqueue.  Returns the times and each callable's last
    output."""
    host = dict.fromkeys(fns, 0.0)
    for _ in range(warmup):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            host[k] = time.perf_counter() - t0
            torch.cuda.synchronize()
    times = {k: [] for k in fns}
    outs = {}
    for _ in range(rounds):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(2e9 * (1.5 * launches * host[k] + 1e-4)))
            start.record()
            for _ in range(launches):
                outs[k] = fn()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end) / launches)
    return {k: statistics.median(v) for k, v in times.items()}, outs


def median_ms(fns: dict, reps: int, warmup: int = 1) -> tuple[dict, dict]:
    """Median CUDA-event time of single calls of each callable, the
    callables taking turns in every repetition, and each callable's last
    output (for the plain versions, whose calls are long)."""
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


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def max_sm_clock_hz() -> float:
    """The card's top SM clock (nvidia-smi ``clocks.max.sm``)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(smi.stdout.split()[0]) * 1e6


def issue_rate(dev) -> float:
    """Single-issue instructions a second: 128 lanes a clock on each of
    the card's SMs at its top SM clock (nvidia-smi)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return LANES_PER_SM * sms * max_sm_clock_hz()


# -- SASS -------------------------------------------------------------------

_FUNCTION = re.compile(r"\s*Function : (\S+)")
_INSTR = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                    r"([A-Z][A-Z0-9_]*)([^;]*);")


def sass(lib_path) -> str:
    """``cuobjdump -sass`` of a built library."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout


def sass_functions(text: str) -> dict:
    """Kernel function (mangled name) -> its instructions, each
    (address, mnemonic, operands)."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSTR.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return funcs


def _branch_target(mnemonic: str, operands: str) -> int | None:
    if not mnemonic.startswith("BRA"):
        return None
    t = re.findall(r"0x([0-9a-f]+)", operands)
    return int(t[-1], 16) if t else None


def loop_issues(instrs: list, op: str, without: tuple = (),
                needs: tuple = ()) -> tuple[int, int]:
    """(instructions, ops) of one trip of a kernel's hot loop: of its
    loops (each the range of a backward branch), the one with the most
    ``op`` instructions (FMUL: one a FW relaxation; FADD: one a min-plus
    update; MUFU: one a selective-scan (step, state) or an RG-LRU
    producer's (step, channel); FFMA without MUFU: one an RG-LRU walker's
    step) that every warp issues each trip, and of equals the shortest;
    loops that issue any mnemonic of ``without`` each trip, or not every
    mnemonic of ``needs`` (min-plus: LDGSTS, the 16-byte staging of its
    steady-state loop), are passed over.
    Left out of a loop's count: what a forward branch inside it may skip
    (guarded code, such as kernel 1's row publish or min-plus's tile
    loads) and the bodies of loops nested in it, whose trips vary.  So
    the count is what every warp issues each trip: the operand loads, the
    loop's own control and unguarded barriers included."""
    loops = []
    for addr, mn, operands in instrs:
        t = _branch_target(mn, operands)
        if t is not None and t <= addr:
            loops.append((t, addr))
    best = None
    for t, a in loops:
        body = [x for x in instrs if t <= x[0] <= a]
        left_out = {x[0] for x in body for t2, a2 in loops
                    if (t2, a2) != (t, a) and t <= t2 and a2 <= a
                    and t2 <= x[0] <= a2}
        for addr, mn, operands in body:
            tgt = _branch_target(mn, operands)
            if tgt is not None and addr < tgt <= a:
                left_out.update(x[0] for x in body if addr < x[0] < tgt)
        kept = [x for x in body if x[0] not in left_out]
        if any(x[1] in without for x in kept) or not all(
                any(x[1] == m for x in kept) for m in needs):
            continue
        n_ops = sum(1 for x in kept if x[1] == op)
        if best is None or (n_ops, -len(kept)) > (best[1], -best[0]):
            best = (len(kept), n_ops)
    if not best or not best[1]:
        raise ValueError(f"no loop with {op} instructions")
    return best


# The scans' hot loops: (kernel function, op, ops passed over).  The
# selective scan issues one MUFU (ex2) a (step, state); an RG-LRU
# producer one MUFU (the square root's rsqrt) a (step, channel), and the
# walker warp one FFMA a step, in the one loop with no MUFU.
SCAN_LOOPS = {
    "selective_scan": ("selective_scan_kernel", "MUFU", ()),
    "rglru_scan walker": ("rglru_scan_kernel", "FFMA", ("MUFU",)),
    "rglru_scan producers": ("rglru_scan_kernel", "MUFU", ()),
}
# The instances the serve runs launch: falcon-mamba-7b's x in bfloat16
# with dt in float32; recurrentgemma-9b's x and a in bfloat16.
SCAN_SERVE_INSTANCE = {"selective_scan": "I13__nv_bfloat16fE",
                       "rglru_scan": "I13__nv_bfloat16E"}


def scan_issues(funcs: dict) -> dict:
    """Instructions a (step, state) of the selective scan, and a (step,
    channel) of RG-LRU's walker and producers, in the serve instances'
    hot loops (``SCAN_LOOPS``, ``loop_issues``): loop -> (instructions,
    ops) of one trip."""
    out = {}
    for loop, (fn, op, without) in SCAN_LOOPS.items():
        name = find_function(funcs, fn + SCAN_SERVE_INSTANCE[
            loop.split()[0]])
        out[loop] = loop_issues(funcs[name], op, without)
    return out


# The selective scan's backward: one trip of its loop over chunks walks,
# in every lane, 32 steps of 2 states (recompute, walk, the rewrite into
# float32 and the epilogue all in the trip).
SSCAN_BWD_TRIP = 32 * 2


def sscan_bwd_issues(funcs: dict) -> tuple[int, int]:
    """(instructions, MUFU) of one trip of the selective-scan backward's
    loop over chunks, in its training instance (x bfloat16, dt float32):
    its loop with the most MUFU (``loop_issues``)."""
    name = find_function(funcs, "sscan_bwd_kernel"
                         + SCAN_SERVE_INSTANCE["selective_scan"])
    return loop_issues(funcs[name], "MUFU")


def sscan_bwd_floor_ms(n: int, B: int, S: int, Di: int, dev) -> float:
    """Issue floor (ms) of one selective-scan backward call from the
    instructions ``n`` of one trip (``sscan_bwd_issues``): B * S * Di * 16
    (step, channel, state) lanes at n / SSCAN_BWD_TRIP instructions each,
    at the card's issue rate."""
    return 1e3 * B * S * Di * 16 * n / SSCAN_BWD_TRIP / issue_rate(dev)


def scan_floors_ms(issues: dict, B: int, S: int, width: int, kernel: str,
                   dev) -> dict:
    """Issue floors (ms) of one scan call from ``scan_issues``: the
    selective scan's B * S * width * 16 (step, state) lanes (16 states a
    channel whatever N) and RG-LRU's producers' B * S * width (step,
    channel) lanes at the card's issue rate; RG-LRU's walker, one warp a
    block that issues at most one instruction a clock, S steps at its
    instructions a step at the top SM clock (one wave: B * width <= 32 per
    SM)."""
    rate = issue_rate(dev)
    if kernel == "selective_scan":
        n, k = issues["selective_scan"]
        return {"selective_scan": 1e3 * B * S * width * 16 * n / k / rate}
    n, k = issues["rglru_scan producers"]
    nw, kw = issues["rglru_scan walker"]
    return {"producers": 1e3 * B * S * width * n / k / rate,
            "walker": 1e3 * S * nw / kw / max_sm_clock_hz()}


# The flash-attention backward's timed shapes, as chip_smoke.py's
# BWD_TIMED and TRAIN_S (bfloat16, causal, S = 2048: smollm-360m's heads at
# B = 8, qwen3-1.7b's at B = 1), and its BWD_LIMIT: |kernel - plain| <=
# 2^-8 max|plain| + 2^-6 |plain|, each of dq, dk, dv.
BWD_TIMED = (("smollm-360m", 8), ("qwen3-1.7b", 1))
BWD_S = 2048
BWD_RTOL, BWD_ATOL_SHARE = 2.0 ** -6, 2.0 ** -8


def bwd_limit_share(got, want) -> float:
    """The largest share of ``BWD_LIMIT`` an entry of ``got`` (dq, dk,
    dv) uses against ``want``, the plain version's."""
    share = 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        limit = BWD_ATOL_SHARE * b.abs().max() + BWD_RTOL * b.abs()
        share = max(share, float(((a - b).abs() / limit).max()))
    return share


def ptxas_usage(log: str, part: str) -> dict:
    """Registers, stack frame and spill bytes that ptxas (``-Xptxas=-v``)
    reports for each kernel whose mangled name holds ``part``, keyed by
    that name."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = m.group(1) if part in m.group(1) else None
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", ln)
        if m:
            out[cur]["stack"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[cur]["spill_stores"] = int(m.group(1))
            out[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def scan_serve_operands(kernel: str, S: int, dev, seed: int | None = None,
                        h0: bool = False) -> list:
    """A scan's operands at its serve run's prefill shape (B = 1), drawn on
    the card from ``seed`` (S by default) in the ranges the models give:
    falcon-mamba-7b's selective scan (Di = 8192, N = 16; x in bfloat16, dt
    in [1e-3, 0.1) from its dt bias, A = -(1..16) from the S4D-real init,
    D = 1) and recurrentgemma-9b's RG-LRU (D = 4096; x and a in [0.5, 1)
    in bfloat16); h0 zeros, or standard normal with ``h0``."""
    g = torch.Generator(device=dev).manual_seed(S if seed is None else seed)
    f32, bf16 = torch.float32, torch.bfloat16
    if kernel == "selective_scan":
        Di, N = 8192, 16
        args = [torch.randn(1, S, Di, generator=g, device=dev).to(bf16),
                1e-3 + 0.099 * torch.rand(1, S, Di, generator=g, device=dev),
                -torch.arange(1, N + 1, dtype=f32, device=dev).expand(
                    Di, N).contiguous(),
                torch.randn(1, S, N, generator=g, device=dev),
                torch.randn(1, S, N, generator=g, device=dev),
                torch.ones(Di, device=dev)]
        state = (1, Di, N)
    else:
        D = 4096
        args = [torch.randn(1, S, D, generator=g, device=dev).to(bf16),
                (0.5 + 0.5 * torch.rand(1, S, D, generator=g,
                                        device=dev)).to(bf16)]
        state = (1, D)
    args.append(torch.randn(*state, generator=g, device=dev) if h0
                else torch.zeros(*state, device=dev))
    return args


# The selective scan's gradients, in the order its backward returns them.
SSCAN_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")

# The scans' training shapes (S = 4096, the reference's train_4k length):
# falcon-mamba-7b's selective scan at the smoke's B = 2, recurrentgemma-9b's
# RG-LRU at B = 1.
SCAN_TRAIN = {"selective_scan": dict(B=2, S=4096, Di=8192, N=16),
              "rglru_scan": dict(B=1, S=4096, D=4096)}


def scan_train_operands(kernel: str, dev, seed: int = 0) -> tuple:
    """A scan's operands at its training shape (``SCAN_TRAIN``), drawn on
    the card from ``seed`` as :func:`scan_serve_operands` draws them but
    for RG-LRU's a in [0.5, 0.99] (a bfloat16 a of 1 has an infinite
    gradient), and a standard normal output gradient in x's dtype and
    float32 dh_final: (operands, dy, dh_final)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f32, bf16 = torch.float32, torch.bfloat16
    shape = SCAN_TRAIN[kernel]
    B, S = shape["B"], shape["S"]
    if kernel == "selective_scan":
        Di, N = shape["Di"], shape["N"]
        args = [torch.randn(B, S, Di, generator=g, device=dev).to(bf16),
                1e-3 + 0.099 * torch.rand(B, S, Di, generator=g, device=dev),
                -torch.arange(1, N + 1, dtype=f32, device=dev).expand(
                    Di, N).contiguous(),
                torch.randn(B, S, N, generator=g, device=dev),
                torch.randn(B, S, N, generator=g, device=dev),
                torch.ones(Di, device=dev)]
        state = (B, Di, N)
    else:
        D = shape["D"]
        args = [torch.randn(B, S, D, generator=g, device=dev).to(bf16),
                (0.5 + 0.49 * torch.rand(B, S, D, generator=g,
                                         device=dev)).to(bf16)]
        state = (B, D)
    args.append(torch.zeros(*state, device=dev))
    dy = torch.randn(B, S, args[0].shape[2], generator=g,
                     device=dev).to(bf16)
    return args, dy, torch.randn(*state, generator=g, device=dev)


def sscan_bwd_work(B: int, S: int, Di: int, N: int, x_item: int,
                   dt_item: int) -> tuple[float, float, float]:
    """(float operations, special-function operations, bytes) that the
    selective scan's gradient needs, whatever the kernel's design
    (``csrc/selective_scan_bwd.cu`` stores states a chunk and computes
    e_t twice).  Per (step, channel, state): the states from h0 (dt A,
    u B and the multiply-add: 4, and one exp, e_t, which the walk back
    uses again), the walk back (G's multiply-add, e h, the sums for dx
    and ddt and the products inside them, dA's, dB's and dC's products,
    e G: 16) and the sums over channels of dB and dC (2); per (step,
    channel) dt x twice, dD's and dx's multiply-adds and a product (7).
    Bytes: x, dt and dy read and dx (x's dtype) and ddt (float32) written
    once a (step, channel); B and C read and dB and dC written once a
    (step, state); A, D, h0 and dh_final in and dA, dD, dh0 out."""
    tdn, td = B * S * Di * N, B * S * Di
    return (22 * tdn + 7 * td, tdn,
            td * (2 * x_item + dt_item + x_item + 4) + 4 * B * S * N * 4
            + 4 * (2 * Di * N + 2 * Di + 3 * B * Di * N))


def rglru_bwd_work(B: int, S: int, D: int, item: int
                   ) -> tuple[float, float, float]:
    """(float operations, special-function operations, bytes) that the
    RG-LRU scan's gradient needs, whatever the kernel's design
    (``csrc/rglru_scan_bwd.cu`` reads float32 states the forward wrote).
    Per (step, channel): h_{t-1} from h0 (a h and the multiply-add with
    s x: 2), a a and 1 - a a, the max, x s' and h + x s', G's
    multiply-add, G s and G q (9 float operations), the square root and
    the division (2 special-function operations).  Bytes: a, x, dy read
    and dx, da written (x's dtype) once a (step, channel); h0, dh_final
    in and dh0 out."""
    n = B * S * D
    return 11 * n, 2 * n, n * 5 * item + 3 * 4 * B * D


# Min-plus: its steady-state loop is the one that stages by 16-byte
# cp.async (LDGSTS) every trip; the loop of edge tiles stages only in
# guarded code.  A kernel without it (the first port's) has one loop.
MINPLUS_LOOP_NEEDS = ("LDGSTS",)


def minplus_issues(instrs: list) -> tuple[int, int]:
    """(instructions, updates) of one trip of a min-plus kernel's
    steady-state loop, staging included (``MINPLUS_LOOP_NEEDS``); for a
    kernel that stages without cp.async, its loop with the most FADD."""
    try:
        return loop_issues(instrs, "FADD", needs=MINPLUS_LOOP_NEEDS)
    except ValueError:
        return loop_issues(instrs, "FADD")


def minplus_bound_ms(M: int, K: int, N: int, sms: int,
                     clock_hz: float) -> float:
    """The instruction bound of an [M, K] x [K, N] min-plus product: each
    of its M N K updates is an FADD and an FMNMX, two instructions that
    nothing on Hopper fuses or packs, at ``LANES_PER_SM`` lanes a clock on
    each of ``sms`` SMs (0.2167 ms at 1536^3 on 132 SMs at 1 980 MHz).
    The float32 peak of 67 TFLOP/s counts an FFMA as two operations, so
    2 M N K over it (half this) is out of reach."""
    return 1e3 * 2 * M * N * K / (LANES_PER_SM * sms * clock_hz)


def find_function(funcs: dict, *parts: str) -> str:
    """The one mangled name that holds every part."""
    names = [f for f in funcs if all(p in f for p in parts)]
    if len(names) != 1:
        raise ValueError(f"{len(names)} SASS functions match {parts}")
    return names[0]


# -- the timed runs of run_experiment ---------------------------------------

# name -> (arch, config, algorithm, evaluations, norm samples, the
# algorithm's parameters, backend or None for the tree's default).  The
# quickstart is examples/quickstart.py's; homog64 placeit the paper's GA on
# its largest homogeneous arch; the large families on backend "fw-tiled"
# (named, so that a tree whose default is another backend times the same
# kernels).  Then the heterogeneous archs: hetero32 through the host GA at
# the paper's 30 / 6 / 6, hetero64 through ga-batched at its 20 / 5 / 5;
# homog256 through ga-batched at LARGE_DEFAULTS, two generations as the
# host GA run above has (92 placements scored against its 100); and one
# short br-batched and sa-batched run.  hetero64's norm samples stay few:
# each is a host corner placement and MST, one placement at a time, the
# slowest host step of any arch.
RUNS = {
    "quickstart": ("homog32", "baseline", "ga", 240, 32,
                   dict(population=24, elitism=5, tournament=5), None),
    "homog64 placeit": ("homog64", "placeit", "ga", 300, 100,
                        dict(population=50, elitism=8, tournament=8), None),
    "homog256 placeit": ("homog256", "placeit", "ga", 100, 20,
                         dict(population=50, elitism=8, tournament=8),
                         "fw-tiled"),
    "hex127 baseline": ("hex127", "baseline", "ga", 100, 20,
                        dict(population=50, elitism=8, tournament=8),
                        "fw-tiled"),
    "hetero32 placeit": ("hetero32", "placeit", "ga", 90, 30,
                         dict(population=30, elitism=6, tournament=6), None),
    "hetero64 placeit ga-batched": (
        "hetero64", "placeit", "ga-batched", 80, 10,
        dict(population=20, elitism=5, tournament=5), None),
    "homog256 placeit ga-batched": (
        "homog256", "placeit", "ga-batched", 134, 20,
        dict(population=50, elitism=8, tournament=8), "fw-tiled"),
    "hetero32 placeit br-batched": ("hetero32", "placeit", "br-batched", 64,
                                    30, dict(batch=32), None),
    "homog64 placeit sa-batched": ("homog64", "placeit", "sa-batched", 40,
                                   20, dict(chains=8), None),
}


def experiment_config(api, name: str, **overrides):
    """``RUNS[name]`` as an ``ExperimentConfig`` of ``api`` (a tree's
    ``repro_torch.core.api``)."""
    arch, config, algo, evals, norm, params, backend = RUNS[name]
    kw = dict(arch=arch, config=config, algorithms=(algo,),
              budget=api.Budget(evals=evals), norm_samples=norm,
              params={algo: dict(params)})
    if backend is not None:
        kw["backend"] = backend
    kw.update(overrides)
    return api.ExperimentConfig(**kw)


# The sweep: homog64 placeit (V = 480, the largest paper arch), the
# paper's GA 50 / 8 / 8, seeds 0 and 1 x (br, ga), plus a ga-batched and
# an sa-batched config on the same scorer, so host graph lists and device
# batches stack in one group: (algorithms, seed).
SWEEP_RUNS = ((("br", "ga"), 0), (("br", "ga"), 1), (("ga-batched",), 0),
              (("sa-batched",), 1))


def sweep_configs(api) -> tuple:
    """The ``ExperimentConfig``s of :data:`SWEEP_RUNS` in ``api``."""
    ga = dict(population=50, elitism=8, tournament=8)
    return tuple(api.ExperimentConfig(
        arch="homog64", config="placeit", algorithms=algos, seed=seed,
        budget=api.Budget(evals=100), norm_samples=50,
        params={"ga": ga, "ga-batched": ga, "sa-batched": dict(chains=8)})
        for algos, seed in SWEEP_RUNS)
