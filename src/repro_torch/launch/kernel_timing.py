"""How the port's kernels are timed and their floors counted on a card,
shared by ``chip_smoke.py`` and ``launch/kernel_compare.py``.

This module imports only the standard library and torch, never the rest
of ``repro_torch``, so that ``kernel_compare.py`` can load it by path and
time another checkout's kernels (one without this module) the same way.

* :func:`batched_ms`: device time of one call, ``launches`` calls back to
  back between one pair of CUDA events behind a spin kernel, so the
  host's enqueue is not timed; :func:`median_ms` times single calls.
* :func:`loop_issues`: the single-issue instructions a relaxation (or a
  min-plus update) costs in a kernel's inner loop, counted from the SASS
  of the library just built (``cuobjdump -sass``), and :func:`issue_rate`,
  the card's instructions a second; their quotient is the issue floor.
* :data:`RUNS` and :func:`experiment_config`: the ``run_experiment``
  configurations whose walls both scripts time.
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


def issue_rate(dev) -> float:
    """Single-issue instructions a second: 128 lanes a clock on each of
    the card's SMs at its top SM clock (nvidia-smi)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return LANES_PER_SM * sms * float(smi.stdout.split()[0]) * 1e6


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


def loop_issues(instrs: list, op: str) -> tuple[int, int]:
    """(instructions, ops) of one trip of a kernel's hot loop: of its
    loops (each the range of a backward branch), the one with the most
    ``op`` instructions (FMUL: one a FW relaxation; FADD: one a min-plus
    update) that every warp issues each trip, and of equals the shortest.
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
        n_ops = sum(1 for x in kept if x[1] == op)
        if best is None or (n_ops, -len(kept)) > (best[1], -best[0]):
            best = (len(kept), n_ops)
    if not best or not best[1]:
        raise ValueError(f"no loop with {op} instructions")
    return best


def find_function(funcs: dict, *parts: str) -> str:
    """The one mangled name that holds every part."""
    names = [f for f in funcs if all(p in f for p in parts)]
    if len(names) != 1:
        raise ValueError(f"{len(names)} SASS functions match {parts}")
    return names[0]


# -- the timed runs of run_experiment ---------------------------------------

# name -> (arch, config, evaluations, norm samples, GA population /
# elitism / tournament, backend or None for the tree's default).  The
# quickstart is examples/quickstart.py's; homog64 placeit the paper's GA on
# its largest arch; the large families on backend "fw-tiled" (named, so
# that a tree whose default is another backend times the same kernels).
RUNS = {
    "quickstart": ("homog32", "baseline", 240, 32, (24, 5, 5), None),
    "homog64 placeit": ("homog64", "placeit", 300, 100, (50, 8, 8), None),
    "homog256 placeit": ("homog256", "placeit", 100, 20, (50, 8, 8),
                         "fw-tiled"),
    "hex127 baseline": ("hex127", "baseline", 100, 20, (50, 8, 8),
                        "fw-tiled"),
}


def experiment_config(api, name: str, **overrides):
    """``RUNS[name]`` as an ``ExperimentConfig`` of ``api`` (a tree's
    ``repro_torch.core.api``)."""
    arch, config, evals, norm, (pop, elit, tour), backend = RUNS[name]
    kw = dict(arch=arch, config=config, algorithms=("ga",),
              budget=api.Budget(evals=evals), norm_samples=norm,
              params={"ga": api.GAParams(population=pop, elitism=elit,
                                         tournament=tour)})
    if backend is not None:
        kw["backend"] = backend
    kw.update(overrides)
    return api.ExperimentConfig(**kw)
