"""Netrace-like dependency-driven traffic traces (paper §VII-A, Table VI).

A numpy-only copy of ``repro.core.traces``: the same seed gives the same
packets in both packages.

The Netrace collection (PARSEC cache-coherency traces) is not
redistributable here; we generate traces with the *measured* statistics the
paper reports (§V-B): 0-5% C2C, 80-95% C2M, 3-16% M2I message mix, split
into five regions with per-region packet counts and injection rates shaped
like Table VI.  Dependencies follow cache-coherency transaction chains:

  L1 load miss : C->M  req(1 flit)  -> M->C  data(9)
  L2 miss      : C->M  req(1)       -> M->I  req(1) -> I->M data(9) -> M->C data(9)
  writeback    : C->M  data(9)      [-> M->I data(9) with p_wb_mem]
  coherence fwd: C->M  req(1)       -> M->C' ctrl(1) -> C'->C data(9)

Every chain is anchored at a trace cycle; *authentic* simulation injects at
max(cycle, deps-done), *idealized* at deps-done (paper §VII-C).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .chiplets import COMPUTE, IO, MEMORY
from .netsim import ChipletNet, Packet

CTRL_FLITS, DATA_FLITS = 1, 9  # paper §VII-A [15]


@dataclass(frozen=True)
class TraceRegion:
    n_packets: int
    n_cycles: int

    @property
    def injection_rate(self) -> float:
        return self.n_packets / max(self.n_cycles, 1)


# Region shape modeled on Table VI (scaled down; I = P/C kept in-range).
DEFAULT_REGIONS = (
    TraceRegion(1_890, 56_000),
    TraceRegion(12_000, 219_000 // 4),
    TraceRegion(24_000, 100_000),
    TraceRegion(1_950, 100_000),
    TraceRegion(1_290, 57_000),
)


@dataclass(frozen=True)
class TraceMix:
    """Transaction-type probabilities; defaults follow §V-B measurements."""

    p_l2_miss: float = 0.10       # of read transactions, go to memory/IO
    p_writeback: float = 0.15
    p_coherence: float = 0.03     # produces the small C2C share
    p_wb_mem: float = 0.30        # writebacks that propagate M->I

    def class_shares(self, flit_weighted: bool = True) -> dict:
        """Expected traffic share per cost-function class (closed form).

        Mirrors the emit structure of :func:`generate_trace` transaction by
        transaction, folding both directions of a chiplet pair into the
        proxy classes (``c2m`` includes M->C replies, ``m2i`` includes
        I->M data; the traces carry no direct C<->I traffic so ``c2i`` is
        0).  ``flit_weighted`` weighs packets by their flit count (ctrl 1 /
        data 9) — the load a trace actually puts on links — instead of
        counting messages.  Shares sum to 1; this is what
        ``objective.TrafficMix.from_trace_mix`` turns into cost weights.
        """
        wc, wd = (CTRL_FLITS, DATA_FLITS) if flit_weighted else (1, 1)
        p_coh, p_wb, p_l2 = self.p_coherence, self.p_writeback, self.p_l2_miss
        p_hit = 1.0 - p_coh - p_wb - p_l2
        n = {
            # coherence fwd: C->M req, M->C' ctrl (both class c2m), C'->C data
            "c2c": p_coh * wd,
            "c2m": (p_coh * (wc + wc)
                    + p_wb * wd                      # writeback C->M data
                    + p_l2 * (wc + wd)               # L2 miss C->M + M->C
                    + p_hit * (wc + wd)),            # read hit C->M + M->C
            "c2i": 0.0,
            # L2 miss M->I req + I->M data; writeback M->I with p_wb_mem
            "m2i": p_l2 * (wc + wd) + p_wb * self.p_wb_mem * wd,
        }
        tot = sum(n.values())
        return {k: v / tot for k, v in n.items()}


def generate_trace(net: ChipletNet, regions=DEFAULT_REGIONS,
                   mix: TraceMix = TraceMix(), seed: int = 0,
                   name: str = "synthetic_parsec_like") -> list[Packet]:
    """Generate a dependency-driven trace over the chiplets of ``net``."""
    rng = np.random.default_rng(seed)
    comp = np.nonzero(net.kinds == COMPUTE)[0]
    mem = np.nonzero(net.kinds == MEMORY)[0]
    io = np.nonzero(net.kinds == IO)[0]
    if len(mem) == 0 or len(comp) == 0:
        raise ValueError("trace needs compute and memory chiplets")
    packets: list[Packet] = []
    pid = 0

    def emit(src, dst, flits, cycle, deps=()) -> int:
        nonlocal pid
        packets.append(Packet(pid, int(src), int(dst), flits, int(cycle),
                              tuple(deps)))
        pid += 1
        return pid - 1

    t_base = 0
    for reg in regions:
        n_txn = 0
        # Each transaction emits >= 2 packets; budget by packet count.
        budget = reg.n_packets
        while budget > 0:
            c = rng.choice(comp)
            m = mem[int(rng.choice(len(mem)))]
            cyc = t_base + int(rng.integers(0, reg.n_cycles))
            u = rng.random()
            if u < mix.p_coherence and len(comp) > 1:
                c2 = rng.choice(comp[comp != c])
                a = emit(c, m, CTRL_FLITS, cyc)
                b = emit(m, c2, CTRL_FLITS, cyc, (a,))
                emit(c2, c, DATA_FLITS, cyc, (b,))
                budget -= 3
            elif u < mix.p_coherence + mix.p_writeback:
                a = emit(c, m, DATA_FLITS, cyc)
                budget -= 1
                if rng.random() < mix.p_wb_mem and len(io):
                    i = io[int(rng.choice(len(io)))]
                    emit(m, i, DATA_FLITS, cyc, (a,))
                    budget -= 1
            elif u < mix.p_coherence + mix.p_writeback + mix.p_l2_miss \
                    and len(io):
                i = io[int(rng.choice(len(io)))]
                a = emit(c, m, CTRL_FLITS, cyc)
                b = emit(m, i, CTRL_FLITS, cyc, (a,))
                d = emit(i, m, DATA_FLITS, cyc, (b,))
                emit(m, c, DATA_FLITS, cyc, (d,))
                budget -= 4
            else:
                a = emit(c, m, CTRL_FLITS, cyc)
                emit(m, c, DATA_FLITS, cyc, (a,))
                budget -= 2
            n_txn += 1
        t_base += reg.n_cycles
    return packets


def trace_stats(packets: list[Packet], net: ChipletNet) -> dict:
    """Message-mix shares — used to validate against §V-B measurements."""
    kinds = net.kinds
    n = {"c2c": 0, "c2m": 0, "m2c": 0, "m2i": 0, "i2m": 0, "other": 0}
    for p in packets:
        ks, kd = int(kinds[p.src]), int(kinds[p.dst])
        if ks == COMPUTE and kd == COMPUTE:
            n["c2c"] += 1
        elif ks == COMPUTE and kd == MEMORY:
            n["c2m"] += 1
        elif ks == MEMORY and kd == COMPUTE:
            n["m2c"] += 1
        elif ks == MEMORY and kd == IO:
            n["m2i"] += 1
        elif ks == IO and kd == MEMORY:
            n["i2m"] += 1
        else:
            n["other"] += 1
    tot = max(sum(n.values()), 1)
    return {k: v / tot for k, v in n.items()} | {"total": tot}
