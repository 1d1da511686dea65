"""Layered traffic evaluation, the port of ``repro.netsim``.

* :mod:`repro_torch.netsim.workload` — traces / synthetic traffic compiled
  into fixed-shape demand arrays (runtime operands of the scorer).
* :mod:`repro_torch.netsim.model` — the batched ECMP + queueing rate model
  over stacked ScoreGraphs, in PyTorch on the scorer's device; feeds the
  ``trace-lat`` / ``trace-thr`` objective terms.
* :mod:`repro_torch.netsim.sim` — the event-driven wormhole-lite simulator
  (host-side calibration oracle, numpy only; re-exported at
  ``repro_torch.core.netsim``).
"""
from .model import (Q_CAP, TRACE_METRIC_KEYS, make_trace_model,
                    trace_metrics_one, unpack_demand)
from .sim import (ROUTER_PIPELINE, ChipletNet, NetSim, Packet, SimResult,
                  latency_throughput_curve, synthetic_packets)
from .workload import Workload, demand_dim

__all__ = [
    "Q_CAP", "TRACE_METRIC_KEYS", "make_trace_model", "trace_metrics_one",
    "unpack_demand", "ROUTER_PIPELINE", "ChipletNet", "NetSim", "Packet",
    "SimResult", "latency_throughput_curve", "synthetic_packets",
    "Workload", "demand_dim",
]
