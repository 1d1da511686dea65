"""Compatibility shim, as in the reference: the event-driven simulator
lives in ``repro_torch.netsim.sim`` (with the rate model and the workload
compiler beside it in ``repro_torch.netsim``)."""
from ..netsim.sim import (ROUTER_PIPELINE, ChipletNet, NetSim, Packet,
                          SimResult, latency_throughput_curve,
                          synthetic_packets)

__all__ = [
    "ROUTER_PIPELINE", "ChipletNet", "NetSim", "Packet", "SimResult",
    "latency_throughput_curve", "synthetic_packets",
]
