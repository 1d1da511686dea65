"""Bridge: an LM workload's traffic signature -> a PlaceIT package
co-design.  The port of ``repro.core.bridge``.

The paper's section IV-B sketches using estimates of the inter-chiplet
latency and throughput under an application's trace to design a
domain-specific accelerator.  Here a compiled LM step (a dry-run JSON
artifact) yields a traffic signature

    t_comp  - FLOP residency        -> compute-chiplet count pressure
    t_mem   - memory bytes residency -> C2M traffic (core <-> memory stack)
    t_coll  - link wire residency    -> C2C traffic (core <-> core)
    io      - cross-pod share        -> C2I / M2I traffic (IO chiplets)

which becomes the paper's nine cost weights and a 2.5D package (compute
dies, memory stacks, IO dies) that the PlaceIT optimizer places, against
the 2D-mesh baseline.  Decode workloads weight latency, training
throughput.

The residencies divide an artifact's counts by a device's rates.  The
reference fixes them to its own accelerator's; here they are a
:class:`DeviceRates` argument, by default the table entry of the card the
call runs on (:data:`DEVICE_RATES`; a card not in the table raises).  The
arithmetic is the reference's, in its order: the weights
(``round(w * scale, 3)``) and the package counts are the same numbers.
:func:`codesign` scores on the port's default backend (``"fw-tiled"``:
on the card, FW kernel 1 or the blocked FW kernel as
``kernels.ops.fw_takes_tiled`` picks for the package's V).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass

import numpy as np
import torch

from .api import DEFAULT_BACKEND, Budget, GAParams, make_evaluator
from .baseline import MeshBaseline
from .chiplets import ArchSpec, LatencyParams, heterogeneous_arch
from .cost import total_cost
from .placement_hetero import HeteroRep
from .proxies import resolve_device
from .registries import OPTIMIZERS


@dataclass(frozen=True)
class DeviceRates:
    """A device's peak rates: ``peak_flops`` (operations/s of the dense
    low-precision tensor path), ``hbm_bw`` (memory bytes/s) and
    ``link_bw`` (bytes/s of one inter-device link); ``dci_bw`` (bytes/s a
    device across nodes, the roofline's cross-pod term) and ``hbm_bytes``
    (its memory's capacity), where known."""
    peak_flops: float
    hbm_bw: float
    link_bw: float
    dci_bw: float | None = None
    hbm_bytes: float | None = None


# The cards the port knows, by ``torch.cuda.get_device_name``.
DEVICE_RATES = {
    # nvidia-smi: "NVIDIA H100 80GB HBM3, 700.00 W" (the SXM part at its
    # full power limit).  NVIDIA's data sheet: 989 TFLOP/s dense bf16 on
    # the tensor cores, 3.35 TB/s of HBM3, and NVLink 4 at 900 GB/s over
    # 18 links, 50 GB/s a link (both directions counted, as the sheet's
    # 900 GB/s counts them); 80 GB of HBM3.  Across nodes: one ConnectX-7
    # NDR 400 Gb/s port a GPU, as a DGX H100 has, 50 GB/s.
    "NVIDIA H100 80GB HBM3": DeviceRates(peak_flops=989e12, hbm_bw=3.35e12,
                                         link_bw=50e9, dci_bw=50e9,
                                         hbm_bytes=80e9),
}


def device_rates(device=None) -> DeviceRates:
    """The table's rates for the card ``device`` names (default: the
    current card); raises for a card the table does not hold, or without
    a card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"device rates are per card; {dev} has none: pass "
                         f"rates=DeviceRates(...)")
    name = torch.cuda.get_device_name(dev)
    if name not in DEVICE_RATES:
        raise KeyError(f"no rates for {name!r}; the table holds "
                       f"{sorted(DEVICE_RATES)}: pass rates=DeviceRates(...)")
    return DEVICE_RATES[name]


@dataclass(frozen=True)
class TrafficSignature:
    arch: str
    shape: str
    kind: str                   # train | prefill | decode
    t_comp: float
    t_mem: float
    t_coll: float
    io_share: float             # fraction of collective bytes crossing pods

    @property
    def total(self) -> float:
        return max(self.t_comp + self.t_mem + self.t_coll, 1e-30)


def _record(path_or_rec):
    if isinstance(path_or_rec, str):
        with open(path_or_rec) as f:
            return json.load(f)
    return path_or_rec


def signature_from_artifact(path_or_rec, *, multi_pod_rec=None,
                            rates: DeviceRates | None = None
                            ) -> TrafficSignature:
    """The signature of a dry-run JSON artifact (single-pod; a path or the
    parsed record), with the cross-pod share estimated from the multi-pod
    artifact where one is given.  ``rates`` defaults to the current
    card's (:func:`device_rates`)."""
    rates = device_rates() if rates is None else rates
    rec = _record(path_or_rec)
    t_comp = rec["flops_total"] / rates.peak_flops
    t_mem = rec["bytes_accessed_total"] / rates.hbm_bw
    t_coll = rec["collectives"]["wire_bytes_per_chip"] / rates.link_bw
    io_share = 0.05
    if multi_pod_rec is not None:
        mp = _record(multi_pod_rec)
        w_single = rec["collectives"]["wire_bytes_per_chip"]
        w_multi = mp["collectives"]["wire_bytes_per_chip"]
        # extra wire bytes on the multi-pod mesh ~ cross-pod traffic
        io_share = float(np.clip((w_multi - w_single)
                                 / max(w_multi, 1e-9), 0.01, 0.9))
    shape = rec["shape"]
    kind = ("train" if shape.startswith("train")
            else "prefill" if shape.startswith("prefill") else "decode")
    return TrafficSignature(rec["arch"], shape, kind, t_comp, t_mem, t_coll,
                            io_share)


def weights_from_signature(sig: TrafficSignature) -> dict:
    """The paper's nine cost weights from the workload residencies.

    Throughput weights follow the byte-volume shares (what saturates
    links); latency weights follow them too, boosted for decode (one
    dependent small step a generated token) and damped for training
    (pipelined, throughput-bound)."""
    s = sig.total
    c2c = sig.t_coll / s                     # core<->core collectives
    c2m = sig.t_mem / s                      # core<->memory
    c2i = m2i = sig.io_share * max(c2c, c2m)
    lat_boost = {"train": 0.5, "prefill": 1.0, "decode": 3.0}[sig.kind]
    base = dict(
        w_thr=(max(c2c, 0.02), max(c2m, 0.02), max(c2i, 0.02),
               max(m2i, 0.02)),
        w_lat=tuple(lat_boost * w for w in
                    (max(c2c, 0.02), max(c2m, 0.02), max(c2i, 0.02),
                     max(m2i, 0.02))),
        w_area=1.0,
    )
    # normalize so the weights sum to ~10 (the paper's 2 / 0.1 mix's scale)
    tot = sum(base["w_thr"]) + sum(base["w_lat"]) + base["w_area"]
    scale = 10.0 / tot
    return dict(
        w_thr=tuple(round(w * scale, 3) for w in base["w_thr"]),
        w_lat=tuple(round(w * scale, 3) for w in base["w_lat"]),
        w_area=round(base["w_area"] * scale, 3),
    )


def tpu_like_package(sig: TrafficSignature, *, n_compute: int = 8,
                     n_memory: int = 4, n_io: int = 2) -> ArchSpec:
    """The modelled 2.5D package (the reference's name is kept): compute
    dies, memory stacks and IO dies.  Compute-heavy workloads get more
    compute dies, memory-bound decode more memory stacks."""
    s = sig.total
    mem_share = sig.t_mem / s
    comp_share = sig.t_comp / s
    n_memory = max(2, int(round(n_memory * (0.5 + 1.5 * mem_share))))
    n_compute = max(4, int(round(n_compute * (0.5 + 1.5 * comp_share))))
    w = weights_from_signature(sig)
    arch = heterogeneous_arch(n_compute, n_memory, n_io, config="placeit",
                              latency=LatencyParams())
    return dataclasses.replace(
        arch, name=f"tpu_like_{sig.arch}_{sig.shape}",
        w_lat=w["w_lat"], w_thr=w["w_thr"], w_area=w["w_area"])


def codesign(sig: TrafficSignature, *, seed: int = 0, max_evals: int = 300,
             norm_samples: int = 64, optimizer: str = "ga",
             backend: str = DEFAULT_BACKEND, params=None,
             device=None) -> dict:
    """The co-optimization for the workload against the mesh baseline, on
    ``device`` (default: the card).  ``optimizer`` and ``backend`` name
    registry entries.  Returns the reference's keys."""
    arch = tpu_like_package(sig)
    rng = np.random.default_rng(seed)
    rep = HeteroRep(arch, mutation_mode="any-one")
    ev = make_evaluator(rep, arch, rng=rng, norm_samples=norm_samples,
                        backend=backend, device=device)
    entry = OPTIMIZERS.get(optimizer)
    if params is None:
        params = (GAParams(population=20, elitism=4, tournament=4)
                  if optimizer == "ga" else entry.params_cls())
    res = entry.fn(ev, rng, Budget(evals=max_evals), params)
    base_graph = MeshBaseline(arch).build()[0]
    base_metrics = ev.score([base_graph])
    base_cost = float(np.asarray(
        total_cost(base_metrics, arch, ev.norm))[0])
    return {
        "workload": f"{sig.arch}/{sig.shape}",
        "signature": dict(t_comp=sig.t_comp, t_mem=sig.t_mem,
                          t_coll=sig.t_coll, io_share=sig.io_share),
        "weights": weights_from_signature(sig),
        "package": dict(n_compute=arch.counts()[0],
                        n_memory=arch.counts()[1], n_io=arch.counts()[2]),
        "placeit_cost": res.best_cost,
        "baseline_cost": base_cost,
        "improvement": (base_cost - res.best_cost) / base_cost,
        "best_metrics": res.best_metrics,
        "baseline_metrics": {k: float(v[0]) for k, v in
                             base_metrics.items()},
        "best_sol": res.best_sol,
        "n_evaluated": res.n_evaluated,
    }
