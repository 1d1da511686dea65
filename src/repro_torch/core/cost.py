"""The user-defined cost function (paper §IV-B).

cost(placement) = sum_t w_lat[t] * lat_t / E[lat_t]
               + sum_t w_thr[t] * (1/thr_t) / E[1/thr_t]
               + w_area * area / E[area]

where the expectations are *normalizers*: statistics of each raw component
over ``norm_samples`` random placements (Table II, "Norm. Samples").
Throughput enters inverted so that every term is "lower is better".

This module keeps the legacy entry points (:class:`CostNormalizers`,
:func:`cost_components`, :func:`total_cost`); the formula itself now lives
in the pluggable ``repro_torch.core.objective`` layer — :func:`total_cost`
evaluates the default :class:`~repro_torch.core.objective.Objective` built from
the (deprecated) ``ArchSpec.w_*`` weights.  Same weights, same float64
component math (``cost_components`` is unchanged and serves as the
independent reference in the tests); the only numerical change is the
summation order — components are now accumulated grouped by term (all
lat, all inv-thr, area) instead of interleaved per traffic type, which
shifts totals by at most one float64 ulp versus the historical
``sum(cost_components(...).values())``.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np

from .chiplets import TRAFFIC_TYPES, ArchSpec
from .objective import Objective, objective_cost_host

_EPS = 1.0e-6


@dataclass
class CostNormalizers:
    lat: dict = field(default_factory=dict)     # type -> mean latency
    inv_thr: dict = field(default_factory=dict)  # type -> mean 1/throughput
    area: float = 1.0
    # Traffic types whose normalizer fell back to 1.0 because *every* norm
    # sample was disconnected (lat >= 1e8).  A non-empty tuple means the
    # corresponding cost terms are unnormalized and skew the total.
    degenerate: tuple = ()

    @staticmethod
    def from_samples(metrics: dict, policy: str = "mean"
                     ) -> "CostNormalizers":
        """Normalizers from random-placement metrics.

        ``policy`` is the objective's normalizer policy: ``"mean"`` (the
        paper's expectation), ``"median"`` (robust to heavy-tailed
        latency/throughput draws), or ``"ones"`` (raw, unnormalized
        components).
        """
        if policy == "ones":
            return CostNormalizers(
                lat={t: 1.0 for t in TRAFFIC_TYPES},
                inv_thr={t: 1.0 for t in TRAFFIC_TYPES}, area=1.0)
        stat = {"mean": np.mean, "median": np.median}[policy]
        n = CostNormalizers()
        bad = []
        for t in TRAFFIC_TYPES:
            lat = np.asarray(metrics[f"lat_{t}"], dtype=np.float64)
            thr = np.asarray(metrics[f"thr_{t}"], dtype=np.float64)
            ok = lat < 1.0e8
            if ok.any():
                n.lat[t] = float(stat(lat[ok]))
                n.inv_thr[t] = float(stat(1.0 / np.maximum(thr[ok], _EPS)))
            else:
                n.lat[t] = 1.0
                n.inv_thr[t] = 1.0
                bad.append(t)
        n.area = float(stat(np.asarray(metrics["area"], dtype=np.float64)))
        if bad:
            n.degenerate = tuple(bad)
            warnings.warn(
                f"all norm samples disconnected for traffic type(s) "
                f"{', '.join(bad)}; normalizers fall back to 1.0 and the "
                f"corresponding cost terms are unnormalized "
                f"(degenerate_norms flag set)", RuntimeWarning, stacklevel=2)
        return n


def cost_components(metrics: dict, arch: ArchSpec,
                    norm: CostNormalizers) -> dict:
    """Normalized, weighted components (9 of them, Fig. 4)."""
    comp = {}
    for i, t in enumerate(TRAFFIC_TYPES):
        lat = np.asarray(metrics[f"lat_{t}"], dtype=np.float64)
        thr = np.asarray(metrics[f"thr_{t}"], dtype=np.float64)
        comp[f"lat_{t}"] = arch.w_lat[i] * lat / max(norm.lat[t], _EPS)
        comp[f"thr_{t}"] = (arch.w_thr[i]
                            * (1.0 / np.maximum(thr, _EPS))
                            / max(norm.inv_thr[t], _EPS))
    comp["area"] = (arch.w_area
                    * np.asarray(metrics["area"], dtype=np.float64)
                    / max(norm.area, _EPS))
    return comp


def total_cost(metrics: dict, arch: ArchSpec, norm: CostNormalizers
               ) -> np.ndarray:
    """Legacy entry point: the default objective built from the
    (deprecated) ``ArchSpec.w_*`` weights, evaluated on host float64.
    Summation is grouped by term (all lat, all inv-thr, area) — the
    canonical order shared with the objective layer."""
    return objective_cost_host(metrics, Objective.from_arch(arch), norm)
