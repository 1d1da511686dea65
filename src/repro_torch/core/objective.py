"""Typed, registry-driven placement objectives (paper §IV-B, pluggable).

The port of ``repro.core.objective``.  The paper's cost function is a
*user-defined* mix of four traffic types plus area; this module makes that
mix — and the whole cost formula — a serializable configuration:

* :class:`TrafficMix` — typed per-traffic-type latency/throughput weights
  (paper §V-B values by default).
* :class:`TermSpec` / :class:`Objective` — a cost function as a weighted
  sum of named *terms* from the ``@register_objective_term`` registry
  (``repro_torch.core.registries.OBJECTIVE_TERMS``).  The default
  ``(lat, inv-thr, area)`` triple reproduces the paper formula; extra terms
  (``link-length-cap``, ``node-degree``) turn physical constraints into
  soft penalties.  The JSON form is identical to the reference's.
* :func:`compile_objective` — resolves the terms into a batched torch cost
  function that ``proxies.make_scorer`` evaluates next to the metrics, on
  the scorer's device.  Normalizers (:func:`norms_vec`) and weights
  (:func:`weights_vec`) are runtime tensors, so one scorer serves every
  normalizer draw and every weighting of the same term structure.
* :class:`Schedule` — constraint-hardening ramps: per-term weight scale
  factors (``linear | cosine | step``) applied across optimizer progress.
* :func:`objective_cost_host` — the float64 host evaluation used for
  reporting and equivalence tests; ``cost.total_cost`` delegates here.

Term implementations see a batched ``sample`` dict: the nine metric
tensors (``lat_*`` / ``thr_*`` / ``area``, each ``[P]``) plus the graph
tensors (``edges`` [P,E,2], ``edge_mask`` [P,E], ``edge_len`` [P,E] in mm)
and the static PHY count ``Vp``.  ``norms`` maps the nine normalizer
columns (``lat_*`` / ``inv_thr_*`` / ``area``) *and* the weight columns
``w_lat_*`` / ``w_thr_*`` / ``w_area`` to ``[P]`` tensors; terms read mix
weights from there, never from ``objective.mix``.

The traffic-driven terms ``trace-lat`` / ``trace-thr`` read the netsim rate
model's per-class metrics (``repro_torch.netsim.model``), which the scorer
emits when the evaluator carries a workload (``Evaluator(workload=...)``).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Mapping

import numpy as np
import torch

from .chiplets import TRAFFIC_TYPES, ArchSpec
from .registries import (OBJECTIVE_TERMS, SCHEDULE_RAMPS, ObjectiveTermEntry,
                         register_objective_term, register_schedule_ramp)

_EPS = 1.0e-6

# Objective terms that turn the scorer into a traffic-driven evaluation:
# they read the netsim rate model's per-class metrics, so the evaluator
# must carry a workload whose packed demand rides along as the runtime
# ``_demand`` operand (see repro_torch.netsim.workload /
# proxies.make_scorer).
TRACE_TERMS = ("trace-lat", "trace-thr")

# Normalizer vector layout (stable; the scorer takes this as a runtime
# tensor so normalizer draws share one scorer):
NORM_SLOTS = tuple([f"lat_{t}" for t in TRAFFIC_TYPES]
                   + [f"inv_thr_{t}" for t in TRAFFIC_TYPES] + ["area"])
NORM_DIM = len(NORM_SLOTS)

# Weight vector layout: the fixed slots shared by every objective, then one
# weight per term.  Like the normalizers, a runtime tensor ([W_FIXED +
# n_terms] or per-row [P, ...]).
WEIGHT_SLOTS = tuple([f"w_lat_{t}" for t in TRAFFIC_TYPES]
                     + [f"w_thr_{t}" for t in TRAFFIC_TYPES] + ["w_area"])
W_FIXED = len(WEIGHT_SLOTS)

NORMALIZER_POLICIES = ("mean", "median", "ones")


def norms_vec(norm) -> np.ndarray:
    """``cost.CostNormalizers`` -> flat float32 vector in NORM_SLOTS order."""
    out = np.empty(NORM_DIM, np.float32)
    for i, t in enumerate(TRAFFIC_TYPES):
        out[i] = norm.lat[t]
        out[4 + i] = norm.inv_thr[t]
    out[8] = norm.area
    return out


def weights_vec(objective: "Objective") -> np.ndarray:
    """Objective weights -> flat float32 vector: WEIGHT_SLOTS order (mix
    lat, mix thr, w_area), then one per-term weight in term order."""
    out = np.empty(W_FIXED + len(objective.terms), np.float32)
    out[0:4] = objective.mix.lat
    out[4:8] = objective.mix.thr
    out[8] = objective.w_area
    for j, t in enumerate(objective.terms):
        out[W_FIXED + j] = t.weight
    return out


def weight_dim(objective: "Objective") -> int:
    return W_FIXED + len(objective.terms)


def _norms_dict_from_rows(rows):
    """[P, NORM_DIM] normalizer rows -> mapping of [P] columns."""
    d = {}
    for i, t in enumerate(TRAFFIC_TYPES):
        d[f"lat_{t}"] = rows[:, i]
        d[f"inv_thr_{t}"] = rows[:, 4 + i]
    d["area"] = rows[:, 8]
    return d


def _mix_weights_from_rows(rows):
    """The fixed weight slots of [P, W_FIXED + n_terms] weight rows, keyed
    like the entries term implementations read from their ``norms``."""
    d = {}
    for i, t in enumerate(TRAFFIC_TYPES):
        d[f"w_lat_{t}"] = rows[:, i]
        d[f"w_thr_{t}"] = rows[:, 4 + i]
    d["w_area"] = rows[:, 8]
    return d


def _mix_weights_static(objective: "Objective"):
    """Same mapping, from the objective's own (python-float) weights."""
    d = {}
    for i, t in enumerate(TRAFFIC_TYPES):
        d[f"w_lat_{t}"] = objective.mix.lat[i]
        d[f"w_thr_{t}"] = objective.mix.thr[i]
    d["w_area"] = objective.w_area
    return d


# ---------------------------------------------------------------------------
# TrafficMix: typed per-type weights.
# ---------------------------------------------------------------------------

_PAPER_W = (0.1, 2.0, 0.1, 2.0)     # §V-B: C2M / M2I weighted 2, C2C / C2I 0.1


@dataclass(frozen=True)
class TrafficMix:
    """Latency/throughput weights per traffic type (order TRAFFIC_TYPES)."""

    lat: tuple = _PAPER_W
    thr: tuple = _PAPER_W

    def __post_init__(self):
        for name in ("lat", "thr"):
            v = tuple(float(x) for x in getattr(self, name))
            if len(v) != len(TRAFFIC_TYPES):
                raise ValueError(
                    f"TrafficMix.{name} needs {len(TRAFFIC_TYPES)} weights "
                    f"(order {TRAFFIC_TYPES}), got {len(v)}")
            if not all(np.isfinite(x) and x >= 0.0 for x in v):
                raise ValueError(f"TrafficMix.{name} weights must be finite "
                                 f"and non-negative: {v}")
            object.__setattr__(self, name, v)

    @classmethod
    def paper(cls) -> "TrafficMix":
        return cls()

    @classmethod
    def from_trace_mix(cls, mix, *, flit_weighted: bool = True,
                       scale: float = 4.2) -> "TrafficMix":
        """Weights proportional to the traffic a §VII-A dependency trace
        actually generates (``traces.TraceMix.class_shares``; directions
        folded into the four chiplet-pair classes).  ``scale`` sets the
        overall traffic-vs-area balance — the default makes the weights
        sum to the paper mix's 4.2, so ``w_area`` keeps its meaning."""
        shares = mix.class_shares(flit_weighted=flit_weighted)
        w = tuple(scale * shares[t] for t in TRAFFIC_TYPES)
        return cls(lat=w, thr=w)

    def to_dict(self) -> dict:
        return {"lat": list(self.lat), "thr": list(self.thr)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "TrafficMix":
        unknown = set(d) - {"lat", "thr"}
        if unknown:
            raise ValueError(f"unknown TrafficMix keys: {sorted(unknown)}")
        return cls(**{k: tuple(v) for k, v in d.items()})


# ---------------------------------------------------------------------------
# TermSpec + Objective.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TermSpec:
    """One weighted term: a registry name plus hashable keyword params.

    Param values may be numbers, strings or bools (anything JSON-scalar
    and hashable); numbers are normalized to float so serialization
    round-trips compare equal.
    """

    name: str
    weight: float = 1.0
    params: tuple = ()              # sorted ((key, value), ...) pairs

    @staticmethod
    def _coerce(v):
        if isinstance(v, bool) or isinstance(v, str):
            return v
        if isinstance(v, (int, float)):
            return float(v)
        raise TypeError(f"TermSpec param values must be JSON scalars "
                        f"(number/str/bool), got {type(v).__name__}: {v!r}")

    def __post_init__(self):
        p = self.params
        items = p.items() if isinstance(p, Mapping) else p
        p = tuple(sorted((str(k), self._coerce(v)) for k, v in items))
        object.__setattr__(self, "params", p)
        object.__setattr__(self, "weight", float(self.weight))

    def param_dict(self) -> dict:
        return dict(self.params)

    def to_dict(self) -> dict:
        return {"name": self.name, "weight": self.weight,
                "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d) -> "TermSpec":
        if isinstance(d, TermSpec):
            return d
        if isinstance(d, str):
            return cls(name=d)
        unknown = set(d) - {"name", "weight", "params"}
        if unknown:
            raise ValueError(f"unknown TermSpec keys: {sorted(unknown)}")
        return cls(**dict(d))


DEFAULT_TERMS = (TermSpec("lat"), TermSpec("inv-thr"), TermSpec("area"))


@dataclass(frozen=True)
class Objective:
    """A placement cost function: traffic mix x normalizer policy x terms.

    The default value reproduces the paper's §IV-B formula (and the
    deprecated ``ArchSpec.w_lat/w_thr/w_area`` weights) bit-for-bit on the
    host float64 path.  Hashable — its structure keys the scorer cache.
    """

    mix: TrafficMix = field(default_factory=TrafficMix)
    w_area: float = 2.0
    normalizer: str = "mean"        # mean | median | ones
    terms: tuple = DEFAULT_TERMS

    def __post_init__(self):
        if isinstance(self.mix, Mapping):
            object.__setattr__(self, "mix", TrafficMix.from_dict(self.mix))
        object.__setattr__(self, "w_area", float(self.w_area))
        object.__setattr__(
            self, "terms",
            tuple(TermSpec.from_dict(t) for t in self.terms))
        if self.normalizer not in NORMALIZER_POLICIES:
            raise ValueError(
                f"unknown normalizer policy {self.normalizer!r}; one of "
                f"{NORMALIZER_POLICIES}")

    @classmethod
    def from_arch(cls, arch: ArchSpec, **kw) -> "Objective":
        """Bridge for the deprecated ``ArchSpec.w_*`` weight fields."""
        return cls(mix=TrafficMix(lat=arch.w_lat, thr=arch.w_thr),
                   w_area=arch.w_area, **kw)

    def with_terms(self, *extra: TermSpec) -> "Objective":
        return dataclasses.replace(self, terms=self.terms + tuple(extra))

    def structure_key(self) -> tuple:
        """The structural identity of this objective: term names + params.

        All *weights* (traffic mix, ``w_area``, per-term) are runtime
        vector entries (:func:`weights_vec`), so objectives that differ
        only in weights share one scorer — this key (not the full
        objective) keys the scorer cache.
        """
        return tuple((t.name, t.params) for t in self.terms)

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        return {"mix": self.mix.to_dict(), "w_area": self.w_area,
                "normalizer": self.normalizer,
                "terms": [t.to_dict() for t in self.terms]}

    @classmethod
    def from_dict(cls, d: Mapping) -> "Objective":
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown Objective keys: {sorted(unknown)}")
        return cls(**dict(d))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1)

    @classmethod
    def from_json(cls, s: str) -> "Objective":
        return cls.from_dict(json.loads(s))




# ---------------------------------------------------------------------------
# Built-in terms.  Device fns are batched torch over [P] placements, with
# the same float32 operations in the same order as the reference's
# per-placement jnp terms; host fns are batched float64 numpy whose
# accumulation order matches the legacy ``cost.cost_components`` formula.
# Traffic-mix / area weights are read from the ``norms`` mapping.
# ---------------------------------------------------------------------------

def _lat_host(metrics, batch, norms, obj, params):
    acc = None
    for i, t in enumerate(TRAFFIC_TYPES):
        v = (norms[f"w_lat_{t}"] * np.asarray(metrics[f"lat_{t}"],
                                              np.float64)
             / max(norms[f"lat_{t}"], _EPS))
        acc = v if acc is None else acc + v
    return acc


@register_objective_term("lat", host_fn=_lat_host)
def _lat(sample, norms, obj, params):
    """Normalized mean shortest-path latency, weighted per traffic type."""
    acc = 0.0
    for t in TRAFFIC_TYPES:
        acc = acc + (norms[f"w_lat_{t}"] * sample[f"lat_{t}"]
                     / norms[f"lat_{t}"].clamp_min(_EPS))
    return acc


def _inv_thr_host(metrics, batch, norms, obj, params):
    acc = None
    for i, t in enumerate(TRAFFIC_TYPES):
        v = (norms[f"w_thr_{t}"]
             * (1.0 / np.maximum(np.asarray(metrics[f"thr_{t}"],
                                            np.float64), _EPS))
             / max(norms[f"inv_thr_{t}"], _EPS))
        acc = v if acc is None else acc + v
    return acc


@register_objective_term("inv-thr", host_fn=_inv_thr_host)
def _inv_thr(sample, norms, obj, params):
    """Normalized inverse saturation throughput ("lower is better")."""
    acc = 0.0
    for t in TRAFFIC_TYPES:
        acc = acc + (norms[f"w_thr_{t}"]
                     / sample[f"thr_{t}"].clamp_min(_EPS)
                     / norms[f"inv_thr_{t}"].clamp_min(_EPS))
    return acc


def _area_host(metrics, batch, norms, obj, params):
    return (norms["w_area"] * np.asarray(metrics["area"], np.float64)
            / max(norms["area"], _EPS))


@register_objective_term("area", host_fn=_area_host)
def _area(sample, norms, obj, params):
    """Normalized enclosing-rectangle area (§V-A get_area)."""
    return (norms["w_area"] * sample["area"]
            / norms["area"].clamp_min(_EPS))


def _link_len_host(metrics, batch, norms, obj, params):
    cap = params.get("cap_mm", 3.0)
    over = np.maximum(np.asarray(batch["edge_len"], np.float64) - cap, 0.0)
    return 0.5 * np.where(np.asarray(batch["edge_mask"]), over, 0.0).sum(-1)


@register_objective_term("link-length-cap", host_fn=_link_len_host)
def _link_len(sample, norms, obj, params):
    """Soft D2D link-length budget: total mm of link length above
    ``cap_mm`` over the placement's (undirected) links.  Zero whenever all
    links respect the cap — tighten ``cap_mm`` below ``max_link_mm`` to
    bias the search toward shorter (lower-energy) interposer routes."""
    cap = params.get("cap_mm", 3.0)
    over = (sample["edge_len"] - cap).clamp_min(0.0)
    return 0.5 * torch.where(sample["edge_mask"], over, 0.0).sum(-1)


def _node_degree_host(metrics, batch, norms, obj, params):
    cap = params.get("max_degree", 4.0)
    E = np.asarray(batch["edges"])
    M = np.asarray(batch["edge_mask"])
    out = np.zeros(E.shape[0], np.float64)
    for b in range(E.shape[0]):
        deg = np.bincount(E[b, M[b], 0])
        out[b] = np.maximum(deg - cap, 0.0).sum()
    return out


@register_objective_term("node-degree", host_fn=_node_degree_host)
def _node_degree(sample, norms, obj, params):
    """Per-PHY link-count penalty: sum of degree overage above
    ``max_degree`` (a router-radix proxy).  Out-degree over the directed
    edge list equals the undirected PHY degree."""
    cap = params.get("max_degree", 4.0)
    mask = sample["edge_mask"]
    deg = torch.zeros(mask.shape[0], sample["Vp"], dtype=torch.float32,
                      device=mask.device)
    deg.scatter_add_(1, sample["edges"][..., 0],
                     torch.where(mask, 1.0, 0.0).to(torch.float32))
    return (deg - cap).clamp_min(0.0).sum(-1)


def _trace_lat_host(metrics, batch, norms, obj, params):
    if "trace_lat_c2c" not in metrics:
        raise KeyError(
            "trace-lat host evaluation needs trace_lat_* metrics; score "
            "through an evaluator built with a workload so the scorer "
            "emits them")
    acc = None
    for t in TRAFFIC_TYPES:
        v = (norms[f"w_lat_{t}"]
             * np.asarray(metrics[f"trace_lat_{t}"], np.float64)
             / max(norms[f"lat_{t}"], _EPS))
        acc = v if acc is None else acc + v
    return acc


@register_objective_term("trace-lat", host_fn=_trace_lat_host)
def _trace_lat(sample, norms, obj, params):
    """Normalized traffic-weighted packet latency from the netsim rate
    model (``repro_torch.netsim.model``): per traffic class, the
    demand-weighted mean of path latency + per-hop router pipeline +
    saturating ECMP queueing delay + serialization, under the class's
    workload demand.  Requires an evaluator-attached workload
    (``ExperimentConfig(workload=...)``), which enters the scorer as the
    runtime ``_demand`` operand.  Normalized by the same per-class latency
    scale as the ``lat`` proxy term (both are cycles), weighted by the
    runtime traffic-mix weights."""
    acc = 0.0
    for t in TRAFFIC_TYPES:
        acc = acc + (norms[f"w_lat_{t}"] * sample[f"trace_lat_{t}"]
                     / norms[f"lat_{t}"].clamp_min(_EPS))
    return acc


def _trace_thr_host(metrics, batch, norms, obj, params):
    if "trace_thr_c2c" not in metrics:
        raise KeyError(
            "trace-thr host evaluation needs trace_thr_* metrics; score "
            "through an evaluator built with a workload so the scorer "
            "emits them")
    acc = None
    for t in TRAFFIC_TYPES:
        thr = np.asarray(metrics[f"trace_thr_{t}"], np.float64)
        inv = np.where(thr > 0, 1.0 / np.maximum(thr, _EPS), 0.0)
        v = norms[f"w_thr_{t}"] * inv / max(norms[f"inv_thr_{t}"], _EPS)
        acc = v if acc is None else acc + v
    return acc


@register_objective_term("trace-thr", host_fn=_trace_thr_host)
def _trace_thr(sample, norms, obj, params):
    """Normalized per-class *throughput* cost from the netsim rate model:
    per traffic class, the maximum sustainable aggregate flit injection
    rate before some link saturates (the class's demand scaled up against
    the other classes' fixed link loads — see
    ``repro_torch.netsim.model``).  Cost is the inverse (lower is better),
    normalized by the same per-class inverse-throughput scale as the
    ``inv-thr`` proxy term and weighted by the runtime traffic-mix
    throughput weights; classes without demand contribute 0."""
    acc = 0.0
    for t in TRAFFIC_TYPES:
        thr = sample[f"trace_thr_{t}"]
        inv = torch.where(thr > 0, 1.0 / thr.clamp_min(_EPS), 0.0)
        acc = acc + (norms[f"w_thr_{t}"] * inv
                     / norms[f"inv_thr_{t}"].clamp_min(_EPS))
    return acc


# ---------------------------------------------------------------------------
# Compilation: Objective -> batched device cost function.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CompiledObjective:
    """An :class:`Objective` resolved against the term registry.

    ``cost(sample, norms_rows, weights_rows)`` is the batched cost —
    ``[P, NORM_DIM]`` normalizer rows and ``[P, W_FIXED + n_terms]`` weight
    rows are runtime tensors, so one scorer serves every normalizer draw
    and every weighting of the same term structure.  ``term_values``
    returns the weighted per-term costs individually; ``cost`` is their
    sequential sum.
    """

    objective: Objective
    entries: tuple

    def term_values(self, sample, norms_rows, weights_rows):
        """Weighted per-term [P] tensors, in term order."""
        norms = (_norms_dict_from_rows(norms_rows)
                 | _mix_weights_from_rows(weights_rows))
        return [weights_rows[:, W_FIXED + j]
                * entry.fn(sample, norms, self.objective, spec.param_dict())
                for j, (spec, entry) in enumerate(
                    zip(self.objective.terms, self.entries))]

    def cost(self, sample, norms_rows, weights_rows):
        P = norms_rows.shape[0]
        total = torch.zeros(P, dtype=torch.float32, device=norms_rows.device)
        for v in self.term_values(sample, norms_rows, weights_rows):
            total = total + v
        return total


def compile_objective(objective: Objective) -> CompiledObjective:
    """Resolve ``objective.terms`` against OBJECTIVE_TERMS (fails fast on
    unknown names) into a :class:`CompiledObjective`."""
    entries = tuple(OBJECTIVE_TERMS.get(s.name) for s in objective.terms)
    return CompiledObjective(objective, entries)


# ---------------------------------------------------------------------------
# Host evaluation (reporting, legacy total_cost, device-agreement tests).
# ---------------------------------------------------------------------------

def _host_norms(norm, objective: Objective) -> dict:
    d = {}
    for t in TRAFFIC_TYPES:
        d[f"lat_{t}"] = norm.lat[t]
        d[f"inv_thr_{t}"] = norm.inv_thr[t]
    d["area"] = norm.area
    d.update(_mix_weights_static(objective))
    return d


def _host_fallback(entry: ObjectiveTermEntry, objective, spec, metrics,
                   batch, norm, vp: int | None) -> np.ndarray:
    """Run the device term on CPU tensors (float32) when no dedicated host
    implementation exists."""
    sample = {k: torch.as_tensor(np.asarray(v))
              for k, v in metrics.items()
              if k not in ("cost", "connected", "overflow")}
    if batch is not None:
        if "edges" in batch:
            sample["edges"] = torch.as_tensor(
                np.asarray(batch["edges"], np.int64))
        for k in ("edge_mask", "edge_len"):
            if k in batch:
                sample[k] = torch.as_tensor(np.asarray(batch[k]))
        if vp is None and "edges" in batch:
            # Heuristic lower bound on the PHY count (exact when the
            # highest-numbered PHY carries a link); pass ``vp`` for terms
            # that size arrays by the true layout.Vp.
            vp = int(np.asarray(batch["edges"]).max()) + 1
    sample["Vp"] = vp or 0
    P = len(np.asarray(metrics["area"]))
    rows = torch.as_tensor(norms_vec(norm)).expand(P, NORM_DIM)
    norms = _norms_dict_from_rows(rows) | _mix_weights_static(objective)
    out = entry.fn(sample, norms, objective, spec.param_dict())
    return np.asarray(out, np.float64)


def objective_cost_host(metrics: dict, objective: Objective, norm, *,
                        batch: dict | None = None,
                        vp: int | None = None) -> np.ndarray:
    """Batched float64 host cost.  For the default ``Objective`` this is
    bit-for-bit ``cost.total_cost`` (same weights, same grouped float64
    accumulation: all lat, all inv-thr, area).  Graph-dependent terms
    (``link-length-cap``, ``node-degree``) additionally need the stacked
    graph ``batch``; ``vp`` supplies the true ``layout.Vp`` to host-
    fallback terms that size per-PHY arrays."""
    cobj = compile_objective(objective)
    norms = _host_norms(norm, objective)
    total = None
    for spec, entry in zip(objective.terms, cobj.entries):
        if entry.host_fn is not None:
            v = np.asarray(entry.host_fn(metrics, batch, norms, objective,
                                         spec.param_dict()), np.float64)
        else:
            v = _host_fallback(entry, objective, spec, metrics, batch, norm,
                               vp)
        v = spec.weight * v
        total = v if total is None else total + v
    if total is None:                       # no terms: zero cost
        some = np.asarray(metrics["area"], np.float64)
        total = np.zeros_like(some)
    return total


# ---------------------------------------------------------------------------
# Constraint-hardening schedules: per-term weight scale ramps over a run.
#
# Because the objective weights are a *runtime* vector in the scorer
# (see weights_vec), ramping a penalty weight across optimizer generations
# is just a different [W_FIXED + n_terms] vector per scoring request to the
# same scorer.  Ramp shapes come from the @register_schedule_ramp registry
# (registries.SCHEDULE_RAMPS): fn(t, start, end, params) -> scale, with t
# the run's progress fraction in [0, 1].
# ---------------------------------------------------------------------------

@register_schedule_ramp("linear")
def _ramp_linear(t, start, end, params):
    """start -> end, linearly in progress."""
    return start + (end - start) * t


@register_schedule_ramp("cosine")
def _ramp_cosine(t, start, end, params):
    """start -> end along a half cosine (slow start, slow finish)."""
    return end + (start - end) * 0.5 * (1.0 + np.cos(np.pi * t))


@register_schedule_ramp("step")
def _ramp_step(t, start, end, params):
    """start before progress ``at`` (default 0.5), end from there on."""
    return end if t >= params.get("at", 0.5) else start


@dataclass(frozen=True)
class Ramp:
    """One ramp: a registry kind plus start/end scales and params."""

    kind: str = "linear"
    start: float = 0.0
    end: float = 1.0
    params: tuple = ()              # sorted ((key, value), ...) pairs

    def __post_init__(self):
        p = self.params
        items = p.items() if isinstance(p, Mapping) else p
        object.__setattr__(self, "params", tuple(
            sorted((str(k), float(v)) for k, v in items)))
        object.__setattr__(self, "start", float(self.start))
        object.__setattr__(self, "end", float(self.end))
        SCHEDULE_RAMPS.get(self.kind)          # fail fast on unknown kinds

    def scale_at(self, t: float) -> float:
        t = min(max(float(t), 0.0), 1.0)
        return float(SCHEDULE_RAMPS.get(self.kind)(
            t, self.start, self.end, dict(self.params)))

    def to_dict(self) -> dict:
        return {"kind": self.kind, "start": self.start, "end": self.end,
                "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d) -> "Ramp":
        if isinstance(d, Ramp):
            return d
        unknown = set(d) - {"kind", "start", "end", "params"}
        if unknown:
            raise ValueError(f"unknown Ramp keys: {sorted(unknown)}")
        return cls(**dict(d))


@dataclass(frozen=True)
class Schedule:
    """Per-term weight-scale ramps applied over a run's progress.

    ``ramps`` maps objective term names to :class:`Ramp`s; at progress
    ``t`` the term's runtime weight is ``spec.weight * ramp.scale_at(t)``.
    Classic constraint hardening ramps a penalty term from 0 to full
    strength (``Ramp("linear", start=0.0, end=1.0)``), letting the search
    move through infeasible regions early and forcing feasibility late.
    Hashable and JSON round-trippable like :class:`Objective`; validated
    against the objective's terms when compiled (``compile_schedule``).
    """

    ramps: tuple = ()               # sorted ((term_name, Ramp), ...)

    def __post_init__(self):
        r = self.ramps
        items = r.items() if isinstance(r, Mapping) else r
        object.__setattr__(self, "ramps", tuple(sorted(
            (str(k), Ramp.from_dict(v)) for k, v in items)))

    def scales_at(self, t: float) -> dict:
        return {name: ramp.scale_at(t) for name, ramp in self.ramps}

    def to_dict(self) -> dict:
        return {"ramps": {name: ramp.to_dict() for name, ramp in self.ramps}}

    @classmethod
    def from_dict(cls, d) -> "Schedule":
        if isinstance(d, Schedule):
            return d
        unknown = set(d) - {"ramps"}
        if unknown:
            raise ValueError(f"unknown Schedule keys: {sorted(unknown)}")
        return cls(**dict(d))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1)

    @classmethod
    def from_json(cls, s: str) -> "Schedule":
        return cls.from_dict(json.loads(s))


class CompiledSchedule:
    """A :class:`Schedule` bound to an objective's weight vector.

    ``weights_at(t)`` returns the [W_FIXED + n_terms] float32 runtime
    weight vector at progress ``t``: the objective's base weights with
    each ramped term's weight slot scaled.  Rows for a whole trajectory
    share one scorer — weights are runtime tensors.
    """

    def __init__(self, schedule: Schedule, objective: Objective):
        self.schedule = schedule
        self.objective = objective
        self._base = weights_vec(objective)
        names = [t.name for t in objective.terms]
        unknown = [n for n, _ in schedule.ramps if n not in names]
        if unknown:
            raise ValueError(
                f"schedule ramps unknown objective term(s) {unknown}; "
                f"objective has {names}")
        self._slots = [(np.nonzero([n == name for n in names])[0] + W_FIXED,
                        ramp) for name, ramp in schedule.ramps]

    def weights_at(self, t: float) -> np.ndarray:
        out = self._base.copy()
        for slots, ramp in self._slots:
            out[slots] = out[slots] * np.float32(ramp.scale_at(t))
        return out


def compile_schedule(schedule, objective: Objective) -> CompiledSchedule:
    """Validate + bind a schedule (or its dict form) to an objective."""
    return CompiledSchedule(Schedule.from_dict(schedule)
                            if not isinstance(schedule, Schedule)
                            else schedule, objective)
