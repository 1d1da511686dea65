"""Pareto sweeps over objective scalarizations, in PyTorch.

The port of ``repro.core.pareto``.  PlaceIT's cost function is a
scalarization of a fundamentally multi-objective space — L1-to-L2 latency
vs L2-to-memory latency vs throughput vs area (paper §IV-B).  The objective
layer's runtime weight vectors (``objective.weights_vec``) make exploring
that space cheap: every scalarization of one term *structure* shares a
single scorer, so a whole grid of weightings runs as one stacked sweep
(``optimize.drive_stacked`` lockstep, objective-keyed evaluator cache with
shared normalizer draws).

* :class:`ParetoGridSpec` — a serializable grid of scalarizations: a
  cartesian product of per-term weight axes and (optionally) a
  :class:`~repro_torch.core.objective.TrafficMix` axis, expanded against a
  base :class:`~repro_torch.core.objective.Objective`.
* :func:`nondominated_mask` — dominance on the device: one ``[B, B, n]``
  comparison over the ``[B, n_objectives]`` float32 cost matrix.
  :func:`nondominated_mask_host` is the brute-force host reference the
  device mask must match exactly.
* :func:`hypervolume` — exact dominated hypervolume vs a reference point:
  a sort-and-sweep (``n == 2``) and a coordinate-lattice sweep (``n ==
  3``) on the device in float32, as the reference's jitted paths compute
  (JAX runs without x64 there), and the recursive dimension sweep on the
  host in float64 for any ``n``.
* :class:`ParetoFront` / :class:`ParetoPoint` — typed records with the
  reference's JSON form (a front written by either package loads in the
  other), with per-point provenance.
* :func:`run_pareto_sweep` / :func:`run_pareto` — run one optimization
  population per grid point through ``api.run_sweep`` (stacked), re-score
  every run's best placement in a single scorer call under the *base*
  objective, and compute the front over the per-term cost matrix
  (:func:`term_matrix`, the same term functions the scorer's ``cost``
  sums).

Every entry point runs on the card unless the caller passes
``device="cpu"`` (``proxies.resolve_device``).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import warnings
from dataclasses import dataclass, field
from typing import Mapping

import numpy as np
import torch

from .api import make_evaluator, make_rep, run_sweep
from .chiplets import resolve_arch
from .objective import (NORM_DIM, Objective, TrafficMix, compile_objective,
                        norms_vec, weights_vec)
from .proxies import resolve_device
from .topology import stack_graphs


# ---------------------------------------------------------------------------
# Grid specification.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParetoGridSpec:
    """A grid of objective scalarizations.

    ``term_weights`` maps objective term names to the weight values that
    term sweeps over; ``mixes`` is an optional axis of
    :class:`TrafficMix` values.  The grid is the cartesian product of all
    axes, expanded against a base objective with :meth:`points` — every
    expanded objective keeps the base term *structure*, so the whole grid
    shares one compiled scorer and stacks in ``run_sweep``.
    """

    term_weights: tuple = ()     # sorted ((term_name, (v, ...)), ...)
    mixes: tuple = ()            # optional TrafficMix axis

    def __post_init__(self):
        tw = self.term_weights
        items = tw.items() if isinstance(tw, Mapping) else tw
        object.__setattr__(self, "term_weights", tuple(sorted(
            (str(k), tuple(float(x) for x in v)) for k, v in items)))
        for name, vals in self.term_weights:
            if not vals:
                raise ValueError(f"empty weight axis for term {name!r}")
        object.__setattr__(self, "mixes", tuple(
            m if isinstance(m, TrafficMix) else TrafficMix.from_dict(m)
            for m in self.mixes))

    @property
    def n_points(self) -> int:
        n = 1
        for _, vals in self.term_weights:
            n *= len(vals)
        return n * max(1, len(self.mixes))

    def points(self, base: Objective) -> list[tuple[str, Objective]]:
        """Expand to ``(label, objective)`` pairs against ``base``."""
        names = [t.name for t in base.terms]
        for name, _ in self.term_weights:
            if name not in names:
                raise ValueError(
                    f"pareto grid sweeps unknown objective term {name!r}; "
                    f"objective has {names}")
        axes = [[(f"{name}={v:g}", name, v) for v in vals]
                for name, vals in self.term_weights]
        mix_axis = ([(f"mix={i}", None, m)
                     for i, m in enumerate(self.mixes)]
                    or [("", None, None)])
        out = []
        for combo in itertools.product(mix_axis, *axes):
            obj = base
            labels = []
            for lab, name, v in combo:
                if name is None:
                    if v is not None:       # TrafficMix axis
                        obj = dataclasses.replace(obj, mix=v)
                        labels.append(lab)
                    continue
                terms = tuple(dataclasses.replace(t, weight=v)
                              if t.name == name else t for t in obj.terms)
                obj = dataclasses.replace(obj, terms=terms)
                labels.append(lab)
            out.append(("|".join(labels) or "base", obj))
        return out

    def to_dict(self) -> dict:
        return {"term_weights": {k: list(v) for k, v in self.term_weights},
                "mixes": [m.to_dict() for m in self.mixes]}

    @classmethod
    def from_dict(cls, d: Mapping) -> "ParetoGridSpec":
        if isinstance(d, ParetoGridSpec):
            return d
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(
                f"unknown ParetoGridSpec keys: {sorted(unknown)}")
        return cls(**dict(d))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1)

    @classmethod
    def from_json(cls, s: str) -> "ParetoGridSpec":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# Dominance + hypervolume.
# ---------------------------------------------------------------------------

def _nondom(Y: torch.Tensor) -> torch.Tensor:
    le = (Y[:, None, :] <= Y[None, :, :]).all(-1)
    lt = (Y[:, None, :] < Y[None, :, :]).any(-1)
    return ~(le & lt).any(0)


def nondominated_mask(Y, *, device=None) -> np.ndarray:
    """Dominance on ``device`` (default: the card): ``mask[j]`` is True iff
    no row of the (lower is better) float32 cost matrix ``Y [B, n]``
    dominates row ``j`` — one ``[B, B, n]`` comparison."""
    dev = resolve_device(device)
    Y = torch.as_tensor(np.asarray(Y, np.float32), device=dev)
    return _nondom(Y).cpu().numpy()


def nondominated_mask_host(Y) -> np.ndarray:
    """Brute-force host reference for :func:`nondominated_mask` (same
    float32 matrix, same tie semantics: duplicates do not dominate each
    other)."""
    Y = np.asarray(Y, np.float32)
    B = Y.shape[0]
    mask = np.ones(B, bool)
    for j in range(B):
        for i in range(B):
            if (Y[i] <= Y[j]).all() and (Y[i] < Y[j]).any():
                mask[j] = False
                break
    return mask


def _hv2d(P: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Sort-and-sweep in x: each point adds the strip between its x and the
    reference, from its y up to the lowest y seen before it."""
    p = P[torch.sort(P[:, 0], stable=True).indices]
    best1 = torch.cat([ref[1:2], torch.cummin(p[:, 1], 0).values[:-1]])
    best1 = torch.minimum(best1, ref[1])
    return ((ref[0] - p[:, 0]) * (best1 - p[:, 1]).clamp_min(0.0)).sum()


def _hv3d(P: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    # Grid sweep over the x/y coordinate lattice: cell (i, j) spans
    # [xs[i], xs[i+1]) x [ys[j], ys[j+1]); its dominated depth is
    # ref_z - min z over points covering the cell's lower corner.
    xs = torch.sort(P[:, 0]).values
    ys = torch.sort(P[:, 1]).values
    dx = torch.diff(torch.cat([xs, ref[0:1]]))
    dy = torch.diff(torch.cat([ys, ref[1:2]]))
    cover = ((P[None, None, :, 0] <= xs[:, None, None])
             & (P[None, None, :, 1] <= ys[None, :, None]))
    z = torch.where(cover, P[None, None, :, 2], ref[2]).min(-1).values
    return (dx[:, None] * dy[None, :] * (ref[2] - z)).sum()


def _hv_rec(pts: np.ndarray, ref: np.ndarray) -> float:
    """Exact hypervolume by recursive dimension sweep (host float64;
    fronts are small).  ``pts`` must be clipped to ``ref``."""
    if pts.shape[0] == 0:
        return 0.0
    if pts.shape[1] == 1:
        return float(ref[0] - pts[:, 0].min())
    order = np.argsort(pts[:, -1], kind="stable")
    pts = pts[order]
    zs = pts[:, -1]
    hv = 0.0
    for i in range(len(pts)):
        z_hi = zs[i + 1] if i + 1 < len(pts) else ref[-1]
        if z_hi > zs[i]:
            hv += (z_hi - zs[i]) * _hv_rec(pts[:i + 1, :-1], ref[:-1])
    return hv


def hypervolume(Y, ref, *, device=None) -> float:
    """Dominated hypervolume of (lower is better) points ``Y [B, n]`` vs a
    reference point ``ref [n]`` (every coordinate worse than the front).

    Exact for any ``n``.  ``n == 2`` runs a sort-and-sweep and ``n == 3``
    a coordinate-lattice sweep (O(B^3) elements — fronts are small) on the
    device in float32, as the reference's jitted paths do; ``device`` is
    that device (default, or ``True``: the card).  ``device=False`` forces
    the host float64 recursion, e.g. for testing; ``n > 3`` always falls
    back to it (exponential in ``n``) and warns."""
    Y = np.asarray(Y, np.float64)
    ref = np.asarray(ref, np.float64)
    if Y.size == 0:
        return 0.0
    pts = np.minimum(Y, ref)             # clip: no negative contributions
    if device is not False and Y.shape[1] in (2, 3):
        dev = resolve_device(None if device is True else device)
        P = torch.as_tensor(pts, dtype=torch.float32, device=dev)
        R = torch.as_tensor(ref, dtype=torch.float32, device=dev)
        fn = _hv2d if Y.shape[1] == 2 else _hv3d
        return float(fn(P, R))
    if Y.shape[1] > 3:
        warnings.warn(
            f"hypervolume: no device path for n={Y.shape[1]} objectives; "
            "using the exact host recursion (cost grows exponentially "
            "with n)", stacklevel=2)
    return _hv_rec(pts, ref)


# ---------------------------------------------------------------------------
# Per-term cost matrix (the Pareto objective vectors), on the device.
# ---------------------------------------------------------------------------

def term_matrix(metrics: dict, batch: dict, objective: Objective, norm,
                vp: int, *, device=None) -> np.ndarray:
    """``[B, n_terms]`` float32 weighted per-term costs for a scored,
    stacked batch — the compiled objective's term functions (the ones the
    scorer's ``cost`` sums) over the whole batch on ``device`` (default:
    the card)."""
    dev = resolve_device(device)
    cobj = compile_objective(objective)
    sample = {k: torch.as_tensor(np.asarray(v), device=dev)
              for k, v in metrics.items()
              if k not in ("cost", "connected", "overflow")}
    B = len(np.asarray(metrics["area"]))
    for k, dtype in (("edges", torch.long), ("edge_mask", torch.bool),
                     ("edge_len", torch.float32)):
        if k in batch:
            sample[k] = torch.as_tensor(np.asarray(batch[k]), dtype=dtype,
                                        device=dev)
    sample["Vp"] = vp
    norms = torch.as_tensor(norms_vec(norm), device=dev).expand(B, NORM_DIM)
    w = torch.as_tensor(weights_vec(objective), device=dev)
    cols = cobj.term_values(sample, norms, w.expand(B, w.shape[0]))
    return torch.stack(cols, 1).cpu().numpy().astype(np.float32)


# ---------------------------------------------------------------------------
# Typed result records.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParetoPoint:
    """One candidate with full provenance back to its config + placement.

    ``terms`` are the base-objective weighted per-term costs (the row of
    the front's cost matrix); ``cost`` is the scalar cost under the
    point's *own* scalarization (``objective``); ``placement`` serializes
    the winning solution (``types``/``rots`` — the homogeneous grid's
    [R, C] arrays or the heterogeneous (order, rotations) vectors).
    """

    label: str
    cfg_index: int
    algorithm: str
    repetition: int
    objective: Objective
    cost: float
    terms: tuple
    metrics: dict = field(default_factory=dict)
    placement: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"label": self.label, "cfg_index": self.cfg_index,
                "algorithm": self.algorithm, "repetition": self.repetition,
                "objective": self.objective.to_dict(), "cost": self.cost,
                "terms": list(self.terms), "metrics": dict(self.metrics),
                "placement": dict(self.placement)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "ParetoPoint":
        d = dict(d)
        d["objective"] = Objective.from_dict(d["objective"])
        d["terms"] = tuple(float(x) for x in d["terms"])
        return cls(**d)

    def sol(self):
        """The placement as the host representation's ``(a, b)`` arrays."""
        return (np.asarray(self.placement["types"], np.int8),
                np.asarray(self.placement["rots"], np.int8))


@dataclass(frozen=True)
class ParetoFront:
    """A non-dominated front over one base config's scalarization grid."""

    arch: str
    config: str
    term_names: tuple
    ref_point: tuple
    hypervolume: float
    points: tuple            # non-dominated ParetoPoints, by first term
    n_candidates: int
    matrix: tuple = ()       # full [B, n_terms] candidate cost matrix

    def to_dict(self) -> dict:
        return {"arch": self.arch, "config": self.config,
                "term_names": list(self.term_names),
                "ref_point": list(self.ref_point),
                "hypervolume": self.hypervolume,
                "points": [p.to_dict() for p in self.points],
                "n_candidates": self.n_candidates,
                "matrix": [list(r) for r in self.matrix]}

    @classmethod
    def from_dict(cls, d: Mapping) -> "ParetoFront":
        d = dict(d)
        d["term_names"] = tuple(d["term_names"])
        d["ref_point"] = tuple(float(x) for x in d["ref_point"])
        d["points"] = tuple(ParetoPoint.from_dict(p) for p in d["points"])
        d["matrix"] = tuple(tuple(float(x) for x in r)
                            for r in d.get("matrix", ()))
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1)

    @classmethod
    def from_json(cls, s: str) -> "ParetoFront":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# The sweep engine.
# ---------------------------------------------------------------------------

@dataclass
class FrontCandidate:
    """One placement proposed for a front, with provenance.

    ``sol`` is the representation's ``(a, b)`` solution pair;
    ``normalizers`` (optional) carries a run's normalizer draw so the
    front's evaluator reuses it instead of re-generating ``norm_samples``
    placements (first candidate that has one wins).
    """

    label: str
    cfg_index: int
    algorithm: str
    repetition: int
    objective: Objective
    cost: float
    sol: tuple
    normalizers: object | None = None


def candidates_from_records(entries) -> list[FrontCandidate]:
    """``(label, cfg_index, objective, RunRecord)`` tuples (the
    :func:`compute_front` input shape) -> best-placement candidates."""
    return [FrontCandidate(
        label=label, cfg_index=int(cfg_i), algorithm=rec.algorithm,
        repetition=rec.repetition, objective=obj,
        cost=float(rec.result.best_cost), sol=rec.result.best_sol,
        normalizers=rec.result.normalizers)
        for label, cfg_i, obj, rec in entries]


def archive_candidates(label: str, cfg_index: int, objective: Objective,
                       archive: Mapping, *, normalizers=None
                       ) -> list[FrontCandidate]:
    """Candidates from a population-archive snapshot (``{"costs", "a",
    "b"}``, :meth:`repro_torch.core.optimize.PopArchive.snapshot`, or the
    reference's) — every retained top-K row becomes one candidate tagged
    ``algorithm="archive"``, ``repetition=-1``."""
    costs = np.asarray(archive["costs"])
    return [FrontCandidate(
        label=f"{label}|archive", cfg_index=cfg_index,
        algorithm="archive", repetition=-1, objective=objective,
        cost=float(costs[i]),
        sol=(np.asarray(archive["a"][i]), np.asarray(archive["b"][i])),
        normalizers=normalizers)
        for i in range(costs.shape[0])]


class IncrementalFront:
    """A Pareto front that grows as candidates stream in.

    Each :meth:`add` re-scores only the *new* candidates (one scorer call
    under the base objective, on ``device``, default the card), appends
    their rows to the running cost matrix, and recomputes the
    non-dominated mask over everything seen so far.  A single ``add`` of
    all candidates produces exactly :func:`compute_front`'s output.
    """

    def __init__(self, base_cfg, *, ref_point=None, device=None):
        self.base_cfg = base_cfg
        self.ref_point = ref_point
        self.device = resolve_device(device)
        self._arch = resolve_arch(base_cfg.arch, base_cfg.config)
        self._rep = make_rep(self._arch, base_cfg.arch,
                             base_cfg.mutation_mode)
        self._ev = None                       # built on first add
        self._cands: list[FrontCandidate] = []
        self._rows: list[dict] = []           # per-candidate raw metrics
        self._Y: np.ndarray | None = None

    @property
    def n_candidates(self) -> int:
        return len(self._cands)

    def add(self, cands) -> ParetoFront:
        """Score ``cands`` (list of :class:`FrontCandidate`), fold them
        into the front, and return the updated :class:`ParetoFront`."""
        cands = list(cands)
        if not cands:
            return self.front()
        if self._ev is None:
            # Reuse a run's normalizer draw (carried on every OptResult)
            # so the matrix is normalized exactly like in-run costs — and
            # the norm_samples draw is not paid twice.
            norm = next((c.normalizers for c in cands
                         if c.normalizers is not None), None)
            self._ev = make_evaluator(
                self._rep, self._arch,
                rng=np.random.default_rng(self.base_cfg.seed),
                norm_samples=self.base_cfg.norm_samples,
                chunk=self.base_cfg.chunk, backend=self.base_cfg.backend,
                objective=self.base_cfg.objective, norm=norm,
                workload=self.base_cfg.workload, device=self.device)
        graphs = [self._rep.score_graph(c.sol) for c in cands]
        batch = stack_graphs(graphs)
        metrics = self._ev.score_batch(batch)    # one scorer call
        Y = term_matrix(metrics, batch, self.base_cfg.objective,
                        self._ev.norm, self._rep.layout.Vp,
                        device=self.device)
        keys = [k for k in metrics if k not in ("cost", "connected")]
        self._rows.extend({k: float(metrics[k][i]) for k in keys}
                          for i in range(len(cands)))
        self._cands.extend(cands)
        self._Y = Y if self._Y is None else np.concatenate([self._Y, Y])
        return self.front()

    def front(self) -> ParetoFront:
        """The current front over everything added so far."""
        base_cfg = self.base_cfg
        term_names = tuple(t.name for t in base_cfg.objective.terms)
        if self._Y is None:
            return ParetoFront(
                arch=base_cfg.arch, config=base_cfg.config,
                term_names=term_names, ref_point=(), hypervolume=0.0,
                points=(), n_candidates=0)
        Y = self._Y
        mask = nondominated_mask(Y, device=self.device)
        if self.ref_point is None:
            span = Y.max(axis=0) - Y.min(axis=0)
            ref = Y.max(axis=0) + 0.05 * np.maximum(span, 1.0)
        else:
            ref = np.asarray(self.ref_point, np.float64)
        hv = hypervolume(Y[mask], ref, device=self.device)
        points = []
        for i in np.nonzero(mask)[0]:
            c = self._cands[int(i)]
            a, b = c.sol
            points.append(ParetoPoint(
                label=c.label, cfg_index=c.cfg_index,
                algorithm=c.algorithm, repetition=c.repetition,
                objective=c.objective, cost=c.cost,
                terms=tuple(float(x) for x in Y[i]),
                metrics=dict(self._rows[int(i)]),
                placement={"types": np.asarray(a).tolist(),
                           "rots": np.asarray(b).tolist()}))
        order = np.argsort([p.terms[0] for p in points], kind="stable")
        points = tuple(points[int(i)] for i in order)
        return ParetoFront(
            arch=base_cfg.arch, config=base_cfg.config,
            term_names=term_names, ref_point=tuple(float(x) for x in ref),
            hypervolume=float(hv), points=points,
            n_candidates=len(self._cands),
            matrix=tuple(tuple(float(x) for x in r) for r in Y))


def compute_front(base_cfg, entries, *, ref_point=None,
                  extra_candidates=(), device=None) -> ParetoFront:
    """Front over ``entries`` = ``(label, cfg_index, objective,
    RunRecord)`` tuples (``objective`` is the scalarization that produced
    the record), plus optional pre-built ``extra_candidates``
    (:class:`FrontCandidate`).

    Re-scores every record's best placement in one scorer call on
    ``device`` (default: the card; base-config evaluator, shared
    scorer-cache entry), builds the ``[B, n_terms]`` cost matrix with
    :func:`term_matrix`, masks the non-dominated rows on the device and
    reports the exact hypervolume vs ``ref_point`` (default: 5% beyond the
    per-term candidate maximum).
    """
    inc = IncrementalFront(base_cfg, ref_point=ref_point, device=device)
    return inc.add(candidates_from_records(entries)
                   + list(extra_candidates))


def run_pareto_sweep(base_configs, grid, *, fold_repetitions: bool = True,
                     stack_scoring: bool = True, shard: bool = False,
                     ref_point=None, device=None):
    """Expand every base config over ``grid``, run one stacked sweep on
    ``device`` (default: the card), and attach a :class:`ParetoFront` per
    base config.

    Returns the underlying :class:`repro_torch.core.api.SweepResult` (runs
    are the *expanded* configs, in base-config-major, grid-point-minor
    order) with ``fronts`` populated.  Because grid points share the base
    objective's term structure, the whole grid shares one scorer and
    executes in ``drive_stacked`` lockstep — the per-row runtime weight
    vectors keep every scalarization's costs exact.

    A run whose ``OptResult.archive`` holds a population-archive snapshot
    (top-K of every evaluated placement) feeds extra front candidates
    (``algorithm="archive"``): configs with ``archive_k`` > 0 thicken
    their fronts beyond one point per run.  ``shard`` forwards to
    :func:`run_sweep` (the population axis split across devices).
    """
    grid = ParetoGridSpec.from_dict(grid) \
        if not isinstance(grid, ParetoGridSpec) else grid
    if not isinstance(base_configs, (list, tuple)):
        base_configs = (base_configs,)
    expanded, prov = [], []
    for b_i, cfg in enumerate(base_configs):
        for label, obj in grid.points(cfg.objective):
            prov.append((b_i, label, obj))
            expanded.append(dataclasses.replace(cfg, objective=obj))
    sweep = run_sweep(expanded, fold_repetitions=fold_repetitions,
                      stack_scoring=stack_scoring, shard=shard,
                      device=device)
    fronts = []
    for b_i, cfg in enumerate(base_configs):
        entries, extras, seen = [], [], set()
        for i, run in enumerate(sweep.runs):
            if prov[i][0] != b_i:
                continue
            for rec in run.records:
                entries.append((prov[i][1], i, prov[i][2], rec))
            # The archive is per-evaluator (shared by a run's records);
            # the run's *last* snapshot is the cumulative archive.  Runs
            # sharing an evaluator would re-emit identical rows, so dedup
            # snapshots by content.
            snap = next((rec.result.archive for rec in
                         reversed(run.records)
                         if rec.result.archive is not None), None)
            if snap is not None:
                key = np.asarray(snap["costs"]).tobytes()
                if key not in seen:
                    seen.add(key)
                    norm = next((rec.result.normalizers
                                 for rec in run.records
                                 if rec.result.normalizers is not None),
                                None)
                    extras.extend(archive_candidates(
                        prov[i][1], i, prov[i][2], snap,
                        normalizers=norm))
        fronts.append(compute_front(cfg, entries, ref_point=ref_point,
                                    extra_candidates=extras, device=device))
    sweep.fronts = fronts
    return sweep


def run_pareto(base_cfg, grid, **kw) -> ParetoFront:
    """One base config, one grid -> its :class:`ParetoFront`."""
    return run_pareto_sweep(base_cfg, grid, **kw).fronts[0]
