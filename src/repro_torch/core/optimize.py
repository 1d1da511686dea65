"""Optimization algorithms (paper §II-B) over placement representations.

The port of ``repro.core.optimize``: Best Random (BR), Genetic Algorithm
(GA) and Simulated Annealing (SA), all driven through the four
representation functions random_placement / mutate / merge / get_cost
(§IV).  Invalid placements (unconnected chiplets) cause the generating
operation to be repeated, exactly as in §V-A / §VI-A.

Two execution styles coexist, as in the reference:

* **Host-loop** (``best_random`` / ``genetic_algorithm`` /
  ``simulated_annealing``): individuals are generated, mutated and merged
  one at a time in host numpy from a ``np.random.Generator`` (so the same
  seed gives the reference's placements), and each GA generation / SA
  chain-block is scored in one batched call of the Evaluator's scorer on
  its device.
* **Device-resident** (``best_random_batched`` /
  ``genetic_algorithm_batched`` / ``simulated_annealing_batched``): whole
  generations / chain-blocks are produced by :class:`DevicePipeline` as
  batched generate→graph→score calls over stacked tensors — on the device
  end to end for homogeneous grids, with a vectorized host corner-placement
  stage for heterogeneous archs — and invalid individuals are
  masked-and-resampled in batch instead of retried one by one.  Their
  device draws come from a ``torch.Generator``, so they match the
  reference in distribution, not draw for draw.

All six are *step generators* (``*_steps``) that yield scoring requests
and receive ``(costs, metrics)``; ``_drive`` runs one against one
Evaluator, :func:`drive_stacked` runs several in lockstep with their
scoring requests concatenated into single scorer calls on the scorer's
device (the ``run_sweep`` cross-config path, :func:`score_stacked`).

An Evaluator built with ``archive_k`` > 0 keeps a :class:`PopArchive`, the
top-K of every search batch it scores, on the scorer's device; each
driver's ``OptResult.archive`` is its snapshot at the run's end.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .cache import LRUCache
from .cost import CostNormalizers
from .objective import (NORM_DIM, TRACE_TERMS, Objective, compile_schedule,
                        norms_vec, objective_cost_host, weights_vec)
from .placement_hetero import HeteroRep
from .placement_homog import HomogRep
from .proxies import batch_tensor, make_scorer, resolve_device
from .topology import (HeteroGraphBatch, HomogGraphBatch, ScoreGraph,
                       stack_graphs)


@dataclass
class OptResult:
    best_sol: object
    best_cost: float
    best_metrics: dict
    # (wall_seconds, n_evaluated, best_cost_so_far) samples
    history: list = field(default_factory=list)
    n_generated: int = 0          # placements generated incl. retries
    n_evaluated: int = 0          # placements actually scored
    normalizers: CostNormalizers | None = None
    # Snapshot of the evaluator's population archive at run end (see
    # PopArchive.snapshot; None when the evaluator has no archive).  The
    # archive is per-evaluator, so records sharing an evaluator carry
    # increasingly complete snapshots — the last one is the full archive.
    archive: dict | None = None


# ---------------------------------------------------------------------------
# Device-resident population archive.
# ---------------------------------------------------------------------------

def _archive_merge(sc, sa, sb, costs, a, b, k: int):
    """The reference's merge step for step: concatenate, stable sort (NaN
    last, -0.0 equal to +0.0), equal neighbours to +inf (NaN is unequal
    to itself, so NaN rows stay), a second stable sort that keeps the
    first-seen row among equal costs, and the first ``k``."""
    c = torch.cat([sc, costs])
    A = torch.cat([sa, a])
    B = torch.cat([sb, b])
    cs, order = torch.sort(c, stable=True)
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=c.device),
                     cs[1:] == cs[:-1]])
    cs = torch.where(dup, torch.inf, cs)        # equal-cost rows collapse
    keep = torch.sort(cs, stable=True).indices[:k]
    sel = order[keep]
    return cs[keep], A[sel], B[sel]


class PopArchive:
    """Fixed-size top-K archive of evaluated (cost, placement) rows, on a
    device.

    Every scored batch that passes through :meth:`add` is masked (invalid
    rows -> +inf) and merged with the current archive in a few tensor ops
    on the archive's device (concatenate + stable sort + equal-cost dedup
    + take-K), so the archive rides along with the search at no extra
    scoring cost and no host synchronisation; :meth:`snapshot` is its only
    copy to the host.  Pareto fronts built from a sweep re-score these K
    placements next to the per-run winners (``pareto.run_pareto_sweep``).

    The scalar ``cost`` is only the archive's *selection pressure* — rows
    are re-scored under the front's base objective before entering a
    front.  Equal-cost rows are collapsed to the first seen (elites
    re-scored every generation must not fill the archive with copies);
    distinct placements with bit-equal costs are deliberately dropped too.
    """

    def __init__(self, k: int, device="cpu"):
        if k < 1:
            raise ValueError(f"archive size must be >= 1, got {k}")
        self.k = int(k)
        self.device = torch.device(device)
        self.n_added = 0
        self._state = None

    def add(self, costs, a, b, valid=None) -> None:
        """Fold a scored batch into the archive.  ``a``/``b`` are the
        stacked placement arrays ([B, ...]; numpy or tensors, the host
        Sol tuple's two members), ``costs`` the matching [B] cost vector,
        ``valid`` an optional [B] bool mask (e.g. batched-pipeline
        connectivity).  Host rows are copied to the device; nothing comes
        back."""
        dev = self.device
        costs = torch.as_tensor(costs, device=dev).to(torch.float32)
        if valid is not None:
            costs = torch.where(torch.as_tensor(valid, device=dev).bool(),
                                costs, torch.inf)
        a = torch.as_tensor(a, device=dev)
        b = torch.as_tensor(b, device=dev)
        if self._state is None:
            self._state = (
                torch.full((self.k,), torch.inf, device=dev),
                torch.zeros((self.k,) + a.shape[1:], dtype=a.dtype,
                            device=dev),
                torch.zeros((self.k,) + b.shape[1:], dtype=b.dtype,
                            device=dev))
        self._state = _archive_merge(*self._state, costs, a, b, self.k)
        self.n_added += int(costs.shape[0])

    def snapshot(self) -> dict | None:
        """Host copy of the filled rows: ``{"costs", "a", "b"}`` numpy
        arrays (ascending cost), or None when nothing was archived."""
        if self._state is None:
            return None
        c, a, b = (x.cpu().numpy() for x in self._state)
        m = np.isfinite(c)
        if not m.any():
            return None
        return {"costs": c[m], "a": a[m], "b": b[m]}


class Evaluator:
    """rep + scorer + objective + cost normalizers -> batched get_cost().

    ``objective`` defaults to the arch's (deprecated) ``w_*`` weights via
    :meth:`Objective.from_arch`.  When a pre-built ``scorer`` is passed it
    must have been built with the *same term structure*
    (``Objective.structure_key``; ``api.get_scorer`` keys its cache
    accordingly) — the objective's weights are always passed at call time
    as the runtime weight vector.  Without one, the scorer is built on
    ``device`` (default: the card, see ``proxies.resolve_device``).

    ``schedule`` (an ``objective.Schedule``) attaches constraint-hardening
    weight ramps: step generators ask :meth:`sched_weights` for the weight
    vector at their current progress and tag their scoring requests with
    it.  ``norm`` re-uses an existing ``CostNormalizers`` draw instead of
    re-drawing ``norm_samples`` placements.

    ``workload`` (a :class:`repro_torch.netsim.workload.Workload`) backs a
    ``trace-lat`` / ``trace-thr`` objective term: its packed vector rides
    along with every scoring request as the runtime ``_demand`` operand,
    on the scorer's device.

    ``device`` is the scorer's (``score.device``); the device pipeline
    (:meth:`pipeline`) runs there too.  ``archive_k`` > 0 attaches a
    :class:`PopArchive` of that size on the same device (``archive``,
    else ``None``); it collects search batches only, never the norm
    samples.
    """

    def __init__(self, rep, arch, *, rng: np.random.Generator,
                 norm_samples: int = 500, chunk: int = 16, fw_impl=None,
                 scorer=None, objective: Objective | None = None,
                 schedule=None, norm: CostNormalizers | None = None,
                 archive_k: int = 0, workload=None, device=None):
        self.rep = rep
        self.arch = arch
        self.objective = (objective if objective is not None
                          else Objective.from_arch(arch))
        self._weights_vec = weights_vec(self.objective)
        self.workload = workload
        needs_demand = any(t.name in TRACE_TERMS
                           for t in self.objective.terms)
        if needs_demand and workload is None:
            raise ValueError(
                "objective has a trace term (trace-lat/trace-thr) but no "
                "workload; pass Evaluator(..., "
                "workload=netsim.Workload(...))")
        self._demand_vec = None
        if needs_demand:
            if workload.n != rep.layout.N:
                raise ValueError(
                    f"workload covers {workload.n} chiplets but the arch "
                    f"has {rep.layout.N}")
            self._demand_vec = np.asarray(workload.vec(), np.float32)
        self.schedule = (compile_schedule(schedule, self.objective)
                         if schedule is not None else None)
        if scorer is not None:
            # Pre-built (usually cached) scorer — see api.get_scorer.
            self.scorer = scorer
        else:
            kw = {"chunk": chunk, "objective": self.objective,
                  "device": device}
            if fw_impl is not None:
                kw["fw_impl"] = fw_impl
            self.scorer = make_scorer(rep.layout, **kw)
        self.device = getattr(self.scorer, "device", None)
        if self.device is None:
            self.device = resolve_device(device)
        self._demand_t = (None if self._demand_vec is None else
                          torch.as_tensor(self._demand_vec,
                                          device=self.device))
        self.n_generated = 0
        self.n_score_calls = 0
        # The archive only collects search batches, never the norm-sample
        # draw below (those costs are computed against all-ones norms).
        self.archive: PopArchive | None = None
        self._pipeline: DevicePipeline | None = None
        if norm is not None:
            self.norm = norm
            self._norm_vec = norms_vec(self.norm)
        else:
            # Norm-sample draws are scored before normalizers exist; the
            # device cost of those calls is computed against all-ones norms
            # and never consumed.
            self._norm_vec = np.ones(NORM_DIM, np.float32)
            sols, graphs = self.generate_valid(
                lambda r: self.rep.random(r), rng, norm_samples)
            metrics = self.score(graphs)
            self.norm = CostNormalizers.from_samples(
                metrics, policy=self.objective.normalizer)
            self._norm_vec = norms_vec(self.norm)
        if archive_k:
            self.archive = PopArchive(archive_k, self.device)

    @property
    def norm_vec(self) -> np.ndarray:
        """Normalizers as the scorer's runtime [NORM_DIM] vector."""
        return self._norm_vec

    @property
    def demand_vec(self) -> np.ndarray | None:
        """The workload's packed demand operand (``None`` unless the
        objective carries a trace term — trace-lat / trace-thr)."""
        return self._demand_vec

    @property
    def demand_tensor(self) -> torch.Tensor | None:
        """:attr:`demand_vec` on the scorer's device."""
        return self._demand_t

    def _with_demand(self, batch: dict) -> dict:
        """Attach the workload's `_demand` rows to a scoring batch (no-op
        without a trace-term workload, or when rows — e.g. per-row stacked
        demand — are already present)."""
        if self._demand_t is None or "_demand" in batch:
            return batch
        P = int(batch["W"].shape[0])
        return dict(batch, _demand=self._demand_t.expand(P, -1))

    @property
    def weights_vec(self) -> np.ndarray:
        """Objective weights as the scorer's runtime weight vector."""
        return self._weights_vec

    def sched_weights(self, progress: float) -> np.ndarray | None:
        """The schedule's weight vector at ``progress`` in [0, 1] (``None``
        when no schedule is attached — requests then use the static
        objective weights)."""
        if self.schedule is None:
            return None
        return self.schedule.weights_at(progress)

    @property
    def degenerate_norms(self) -> tuple:
        """Traffic types whose normalizer fell back to 1.0 (see
        ``CostNormalizers.degenerate``)."""
        return self.norm.degenerate

    # -- generation with the paper's retry-until-connected semantics -------
    def generate_valid(self, op, rng: np.random.Generator, n: int,
                       max_tries: int = 500):
        sols, graphs = [], []
        while len(sols) < n:
            for _ in range(max_tries):
                s = op(rng)
                self.n_generated += 1
                g = self.rep.score_graph(s)
                if g.connected:
                    sols.append(s)
                    graphs.append(g)
                    break
            else:  # pragma: no cover - pathological architecture
                raise RuntimeError("could not generate a connected placement")
        return sols, graphs

    def score(self, graphs: list[ScoreGraph]) -> dict:
        return self.score_batch(stack_graphs(graphs))

    def score_batch(self, batch: dict, norms=None, weights=None,
                    fn=None) -> dict:
        """Score pre-stacked ScoreGraph arrays (numpy or tensors) into
        float32 numpy metrics.  ``norms`` / ``weights`` override the
        evaluator's normalizer / objective weight vectors (e.g. per-row
        vectors in stacked cross-run scoring, or a schedule's ramped
        weights).  ``fn`` substitutes the scorer call itself while keeping
        the evaluator's dispatch accounting."""
        self.n_score_calls += 1
        return (fn or self.scorer)(
            self._with_demand(batch),
            self._norm_vec if norms is None else norms,
            self._weights_vec if weights is None else weights)

    def archive_add(self, sols, costs, valid=None) -> None:
        """Fold scored host solutions into the population archive (no-op
        without one); sols are the representation's ``(a, b)`` tuples."""
        if self.archive is None or not len(sols):
            return
        self.archive.add(costs, np.stack([s[0] for s in sols]),
                         np.stack([s[1] for s in sols]), valid=valid)

    def costs_from(self, metrics: dict) -> np.ndarray:
        """Per-placement cost — the scorer's ``cost`` when present (always,
        for objective-built scorers); the float64 host evaluation of the
        objective otherwise."""
        if "cost" in metrics:
            return np.array(metrics["cost"])   # writable copy, not a view
        return objective_cost_host(metrics, self.objective, self.norm)

    def costs(self, graphs: list[ScoreGraph]) -> tuple[np.ndarray, dict]:
        metrics = self.score(graphs)
        return self.costs_from(metrics), metrics

    def pipeline(self) -> "DevicePipeline":
        """Cached device-resident generate→graph→score pipeline."""
        if self._pipeline is None:
            self._pipeline = DevicePipeline(self)
        return self._pipeline


def _metrics_row(metrics: dict, i: int) -> dict:
    return {k: float(v[i]) for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# Step-generator execution.  Optimizers yield *scoring requests* — either a
# list of host ScoreGraphs or a pre-stacked (device) batch dict, optionally
# carrying its own ``connected`` flags (the hetero Borůvka-component rule,
# which overrides the scorer's FW reachability) and/or a per-request
# ``weights`` vector (a schedule's ramped objective weights at the run's
# current progress) — and receive ``(costs, metrics)`` back.  _drive runs
# one generator against one Evaluator (the classic entry points below).
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _request_parts(req):
    """Normalize a scoring request to
    ``(batch, conn_override, size, weights_override)``."""
    wrow = None
    if isinstance(req, tuple):            # weight-tagged host graph list
        req, wrow = req
    if isinstance(req, dict):
        batch = dict(req)
        gconn = batch.pop("connected", None)
        wrow = batch.pop("weights", wrow)
        return batch, gconn, int(batch["W"].shape[0]), wrow
    return stack_graphs(req), None, len(req), wrow


def _tag(req, weights):
    """Attach a schedule's weight vector to a scoring request (no-op when
    ``weights`` is None — the evaluator's static weights then apply)."""
    if weights is None:
        return req
    if isinstance(req, dict):
        return dict(req, weights=weights)
    return (req, weights)


def _sched_progress(done, total, t0: float,
                    budget_s: float | None) -> float:
    """A run's progress fraction for schedule ramps: completed units over
    the unit budget when one is set, elapsed wall fraction otherwise."""
    if total:
        return min(1.0, done / total)
    if budget_s:
        return min(1.0, (time.monotonic() - t0) / budget_s)
    return 0.0


def _score_request(ev: Evaluator, req) -> tuple[np.ndarray, dict]:
    batch, gconn, _, wrow = _request_parts(req)
    metrics = ev.score_batch(batch, weights=wrow)
    if gconn is not None:
        metrics["connected"] = _host(gconn)
    return ev.costs_from(metrics), metrics


def _drive(gen, ev: Evaluator) -> OptResult:
    try:
        req = next(gen)
        while True:
            req = gen.send(_score_request(ev, req))
    except StopIteration as e:
        return e.value

# ---------------------------------------------------------------------------
# Best Random (§II-B1).
# ---------------------------------------------------------------------------

def best_random_steps(ev: Evaluator, rng: np.random.Generator, *,
                      time_budget_s: float | None = None,
                      max_evals: int | None = None,
                      batch: int = 32):
    """Generator form of :func:`best_random` (yields graphs to score).

    With a schedule attached to the evaluator, each batch is scored under
    the ramped weights at the run's progress, and the per-batch winners
    are re-ranked under the *final* (progress 1.0) weights at the end —
    costs from different ramp stages are not comparable, so ``best_*``
    always refers to the final weighting.
    """
    res = OptResult(None, np.inf, {})
    t0 = time.monotonic()
    pool_sols, pool_graphs = [], []
    while True:
        if time_budget_s is not None and time.monotonic() - t0 > time_budget_s:
            break
        if max_evals is not None and res.n_evaluated >= max_evals:
            break
        sols, graphs = ev.generate_valid(ev.rep.random, rng, batch)
        w = ev.sched_weights(_sched_progress(res.n_evaluated, max_evals,
                                             t0, time_budget_s))
        costs, metrics = yield _tag(graphs, w)
        ev.archive_add(sols, costs)
        res.n_evaluated += len(sols)
        i = int(np.argmin(costs))
        if ev.schedule is not None:
            pool_sols.append(sols[i])
            pool_graphs.append(graphs[i])
        if costs[i] < res.best_cost:
            res.best_cost = float(costs[i])
            res.best_sol = sols[i]
            res.best_metrics = _metrics_row(metrics, i)
        res.history.append((time.monotonic() - t0, res.n_evaluated,
                            res.best_cost))
    if ev.schedule is not None and pool_sols:
        costs, metrics = yield _tag(pool_graphs, ev.sched_weights(1.0))
        i = int(np.argmin(costs))
        res.best_cost = float(costs[i])
        res.best_sol = pool_sols[i]
        res.best_metrics = _metrics_row(metrics, i)
        res.history.append((time.monotonic() - t0, res.n_evaluated,
                            res.best_cost))
    res.n_generated = ev.n_generated
    res.normalizers = ev.norm
    if ev.archive is not None:
        res.archive = ev.archive.snapshot()
    return res


def best_random(ev: Evaluator, rng: np.random.Generator, *,
                time_budget_s: float | None = None,
                max_evals: int | None = None,
                batch: int = 32) -> OptResult:
    return _drive(best_random_steps(ev, rng, time_budget_s=time_budget_s,
                                    max_evals=max_evals, batch=batch), ev)


# ---------------------------------------------------------------------------
# Genetic Algorithm (§II-B2; parameters Table III/IV).
# ---------------------------------------------------------------------------

def genetic_algorithm_steps(ev: Evaluator, rng: np.random.Generator, *,
                            population: int, elitism: int, tournament: int,
                            p_mutation: float = 0.5,
                            time_budget_s: float | None = None,
                            max_generations: int | None = None):
    """Generator form of :func:`genetic_algorithm` (yields graphs).

    With a schedule, each generation is scored under the ramped weights at
    ``gen / max_generations`` (selection pressure hardens over the run)
    and the final population is re-ranked under the final weights for
    ``best_*``.
    """
    res = OptResult(None, np.inf, {})
    t0 = time.monotonic()
    sols, graphs = ev.generate_valid(ev.rep.random, rng, population)
    gen = 0
    while True:
        w = ev.sched_weights(_sched_progress(gen, max_generations, t0,
                                             time_budget_s))
        costs, metrics = yield _tag(graphs, w)
        ev.archive_add(sols, costs)
        res.n_evaluated += len(sols)
        order = np.argsort(costs)
        if costs[order[0]] < res.best_cost:
            res.best_cost = float(costs[order[0]])
            res.best_sol = sols[order[0]]
            res.best_metrics = _metrics_row(metrics, int(order[0]))
        res.history.append((time.monotonic() - t0, res.n_evaluated,
                            res.best_cost))
        gen += 1
        if time_budget_s is not None and time.monotonic() - t0 > time_budget_s:
            break
        if max_generations is not None and gen >= max_generations:
            break

        def tournament_pick() -> int:
            idx = rng.choice(len(sols), size=min(tournament, len(sols)),
                             replace=False)
            return int(idx[np.argmin(costs[idx])])

        elite_idx = order[:elitism]
        new_sols = [sols[i] for i in elite_idx]
        new_graphs = [graphs[i] for i in elite_idx]
        while len(new_sols) < population:
            pa, pb = sols[tournament_pick()], sols[tournament_pick()]

            def op(r, pa=pa, pb=pb):
                child = ev.rep.merge(pa, pb, r)
                if r.random() < p_mutation:
                    child = ev.rep.mutate(child, r)
                return child

            cs, cg = ev.generate_valid(op, rng, 1)
            new_sols += cs
            new_graphs += cg
        sols, graphs = new_sols, new_graphs
    if ev.schedule is not None:
        costs, metrics = yield _tag(graphs, ev.sched_weights(1.0))
        i = int(np.argmin(costs))
        res.best_cost = float(costs[i])
        res.best_sol = sols[i]
        res.best_metrics = _metrics_row(metrics, i)
        res.history.append((time.monotonic() - t0, res.n_evaluated,
                            res.best_cost))
    res.n_generated = ev.n_generated
    res.normalizers = ev.norm
    if ev.archive is not None:
        res.archive = ev.archive.snapshot()
    return res


def genetic_algorithm(ev: Evaluator, rng: np.random.Generator, *,
                      population: int, elitism: int, tournament: int,
                      p_mutation: float = 0.5,
                      time_budget_s: float | None = None,
                      max_generations: int | None = None) -> OptResult:
    return _drive(genetic_algorithm_steps(
        ev, rng, population=population, elitism=elitism,
        tournament=tournament, p_mutation=p_mutation,
        time_budget_s=time_budget_s, max_generations=max_generations), ev)


# ---------------------------------------------------------------------------
# Simulated Annealing (§II-B3; adaptive cooling, DESIGN.md §3).
#
# Cooling: after each block of L iterations at temperature T,
#     T <- alpha * T / (1 + beta * T / sigma_block)
# with sigma_block the std-dev of costs seen in the block (Aarts & van
# Laarhoven).  Table III/IV's (T0, L, alpha=1, beta) plug in directly.
# ``chains`` > 1 runs that many independent chains, evaluated as one batch
# per step (beyond-paper batching; chains never interact).
# ---------------------------------------------------------------------------

def _sa_accept(rng: np.random.Generator, delta: np.ndarray,
               temps: np.ndarray) -> np.ndarray:
    return (delta < 0) | (rng.random(len(delta))
                          < np.exp(-np.maximum(delta, 0)
                                   / np.maximum(temps, 1e-9)))


def _sa_cool(temps: np.ndarray, block_costs: list[np.ndarray],
             alpha: float, beta: float) -> np.ndarray:
    sigma = np.maximum(np.stack(block_costs).std(axis=0), 1e-6)
    return alpha * temps / (1.0 + beta * temps / sigma)


def simulated_annealing_steps(ev: Evaluator, rng: np.random.Generator, *,
                              t0_temp: float, block_len: int,
                              alpha: float = 1.0, beta: float = 5.0,
                              chains: int = 1,
                              time_budget_s: float | None = None,
                              max_iters: int | None = None):
    """Generator form of :func:`simulated_annealing` (yields graphs).

    With a schedule, proposals are accepted under the ramped weights at
    ``it / max_iters`` (chains traverse infeasible regions early, harden
    late) and the final chain states are re-ranked under the final
    weights for ``best_*``.
    """
    res = OptResult(None, np.inf, {})
    tstart = time.monotonic()
    sols, graphs = ev.generate_valid(ev.rep.random, rng, chains)
    costs, metrics = yield _tag(graphs, ev.sched_weights(0.0))
    ev.archive_add(sols, costs)
    res.n_evaluated += chains
    temps = np.full(chains, float(t0_temp))
    block_costs: list[np.ndarray] = []
    i = int(np.argmin(costs))
    res.best_cost = float(costs[i])
    res.best_sol = sols[i]
    res.best_metrics = _metrics_row(metrics, i)
    it = 0
    while True:
        if time_budget_s is not None and \
                time.monotonic() - tstart > time_budget_s:
            break
        if max_iters is not None and it >= max_iters:
            break
        nb_sols, nb_graphs = [], []
        for c in range(chains):
            s, g = ev.generate_valid(
                lambda r, c=c: ev.rep.mutate(sols[c], r), rng, 1)
            nb_sols += s
            nb_graphs += g
        w = ev.sched_weights(_sched_progress(it, max_iters, tstart,
                                             time_budget_s))
        if w is None:
            nb_costs, nb_metrics = yield nb_graphs
        else:
            # Ramped weights shift the incumbents' costs too: score the
            # proposals and the current chain states in one request so the
            # Metropolis delta compares both under the *current* weights.
            all_costs, nb_metrics = yield _tag(nb_graphs + graphs, w)
            nb_costs = all_costs[:chains]
            costs = all_costs[chains:]
            nb_metrics = {k: v[:chains] for k, v in nb_metrics.items()}
        ev.archive_add(nb_sols, nb_costs)
        res.n_evaluated += chains
        accept = _sa_accept(rng, nb_costs - costs, temps)
        for c in range(chains):
            if accept[c]:
                sols[c], graphs[c], costs[c] = \
                    nb_sols[c], nb_graphs[c], nb_costs[c]
        block_costs.append(nb_costs.copy())
        i = int(np.argmin(nb_costs))
        if nb_costs[i] < res.best_cost:
            res.best_cost = float(nb_costs[i])
            res.best_sol = nb_sols[i]
            res.best_metrics = _metrics_row(nb_metrics, i)
        it += 1
        if it % block_len == 0:
            temps = _sa_cool(temps, block_costs, alpha, beta)
            block_costs = []
        res.history.append((time.monotonic() - tstart, res.n_evaluated,
                            res.best_cost))
    if ev.schedule is not None:
        fcosts, fmetrics = yield _tag(graphs, ev.sched_weights(1.0))
        i = int(np.argmin(fcosts))
        res.best_cost = float(fcosts[i])
        res.best_sol = sols[i]
        res.best_metrics = _metrics_row(fmetrics, i)
        res.history.append((time.monotonic() - tstart, res.n_evaluated,
                            res.best_cost))
    res.n_generated = ev.n_generated
    res.normalizers = ev.norm
    if ev.archive is not None:
        res.archive = ev.archive.snapshot()
    return res


def simulated_annealing(ev: Evaluator, rng: np.random.Generator, *,
                        t0_temp: float, block_len: int,
                        alpha: float = 1.0, beta: float = 5.0,
                        chains: int = 1,
                        time_budget_s: float | None = None,
                        max_iters: int | None = None) -> OptResult:
    return _drive(simulated_annealing_steps(
        ev, rng, t0_temp=t0_temp, block_len=block_len, alpha=alpha,
        beta=beta, chains=chains, time_budget_s=time_budget_s,
        max_iters=max_iters), ev)



# ---------------------------------------------------------------------------
# Device-resident pipeline: batched generate→graph→score over stacked
# tensors.
# ---------------------------------------------------------------------------

class DevicePipeline:
    """Batched produce→graph→score path for both placement families.

    Couples the vectorized representation operators
    (:class:`placement_homog.HomogBatch` / :class:`placement_hetero.
    HeteroBatch`), the batched ScoreGraph assembly
    (:class:`topology.HomogGraphBatch` with masked selection over the static
    grid adjacency, or :class:`topology.HeteroGraphBatch` with the batched
    Borůvka MST + augmentation over padded candidate edges) and the
    Evaluator's scorer, all on the Evaluator's device.  Each ``sample_*``
    call produces a whole batch; invalid individuals are masked and
    resampled in batch (valid slots are kept) — the device equivalent of
    the paper's retry-until-connected loop.

    Homogeneous grids run generate→graph on the device end to end: the
    scorer receives device tensors, and W never crosses from the host.  The
    heterogeneous corner placement is inherently sequential per individual
    and stays host-side, but vectorized across the population
    (``HeteroBatch.geometry_batch``): the orders go to the host and the PHY
    positions come back, two copies a batch.  Connectivity masking uses the
    scorer's FW-derived ``connected`` for grids and the Borůvka-component
    flag (identical to the fixed host union-find rule) for hetero archs.
    Any other rep that exposes ``device_stage_key()`` / ``graph_batch()``
    / ``batch_ops()`` (the 3D families, :mod:`repro_torch.arch3d`) plugs
    in as a grid does, its ``tier_values`` bound as the graph build's
    trailing runtime operand.

    The produce→graph stages only depend on the arch statics (grid dims,
    mask, mutation mode) and the device, so they are cached module-wide and
    shared by every Evaluator over the same arch, with their static W
    already on the device.  The cache is a bounded LRU; live pipelines hold
    their own stage references, so eviction only drops the shared entry.
    """

    _STAGE_CACHE: LRUCache = LRUCache(32)

    @classmethod
    def clear_stage_cache(cls) -> None:
        """Drop the cached produce→graph stages and their static W
        matrices (mirrors ``api.clear_scorer_cache`` for the produce→graph
        side)."""
        cls._STAGE_CACHE.clear()

    @classmethod
    def _stages(cls, rep, device):
        dev = torch.device(device)
        if isinstance(rep, HomogRep):
            # The allowed-cell mask shapes every stage (generation,
            # mutation, area); two reps differing only in mask must not
            # share stages.
            mask_key = (None if rep.allowed is None
                        else rep.allowed.tobytes())
            key = ("homog", rep.arch, rep.R, rep.C, rep.mutation_mode,
                   mask_key, str(dev))
        elif isinstance(rep, HeteroRep):
            key = ("hetero", rep.arch, rep.mutation_mode, str(dev))
        elif hasattr(rep, "device_stage_key") and hasattr(rep, "graph_batch"):
            # Pluggable grid-like reps (repro_torch.arch3d.Homog3DRep): the
            # rep names its own cache key — tier latency values are
            # runtime operands and must NOT appear in it.
            key = rep.device_stage_key() + (str(dev),)
        else:
            raise TypeError(
                "device-resident batched optimizers require a HomogRep, "
                "HeteroRep, or a rep exposing device_stage_key()/"
                f"graph_batch()/batch_ops(), got {type(rep)!r}")
        if key in cls._STAGE_CACHE:
            return cls._STAGE_CACHE[key]
        ops = rep.batch_ops(dev)

        def _child_op(gen, pat, par, pbt, pbr, p_mut):
            t, r = ops.merge_batch(gen, pat, par, pbt, pbr)
            mt, mr = ops.mutate_batch(gen, t, r)
            m = torch.rand(t.shape[0], generator=gen, device=dev) < p_mut
            m = m.view((-1,) + (1,) * (t.dim() - 1))
            return torch.where(m, mt, t), torch.where(m, mr, r)

        if not isinstance(rep, (HomogRep, HeteroRep)):
            # The stages take the tier latency vector as a trailing operand
            # (DevicePipeline.__init__ binds the rep's values), so reps
            # that differ only in tsv/backbone factors share this entry.
            gb = rep.graph_batch(dev)

            def _gen(gen, n, tiers):
                t, r = ops.random_batch(gen, n)
                return t, r, gb.build(t, r, tiers)

            def _mut(gen, t, r, tiers):
                nt, nr = ops.mutate_batch(gen, t, r)
                return nt, nr, gb.build(nt, nr, tiers)

            def _child(gen, pat, par, pbt, pbr, p_mut, tiers):
                t, r = _child_op(gen, pat, par, pbt, pbr, p_mut)
                return t, r, gb.build(t, r, tiers)

            cls._STAGE_CACHE[key] = (ops, gb, _gen, _mut, _child, gb.build)
            return cls._STAGE_CACHE[key]
        if isinstance(rep, HomogRep):
            gb = HomogGraphBatch(rep.arch, rep.R, rep.C, area=rep.area,
                                 device=dev)
            _graph = gb.build
        else:
            gb = HeteroGraphBatch(rep.arch, device=dev)

            def _graph(o, r):
                # Host-side stage: corner placement is sequential per
                # individual; vectorized across the population.
                on, rn = o.cpu().numpy(), r.cpu().numpy()
                ppos, area = ops.geometry_batch(on, rn)
                batch = gb.build(torch.from_numpy(ppos).to(dev),
                                 torch.from_numpy(area).to(dev))
                ovf = batch.pop("overflow").cpu().numpy()
                for b in np.nonzero(ovf)[0]:
                    # Candidate set exceeded the device working set: take
                    # the exact host path for the affected rows.
                    g = rep.score_graph((on[b], rn[b]))
                    for k in ("W", "edges", "edge_mask", "edge_len"):
                        batch[k][b] = torch.from_numpy(getattr(g, k))
                    batch["connected"][b] = bool(g.connected)
                return batch

        def _gen(gen, n):
            t, r = ops.random_batch(gen, n)
            return t, r, _graph(t, r)

        def _mut(gen, t, r):
            nt, nr = ops.mutate_batch(gen, t, r)
            return nt, nr, _graph(nt, nr)

        def _child(gen, pat, par, pbt, pbr, p_mut):
            t, r = _child_op(gen, pat, par, pbt, pbr, p_mut)
            return t, r, _graph(t, r)

        cls._STAGE_CACHE[key] = (ops, gb, _gen, _mut, _child, _graph)
        return cls._STAGE_CACHE[key]

    def __init__(self, ev: Evaluator):
        self.ev = ev
        self.device = ev.device
        (self.ops, self.graphs, self._gen, self._mut,
         self._child, self._rebuild) = self._stages(ev.rep, ev.device)
        tiers = getattr(ev.rep, "tier_values", None)
        if tiers is not None:
            # Bind this rep's tier latency vector as the stages' trailing
            # runtime operand (shared stages across tier values).
            tv = torch.as_tensor(np.asarray(tiers, np.float32),
                                 device=self.device)
            _gen, _mut, _child, _reb = (self._gen, self._mut, self._child,
                                        self._rebuild)
            self._gen = lambda g, n: _gen(g, n, tv)
            self._mut = lambda g, t, r: _mut(g, t, r, tv)
            self._child = lambda g, pat, par, pbt, pbr, p: _child(
                g, pat, par, pbt, pbr, p, tv)
            self._rebuild = lambda t, r: _reb(t, r, tv)

    def rebuild(self, t, r) -> dict:
        """Graph batch for existing solutions (no RNG): re-scoring a
        population under different (e.g. schedule-final) weights."""
        return dict(self._rebuild(t, r))

    def _key(self, rng: np.random.Generator) -> torch.Generator:
        """One draw from the host stream seeds the device generator of one
        call, so the host draws that follow (tournaments, acceptance)
        consume the stream as the reference's do."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(rng.integers(2 ** 31 - 1)))
        return gen

    def _until_connected_steps(self, rng, make, n, max_rounds: int = 500,
                               weights=None):
        """Generator: run ``make`` until every slot holds a connected
        placement, yielding each produced batch as a scoring request and
        receiving ``(costs, metrics)`` back.

        ``make(gen, idx)`` produces one candidate per entry of ``idx``
        (slot indices; repeats allowed).  The first round fills every
        slot; later rounds only produce candidates for the still-invalid
        slots — padded to a power of two, as the reference pads them to
        bound its retraces, so ``n_generated`` counts the same sizes — and
        each slot takes its first connected candidate (per-slot rejection
        sampling, the same conditional distribution as the host retry
        loop).

        A graph stage may put its own ``connected`` into the batch dict
        (the hetero path's Borůvka-component flag, which matches the host
        union-find rule exactly); :func:`_score_request` then lets it
        override the scorer's FW-reachability output.

        ``weights`` (a schedule's runtime weight vector) tags every
        yielded request, so ramped costs apply to resample rounds too.

        Returns ``(t, r, metrics, costs)`` for the filled slots.
        """
        t, r, batch = make(self._key(rng), np.arange(n))
        costs, metrics = yield _tag(batch, weights)
        costs = np.array(costs)
        metrics = {k: np.array(v) for k, v in metrics.items()}
        self.ev.n_generated += n
        conn = metrics["connected"].astype(bool)
        if self.ev.archive is not None:
            self.ev.archive.add(costs, t, r, valid=conn)
        for _ in range(max_rounds):
            bad = np.nonzero(~conn)[0]
            if not len(bad):
                return t, r, metrics, costs
            size = 1 << (len(bad) - 1).bit_length()
            size = min(max(size, min(8, n)), n)
            idx = bad[np.arange(size) % len(bad)]
            t2, r2, batch2 = make(self._key(rng), idx)
            c2, m2 = yield _tag(batch2, weights)
            self.ev.n_generated += size
            conn2 = np.asarray(m2["connected"]).astype(bool)
            if self.ev.archive is not None:
                self.ev.archive.add(np.asarray(c2), t2, r2, valid=conn2)
            slots, rows = [], []
            for i in range(size):
                s = int(idx[i])
                if conn2[i] and not conn[s]:
                    conn[s] = True
                    slots.append(s)
                    rows.append(i)
            if slots:
                sl, rw = np.array(slots), np.array(rows)
                t, r = t.clone(), r.clone()
                t[_index(sl, t)] = t2[_index(rw, t2)]
                r[_index(sl, r)] = r2[_index(rw, r2)]
                for k, v in metrics.items():
                    v[sl] = np.asarray(m2[k])[rw]
                costs[sl] = np.asarray(c2)[rw]
        raise RuntimeError(  # pragma: no cover - pathological architecture
            "could not batch-generate connected placements")

    # -- generator forms (used by the *_batched_steps optimizers) -----------
    def sample_random_steps(self, rng, n: int, weights=None):
        return self._until_connected_steps(
            rng, lambda g, idx: self._gen(g, len(idx)), n, weights=weights)

    def sample_mutants_steps(self, rng, t, r, weights=None):
        def make(g, idx):
            i = _index(idx, t)
            return self._mut(g, t[i], r[i])
        return self._until_connected_steps(rng, make, t.shape[0],
                                           weights=weights)

    def sample_children_steps(self, rng, pat, par, pbt, pbr,
                              p_mutation: float, weights=None):
        def make(g, idx):
            i = _index(idx, pat)
            return self._child(g, pat[i], par[i], pbt[i], pbr[i],
                               p_mutation)
        return self._until_connected_steps(rng, make, pat.shape[0],
                                           weights=weights)

    # -- the direct form of sample_random_steps ------------------------------
    def _run(self, gen):
        try:
            req = next(gen)
            while True:
                req = gen.send(_score_request(self.ev, req))
        except StopIteration as e:
            t, r, metrics, _ = e.value
            return t, r, metrics

    def sample_random(self, rng, n: int):
        return self._run(self.sample_random_steps(rng, n))


def _index(idx, like: torch.Tensor) -> torch.Tensor:
    """Host row indices as a long tensor on ``like``'s device."""
    return torch.as_tensor(np.asarray(idx), dtype=torch.long,
                           device=like.device)


def _sol_at(t, r, i: int):
    """Device batch row -> host Sol (the host operators' int8 dtypes; a
    copy, never a view of the batch)."""
    return t[i].cpu().numpy().copy(), r[i].cpu().numpy().copy()


def best_random_batched_steps(ev: Evaluator, rng: np.random.Generator, *,
                              time_budget_s: float | None = None,
                              max_evals: int | None = None,
                              batch: int = 32):
    """BR over the device pipeline: one batched request per batch.  Under a
    schedule, batches score with ramped weights and the per-batch winners
    are re-ranked under the final weights (see ``best_random_steps``)."""
    pipe = ev.pipeline()
    res = OptResult(None, np.inf, {})
    t0 = time.monotonic()
    pool_t, pool_r = [], []
    while True:
        if time_budget_s is not None and time.monotonic() - t0 > time_budget_s:
            break
        if max_evals is not None and res.n_evaluated >= max_evals:
            break
        w = ev.sched_weights(_sched_progress(res.n_evaluated, max_evals,
                                             t0, time_budget_s))
        t, r, metrics, costs = yield from pipe.sample_random_steps(
            rng, batch, weights=w)
        res.n_evaluated += batch
        i = int(np.argmin(costs))
        if ev.schedule is not None:
            pool_t.append(t[i])
            pool_r.append(r[i])
        if costs[i] < res.best_cost:
            res.best_cost = float(costs[i])
            res.best_sol = _sol_at(t, r, i)
            res.best_metrics = _metrics_row(metrics, i)
        res.history.append((time.monotonic() - t0, res.n_evaluated,
                            res.best_cost))
    if ev.schedule is not None and pool_t:
        pt, pr = torch.stack(pool_t), torch.stack(pool_r)
        costs, metrics = yield _tag(pipe.rebuild(pt, pr),
                                    ev.sched_weights(1.0))
        i = int(np.argmin(costs))
        res.best_cost = float(costs[i])
        res.best_sol = _sol_at(pt, pr, i)
        res.best_metrics = _metrics_row(metrics, i)
        res.history.append((time.monotonic() - t0, res.n_evaluated,
                            res.best_cost))
    res.n_generated = ev.n_generated
    res.normalizers = ev.norm
    if ev.archive is not None:
        res.archive = ev.archive.snapshot()
    return res


def best_random_batched(ev: Evaluator, rng: np.random.Generator, *,
                        time_budget_s: float | None = None,
                        max_evals: int | None = None,
                        batch: int = 32) -> OptResult:
    """BR over the device pipeline: one batched call per batch."""
    return _drive(best_random_batched_steps(
        ev, rng, time_budget_s=time_budget_s, max_evals=max_evals,
        batch=batch), ev)


def genetic_algorithm_batched_steps(ev: Evaluator,
                                    rng: np.random.Generator, *,
                                    population: int, elitism: int,
                                    tournament: int,
                                    p_mutation: float = 0.5,
                                    time_budget_s: float | None = None,
                                    max_generations: int | None = None):
    """Generator form of :func:`genetic_algorithm_batched`.  Under a
    schedule, children score with the ramped weights at their generation,
    the retained population is re-scored under the current weights each
    generation (the host GA re-yields its whole population per
    generation, so elite costs never go stale against the ramp), and the
    final population is re-ranked under the final weights."""
    pipe = ev.pipeline()
    res = OptResult(None, np.inf, {})
    t0 = time.monotonic()
    t, r, metrics, costs = yield from pipe.sample_random_steps(
        rng, population, weights=ev.sched_weights(0.0))
    res.n_evaluated += population
    gen = 0
    while True:
        if ev.schedule is not None and gen > 0:
            # Unify the mixed-progress costs (elites were scored under an
            # earlier, weaker ramp stage) so selection pressure hardens
            # for the whole population, not just the fresh children.
            w_now = ev.sched_weights(_sched_progress(
                gen, max_generations, t0, time_budget_s))
            costs, metrics = yield _tag(pipe.rebuild(t, r), w_now)
        order = np.argsort(costs)
        if costs[order[0]] < res.best_cost:
            i = int(order[0])
            res.best_cost = float(costs[i])
            res.best_sol = _sol_at(t, r, i)
            res.best_metrics = _metrics_row(metrics, i)
        res.history.append((time.monotonic() - t0, res.n_evaluated,
                            res.best_cost))
        gen += 1
        if time_budget_s is not None and time.monotonic() - t0 > time_budget_s:
            break
        if max_generations is not None and gen >= max_generations:
            break

        def tournament_pick() -> int:
            idx = rng.choice(population, size=min(tournament, population),
                             replace=False)
            return int(idx[np.argmin(costs[idx])])

        n_child = population - elitism
        pa = _index([tournament_pick() for _ in range(n_child)], t)
        pb = _index([tournament_pick() for _ in range(n_child)], t)
        w = ev.sched_weights(_sched_progress(gen, max_generations, t0,
                                             time_budget_s))
        ct, cr, cm, ccosts = yield from pipe.sample_children_steps(
            rng, t[pa], r[pa], t[pb], r[pb], p_mutation, weights=w)
        res.n_evaluated += n_child
        elite = order[:elitism]
        t = torch.cat([t[_index(elite, t)], ct])
        r = torch.cat([r[_index(elite, r)], cr])
        metrics = {k: np.concatenate([v[elite], cm[k]])
                   for k, v in metrics.items()}
        costs = np.concatenate([costs[elite], ccosts])
    if ev.schedule is not None:
        costs, metrics = yield _tag(pipe.rebuild(t, r),
                                    ev.sched_weights(1.0))
        i = int(np.argmin(costs))
        res.best_cost = float(costs[i])
        res.best_sol = _sol_at(t, r, i)
        res.best_metrics = _metrics_row(metrics, i)
        res.history.append((time.monotonic() - t0, res.n_evaluated,
                            res.best_cost))
    res.n_generated = ev.n_generated
    res.normalizers = ev.norm
    if ev.archive is not None:
        res.archive = ev.archive.snapshot()
    return res


def genetic_algorithm_batched(ev: Evaluator, rng: np.random.Generator, *,
                              population: int, elitism: int, tournament: int,
                              p_mutation: float = 0.5,
                              time_budget_s: float | None = None,
                              max_generations: int | None = None
                              ) -> OptResult:
    """GA whose whole generation (merge + mutate + graph + score) is one
    batched device request; selection stays host-side on the cost vector.
    Individuals are scored once, at creation (the host loop re-scores the
    full population every generation), so ``n_evaluated`` counts scored
    placements: ``population + generations * (population - elitism)``."""
    return _drive(genetic_algorithm_batched_steps(
        ev, rng, population=population, elitism=elitism,
        tournament=tournament, p_mutation=p_mutation,
        time_budget_s=time_budget_s, max_generations=max_generations), ev)


def simulated_annealing_batched_steps(ev: Evaluator,
                                      rng: np.random.Generator, *,
                                      t0_temp: float, block_len: int,
                                      alpha: float = 1.0, beta: float = 5.0,
                                      chains: int = 1,
                                      time_budget_s: float | None = None,
                                      max_iters: int | None = None):
    """Generator form of :func:`simulated_annealing_batched`.  Under a
    schedule, proposals (and, for exact Metropolis deltas, the re-scored
    incumbents) use the ramped weights at the current iteration; the final
    chain states are re-ranked under the final weights."""
    pipe = ev.pipeline()
    res = OptResult(None, np.inf, {})
    tstart = time.monotonic()
    t, r, metrics, costs = yield from pipe.sample_random_steps(
        rng, chains, weights=ev.sched_weights(0.0))
    res.n_evaluated += chains
    temps = np.full(chains, float(t0_temp))
    block_costs: list[np.ndarray] = []
    i = int(np.argmin(costs))
    res.best_cost = float(costs[i])
    res.best_sol = _sol_at(t, r, i)
    res.best_metrics = _metrics_row(metrics, i)
    it = 0
    while True:
        if time_budget_s is not None and \
                time.monotonic() - tstart > time_budget_s:
            break
        if max_iters is not None and it >= max_iters:
            break
        w = ev.sched_weights(_sched_progress(it, max_iters, tstart,
                                             time_budget_s))
        nt, nr, nm, ncosts = yield from pipe.sample_mutants_steps(
            rng, t, r, weights=w)
        if w is not None:
            # Incumbent costs are stale under ramped weights: re-score the
            # chain states so the Metropolis delta is exact at progress t.
            costs, _ = yield _tag(pipe.rebuild(t, r), w)
        res.n_evaluated += chains
        accept = _sa_accept(rng, ncosts - costs, temps)
        acc = torch.as_tensor(accept, device=t.device).view(
            (-1,) + (1,) * (t.dim() - 1))
        t = torch.where(acc, nt, t)
        r = torch.where(acc, nr, r)
        costs = np.where(accept, ncosts, costs)
        block_costs.append(ncosts.copy())
        i = int(np.argmin(ncosts))
        if ncosts[i] < res.best_cost:
            res.best_cost = float(ncosts[i])
            res.best_sol = _sol_at(nt, nr, i)
            res.best_metrics = _metrics_row(nm, i)
        it += 1
        if it % block_len == 0:
            temps = _sa_cool(temps, block_costs, alpha, beta)
            block_costs = []
        res.history.append((time.monotonic() - tstart, res.n_evaluated,
                            res.best_cost))
    if ev.schedule is not None:
        fcosts, fmetrics = yield _tag(pipe.rebuild(t, r),
                                      ev.sched_weights(1.0))
        i = int(np.argmin(fcosts))
        res.best_cost = float(fcosts[i])
        res.best_sol = _sol_at(t, r, i)
        res.best_metrics = _metrics_row(fmetrics, i)
        res.history.append((time.monotonic() - tstart, res.n_evaluated,
                            res.best_cost))
    res.n_generated = ev.n_generated
    res.normalizers = ev.norm
    if ev.archive is not None:
        res.archive = ev.archive.snapshot()
    return res


def simulated_annealing_batched(ev: Evaluator, rng: np.random.Generator, *,
                                t0_temp: float, block_len: int,
                                alpha: float = 1.0, beta: float = 5.0,
                                chains: int = 1,
                                time_budget_s: float | None = None,
                                max_iters: int | None = None) -> OptResult:
    """SA whose chain-step (mutate all chains + graph + score) is one
    batched device request; Metropolis acceptance and adaptive cooling are
    host-side (identical to the host loop's rule on identically
    distributed proposals)."""
    return _drive(simulated_annealing_batched_steps(
        ev, rng, t0_temp=t0_temp, block_len=block_len, alpha=alpha,
        beta=beta, chains=chains, time_budget_s=time_budget_s,
        max_iters=max_iters), ev)


# ---------------------------------------------------------------------------
# Stacked execution of step generators (run_sweep cross-config batching).
# ---------------------------------------------------------------------------

def score_stacked(entries: list, *, score_fn=None
                  ) -> tuple[list, float]:
    """One stacked scoring round: concatenate several runs' pending
    scoring requests into a single batched scorer call with per-row
    normalizer and weight vectors, and split the results back.

    ``entries`` is a list of ``(parts, evaluator)`` pairs where ``parts``
    is the :func:`_request_parts` normalization of one scoring request;
    all evaluators must share one scorer (same layout / chunk / backend /
    objective structure / device).  Host requests (numpy graph stacks)
    and device requests (``-batched`` dicts of tensors) mix freely: each
    key is concatenated on the scorer's device in the dtype the scorer
    reads it in.  ``score_fn`` substitutes the scorer call for the whole
    stacked batch.  Returns ``(per_entry, t_score)`` with ``per_entry[i]
    = (costs, metrics)`` for entry ``i`` (per-request ``connected``
    overrides restored, costs via each run's own evaluator).
    """
    sizes = [p[2] for p, _ in entries]
    keys = sorted(entries[0][0][0])
    for j, (p, _) in enumerate(entries[1:], start=1):
        if sorted(p[0]) != keys:    # fail loudly on heterogeneous requests
            raise ValueError(
                f"stacked scoring requests disagree on batch keys: entry "
                f"0 has {keys}, entry {j} has {sorted(p[0])}")
    dev = entries[0][1].device
    cat = {k: torch.cat([batch_tensor(k, p[0][k], dev) for p, _ in entries])
           for k in keys}
    # Per-row workload demand: entries whose evaluator carries a trace
    # workload contribute their own demand rows, so requests over
    # *different* workloads stack into one call of the same scorer.
    # Mixing demand-bearing and demand-free entries would feed one term
    # structure two different batch layouts — fail loudly.
    dts = [ev.demand_tensor for _, ev in entries]
    if any(d is not None for d in dts):
        if any(d is None for d in dts):
            raise ValueError(
                "stacked scoring requests disagree on workloads: some "
                "evaluators carry a 'trace-lat' workload and some do not")
        cat["_demand"] = torch.cat(
            [d.expand(sz, -1) for d, sz in zip(dts, sizes)])
    norms = np.concatenate(
        [np.broadcast_to(ev.norm_vec, (sz, NORM_DIM))
         for (p, ev), sz in zip(entries, sizes)])
    weights = np.concatenate(
        [np.broadcast_to(np.asarray(
            ev.weights_vec if p[3] is None else p[3], np.float32),
            (sz, ev.weights_vec.shape[0]))
         for (p, ev), sz in zip(entries, sizes)])
    ts = time.monotonic()
    metrics = entries[0][1].score_batch(cat, norms=norms, weights=weights,
                                        fn=score_fn)
    t_score = time.monotonic() - ts
    out = []
    off = 0
    for (p, ev), sz in zip(entries, sizes):
        mi = {k: v[off:off + sz] for k, v in metrics.items()}
        if p[1] is not None:                   # per-request conn override
            mi["connected"] = _host(p[1])
        off += sz
        out.append((ev.costs_from(mi), mi))
    return out, t_score


def drive_stacked(items: list, *, score_fn=None
                  ) -> tuple[list, list[int], list[float]]:
    """Run several step-generators in lockstep, stacking each round's
    scoring requests into one batched scorer call.

    ``items`` is a list of ``(generator, evaluator)`` pairs whose
    evaluators share one scorer (same layout/chunk/backend/device and
    objective *structure* — objectives differing only in weights share).
    Each round collects the pending scoring requests of every live
    generator — host graph lists and device batch dicts mix freely —
    scores their concatenation once with *per-row normalizer and weight
    vectors* (each row carries its own run's norms and objective weights,
    so the scorer's ``cost`` is exact for every run), splits the metrics
    back (restoring per-request ``connected`` overrides), and resumes the
    generators.  Results are bit for bit those of driving each generator
    alone (the scorer's per-placement results do not depend on the
    chunk a placement falls in), with ~k fewer calls.  ``score_fn``
    routes every stacked call through a substitute scorer (see
    :func:`score_stacked`).

    Returns ``(results, n_generated, seconds)`` aligned with ``items`` —
    ``n_generated[i]`` is the number of placements generated by run ``i``
    (attributed exactly even though evaluators may be shared, because only
    one generator runs between two of its scoring requests), and
    ``seconds[i]`` is run ``i``'s attributed wall time: its own generator
    resumes plus each stacked scoring call split proportionally to its
    share of that call's batch.
    """
    n = len(items)
    results: list = [None] * n
    gen_counts = [0] * n
    secs = [0.0] * n
    reqs: dict[int, tuple] = {}

    def _resume(i, send=None):
        gen, ev = items[i]
        g0 = ev.n_generated
        ta = time.monotonic()
        try:
            req = next(gen) if send is None else gen.send(send)
            reqs[i] = _request_parts(req)
        except StopIteration as e:
            results[i] = e.value
        secs[i] += time.monotonic() - ta
        gen_counts[i] += ev.n_generated - g0

    for i in range(n):
        _resume(i)
    while reqs:
        order = sorted(reqs)
        parts = {i: reqs[i] for i in order}
        reqs = {}
        sizes = [parts[i][2] for i in order]
        per_entry, t_score = score_stacked(
            [(parts[i], items[i][1]) for i in order], score_fn=score_fn)
        total = max(sum(sizes), 1)
        for i, sz, (ci, mi) in zip(order, sizes, per_entry):
            secs[i] += t_score * (sz / total)
            _resume(i, (ci, mi))
    return results, gen_counts, secs


ALGORITHMS = {
    "br": best_random,
    "ga": genetic_algorithm,
    "sa": simulated_annealing,
    "br-batched": best_random_batched,
    "ga-batched": genetic_algorithm_batched,
    "sa-batched": simulated_annealing_batched,
}
