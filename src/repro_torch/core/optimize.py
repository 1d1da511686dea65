"""Optimization algorithms (paper §II-B) over placement representations.

The port of the host half of ``repro.core.optimize``: Best Random (BR),
Genetic Algorithm (GA) and Simulated Annealing (SA), all driven through the
four representation functions random_placement / mutate / merge / get_cost
(§IV).  Invalid placements (unconnected chiplets) cause the generating
operation to be repeated, exactly as in §V-A / §VI-A.

Individuals are generated, mutated and merged one at a time in host numpy
from a ``np.random.Generator`` (so the same seed gives the reference's
placements), and each GA generation / SA chain-block is scored in one
batched call of the Evaluator's scorer on its device.  The optimizers are
*step generators* (``best_random_steps`` / ``genetic_algorithm_steps`` /
``simulated_annealing_steps``) that yield scoring requests and receive
``(costs, metrics)``; ``_drive`` runs one against one Evaluator.

Not ported yet: the population archive (``PopArchive``, ROADMAP queue 1
item 13), the device-resident pipeline and ``*_batched`` drivers, and
stacked cross-run scoring (``score_stacked`` / ``drive_stacked``, queue 1
item 7).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .cost import CostNormalizers
from .objective import (NORM_DIM, Objective, compile_schedule, norms_vec,
                        objective_cost_host, weights_vec)
from .proxies import make_scorer
from .topology import ScoreGraph, stack_graphs


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
    """

    def __init__(self, rep, arch, *, rng: np.random.Generator,
                 norm_samples: int = 500, chunk: int = 16, fw_impl=None,
                 scorer=None, objective: Objective | None = None,
                 schedule=None, norm: CostNormalizers | None = None,
                 archive_k: int = 0, workload=None, device=None):
        if archive_k:
            raise NotImplementedError(
                "the population archive (archive_k > 0) is not ported yet: "
                "ROADMAP queue 1 item 13")
        if workload is not None:
            raise NotImplementedError(
                "traffic workloads are not ported yet: ROADMAP queue 1 "
                "item 11")
        self.rep = rep
        self.arch = arch
        self.objective = (objective if objective is not None
                          else Objective.from_arch(arch))
        self._weights_vec = weights_vec(self.objective)
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
        self.n_generated = 0
        self.n_score_calls = 0
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

    @property
    def norm_vec(self) -> np.ndarray:
        """Normalizers as the scorer's runtime [NORM_DIM] vector."""
        return self._norm_vec

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

    def score_batch(self, batch: dict, norms=None, weights=None) -> dict:
        """Score pre-stacked ScoreGraph arrays (numpy or tensors) into
        float32 numpy metrics.  ``norms`` / ``weights`` override the
        evaluator's normalizer / objective weight vectors (e.g. a
        schedule's ramped weights)."""
        self.n_score_calls += 1
        return self.scorer(
            batch,
            self._norm_vec if norms is None else norms,
            self._weights_vec if weights is None else weights)

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


def _metrics_row(metrics: dict, i: int) -> dict:
    return {k: float(v[i]) for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# Step-generator execution.  Optimizers yield *scoring requests* — a list of
# host ScoreGraphs, optionally tagged with a per-request ``weights`` vector
# (a schedule's ramped objective weights at the run's current progress) —
# and receive ``(costs, metrics)`` back.  _drive runs one generator against
# one Evaluator (the classic entry points below).
# ---------------------------------------------------------------------------

def _tag(req, weights):
    """Attach a schedule's weight vector to a scoring request (no-op when
    ``weights`` is None — the evaluator's static weights then apply)."""
    return req if weights is None else (req, weights)


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
    graphs, wrow = req if isinstance(req, tuple) else (req, None)
    metrics = ev.score_batch(stack_graphs(graphs), weights=wrow)
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

