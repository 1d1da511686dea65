"""Placement-design service: continuous-batching over stacked sweeps.

The port of ``repro.serve.design``, on the card unless the engine is
built with ``device="cpu"``.  Many tenants submit
:class:`~repro_torch.core.api.DesignRequest`\\ s (an ``ExperimentConfig``,
optionally expanded over a :class:`~repro_torch.core.pareto.ParetoGridSpec`).
The engine turns every
(expanded config x algorithm x repetition) into one preemptible
step-generator unit (``api.stackable_steps``), and each tick:

1. expires timed-out requests and admits queued ones into free capacity,
2. groups every live unit's pending scoring request by scorer (same
   layout / chunk / backend / objective *structure* / shape key / device
   — the ``get_scorer`` LRU key), concatenates each group into **one**
   batched scorer call with per-row normalizer/weight vectors
   (:func:`repro_torch.core.optimize.score_stacked` — the same core
   ``run_sweep`` stacks with), optionally population-sharded across
   devices (:func:`repro_torch.sharding.population.shard_scorer`),
3. resumes the generators and streams one ``"progress"`` update per
   request (best-so-far cost), a ``"front"`` update whenever finished
   units extend the request's incremental Pareto front
   (:class:`repro_torch.core.pareto.IncrementalFront`), and a terminal
   ``"done"`` / ``"cancelled"`` / ``"timeout"`` / ``"error"`` update.

Unlike the lockstep ``drive_stacked`` (all runs start together), tenants
join and leave the stacked batch at arbitrary generations — continuous
batching, exactly the ``serve.engine`` slot loop with "decode one token"
replaced by "score one stacked generation".

Results are bit-for-bit what ``run_sweep(fold_repetitions=False)``
produces for the same configs (same evaluator-cache keys, same norm
sharing, same per-(seed, repetition, algorithm) RNG streams; a
``-batched`` unit seeds each device generator from its own host stream),
so batching/sharding never changes a tenant's answer.  Evaluators live in
a bounded LRU (scorers have their own in ``api.get_scorer``); entries
backing live runs are pinned so eviction can never invalidate an active
request.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np

from ..core.api import (DesignRequest, DesignResponse, DesignUpdate,
                        RunRecord, algo_seed, make_evaluator, make_rep,
                        shard_device_list, stackable_steps)
from ..core.cache import LRUCache
from ..core.chiplets import resolve_arch
from ..core.optimize import _request_parts, score_stacked
from ..core.pareto import (IncrementalFront, archive_candidates,
                           candidates_from_records)
from ..core.proxies import resolve_device
from ..core.registries import OPTIMIZERS


@dataclass
class DesignStats:
    """Engine counters (``SweepStats``-style; cumulative over the engine's
    lifetime).  ``score_calls`` counts scorer dispatches — with >= 2
    compatible tenants in flight it is strictly smaller than the sum of
    the tenants' sequential dispatches (pinned by tests)."""

    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    cancelled: int = 0
    timeouts: int = 0
    errors: int = 0
    ticks: int = 0
    score_calls: int = 0       # batched scorer dispatches
    stacked_rounds: int = 0    # dispatches that covered >= 2 units
    rows_scored: int = 0       # total placements scored
    evaluators_built: int = 0
    evaluator_evictions: int = 0
    shard_devices: int = 1


@dataclass
class _Unit:
    """One (expanded config, algorithm, repetition) run of a request."""

    req_id: str
    label: str                 # grid-point label ("base" for plain runs)
    cfg_i: int                 # expanded-config index within the request
    cfg: object                # the expanded ExperimentConfig
    objective: object          # its scalarization
    algo: str
    rep_i: int
    ev: object
    ev_key: tuple
    gen: object = None         # step generator (None once closed/sync)
    parts: tuple | None = None  # pending scoring request (_request_parts)
    result: object = None      # OptResult on completion
    record: RunRecord | None = None
    done: bool = False
    seconds: float = 0.0
    n_generated: int = 0
    best: float = float("inf")


@dataclass
class _ReqState:
    req: DesignRequest
    status: str = "queued"     # queued|active|done|cancelled|timeout|error
    units: list = field(default_factory=list)
    records: list = field(default_factory=list)
    updates: list = field(default_factory=list)
    front: IncrementalFront | None = None
    deadline: float | None = None
    t_submit: float = 0.0
    generation: int = 0        # scoring rounds this request took part in
    error: str | None = None
    _archive_seen: set = field(default_factory=set)

    @property
    def best(self) -> float | None:
        costs = [u.best for u in self.units if np.isfinite(u.best)]
        return min(costs) if costs else None


class DesignEngine:
    """The placement-design request engine (see module docstring).

    ``max_active`` bounds concurrently-running requests (queued requests
    wait); ``evaluator_cache`` bounds the evaluator LRU; ``device`` is
    where every tenant scores (default: the card); ``shard`` routes every
    stacked scoring call through the population-axis split
    (:func:`repro_torch.sharding.population.shard_scorer`; ``True`` takes
    every CUDA device on a CUDA ``device``, a list names the devices),
    bit for bit the unsharded result.
    """

    def __init__(self, *, max_active: int = 8, evaluator_cache: int = 16,
                 shard=False, device=None):
        self.stats = DesignStats()
        self.max_active = int(max_active)
        self.device = resolve_device(device)
        self.shard = shard is not None and shard is not False
        self._shard_devs = None
        self._shard_fns: dict[int, object] = {}  # id(scorer) -> wrapper
        if self.shard:
            from ..sharding.population import population_devices
            self._shard_devs = population_devices(
                shard_device_list(shard, self.device))
            self.stats.shard_devices = len(self._shard_devs)

        def _on_evict(key, ev):
            self.stats.evaluator_evictions += 1

        self._evs: LRUCache = LRUCache(evaluator_cache, on_evict=_on_evict)
        self._norms: dict[tuple, object] = {}    # nkey -> normalizer draw
        self._queue: list[str] = []
        self._reqs: dict[str, _ReqState] = {}
        self._n = 0

    # -- request lifecycle -------------------------------------------------
    def submit(self, req: DesignRequest | dict) -> str:
        """Enqueue a request; returns its id (assigned when empty)."""
        if not isinstance(req, DesignRequest):
            req = DesignRequest.from_dict(req)
        if not req.request_id:
            self._n += 1
            req = dataclasses.replace(req, request_id=f"req-{self._n}")
        rid = req.request_id
        if rid in self._reqs:
            raise ValueError(f"duplicate request_id {rid!r}")
        st = _ReqState(req, t_submit=time.monotonic())
        if req.timeout_s is not None:
            st.deadline = st.t_submit + float(req.timeout_s)
        self._reqs[rid] = st
        self._queue.append(rid)
        self.stats.submitted += 1
        return rid

    def cancel(self, request_id: str) -> bool:
        """Cancel a queued or active request (False if already terminal)."""
        st = self._reqs[request_id]
        if st.status not in ("queued", "active"):
            return False
        self._finish(st, "cancelled")
        self.stats.cancelled += 1
        return True

    def status(self, request_id: str) -> str:
        return self._reqs[request_id].status

    def updates(self, request_id: str) -> list[DesignUpdate]:
        """All updates streamed so far (terminal one included at the end)."""
        return list(self._reqs[request_id].updates)

    def result(self, request_id: str) -> DesignResponse | None:
        """Terminal :class:`DesignResponse`, or None while still running."""
        st = self._reqs[request_id]
        if st.status in ("queued", "active"):
            return None
        return DesignResponse(
            request_id=request_id, status=st.status,
            records=list(st.records),
            front=None if st.front is None else st.front.front(),
            updates=list(st.updates),
            seconds=time.monotonic() - st.t_submit, error=st.error)

    # -- evaluator cache ---------------------------------------------------
    def _evaluator(self, cfg, salt):
        """run_sweep's evaluator sharing, LRU-bounded: one evaluator per
        (structure key x objective x schedule), one normalizer draw per
        structure key.  Configs with an archive get a per-request ``salt``
        so tenants never share (and so cross-pollute) archives; the norm
        draw is seed-deterministic, so re-building after an eviction
        returns identical evaluators."""
        arch = resolve_arch(cfg.arch, cfg.config)
        nkey = (cfg.arch, cfg.config, cfg.seed, cfg.norm_samples, cfg.chunk,
                cfg.backend, cfg.mutation_mode, cfg.objective.normalizer)
        key = nkey + (cfg.objective, cfg.schedule, cfg.archive_k,
                      cfg.workload, salt)
        if key not in self._evs:
            rep = make_rep(arch, cfg.arch, cfg.mutation_mode)
            ev = make_evaluator(
                rep, arch, rng=np.random.default_rng(cfg.seed),
                norm_samples=cfg.norm_samples, chunk=cfg.chunk,
                backend=cfg.backend, objective=cfg.objective,
                schedule=cfg.schedule, norm=self._norms.get(nkey),
                archive_k=cfg.archive_k, workload=cfg.workload,
                device=self.device)
            self._evs[key] = ev
            self._norms.setdefault(nkey, ev.norm)
            self.stats.evaluators_built += 1
        return key, self._evs[key]

    def _score_fn(self, scorer):
        if not self.shard:
            return None
        sid = id(scorer)
        if sid not in self._shard_fns:
            from ..sharding.population import shard_scorer
            self._shard_fns[sid] = shard_scorer(scorer, self._shard_devs)
        return self._shard_fns[sid]

    # -- admission ---------------------------------------------------------
    def _expanded(self, req: DesignRequest):
        cfg = req.config
        if req.pareto_grid is None:
            return [("base", cfg.objective, cfg)]
        return [(label, obj, dataclasses.replace(cfg, objective=obj))
                for label, obj in req.pareto_grid.points(cfg.objective)]

    def _admit(self, st: _ReqState) -> None:
        st.status = "active"
        self.stats.admitted += 1
        req = st.req
        if req.pareto_grid is not None or req.config.archive_k > 0:
            st.front = IncrementalFront(req.config, device=self.device)
        for cfg_i, (label, obj, cfg) in enumerate(self._expanded(req)):
            salt = req.request_id if cfg.archive_k > 0 else None
            ev_key, ev = self._evaluator(cfg, salt)
            for algo in cfg.algorithms:
                entry = OPTIMIZERS.get(algo)
                params = cfg.resolved_params(algo)
                steps = stackable_steps(algo)
                for rep_i in range(cfg.repetitions):
                    u = _Unit(req.request_id, label, cfg_i, cfg, obj, algo,
                              rep_i, ev, ev_key)
                    st.units.append(u)
                    rng = np.random.default_rng(
                        algo_seed(cfg.seed, rep_i, algo))
                    if steps is None or cfg.budget.seconds is not None:
                        # Not preemptible (unregistered stepper, or a
                        # wall-clock budget that interleaving would eat):
                        # run to completion at admission.
                        ta, g0 = time.monotonic(), ev.n_generated
                        c0 = ev.n_score_calls
                        u.result = entry.fn(ev, rng, cfg.budget, params)
                        u.seconds = time.monotonic() - ta
                        u.n_generated = ev.n_generated - g0
                        u.best = float(u.result.best_cost)
                        u.done = True
                        self.stats.score_calls += ev.n_score_calls - c0
                        self.stats.rows_scored += u.result.n_evaluated
                        self._record(st, u)
                        st.updates.append(DesignUpdate(
                            req.request_id, "progress",
                            tick=self.stats.ticks,
                            generation=st.generation, best_cost=st.best))
                    else:
                        self._evs.pin(ev_key)
                        u.gen = steps(ev, rng, cfg.budget, params)
                        self._resume(u)        # prime to the first request
                        if u.done:             # degenerate: no scoring round
                            self._record(st, u)
        if all(u.done for u in st.units):
            self._finish(st, "done")

    # -- unit stepping -----------------------------------------------------
    def _resume(self, u: _Unit, send=None) -> None:
        g0, ta = u.ev.n_generated, time.monotonic()
        try:
            r = next(u.gen) if send is None else u.gen.send(send)
            u.parts = _request_parts(r)
        except StopIteration as e:
            u.result, u.done, u.parts = e.value, True, None
            u.best = float(u.result.best_cost)
            self._release(u)
        u.seconds += time.monotonic() - ta
        u.n_generated += u.ev.n_generated - g0

    def _release(self, u: _Unit) -> None:
        if u.gen is not None:
            u.gen.close()
            u.gen = None
            self._evs.unpin(u.ev_key)

    def _record(self, st: _ReqState, u: _Unit) -> None:
        u.record = RunRecord(
            u.cfg.arch, u.cfg.config, u.algo, u.rep_i, u.result, u.seconds,
            degenerate_norms=u.ev.degenerate_norms)
        # Completion order varies with budgets; the response's records stay
        # in canonical unit order (config-major), like run_sweep's.
        st.records = [x.record for x in st.units if x.record is not None]
        if st.front is not None:
            cands = candidates_from_records(
                [(u.label, u.cfg_i, u.objective, u.record)])
            snap = u.result.archive
            if snap is not None:
                # The archive is per-evaluator (shared by the request's
                # repetitions/algorithms on one expanded config); dedup
                # snapshots by content so rows are added once.
                h = np.asarray(snap["costs"]).tobytes()
                if h not in st._archive_seen:
                    st._archive_seen.add(h)
                    cands += archive_candidates(
                        u.label, u.cfg_i, u.objective, snap,
                        normalizers=u.result.normalizers)
            st.front.add(cands)

    def _finish(self, st: _ReqState, status: str) -> None:
        for u in st.units:
            self._release(u)
        if st.status == "queued":
            self._queue.remove(st.req.request_id)
        st.status = status
        if status == "done":
            self.stats.completed += 1
            if st.front is not None:
                st.updates.append(DesignUpdate(
                    st.req.request_id, "front", tick=self.stats.ticks,
                    generation=st.generation, best_cost=st.best,
                    front=st.front.front()))
        st.updates.append(DesignUpdate(
            st.req.request_id, status, tick=self.stats.ticks,
            generation=st.generation, best_cost=st.best, error=st.error))

    # -- the tick loop -----------------------------------------------------
    def _active(self) -> list[_ReqState]:
        return [s for s in self._reqs.values() if s.status == "active"]

    def step(self) -> bool:
        """One engine tick; False when nothing is queued or running."""
        if not self._queue and not self._active():
            return False
        self.stats.ticks += 1
        now = time.monotonic()

        # 1. Expire (queued requests included: timeout_s=0 never runs).
        for st in list(self._reqs.values()):
            if st.status in ("queued", "active") and \
                    st.deadline is not None and now >= st.deadline:
                self._finish(st, "timeout")
                self.stats.timeouts += 1

        # 2. Admit into free capacity, FIFO.
        while self._queue and len(self._active()) < self.max_active:
            st = self._reqs[self._queue.pop(0)]
            try:
                self._admit(st)
            except Exception as e:            # bad config: fail the request
                st.error = f"{type(e).__name__}: {e}"
                self._finish(st, "error")
                self.stats.errors += 1

        # 3. One stacked scoring round per compiled scorer.
        live = [u for st in self._active() for u in st.units
                if u.parts is not None]
        groups: dict[int, list[_Unit]] = {}
        for u in live:
            groups.setdefault(id(u.ev.scorer), []).append(u)
        touched: dict[str, bool] = {}
        for us in groups.values():
            entries = [(u.parts, u.ev) for u in us]
            sizes = [p[2] for p, _ in entries]
            score_fn = self._score_fn(us[0].ev.scorer)
            try:
                per_entry, t_score = score_stacked(entries,
                                                   score_fn=score_fn)
            except Exception as e:
                for u in us:
                    st = self._reqs[u.req_id]
                    if st.status == "active":
                        st.error = f"{type(e).__name__}: {e}"
                        self._finish(st, "error")
                        self.stats.errors += 1
                continue
            self.stats.score_calls += 1
            self.stats.rows_scored += sum(sizes)
            if len(us) > 1:
                self.stats.stacked_rounds += 1
            total = max(sum(sizes), 1)
            for u, sz, (costs, mi) in zip(us, sizes, per_entry):
                u.seconds += t_score * (sz / total)
                u.parts = None
                c = np.asarray(costs)
                if c.size:
                    u.best = min(u.best, float(np.min(c)))
                self._resume(u, (costs, mi))
                touched[u.req_id] = True
                if u.done:
                    self._record(self._reqs[u.req_id], u)

        # 4. Stream progress; finalize requests whose units all finished.
        for rid in touched:
            st = self._reqs[rid]
            if st.status != "active":
                continue
            st.generation += 1
            st.updates.append(DesignUpdate(
                rid, "progress", tick=self.stats.ticks,
                generation=st.generation, best_cost=st.best))
            if all(u.done for u in st.units):
                self._finish(st, "done")
        return True

    def run(self, max_ticks: int = 100_000) -> int:
        """Drive ticks until every request is terminal; returns #ticks."""
        ticks = 0
        while ticks < max_ticks and self.step():
            ticks += 1
        return ticks
