"""The port's population archive, design service and population sharding
against the JAX package, on the CPU.

* **archive** — ``PopArchive`` equals the reference's on the same scored
  batches, costs and rows bit for bit: equal-cost dedup (first seen
  kept, -0.0 equal to +0.0), +inf and NaN rows (NaN sorts last and never
  dedups), a ``valid`` mask, more rows than K.  ``OptResult.archive`` of
  host ``br`` / ``ga`` / ``sa`` on homog32 equals the reference's from
  the same seed, the whole record bit for bit, with the reference's
  Evaluator scoring through the port's scorer: the two packages' float32
  link-load sums run in another order and differ in the last bit on some
  placements, which would move an archived cost by one ulp and test the
  scorers rather than the archive.  ``archive_candidates`` fed from a
  real archive gives the reference's front (the same candidates, labels
  and placements; the cost matrix within one float32 ulp, for the same
  reason).
* **schema** — ``DesignRequest`` / ``DesignUpdate`` / ``DesignResponse``
  dicts cross between the packages.
* **engine** — ``DesignEngine`` equals the port's own
  ``run_sweep(fold_repetitions=False)`` bit for bit (``-batched`` tenants
  included; its records keep the evaluator's cumulative ``n_generated``,
  as the reference engine's do), and the reference engine on host-driver
  requests (the same ``best_sol``, bit-equal costs at the sizes
  ``tests/test_torch_sweep.py`` holds bit-equal, the same update kinds in
  the same order); cancel, timeout 0, a bad config isolated, FIFO under
  ``max_active``, the evaluator LRU's eviction counter, and fewer scorer
  calls than the tenants' sequential sum.
* **sharding** — ``shard_scorer`` over ``["cpu", "cpu"]`` at an odd batch
  and ``run_sweep(shard=...)`` / ``DesignEngine(shard=...)`` equal the
  unsharded path bit for bit.

Budgets stay tiny; the reference runs on ``"fw-ref"``, the port on its
default backend (the plain FW on the CPU).
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import optimize as jopt
from repro.core import pareto as jpareto
from repro.serve.design import DesignEngine as JEngine
from repro_torch import interop
from repro_torch.core import api as tapi
from repro_torch.core import optimize as topt
from repro_torch.core import pareto as tpareto
from repro_torch.core.chiplets import paper_arch
from repro_torch.core.topology import stack_graphs
from repro_torch.serve.design import DesignEngine
from repro_torch.sharding.population import (n_pop_devices,
                                             population_devices,
                                             shard_scorer)
from _torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
TWO_CPUS = ["cpu", "cpu"]
PARAMS = {"br": {"batch": 4}, "br-batched": {"batch": 4},
          "ga": {"population": 6, "elitism": 2, "tournament": 2},
          "ga-batched": {"population": 6, "elitism": 2, "tournament": 2},
          "sa": {"chains": 2}, "sa-batched": {"chains": 2}}
GRID = {"term_weights": {"area": (0.5, 2.0)}}


def _dict(arch="homog32", algorithms=("br", "ga"), **kw):
    d = dict(arch=arch, config="placeit", algorithms=list(algorithms),
             budget={"evals": 8}, norm_samples=3, chunk=4,
             params={a: PARAMS[a] for a in algorithms})
    d.update(kw)
    return d


def _pair(**kw):
    d = _dict(**kw)
    return (japi.ExperimentConfig.from_dict(dict(d, backend="fw-ref")),
            tapi.ExperimentConfig.from_dict(d))


def _cfg(**kw):
    return tapi.ExperimentConfig.from_dict(_dict(**kw))


def _cfg3d(**kw):
    """The engine's lifecycle tests run on stack3d32 (V = 192 in placeit,
    the cheapest arch on the CPU)."""
    return _cfg(arch="stack3d32", **kw)


def _same_record(a, b):
    """``a`` the reference's (or the unsharded / sweep) record."""
    ra, rb = a.result, b.result
    assert (b.algorithm, b.repetition) == (a.algorithm, a.repetition)
    for x, y in zip(interop.sol_from_arrays(*ra.best_sol), rb.best_sol):
        np.testing.assert_array_equal(y, x)
    assert np.float32(rb.best_cost).tobytes() == \
        np.float32(ra.best_cost).tobytes()
    assert rb.n_evaluated == ra.n_evaluated
    assert [(n, c) for _, n, c in rb.history] == \
        [(n, c) for _, n, c in ra.history]
    _same_archive(ra.archive, rb.archive)


def _same_archive(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    for k in ("costs", "a", "b"):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(y, x, err_msg=k)


# ---------------------------------------------------------------------------
# The population archive.
# ---------------------------------------------------------------------------

def _batches(kind: str, seed: int = 0):
    """Scored batches ``(costs, a, b, valid)`` that exercise the merge."""
    rng = np.random.default_rng(seed)

    def rows(n):
        return (rng.integers(-1, 3, (n, 3, 2)).astype(np.int8),
                rng.integers(0, 4, (n, 3, 2)).astype(np.int8))

    out = []
    for i in range(4):
        n = int(rng.integers(3, 9))
        c = rng.choice(np.float32([1.5, 2.0, 2.25, 3.0, 0.5]), n)
        if kind == "distinct":
            c = rng.random(n).astype(np.float32) * 10
        elif kind == "specials":
            c = c.copy()
            c[0] = np.inf
            c[-1] = np.nan
            if n > 3:
                c[1], c[2] = np.float32(-0.0), np.float32(0.0)
        valid = None
        if kind == "valid":
            valid = rng.random(n) < 0.6
        out.append((c.astype(np.float32),) + rows(n) + (valid,))
    if kind == "specials":       # a batch with nothing finite in it
        out.append((np.full(3, np.nan, np.float32),) + rows(3) + (None,))
    return out


@pytest.mark.parametrize("k", [1, 4, 64])
@pytest.mark.parametrize("kind", ["distinct", "ties", "specials", "valid"])
def test_pop_archive_matches_reference(kind, k):
    aj, at = jopt.PopArchive(k), topt.PopArchive(k, CPU)
    for costs, a, b, valid in _batches(kind):
        aj.add(costs, a, b, valid=valid)
        at.add(costs, torch.from_numpy(a), b, valid=valid)
        sj = [np.asarray(x) for x in aj._state]
        st = [x.numpy() for x in at._state]
        for x, y in zip(sj, st):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(y, x)
    assert at.n_added == aj.n_added
    _same_archive(aj.snapshot(), at.snapshot())


def test_pop_archive_empty_and_bad_size():
    assert topt.PopArchive(3, CPU).snapshot() is None
    arc = topt.PopArchive(3, CPU)
    arc.add(np.full(2, np.inf, np.float32), np.zeros((2, 2), np.int8),
            np.zeros((2, 2), np.int8))
    assert arc.snapshot() is None
    with pytest.raises(ValueError, match=">= 1"):
        topt.PopArchive(0)


@pytest.mark.parametrize("algo", ["br", "ga", "sa"])
def test_host_driver_archives_match_reference(algo):
    """The port's host driver and archive against the reference's, both
    scoring through one scorer (the port's): the records, archives
    included, bit for bit."""
    cj, ct = _pair(algorithms=(algo,), archive_k=8, seed=1,
                   budget={"evals": 12})
    arch_j = japi.resolve_arch(cj.arch, cj.config)
    arch_t = tapi.resolve_arch(ct.arch, ct.config)
    rep_j = japi.make_rep(arch_j, cj.arch)
    rep_t = tapi.make_rep(arch_t, ct.arch)
    ev_t = tapi.make_evaluator(rep_t, arch_t, rng=np.random.default_rng(1),
                               norm_samples=3, chunk=4, archive_k=8,
                               device=CPU)
    ev_j = jopt.Evaluator(rep_j, arch_j, rng=np.random.default_rng(1),
                          norm_samples=3, scorer=ev_t.scorer, archive_k=8)
    np.testing.assert_array_equal(ev_t.norm_vec, ev_j.norm_vec)
    seed = tapi.algo_seed(1, 0, algo)
    assert seed == japi.algo_seed(1, 0, algo)
    rj = japi.OPTIMIZERS.get(algo).fn(
        ev_j, np.random.default_rng(seed), cj.budget,
        cj.resolved_params(algo))
    rt = tapi.OPTIMIZERS.get(algo).fn(
        ev_t, np.random.default_rng(seed), ct.budget,
        ct.resolved_params(algo))
    _same_record(japi.RunRecord("homog32", "placeit", algo, 0, rj, 0.0),
                 tapi.RunRecord("homog32", "placeit", algo, 0, rt, 0.0))
    assert rt.n_generated == rj.n_generated
    assert ev_t.archive.n_added == ev_j.archive.n_added
    snap = rt.archive
    assert 0 < len(snap["costs"]) <= 8
    assert snap["a"].shape[1:] == (8, 5)
    assert np.all(np.diff(snap["costs"]) >= 0)
    assert snap["costs"][0] == np.float32(rt.best_cost)


def test_batched_driver_archives_collect_every_round():
    """The ``-batched`` drivers archive every scored round, resample
    rounds included (``valid`` = connected): the evaluator's archive
    grows across its runs, and its head is at most the best winner (a
    resample round may score a second connected candidate for a slot
    and keep the first)."""
    cfg = _cfg3d(algorithms=("ga-batched", "br-batched", "sa-batched"),
                 archive_k=5)
    runs = tapi.run_experiment(cfg, device=CPU)
    heads = [r.result.archive["costs"][0] for r in runs]
    assert heads == sorted(heads, reverse=True)
    snap = runs[-1].result.archive          # the evaluator's full archive
    assert len(snap["costs"]) == 5
    assert np.all(np.diff(snap["costs"]) > 0)
    assert snap["costs"][0] <= np.float32(min(r.result.best_cost
                                              for r in runs))
    assert snap["a"].dtype == np.int8 and snap["a"].shape[1:] == (4, 4, 2)


def test_archive_candidates_from_real_archive_match_reference():
    cj, ct = _pair(algorithms=("br",), budget={"evals": 8}, archive_k=5)
    fj = jpareto.run_pareto(cj, GRID)
    ft = tpareto.run_pareto(ct, GRID, device=CPU)
    assert ft.n_candidates == fj.n_candidates > 4
    assert sum(p.algorithm == "archive" for p in ft.points) == \
        sum(p.algorithm == "archive" for p in fj.points)
    assert [p.label for p in ft.points] == [p.label for p in fj.points]
    np.testing.assert_array_max_ulp(np.asarray(ft.matrix, np.float32),
                                    np.asarray(fj.matrix, np.float32), 1)
    for p, q in zip(ft.points, fj.points):
        assert p.placement == q.placement
    # ... and the port's archive snapshot feeds archive_candidates.
    rec = tapi.run_sweep([ct], device=CPU).records[0]
    cands = tpareto.archive_candidates("base", 0, ct.objective,
                                       rec.result.archive)
    assert [c.cost for c in cands] == \
        [float(x) for x in rec.result.archive["costs"]]
    assert all(c.algorithm == "archive" for c in cands)


# ---------------------------------------------------------------------------
# The request schema.
# ---------------------------------------------------------------------------

def test_design_schema_crosses_packages():
    d = _dict(archive_k=8)
    req_t = tapi.DesignRequest(config=tapi.ExperimentConfig.from_dict(d),
                               request_id="t1", pareto_grid=GRID,
                               timeout_s=5.0)
    req_j = japi.DesignRequest.from_dict(req_t.to_dict())
    assert req_j.to_dict() == req_t.to_dict()
    back = tapi.DesignRequest.from_dict(req_j.to_dict())
    assert back.config == req_t.config and back.config.archive_k == 8
    assert back.pareto_grid.n_points == 2 and back.timeout_s == 5.0
    with pytest.raises(ValueError, match="unknown DesignRequest"):
        tapi.DesignRequest.from_dict({"config": d, "nope": 1})
    upd = dict(request_id="r1", kind="progress", tick=3, generation=2,
               best_cost=1.5)
    assert tapi.DesignUpdate(**upd).to_dict() == \
        japi.DesignUpdate(**upd).to_dict()
    resp = dict(request_id="r1", status="cancelled", seconds=0.5,
                error="x")
    assert tapi.DesignResponse(**resp).to_dict() == \
        japi.DesignResponse(**resp).to_dict()
    assert tapi.DesignResponse(**resp).best_cost is None


def test_experiment_config_archive_k_serde():
    cj, ct = _pair(archive_k=5)
    assert tapi.ExperimentConfig.from_dict(ct.to_dict()) == ct
    assert japi.ExperimentConfig.from_json(ct.to_json()).archive_k == 5
    sc = tapi.SweepConfig(configs=(ct,), shard=True)
    rt = tapi.SweepConfig.from_json(sc.to_json())
    assert rt.shard is True and rt.configs[0] == ct
    assert japi.SweepConfig.from_json(sc.to_json()).shard is True


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------

ENGINE_CFGS = (
    dict(seed=0),
    dict(arch="stack3d32", seed=1, algorithms=("br", "ga-batched")),
    dict(arch="stack3d32", seed=2,
         algorithms=("sa", "br-batched", "sa-batched"), archive_k=4),
    dict(arch="stack3d32", seed=0, algorithms=("ga", "ga-batched"),
         archive_k=4),
)


def _engine_records(cfgs, **kw):
    eng = DesignEngine(device=CPU, **kw)
    rids = [eng.submit(tapi.DesignRequest(config=c)) for c in cfgs]
    eng.run()
    resps = [eng.result(r) for r in rids]
    assert all(r.status == "done" for r in resps), [r.error for r in resps]
    return eng, resps


def test_engine_equals_run_sweep_bitwise():
    cfgs = [_cfg(**kw) for kw in ENGINE_CFGS]
    eng, resps = _engine_records(cfgs)
    sweep = tapi.run_sweep(cfgs, fold_repetitions=False, device=CPU)
    recs = [r for resp in resps for r in resp.records]
    assert len(recs) == len(sweep.records) == 9
    for a, b in zip(sweep.records, recs):
        _same_record(a, b)
    assert eng.stats.stacked_rounds >= 1
    assert eng.stats.completed == len(cfgs)


def test_engine_matches_reference_engine():
    pairs = [_pair(seed=s, algorithms=("br", "ga"), config="baseline",
                   norm_samples=8, budget={"evals": 12}) for s in (0, 1)]
    ej, et = JEngine(), DesignEngine(device=CPU)
    for cj, ct in pairs:
        ej.submit(japi.DesignRequest(config=cj))
        et.submit(tapi.DesignRequest(config=ct))
    ej.run()
    et.run()
    for rid in ("req-1", "req-2"):
        rj, rt = ej.result(rid), et.result(rid)
        assert rt.status == rj.status == "done"
        for a, b in zip(rj.records, rt.records):
            _same_record(a, b)
        assert [u.kind for u in rt.updates] == [u.kind for u in rj.updates]
        assert [(u.tick, u.generation) for u in rt.updates] == \
            [(u.tick, u.generation) for u in rj.updates]
        assert np.float32(rt.best_cost) == np.float32(rj.best_cost)
    for f in ("score_calls", "stacked_rounds", "rows_scored", "ticks"):
        assert getattr(et.stats, f) == getattr(ej.stats, f), f


def test_engine_streams_progress_and_beats_sequential_calls():
    cfgs = [_cfg3d(seed=s) for s in (0, 1)]
    eng, resps = _engine_records(cfgs)
    seq = sum(tapi.run_sweep([c], fold_repetitions=False,
                             device=CPU).stats.score_calls for c in cfgs)
    assert eng.stats.score_calls < seq
    for resp in resps:
        kinds = [u.kind for u in resp.updates]
        assert kinds[-1] == "done"
        assert sum(k == "progress" for k in kinds[:-1]) >= 2
        assert resp.to_dict()["records"][0]["algorithm"] == "br"


def test_engine_cancel_queued_and_active():
    eng = DesignEngine(device=CPU)
    rq = eng.submit(tapi.DesignRequest(config=_cfg3d(seed=0)))
    assert eng.cancel(rq) is True
    assert eng.result(rq).status == "cancelled"
    assert eng.cancel(rq) is False
    ra = eng.submit(tapi.DesignRequest(config=_cfg3d(seed=1)))
    eng.step()
    assert eng.status(ra) == "active" and eng.result(ra) is None
    assert eng.cancel(ra) is True
    eng.run()
    resp = eng.result(ra)
    assert resp.status == "cancelled"
    assert resp.updates[-1].kind == "cancelled"
    assert eng.stats.cancelled == 2


def test_engine_timeout_zero_never_runs():
    eng = DesignEngine(device=CPU)
    rid = eng.submit(tapi.DesignRequest(config=_cfg3d(), timeout_s=0.0))
    eng.run()
    resp = eng.result(rid)
    assert resp.status == "timeout" and resp.records == []
    assert eng.stats.timeouts == 1


def test_engine_bad_config_is_isolated():
    eng = DesignEngine(device=CPU)
    rb = eng.submit(tapi.DesignRequest(
        config=_cfg3d(), pareto_grid={"term_weights": {"no-such-term":
                                                     (1.0,)}}))
    rg = eng.submit(tapi.DesignRequest(config=_cfg3d(seed=1)))
    eng.run()
    assert eng.result(rb).status == "error"
    assert "no-such-term" in eng.result(rb).error
    assert eng.result(rg).status == "done"
    assert eng.stats.errors == 1
    with pytest.raises(ValueError, match="duplicate request_id"):
        eng.submit(tapi.DesignRequest(config=_cfg3d(), request_id=rg))


def test_engine_max_active_queues_fifo():
    eng = DesignEngine(max_active=1, device=CPU)
    r1 = eng.submit(tapi.DesignRequest(config=_cfg3d(seed=0)))
    r2 = eng.submit(tapi.DesignRequest(config=_cfg3d(seed=1)))
    eng.step()
    assert eng.status(r1) == "active" and eng.status(r2) == "queued"
    eng.run()
    assert eng.result(r1).status == eng.result(r2).status == "done"
    assert eng.stats.admitted == 2


def test_engine_evaluator_lru_eviction_counter():
    eng = DesignEngine(evaluator_cache=1, device=CPU)
    for seed in range(3):
        eng.submit(tapi.DesignRequest(config=_cfg3d(seed=seed,
                                                  algorithms=("br",))))
        eng.run()
    assert eng.stats.evaluators_built == 3
    assert eng.stats.evaluator_evictions >= 2


def test_engine_front_matches_run_pareto():
    cfg = _cfg3d(algorithms=("br",), budget={"evals": 8}, archive_k=6)
    eng = DesignEngine(device=CPU)
    rid = eng.submit(tapi.DesignRequest(config=cfg, pareto_grid=GRID))
    eng.run()
    resp = eng.result(rid)
    assert resp.status == "done" and resp.front is not None
    assert [u.kind for u in resp.updates][-2:] == ["front", "done"]
    ref = tpareto.run_pareto(cfg, GRID, fold_repetitions=False, device=CPU)
    assert resp.front.hypervolume == ref.hypervolume
    assert resp.front.n_candidates == ref.n_candidates
    assert [p.terms for p in resp.front.points] == \
        [p.terms for p in ref.points]


# ---------------------------------------------------------------------------
# Population sharding.
# ---------------------------------------------------------------------------

def test_population_devices():
    assert population_devices(TWO_CPUS) == [CPU, CPU]
    assert n_pop_devices(["cpu"]) == 1
    with pytest.raises(ValueError, match="at least one device"):
        population_devices([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="explicit device list"):
            population_devices()


@functools.lru_cache(maxsize=1)
def _homog32_evaluator():
    arch = paper_arch("homog32")
    rep = tapi.make_rep(arch, "homog32")
    return rep, tapi.make_evaluator(rep, arch, rng=np.random.default_rng(0),
                                    norm_samples=3, chunk=2, device=CPU)


@pytest.mark.parametrize("n", [1, 3, 5])
def test_shard_scorer_two_cpus_odd_batch_bitwise(n):
    rep, ev = _homog32_evaluator()
    rng = np.random.default_rng(n)
    sols = [rep.random(rng) for _ in range(n)]
    batch = stack_graphs([rep.score_graph(s) for s in sols])
    wrapped = shard_scorer(ev.scorer, TWO_CPUS)
    assert wrapped.n_devices == 2
    w_rows = np.stack([ev.weights_vec * (1 + i) for i in range(n)])
    for weights in (ev.weights_vec, w_rows):
        got = wrapped(batch, ev.norm_vec, weights)
        want = ev.scorer(batch, ev.norm_vec, weights)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


SHARD_CFGS = (dict(arch="stack3d32", seed=0, algorithms=("br", "ga-batched")),
              dict(arch="stack3d32", seed=1, algorithms=("sa",),
                   archive_k=3))


@functools.lru_cache(maxsize=1)
def _plain_sweep():
    return tapi.run_sweep([_cfg(**kw) for kw in SHARD_CFGS], device=CPU)


@pytest.mark.parametrize("shard", [True, TWO_CPUS])
def test_run_sweep_shard_bitwise(shard):
    cfgs = [_cfg(**kw) for kw in SHARD_CFGS]
    plain = _plain_sweep()
    sharded = tapi.run_sweep(cfgs, shard=shard, device=CPU)
    assert sharded.stats.shard_devices == (1 if shard is True else 2)
    assert plain.stats.shard_devices == 1
    assert sharded.stats.stacked_groups == plain.stats.stacked_groups == 1
    for a, b in zip(plain.records, sharded.records):
        _same_record(a, b)
    solo = tapi.run_sweep(cfgs[1:], stack_scoring=False, shard=TWO_CPUS,
                          device=CPU)
    _same_record(plain.records[-1], solo.records[0])


def test_engine_sharded_equals_unsharded():
    cfgs = [_cfg(arch="stack3d32", seed=3, algorithms=("br", "ga-batched")),
            _cfg(seed=4, algorithms=("sa-batched",))]
    _, plain = _engine_records(cfgs)
    eng, sharded = _engine_records(cfgs, shard=TWO_CPUS)
    assert eng.stats.shard_devices == 2
    for rp, rs in zip(plain, sharded):
        for a, b in zip(rp.records, rs.records):
            _same_record(a, b)
