"""The port's multi-run paths against the JAX package, on the CPU:
stacked cross-run scoring (``optimize.score_stacked`` /
``drive_stacked``) and ``api.run_sweep``.

* **reference** — in ``test_torch_sweep_reference.py``; here the
  summaries and the stackable set as the reference's.
* **stacking** — in the port, stacked equals unstacked bit for bit for
  all six optimizers on homog32 and hetero32, in one lockstep group that
  mixes host graph lists and ``-batched`` device dicts.
* **plumbing** — the scorer-cache counters, eviction and clearing,
  ``shard=True`` equal to the unsharded sweep, wall-clock budgets never
  folding or stacking, mismatched requests failing loudly, ``summarize`` /
  ``best_by_algorithm`` as the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro_torch.core import api as tapi
from repro_torch.core import optimize as topt
from repro_torch.core.chiplets import paper_arch
from repro_torch.core.topology import stack_graphs
from _torch_sweep import CPU, PARAMS, _assert_same_record, _pair
from _torch_threads import one_torch_thread  # noqa: F401

def _stack_cfgs(arch_name):
    algos = ("br", "ga", "sa", "br-batched", "ga-batched", "sa-batched")
    return [tapi.ExperimentConfig(
        arch=arch_name, algorithms=algos, budget=tapi.Budget(evals=8),
        norm_samples=4, chunk=4, seed=1, params=PARAMS)]


@pytest.mark.parametrize("arch_name", ["homog32", "hetero32"])
def test_stacked_equals_unstacked_all_six_algorithms(arch_name):
    cfgs = _stack_cfgs(arch_name)
    stacked = tapi.run_sweep(cfgs, device=CPU)
    unstacked = tapi.run_sweep(cfgs, stack_scoring=False, device=CPU)
    # One lockstep group over all six runs: host lists (numpy) and device
    # dicts (tensors, int64 edges) concatenate into one call.
    assert stacked.stats.stacked_groups == 1
    assert stacked.stats.score_calls < unstacked.stats.score_calls
    assert stacked.stats.n_evaluated == unstacked.stats.n_evaluated
    for a, b in zip(unstacked.records, stacked.records):
        _assert_same_record(a, b)


def test_score_stacked_mixes_host_and_device_requests():
    arch = paper_arch("homog32")
    rep = tapi.make_rep(arch, "homog32")
    ev = tapi.make_evaluator(rep, arch, rng=np.random.default_rng(0),
                             norm_samples=4, chunk=3, device=CPU)
    _, graphs = ev.generate_valid(rep.random, np.random.default_rng(1), 5)
    host = stack_graphs(graphs[:2])
    dev = {k: torch.as_tensor(v)
           for k, v in stack_graphs(graphs[2:]).items()}
    dev["edges"] = dev["edges"].to(torch.long)
    dev["connected"] = torch.tensor([True, False, True])
    parts = [topt._request_parts(host), topt._request_parts(dev)]
    calls = ev.n_score_calls
    ((c0, m0), (c1, m1)), _ = topt.score_stacked(
        [(parts[0], ev), (parts[1], ev)])
    assert ev.n_score_calls == calls + 1
    want0 = ev.score_batch(host)
    want1 = ev.score_batch(stack_graphs(graphs[2:]))
    np.testing.assert_array_equal(c0, want0["cost"])
    np.testing.assert_array_equal(c1, want1["cost"])
    # the device request's own connected flags override the scorer's
    np.testing.assert_array_equal(m1["connected"], [True, False, True])


def test_drive_stacked_rejects_mismatched_requests():
    arch = paper_arch("homog32")
    rep = tapi.make_rep(arch, "homog32")
    ev = tapi.make_evaluator(rep, arch, rng=np.random.default_rng(0),
                             norm_samples=2, chunk=4, device=CPU)
    _, graphs = ev.generate_valid(rep.random, np.random.default_rng(0), 2)

    def gen_graphs():
        yield graphs

    def gen_bogus():
        yield dict(stack_graphs(graphs), extra_key=np.zeros(2))

    with pytest.raises(ValueError, match="disagree on batch keys"):
        topt.drive_stacked([(gen_graphs(), ev), (gen_bogus(), ev)])


def test_sweep_folds_sa_repetitions_into_chains():
    _, cfg = _pair(algorithms=("sa",), repetitions=3, budget={"evals": 6},
                   norm_samples=4)
    (rec,) = tapi.run_sweep([cfg], device=CPU).records
    assert rec.repetition == -1           # folded batch record
    # 3 reps x 2 chains -> 6 chains: initial batch + 3 iterations of 6
    assert rec.result.n_evaluated == 6 + (6 * 3 // 6) * 6
    unfolded = tapi.run_sweep([cfg], fold_repetitions=False, device=CPU)
    assert [r.repetition for r in unfolded.records] == [0, 1, 2]


def test_wall_clock_budgets_never_fold_or_stack():
    cfgs = [tapi.ExperimentConfig(
        arch="homog32", algorithms=("sa",), repetitions=2, seed=s,
        budget=tapi.Budget(evals=4, seconds=60.0), norm_samples=4, chunk=4)
        for s in (0, 1)]
    res = tapi.run_sweep(cfgs, device=CPU)
    assert res.stats.stacked_groups == 0
    assert [r.repetition for r in res.records] == [0, 1, 0, 1]


def test_scorer_cache_counts_evicts_and_clears():
    tapi.clear_scorer_cache()
    _, ct = _pair(algorithms=("br",), budget={"evals": 8})
    cfgs = [dataclasses.replace(ct, seed=s) for s in (0, 1, 2)]
    res = tapi.run_sweep(cfgs, device=CPU)
    stats = tapi.scorer_cache_stats()
    assert res.stats.scorers_built == 1
    assert stats["misses"] == 1 and stats["hits"] >= 2
    assert stats["size"] == 1 and stats["evictions"] == 0
    # A second chunk size needs a second scorer; capacity 1 evicts one.
    tapi.set_scorer_cache_capacity(1)
    try:
        res2 = tapi.run_sweep([dataclasses.replace(ct, chunk=2)],
                              device=CPU)
        assert res2.stats.scorers_built == 1
        assert res2.stats.scorer_evictions == 1
        assert tapi.scorer_cache_stats()["size"] == 1
    finally:
        tapi.set_scorer_cache_capacity(tapi.SCORER_CACHE_CAPACITY)
    tapi.clear_scorer_cache()
    assert tapi.scorer_cache_stats() == dict(
        hits=0, misses=0, evictions=0, size=0,
        capacity=tapi.SCORER_CACHE_CAPACITY)
    rep = tapi.make_rep(paper_arch("homog32"), "homog32")
    topt.DevicePipeline._stages(rep, CPU)
    assert len(topt.DevicePipeline._STAGE_CACHE) >= 1
    tapi.clear_pipeline_cache()
    assert len(topt.DevicePipeline._STAGE_CACHE) == 0


def test_shard_refuses_by_name():
    # Population sharding is ported (queue 1 item 13): shard=True runs,
    # bit for bit the unsharded sweep; an empty device list refuses.
    _, ct = _pair(algorithms=("br",))
    plain = tapi.run_sweep([ct], device=CPU)
    res = tapi.run_sweep(tapi.SweepConfig(configs=(ct,), shard=True),
                         device=CPU)
    assert res.stats.shard_devices == 1
    _assert_same_record(plain.records[0], res.records[0])
    with pytest.raises(ValueError, match="at least one device"):
        tapi.run_sweep([ct], shard=[], device=CPU)


def test_summaries_match_reference():
    cj, ct = _pair(algorithms=("br", "ga"), seed=3)
    rj = japi.run_sweep([cj]).records
    rt = tapi.run_sweep([ct], device=CPU).records
    drop = ("seconds", "evals_per_s")
    assert [{k: v for k, v in r.items() if k not in drop}
            for r in tapi.summarize(rt)] \
        == [{k: v for k, v in r.items() if k not in drop}
            for r in japi.summarize(rj)]
    bj, bt = japi.best_by_algorithm(rj), tapi.best_by_algorithm(rt)
    assert set(bt) == set(bj) == {"br", "ga"}
    for a in bj:
        assert bt[a].result.best_cost == bj[a].result.best_cost


def test_budget_scaled_and_stackable_steps():
    b = tapi.Budget(evals=7)
    assert b.scaled(3) == tapi.Budget(evals=21)
    assert tapi.Budget(seconds=5.0).scaled(3).evals is None
    assert set(tapi._SWEEP_STACKABLE) == set(japi._SWEEP_STACKABLE)
    assert tapi.stackable_steps("ga") is tapi._ga_steps
    assert tapi.stackable_steps("nope") is None
