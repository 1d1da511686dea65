"""The port's netsim package and trace terms against the JAX package, on
the CPU.

* **host oracle** — ``netsim.sim`` and ``core.traces`` are numpy copies:
  the same seeds give the reference's packets, routes and average
  latencies exactly (``generate_trace``, ``synthetic_packets``,
  ``NetSim.run``, ``latency_throughput_curve``, ``trace_stats``);
* **workloads** — ``Workload.from_trace`` / ``synthetic`` / ``scaled``
  give the reference's arrays and digest; each package's JSON loads in the
  other;
* **rate model** — ``make_trace_model`` (the placement dimension written
  out, the contractions as products and per-axis sums) matches the
  reference's ``trace_*`` metrics on homog32, hetero32 and homog64: rtol
  1e-5 (float32 sums in another order; exact zeros stay exact), and 1e-4
  for ``trace_thr_*``, whose alpha divides the headroom ``1 - (rho -
  rho_k)``, a difference of float32 sums that amplifies their rounding
  where a link carries two classes.  Its zero-load latency equals the
  host's routed-hop formula, latency saturates monotonically, it ranks
  random placements like the host oracle (Spearman >= 0.9 per traffic
  class, as ``tests/test_netsim.py``) and its results do not depend on
  the chunk;
* **trace terms** — the scorer's ``trace-lat`` / ``trace-thr`` cost agrees
  with the float64 host recomputation (rtol 1e-4, as the reference's
  test); a ``trace-lat`` ``run_experiment`` (homog32, host GA) reaches the
  reference's ``best_sol`` (``best_cost`` to rel 1e-5: the trace metrics
  sum in another order); a port ``ExperimentConfig`` JSON with a workload
  runs in the reference; workloads stack in one sweep group.
"""
import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import traces as jtraces
from repro.core.baseline import MeshBaseline as JMeshBaseline
from repro.core.chiplets import paper_arch as jpaper_arch
from repro.netsim import Workload as JWorkload
from repro.netsim import make_trace_model as jmake_trace_model
from repro.netsim import sim as jsim
from repro_torch import interop
from repro_torch.core import api as tapi
from repro_torch.core import traces as ttraces
from repro_torch.core.baseline import MeshBaseline
from repro_torch.core.chiplets import COMPUTE, MEMORY, TRAFFIC_TYPES
from repro_torch.core.chiplets import paper_arch
from repro_torch.core.objective import (Objective, TermSpec,
                                        objective_cost_host)
from repro_torch.core.topology import infer_links_mst, stack_graphs
from repro_torch.kernels import ops
from repro_torch.netsim import (ROUTER_PIPELINE, ChipletNet, NetSim,
                                Workload, demand_dim,
                                latency_throughput_curve, make_trace_model,
                                synthetic_packets)
from _torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
RTOL = 1e-5
THR_RTOL = 1e-4        # trace_thr_*: see the module docstring


@pytest.fixture(scope="module")
def nets():
    """The homog32 2D-mesh net in both packages."""
    ja = jpaper_arch("homog32", "baseline")
    _, geo, links = JMeshBaseline(ja).build()
    arch = paper_arch("homog32", "baseline")
    _, tgeo, tlinks = MeshBaseline(arch).build()
    return (ja, jsim.ChipletNet.from_links(ja, geo, links), arch,
            ChipletNet.from_links(arch, tgeo, tlinks))


def _pk(packets):
    return [(p.pid, p.src, p.dst, p.flits, p.cycle, p.deps)
            for p in packets]


# ---------------------------------------------------------------------------
# Host oracle: exact copies.
# ---------------------------------------------------------------------------

def test_net_and_trace_match_reference(nets):
    ja, jn, arch, tn = nets
    for f in ("kinds", "relay", "adj", "next_hop", "dist"):
        np.testing.assert_array_equal(getattr(tn, f), getattr(jn, f), f)
    regions = (ttraces.TraceRegion(2000, 20000),
               ttraces.TraceRegion(600, 9000))
    jreg = tuple(jtraces.TraceRegion(r.n_packets, r.n_cycles)
                 for r in regions)
    for seed in (0, 7):
        tp = ttraces.generate_trace(tn, regions, seed=seed)
        jp = jtraces.generate_trace(jn, jreg, seed=seed)
        assert _pk(tp) == _pk(jp)
        assert ttraces.trace_stats(tp, tn) == jtraces.trace_stats(jp, jn)
        for mode in ("authentic", "idealized"):
            rt, rj = NetSim(tn, arch).run(tp, mode), \
                jsim.NetSim(jn, ja).run(jp, mode)
            assert (rt.n_done, rt.avg_latency, rt.p99_latency,
                    rt.makespan) == (rj.n_done, rj.avg_latency,
                                     rj.p99_latency, rj.makespan)
            assert rt.times == rj.times
    mix = ttraces.TraceMix(p_coherence=0.05)
    assert mix.class_shares() == jtraces.TraceMix(
        p_coherence=0.05).class_shares()


@pytest.mark.parametrize("traffic", TRAFFIC_TYPES)
def test_synthetic_traffic_and_curve_match_reference(nets, traffic):
    ja, jn, arch, tn = nets
    tp = synthetic_packets(tn, traffic, 0.05, 1500,
                           np.random.default_rng(3))
    jp = jsim.synthetic_packets(jn, traffic, 0.05, 1500,
                                np.random.default_rng(3))
    assert _pk(tp) == _pk(jp)
    rates = [0.005, 0.05, 0.3]
    assert latency_throughput_curve(tn, arch, traffic, rates, n_cycles=600,
                                    seed=2) \
        == jsim.latency_throughput_curve(jn, ja, traffic, rates,
                                         n_cycles=600, seed=2)


def test_workloads_match_reference_and_cross_load(nets):
    ja, jn, arch, tn = nets
    pk = ttraces.generate_trace(tn, (ttraces.TraceRegion(1500, 8000),),
                                seed=1)
    jpk = jtraces.generate_trace(jn, (jtraces.TraceRegion(1500, 8000),),
                                 seed=1)
    pairs = [(Workload.from_trace(pk, arch.kinds(), 8000, name="t"),
              JWorkload.from_trace(jpk, ja.kinds(), 8000, name="t"))]
    for t in TRAFFIC_TYPES:
        pairs.append((Workload.synthetic(arch.kinds(), t, 0.02),
                      JWorkload.synthetic(ja.kinds(), t, 0.02)))
    pairs.append((pairs[0][0].scaled(2.5), pairs[0][1].scaled(2.5)))
    for wt, wj in pairs:
        np.testing.assert_array_equal(wt.rate, wj.rate)
        np.testing.assert_array_equal(wt.flits, wj.flits)
        np.testing.assert_array_equal(wt.vec(), wj.vec())
        assert wt.digest() == wj.digest() and wt.name == wj.name
        assert wt.vec().shape == (demand_dim(wt.n),)
        assert Workload.from_dict(wj.to_dict()) == wt
        assert JWorkload.from_dict(wt.to_dict()) == wj
        assert hash(Workload.from_dict(wt.to_dict())) == hash(wt)
    with pytest.raises(ValueError, match="unknown Workload keys"):
        Workload.from_dict({**pairs[1][0].to_dict(), "bogus": 1})


# ---------------------------------------------------------------------------
# Rate model.
# ---------------------------------------------------------------------------

def _placements(arch_name, n, seed=3):
    arch = paper_arch(arch_name, "placeit")
    rep = tapi.make_rep(arch, arch_name)
    rng = np.random.default_rng(seed)
    graphs = []
    while len(graphs) < n:
        g = rep.score_graph(rep.random(rng))
        if g.connected:
            graphs.append(g)
    return arch, rep, stack_graphs(graphs)


@pytest.mark.parametrize("arch_name", ["homog32", "hetero32", "homog64"])
def test_rate_model_matches_reference(arch_name):
    arch, rep, batch = _placements(arch_name, 4)
    dem = np.stack([Workload.synthetic(arch.kinds(), t, r).vec()
                    for t, r in (("c2m", 0.01), ("c2c", 0.03),
                                 ("m2i", 0.05), ("c2i", 0.02))])
    dem[1] += dem[0]                        # two classes in one row
    ja = jpaper_arch(arch_name, "placeit")
    want = jmake_trace_model(japi.make_rep(ja, arch_name).layout)(batch,
                                                                  dem)
    got = make_trace_model(rep.layout, device=CPU)(batch, dem)
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype == np.float32, k
        rtol = THR_RTOL if k.startswith("trace_thr_") else RTOL
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=0, err_msg=k)
        np.testing.assert_array_equal(got[k] == 0, v == 0, k)


def test_trace_scorer_is_chunk_invariant_bitwise():
    from repro_torch.core.proxies import make_scorer
    arch, rep, batch = _placements("homog32", 5)
    dem = Workload.synthetic(arch.kinds(), "c2m", 0.05).vec()
    batch = dict(batch, _demand=np.tile(dem, (5, 1)))
    outs = [make_scorer(rep.layout, chunk=c, objective=_trace_obj(),
                        device=CPU)(batch, np.ones(9, np.float32))
            for c in (1, 2, 5)]
    for other in outs[1:]:
        for k, v in outs[0].items():
            np.testing.assert_array_equal(other[k], v, k)


def test_zero_load_and_saturation(nets):
    _, _, arch, tn = nets
    rep = tapi.make_rep(arch, "homog32")
    batch = stack_graphs([MeshBaseline(arch).build()[0]])
    model = make_trace_model(rep.layout, device=CPU)
    s = int(np.nonzero(tn.kinds == COMPUTE)[0][0])
    d = int(np.nonzero(tn.kinds == MEMORY)[0][-1])
    from repro_torch.netsim import Packet
    wl = Workload.from_trace([Packet(0, s, d, 9, 0)], tn.kinds, 10 ** 6)
    out = model(batch, wl.vec())
    hops = len(tn.path(s, d)) - 1
    want = hops * (arch.latency.d2d_cost() + ROUTER_PIPELINE) \
        + (hops - 1) * arch.latency.l_relay + 9 - 1
    assert float(out["trace_lat_c2m"][0]) == pytest.approx(want, abs=0.05)
    assert float(out["trace_lat_c2c"][0]) == 0.0
    lats, loads = [], []
    for r in [1e-4, 1e-3, 1e-2, 0.1, 0.4]:
        o = model(batch, Workload.synthetic(tn.kinds, "c2m", r).vec())
        lats.append(float(o["trace_lat_c2m"][0]))
        loads.append(float(o["trace_max_load"][0]))
    assert (np.diff(lats) > 0).all() and (np.diff(loads) > 0).all()
    assert lats[-1] > 2.0 * lats[0]


def _spearman(a, b):
    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    ra -= ra.mean()
    rb -= rb.mean()
    return float((ra * rb).sum()
                 / np.sqrt((ra * ra).sum() * (rb * rb).sum()))


def _calibration_nets(arch_name, n_pl, seed=5):
    """Random connected placements, their host nets and score graphs
    (hetero placements whose link inference double-books a PHY are left
    out, as in ``tests/test_netsim.py``)."""
    arch = paper_arch(arch_name, "baseline")
    rep = tapi.make_rep(arch, arch_name)
    rng = np.random.default_rng(seed)
    graphs, nets = [], []
    while len(nets) < n_pl:
        sol = rep.random(rng)
        g = rep.score_graph(sol)
        if not g.connected:
            continue
        geo = rep.geometry(sol)
        if hasattr(rep, "links_of"):
            links, _ = rep.links_of(sol)
        else:
            links, _ = infer_links_mst(arch, geo)
            cnt = Counter(p for link in links for p in link)
            if any(c > 1 for c in cnt.values()):
                continue
        graphs.append(g)
        nets.append(ChipletNet.from_links(arch, geo, links))
    return arch, rep, stack_graphs(graphs), nets


@pytest.mark.parametrize("arch_name", ["homog32", "hetero32"])
def test_rate_model_ranks_like_host_oracle(arch_name):
    rate, n_cycles, n_pl, n_seeds = 1e-4, 12000, 7, 3
    arch, rep, batch, nets = _calibration_nets(arch_name, n_pl)
    kinds = np.asarray(arch.kinds())
    model = make_trace_model(rep.layout, device=CPU)
    rhos = {}
    for t in TRAFFIC_TYPES:
        dev, host, dems = [], [], []
        for i, cn in enumerate(nets):
            hs = []
            for sd in range(n_seeds):
                pk = synthetic_packets(cn, t, rate, n_cycles,
                                       np.random.default_rng((9, i, sd)))
                pk = [p for p in pk if cn.next_hop[p.src, p.dst] >= 0]
                hs.append(NetSim(cn, arch).run(pk).avg_latency)
                dems.append(Workload.from_trace(pk, kinds, n_cycles).vec())
            host.append(float(np.mean(hs)))
        # every (placement, seed) row in one call of the model
        rows = {k: np.repeat(v, n_seeds, axis=0) for k, v in batch.items()}
        out = model(rows, np.stack(dems))[f"trace_lat_{t}"]
        dev = out.reshape(n_pl, n_seeds).mean(1)
        rhos[t] = _spearman(dev, np.array(host))
    assert all(r >= 0.9 for r in rhos.values()), rhos


# ---------------------------------------------------------------------------
# Trace terms through the scorer, the evaluator and the API.
# ---------------------------------------------------------------------------

def _trace_obj():
    return Objective().with_terms(TermSpec("trace-lat", weight=0.5),
                                  TermSpec("trace-thr", weight=0.25))


@pytest.mark.parametrize("arch_name", ["homog32", "hetero32"])
def test_trace_cost_agrees_with_host(arch_name):
    arch = paper_arch(arch_name)
    rep = tapi.make_rep(arch, arch_name)
    obj = _trace_obj()
    wl = Workload.synthetic(arch.kinds(), "c2m", 0.01)
    ev = tapi.make_evaluator(rep, arch, rng=np.random.default_rng(0),
                             norm_samples=6, chunk=4, objective=obj,
                             workload=wl, device=CPU)
    _, graphs = ev.generate_valid(rep.random, np.random.default_rng(1), 5)
    batch = stack_graphs(graphs)
    metrics = ev.score_batch(batch)
    for t in TRAFFIC_TYPES:
        assert f"trace_lat_{t}" in metrics and f"trace_thr_{t}" in metrics
    host = objective_cost_host(metrics, obj, ev.norm, batch=batch)
    np.testing.assert_allclose(ev.costs_from(metrics), host, rtol=1e-4,
                               atol=1e-5)
    base = objective_cost_host(metrics, Objective(), ev.norm)
    assert (host > base).all()


def test_trace_term_needs_matching_workload():
    arch = paper_arch("homog32")
    rep = tapi.make_rep(arch, "homog32")
    obj = Objective().with_terms(TermSpec("trace-lat"))
    kw = dict(rng=np.random.default_rng(0), norm_samples=2, objective=obj,
              device=CPU)
    with pytest.raises(ValueError, match="workload"):
        tapi.make_evaluator(rep, arch, **kw)
    with pytest.raises(ValueError, match="arch has 40"):
        tapi.make_evaluator(rep, arch, workload=Workload.synthetic(
            paper_arch("homog64").kinds(), "c2m", 0.01), **kw)
    with pytest.raises(KeyError, match="trace_lat"):
        objective_cost_host({"area": np.ones(1)},
                            Objective(terms=("trace-lat",)),
                            tapi.make_evaluator(
                                rep, arch, rng=np.random.default_rng(0),
                                norm_samples=2, device=CPU).norm)


def _trace_pair(**kw):
    ja = jpaper_arch("homog32", "baseline")
    wl = JWorkload.synthetic(ja.kinds(), "c2m", 0.01)
    d = dict(arch="homog32", algorithms=["ga"], budget={"evals": 16},
             norm_samples=8, chunk=4, seed=1,
             params={"ga": {"population": 8, "elitism": 2,
                            "tournament": 3}},
             objective=_trace_obj().to_dict(), workload=wl.to_dict())
    d.update(kw)
    cj = japi.ExperimentConfig.from_dict(dict(d, backend="fw-ref"))
    return cj, interop.config_from_json(cj.to_json())


def test_trace_run_experiment_matches_reference():
    cj, ct = _trace_pair()
    (rj,) = japi.run_experiment(cj)
    (rt,) = tapi.run_experiment(ct, device=CPU)
    for a, b in zip(interop.sol_from_arrays(*rj.result.best_sol),
                    rt.result.best_sol):
        np.testing.assert_array_equal(b, a)
    assert rt.result.best_cost == pytest.approx(rj.result.best_cost,
                                                rel=RTOL)
    assert rt.result.n_evaluated == rj.result.n_evaluated
    assert rt.result.n_generated == rj.result.n_generated
    assert set(rt.result.best_metrics) == set(rj.result.best_metrics)
    for k, v in rj.result.best_metrics.items():
        rtol = THR_RTOL if k.startswith("trace_thr_") else RTOL
        assert rt.result.best_metrics[k] == pytest.approx(v, rel=rtol), k


def test_workload_config_json_runs_in_reference():
    arch = paper_arch("homog32")
    wl = Workload.synthetic(arch.kinds(), "c2m", 0.01)
    ct = tapi.ExperimentConfig(
        arch="homog32", algorithms=("br",), budget=tapi.Budget(evals=4),
        norm_samples=4, chunk=4, objective=_trace_obj(), workload=wl,
        params={"br": {"batch": 4}})
    back = tapi.ExperimentConfig.from_json(ct.to_json())
    assert back == ct and back.workload == wl and hash(back) == hash(ct)
    d = ct.to_dict()
    del d["workload"]
    assert tapi.ExperimentConfig.from_dict(d).workload is None
    cj = japi.ExperimentConfig.from_json(ct.to_json())
    assert cj.workload.digest() == wl.digest()
    (rj,) = japi.run_experiment(dataclasses.replace(cj, backend="fw-ref"))
    (rt,) = tapi.run_experiment(ct, device=CPU)
    assert rt.result.best_cost == pytest.approx(rj.result.best_cost,
                                                rel=RTOL)


def test_workloads_stack_in_one_sweep_group():
    arch = paper_arch("homog32")
    obj = Objective().with_terms(TermSpec("trace-lat", weight=0.5))
    base = dict(arch="homog32", algorithms=("br",),
                budget=tapi.Budget(evals=4), norm_samples=4, chunk=4,
                objective=obj, params={"br": {"batch": 4}})
    cfgs = [tapi.ExperimentConfig(**base, workload=Workload.synthetic(
        arch.kinds(), t, 0.01)) for t in ("c2m", "c2c")]
    tapi.clear_scorer_cache()
    res = tapi.run_sweep(cfgs, device=CPU)
    assert res.stats.scorers_built == 1
    assert res.stats.stacked_groups == 1
    for cfg, run in zip(cfgs, res.runs):
        (solo,) = tapi.run_experiment(cfg, device=CPU)
        assert run.records[0].result.best_cost == solo.result.best_cost
    # demand-bearing and demand-free runs never share a scorer
    mixed = tapi.run_sweep(cfgs[:1] + [dataclasses.replace(
        cfgs[1], objective=Objective(), workload=None)], device=CPU)
    assert mixed.stats.stacked_groups == 0


def test_trace_chunk_clamp_counts_the_rate_model(monkeypatch):
    from repro_torch.core import proxies
    arch, rep, batch = _placements("homog32", 3)
    obj = _trace_obj()
    dem = Workload.synthetic(arch.kinds(), "c2m", 0.02).vec()
    batch = dict(batch, _demand=np.tile(dem, (3, 1)))
    norms = np.ones(9, np.float32)
    want = proxies.make_scorer(rep.layout, chunk=3, objective=obj,
                               device=CPU)(batch, norms)
    E = batch["edges"].shape[1]
    N = rep.layout.N
    # a budget that fits one placement's [N, E, N] tensor and no more
    monkeypatch.setattr(proxies, "_CHUNK_ELEM_BUDGET", N * N * E)
    seen = []
    fw = ops.fw_impl_ref

    def spy(W):
        seen.append(W.shape[0])
        return fw(W)

    got = proxies.make_scorer(rep.layout, chunk=3, objective=obj,
                              fw_impl=spy, device=CPU)(batch, norms)
    assert seen == [1, 1, 1]
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, k)
    with pytest.raises(ValueError, match="_demand"):
        proxies.make_scorer(rep.layout, chunk=3, objective=obj,
                            device=CPU)(
            {k: v for k, v in batch.items() if k != "_demand"}, norms)
