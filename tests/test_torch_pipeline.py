"""The port's device-resident pipeline on the CPU: the batched operators,
the batched score-graph builds and the ``br-/ga-/sa-batched`` optimizers.

* **graphs** — ``HomogGraphBatch`` and ``HeteroGraphBatch`` equal the host
  ``score_graph`` bit for bit and slot for slot (W, edges, edge_mask,
  edge_len, area), with equal edge sets and ``connected``, and the
  scorer's metrics and cost from both builds are bit-equal
  (``testing.batched_build_parity``, which ``chip_smoke.py`` runs on the
  card); equal candidate lengths, which corner placement makes often, keep
  the host's Kruskal order;
* **operators** — ``HomogBatch`` / ``HeteroBatch`` draw from a
  ``torch.Generator``, not from ``jax.random``, so they are held to
  ``tests/_invariants.py`` and to the distribution checks of
  ``tests/test_batched_pipeline.py`` (connectivity rate within a binomial
  4-sigma band of the host operator's, mean C2M latency within rel 0.25);
* **optimizers** — br/ga/sa-batched run through ``run_experiment``, take their
  host counterparts' paper defaults and return connected host-format
  solutions; resampling counts its padded rounds in ``n_generated``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _invariants import assert_valid_hetero_batch, assert_valid_homog_batch
from repro_torch import testing
from repro_torch.core import api as tapi
from repro_torch.core import optimize as topt
from repro_torch.core.chiplets import paper_arch, resolve_arch
from repro_torch.core.objective import Objective
from repro_torch.core.proxies import make_scorer
from repro_torch.core.topology import (HeteroGraphBatch, HomogGraphBatch,
                                       PlacedPhys, build_score_graph,
                                       build_score_graphs_batched,
                                       infer_links_mst, stack_graphs)
from _torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
B = 8


def _rep(arch_name, config="baseline", mutation_mode=None):
    return tapi.make_rep(resolve_arch(arch_name, config), arch_name,
                         mutation_mode)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# Graphs: bit for bit against the host build.
# ---------------------------------------------------------------------------

# hex127's V = 702 (baseline) makes the plain FW slow on the CPU: its
# arrays are held bit for bit, its metrics on the card (chip_smoke.py and
# tests/test_torch_pipeline_gpu.py).
BUILD_CASES = [("homog32", "baseline", 6, True), ("homog32", "placeit", 6, True),
               ("hex127", "baseline", 4, False), ("hex127", "placeit", 4, False),
               ("hetero32", "baseline", 6, True),
               ("hetero32", "placeit", 6, True),
               ("hetero64", "baseline", 2, True),
               ("hetero64", "placeit", 2, True)]


@pytest.mark.parametrize("arch_name,config,n,score", BUILD_CASES)
def test_batched_build_matches_host(arch_name, config, n, score):
    out = testing.batched_build_parity(arch_name, config, n, seed=n,
                                       device=CPU, score=score, chunk=4)
    assert out["n"] == n and out["links"] > 0


def _lattice_geometry(arch, spacing, seed):
    """PHY positions on a square lattice (many equal candidate lengths),
    shuffled over the PHYs."""
    rep = tapi.make_rep(arch, "hetero32")
    Vp = rep.layout.Vp
    side = int(np.ceil(np.sqrt(Vp)))
    pts = np.stack(np.meshgrid(np.arange(side), np.arange(side)),
                   -1).reshape(-1, 2)[:Vp] * spacing
    pos = pts[np.random.default_rng(seed).permutation(Vp)].astype(
        np.float32)
    owner = np.repeat(np.arange(len(arch.chiplets)),
                      [ch.n_phys() for ch in arch.chiplets]).astype(np.int32)
    return rep, PlacedPhys(
        pos=pos, owner=owner,
        relay=np.array([ch.relay for ch in arch.chiplets]),
        kinds=np.array(arch.kinds(), dtype=np.int8),
        area=float(side * side * spacing * spacing))


@pytest.mark.parametrize("distance", ["euclidean", "manhattan"])
@pytest.mark.parametrize("seed", [0, 1])
def test_hetero_batch_keeps_kruskal_order_on_equal_lengths(distance, seed):
    """Lattice positions give hundreds of candidates of each length: the
    stable (length, enumeration) rank must reproduce the host's Kruskal
    choice among equal lengths, and the augmentation's."""
    arch = dataclasses.replace(paper_arch("hetero32", "baseline"),
                               distance=distance)
    rep, geo = _lattice_geometry(arch, 1.5, seed)
    links, connected = infer_links_mst(arch, geo)
    host = stack_graphs([build_score_graph(arch, geo, links, rep.e_max,
                                           connected)])
    gb = HeteroGraphBatch(arch, CPU)
    batch = gb.build(torch.from_numpy(geo.pos)[None],
                     torch.tensor([geo.area], dtype=torch.float32))
    lengths = host["edge_len"][0][host["edge_mask"][0]]
    assert len(lengths) > 2 * len(np.unique(lengths))       # ties abound
    assert not batch.pop("overflow").any()
    assert bool(batch.pop("connected")[0]) == connected
    for k in testing.GRAPH_KEYS:
        np.testing.assert_array_equal(batch[k].numpy(), host[k], err_msg=k)


def test_hetero_batch_flags_overflow():
    """A lattice denser than the Ecap working set holds must be flagged,
    so that the pipeline takes the host path for that row."""
    arch = paper_arch("hetero32", "baseline")
    _, geo = _lattice_geometry(arch, 0.5, 0)
    gb = HeteroGraphBatch(arch, CPU)
    batch = gb.build(torch.from_numpy(geo.pos)[None],
                     torch.tensor([geo.area], dtype=torch.float32))
    assert batch["overflow"].tolist() == [True]


def test_overflow_rows_take_the_host_path():
    """Rows whose candidates exceed the working set are rebuilt by the
    host ``score_graph`` in the pipeline's hetero stage (here with the
    working set cut to Vp, so that every row overflows)."""
    rep = _rep("hetero32", "placeit")
    ops, gb, _, _, _, graph = topt.DevicePipeline._stages(rep, CPU)
    o, r = ops.random_batch(_gen(0), 3)
    saved = gb.Ecap
    gb.Ecap = gb.L
    try:
        ppos, area = ops.geometry_batch(o.numpy(), r.numpy())
        assert gb.build(torch.from_numpy(ppos),
                        torch.from_numpy(area))["overflow"].all()
        batch = graph(o, r)
    finally:
        gb.Ecap = saved
    graphs = [rep.score_graph(topt._sol_at(o, r, i)) for i in range(3)]
    host = stack_graphs(graphs)
    assert "overflow" not in batch
    assert batch["connected"].tolist() == [g.connected for g in graphs]
    for k in testing.GRAPH_KEYS:
        np.testing.assert_array_equal(batch[k].numpy(), host[k], err_msg=k)


# ---------------------------------------------------------------------------
# Operators: invariants, determinism, distributions.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_name,config,mode", [
    ("homog32", "baseline", None), ("homog32", "baseline", "any-both"),
    ("homog32", "placeit", "neighbor-both"), ("hex127", "baseline", None)])
def test_homog_batch_operators_keep_invariants(arch_name, config, mode):
    rep = _rep(arch_name, config, mode)
    ops = rep.batch_ops(CPU)
    t, r = ops.random_batch(_gen(0), B)
    assert t.dtype == r.dtype == torch.int8 and t.shape == (B, rep.R, rep.C)
    assert_valid_homog_batch(rep, t, r)
    t2, r2 = ops.random_batch(_gen(0), B)
    assert torch.equal(t, t2) and torch.equal(r, r2)
    mt, mr = ops.mutate_batch(_gen(1), t, r)
    assert_valid_homog_batch(rep, mt, mr)
    assert ((mt != t) | (mr != r)).flatten(1).any(1).any()
    tb, rb = ops.random_batch(_gen(2), B)
    tg, rg = ops.merge_batch(_gen(3), t, r, tb, rb)
    assert_valid_homog_batch(rep, tg, rg)
    match = t == tb
    assert torch.equal(tg[match], t[match])
    rot_match = match & (r == rb) & ((t == 1) | (t == 2))
    if any(rep._rotatable.values()):
        assert torch.equal(rg[rot_match], r[rot_match])
    if rep.allowed is not None:
        assert (t[:, torch.from_numpy(~rep.allowed)] == -1).all()


@pytest.mark.parametrize("arch_name,config,mode", [
    ("hetero32", "baseline", None), ("hetero32", "baseline", "any-both"),
    ("hetero64", "placeit", None)])
def test_hetero_batch_operators_keep_invariants(arch_name, config, mode):
    rep = _rep(arch_name, config, mode)
    ops = rep.batch_ops(CPU)
    o, r = ops.random_batch(_gen(0), B)
    assert o.dtype == r.dtype == torch.int8 and o.shape == (B, ops.N)
    assert_valid_hetero_batch(rep, o, r)
    o2, r2 = ops.random_batch(_gen(0), B)
    assert torch.equal(o, o2) and torch.equal(r, r2)
    mo, mr = ops.mutate_batch(_gen(1), o, r)
    assert_valid_hetero_batch(rep, mo, mr)
    assert ((mo != o) | (mr != r)).any(1).any()
    ob, rb = ops.random_batch(_gen(2), B)
    og, rg = ops.merge_batch(_gen(3), o, r, ob, rb)
    assert_valid_hetero_batch(rep, og, rg)
    match = o == ob
    assert torch.equal(og[match], o[match])
    rmatch = match & (r == rb)
    assert torch.equal(rg[rmatch], r[rmatch])


def test_homog_random_batch_matches_host_distribution():
    """Connectivity rate and cost distribution of raw random placements
    agree between the host operator and the batched one (the reference's
    test_random_batch_matches_host_distribution; connectivity by the host
    union-find, which the scorer's flag equals:
    test_batched_build_matches_host)."""
    n = 96
    rep = _rep("homog32")
    host_rng = np.random.default_rng(11)
    host = [rep.random(host_rng) for _ in range(n)]
    t, r = rep.batch_ops(CPU).random_batch(_gen(12), n)
    dev = [topt._sol_at(t, r, i) for i in range(n)]
    host_conn = np.array([rep.is_connected(s) for s in host])
    dev_conn = np.array([rep.is_connected(s) for s in dev])
    p = host_conn.mean()
    sigma = np.sqrt(max(p * (1 - p), 1e-4) / n)
    assert abs(dev_conn.mean() - p) < 4 * sigma + 2 / n
    if host_conn.any() and dev_conn.any():
        scorer = make_scorer(rep.layout, chunk=16, device=CPU)
        lat = [scorer(stack_graphs([rep.score_graph(s) for s, c in
                                    zip(sols, conn) if c]))["lat_c2m"]
               for sols, conn in ((host, host_conn), (dev, dev_conn))]
        assert lat[1].mean() == pytest.approx(lat[0].mean(), rel=0.25)


def test_hetero_random_batch_matches_host_distribution():
    """Connectivity rate of raw random hetero32 placements: host operator
    (corner placement + MST) against the batched operator + Borůvka."""
    n = 64
    rep = _rep("hetero32")
    host_rng = np.random.default_rng(21)
    host_conn = np.array([rep.is_connected(rep.random(host_rng))
                          for _ in range(n)])
    ops = rep.batch_ops(CPU)
    o, r = ops.random_batch(_gen(22), n)
    ppos, area = ops.geometry_batch(o.numpy(), r.numpy())
    dev_conn = HeteroGraphBatch(rep.arch, CPU).build(
        torch.from_numpy(ppos), torch.from_numpy(area))["connected"].numpy()
    p = host_conn.mean()
    sigma = np.sqrt(max(p * (1 - p), 1e-4) / n)
    assert abs(dev_conn.mean() - p) < 4 * sigma + 2 / n


# ---------------------------------------------------------------------------
# The pipeline: resampling, the RNG stream, requests, stage cache.
# ---------------------------------------------------------------------------

def _evaluator(arch_name, config="baseline", seed=0):
    rep = _rep(arch_name, config)
    return topt.Evaluator(rep, rep.arch, rng=np.random.default_rng(seed),
                          norm_samples=4, chunk=8, device=CPU)


def test_resampling_counts_padded_rounds():
    """Scripted connectivity: the first round fills all 20 slots, then only
    the invalid slots are resampled, padded to a power of two of at least
    8 (at most n), each slot taking its first connected candidate;
    ``n_generated`` counts every produced row, padding included."""
    ev = _evaluator("hetero32")
    pipe = ev.pipeline()
    n, made = 20, []

    def make(gen, idx):
        made.append(np.array(idx))
        t = torch.as_tensor(np.asarray(idx), dtype=torch.int8)[:, None]
        return t, t.clone(), {"W": torch.zeros(len(idx), 1, 1)}

    g0 = ev.n_generated
    steps = pipe._until_connected_steps(np.random.default_rng(0), make, n)
    req = next(steps)
    replies = [np.arange(n) % 4 != 0,             # slots 0,4,8,12,16 bad
               np.array([False, True, True, False, False, True, False,
                         True]),                  # idx 0,4,8,12,16,0,4,8
               np.ones(8, bool)]                  # idx 12,16,... ok
    with pytest.raises(StopIteration) as stop:
        for conn in replies:
            assert int(req["W"].shape[0]) == len(conn)
            req = steps.send((np.zeros(len(conn)),
                              {"connected": conn,
                               "cost": np.arange(len(conn), dtype=float)}))
    t, r, metrics, costs = stop.value.value
    assert [len(m) for m in made] == [20, 8, 8]
    np.testing.assert_array_equal(made[1], [0, 4, 8, 12, 16, 0, 4, 8])
    np.testing.assert_array_equal(made[2], [12, 16] * 4)
    assert ev.n_generated - g0 == 36
    assert metrics["connected"].all()
    # Each slot keeps its first connected candidate: slots 4 and 8 rows 1
    # and 2 of the second round (not row 7), slot 0 its row 5, slots 12
    # and 16 rows 0 and 1 of the third.
    assert [int(t[s, 0]) for s in (0, 4, 8, 12, 16)] == [0, 4, 8, 12, 16]
    assert [metrics["cost"][s] for s in (0, 4, 8, 12, 16)] == [5, 1, 2, 0, 1]


def test_sample_random_resamples_disconnected_homog32():
    """Baseline homog32 random placements are rarely connected: the
    returned batch is all connected and more than 8 were generated."""
    ev = _evaluator("homog32")
    g0 = ev.n_generated
    t, r, metrics = ev.pipeline().sample_random(np.random.default_rng(1), 8)
    assert metrics["connected"].astype(bool).all()
    assert ev.n_generated - g0 > 8
    rep = ev.rep
    for i in range(8):
        assert rep.score_graph(topt._sol_at(t, r, i)).connected


def test_pipeline_draws_one_host_int_a_call():
    """Each produced batch seeds its generator with one draw from the host
    stream, so the host draws after it stay where the reference has
    them."""
    ev = _evaluator("hetero32", "placeit")
    rng, twin = np.random.default_rng(5), np.random.default_rng(5)
    ev.pipeline().sample_random(rng, 4)      # placeit: connected at once
    twin.integers(2 ** 31 - 1)
    assert rng.integers(1 << 30) == twin.integers(1 << 30)


def test_homog_stage_hands_the_scorer_device_tensors():
    """The grid stage builds W on the pipeline's device: the request the
    scorer receives holds tensors, never host arrays."""
    ev = _evaluator("homog32", "placeit")
    t, r, batch = ev.pipeline()._gen(_gen(0), 4)
    again = build_score_graphs_batched(ev.arch, ev.rep.R, ev.rep.C, t, r)
    for k in testing.GRAPH_KEYS:
        assert isinstance(batch[k], torch.Tensor), k
        assert batch[k].device == ev.device, k
        assert torch.equal(again[k], batch[k]), k


def test_stages_are_cached_per_arch_and_device():
    a, b = _evaluator("hetero32"), _evaluator("hetero32", seed=1)
    assert a.pipeline()._gen is b.pipeline()._gen
    c = _rep("hetero32", mutation_mode="any-both")
    assert topt.DevicePipeline._stages(c, CPU)[2] is not a.pipeline()._gen


def test_score_request_takes_batch_dicts():
    """A batch dict's own ``connected`` overrides the scorer's flag and its
    ``weights`` reach the scorer; host graph lists still work."""
    ev = _evaluator("hetero32", "placeit")
    graphs = [ev.rep.score_graph(ev.rep.random(np.random.default_rng(i)))
              for i in range(3)]
    batch = {k: torch.from_numpy(v) for k, v in stack_graphs(graphs).items()}
    c0, m0 = topt._score_request(ev, graphs)
    assert m0["connected"].all()
    c1, m1 = topt._score_request(
        ev, dict(batch, connected=torch.tensor([True, False, True])))
    assert m1["connected"].tolist() == [True, False, True]
    np.testing.assert_array_equal(c1, c0)
    w = ev.weights_vec * 2
    req = topt._tag(batch, w)
    assert isinstance(req, dict) and req["weights"] is w
    c2, _ = topt._score_request(ev, req)
    np.testing.assert_array_equal(
        c2, ev.score_batch(stack_graphs(graphs), weights=w)["cost"])
    assert not np.array_equal(c2, c0)
    batch2, gconn, size, wrow = topt._request_parts(topt._tag(graphs, w))
    assert (gconn, size, wrow is w) == (None, 3, True)
    assert ev.archive is None


# ---------------------------------------------------------------------------
# Optimizers through the registry API.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_name", ["homog32", "hetero32", "hetero64",
                                       "homog256"])
def test_batched_algorithms_take_host_paper_defaults(arch_name):
    cfg = tapi.ExperimentConfig(arch=arch_name)
    for algo in ("br", "ga", "sa"):
        assert cfg.resolved_params(f"{algo}-batched") == \
            cfg.resolved_params(algo)
    if arch_name in ("hetero32", "hetero64"):
        want = tapi.PAPER_DEFAULTS[tapi.arch_family(arch_name)].ga
        assert cfg.resolved_params("ga-batched") == want


@pytest.mark.parametrize("arch_name,config", [("homog32", "placeit"),
                                               ("hetero32", "baseline")])
def test_batched_optimizers_return_valid_solutions(arch_name, config):
    cfg = tapi.ExperimentConfig(
        arch=arch_name, config=config,
        algorithms=("br-batched", "ga-batched", "sa-batched"),
        budget=tapi.Budget(evals=20), norm_samples=4, chunk=8,
        backend="fw-ref",
        params={"br-batched": {"batch": 8},
                "ga-batched": {"population": 8, "elitism": 2,
                               "tournament": 3},
                "sa-batched": {"chains": 4}})
    recs = tapi.run_experiment(cfg, device="cpu")
    rep = _rep(arch_name, config)
    check = (assert_valid_homog_batch if arch_name.startswith("homog")
             else assert_valid_hetero_batch)
    for rec in recs:
        res = rec.result
        assert np.isfinite(res.best_cost)
        assert res.n_generated >= res.n_evaluated >= 8
        a, b = res.best_sol
        assert a.dtype == b.dtype == np.int8
        check(rep, a[None], b[None])
        assert rep.score_graph((a, b)).connected
        assert res.best_metrics["connected"]
        assert res.history and res.history[-1][2] == res.best_cost
    ga = recs[1].result
    # The population up front, then population - elitism a generation:
    # (20 - 8) // 6 = 2 generations, the first being the population.
    assert ga.n_evaluated == 8 + 6


def test_batched_ga_under_a_schedule_rescores_the_final_population():
    from repro_torch.core.objective import Ramp, Schedule, TermSpec
    cfg = tapi.ExperimentConfig(
        arch="hetero32", config="placeit", algorithms=("ga-batched",),
        budget=tapi.Budget(evals=16), norm_samples=4, chunk=8,
        backend="fw-ref",
        objective=Objective().with_terms(
            TermSpec("node-degree", params={"max_degree": 1})),
        schedule=Schedule(ramps={"node-degree": Ramp("linear", 0.0, 1.0)}),
        params={"ga-batched": {"population": 6, "elitism": 2,
                               "tournament": 3}})
    res = tapi.run_experiment(cfg, device="cpu")[0].result
    assert np.isfinite(res.best_cost)
    assert res.n_evaluated == 6 + 4
