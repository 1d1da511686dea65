"""The port's host-side core against the JAX package, on the CPU.

Arch specs, seeded placements, score graphs, the mesh baseline, the JSON
forms of ``Objective`` / ``ExperimentConfig`` and the float64 host cost
must all be identical between ``repro`` and ``repro_torch``; the parts not
ported yet must refuse clearly.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import api as japi
from repro.core import baseline as jbaseline
from repro.core import chiplets as jchiplets
from repro.core import cost as jcost
from repro.core import objective as jobjective
from repro.core import proxies as jproxies
from repro.core import topology as jtopology
from repro_torch import interop
from repro_torch.core import api as tapi
from repro_torch.core import baseline as tbaseline
from repro_torch.core import chiplets as tchiplets
from repro_torch.core import cost as tcost
from repro_torch.core import objective as tobjective
from repro_torch.core import proxies as tproxies
from repro_torch.core import topology as ttopology
from repro_torch.core.optimize import DevicePipeline
from _torch_threads import one_torch_thread  # noqa: F401

PAPER = [(a, c) for a in ("homog32", "homog64", "hetero32", "hetero64")
         for c in ("baseline", "placeit")]
HOMOG = [(a, c) for a in ("homog32", "homog64")
         for c in ("baseline", "placeit")]
GRAPH_FIELDS = ("W", "edges", "edge_mask", "area", "connected", "edge_len")


def _reps(arch_name, config):
    ja = jchiplets.paper_arch(arch_name, config)
    ta = tchiplets.paper_arch(arch_name, config)
    return japi.make_rep(ja, arch_name), tapi.make_rep(ta, arch_name)


def _assert_graphs_equal(gj, gt):
    for f in GRAPH_FIELDS:
        a, b = getattr(gj, f), getattr(gt, f)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), f)


@pytest.mark.parametrize("arch_name,config", PAPER)
def test_arch_spec_fields_equal(arch_name, config):
    ja = jchiplets.paper_arch(arch_name, config)
    ta = tchiplets.paper_arch(arch_name, config)
    assert dataclasses.asdict(ta) == dataclasses.asdict(ja)
    assert ta.counts() == ja.counts() and ta.kinds() == ja.kinds()
    for cj, ct in zip(ja.chiplets, ta.chiplets):
        assert ct.allowed_rotations() == cj.allowed_rotations()
    lj = jproxies.layout_for(ja)
    assert tproxies.layout_for(ta) == tproxies.Layout(lj.Vp, lj.kinds)


@pytest.mark.parametrize("arch_name,config", HOMOG)
def test_seeded_operators_give_identical_sols_and_graphs(arch_name, config):
    rj, rt = _reps(arch_name, config)
    assert rt.layout == tproxies.Layout(rj.layout.Vp, rj.layout.kinds)
    gj_rng, gt_rng = np.random.default_rng(11), np.random.default_rng(11)
    sols = []
    for step in range(6):
        if step < 2:
            sj, st = rj.random(gj_rng), rt.random(gt_rng)
        elif step < 4:
            sj, st = rj.mutate(sols[-1][0], gj_rng), rt.mutate(
                sols[-1][1], gt_rng)
        else:
            sj = rj.merge(sols[0][0], sols[-1][0], gj_rng)
            st = rt.merge(sols[0][1], sols[-1][1], gt_rng)
        for a, b in zip(sj, st):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
        _assert_graphs_equal(rj.score_graph(sj), rt.score_graph(st))
        assert rt.is_connected(st) == rj.is_connected(sj)
        sols.append((sj, st))
    assert gt_rng.random() == gj_rng.random()       # streams stayed in step
    bj = jtopology.stack_graphs([rj.score_graph(s[0]) for s in sols])
    bt = ttopology.stack_graphs([rt.score_graph(s[1]) for s in sols])
    assert bj.keys() == bt.keys()
    for k in bj:
        np.testing.assert_array_equal(bt[k], bj[k])


@pytest.mark.parametrize("arch_name,config", PAPER)
def test_mesh_baseline_graph_identical(arch_name, config):
    ja = jchiplets.paper_arch(arch_name, config)
    ta = tchiplets.paper_arch(arch_name, config)
    gj, geo_j, links_j = jbaseline.MeshBaseline(ja).build()
    gt, geo_t, links_t = tbaseline.MeshBaseline(ta).build()
    _assert_graphs_equal(gj, gt)
    assert links_t == links_j
    np.testing.assert_array_equal(geo_t.pos, geo_j.pos)
    assert geo_t.area == geo_j.area


def _objective_dict():
    return {"mix": {"lat": [0.5, 2.0, 0.1, 1.0], "thr": [0.1, 2.0, 0.3, 2.0]},
            "w_area": 1.5, "normalizer": "median",
            "terms": [{"name": "lat", "weight": 1.0, "params": {}},
                      {"name": "inv-thr", "weight": 0.5, "params": {}},
                      {"name": "area", "weight": 1.0, "params": {}},
                      {"name": "link-length-cap", "weight": 2.0,
                       "params": {"cap_mm": 2.0}},
                      {"name": "node-degree", "weight": 1.0,
                       "params": {"max_degree": 1}}]}


def test_objective_json_roundtrips_both_ways():
    oj = jobjective.Objective.from_dict(_objective_dict())
    ot = interop.objective_from_json(oj.to_json())
    assert ot.to_dict() == oj.to_dict()
    assert jobjective.Objective.from_json(ot.to_json()) == oj
    assert tobjective.Objective.from_json(ot.to_json()) == ot
    np.testing.assert_array_equal(tobjective.weights_vec(ot),
                                  jobjective.weights_vec(oj))
    assert ot.structure_key() == oj.structure_key()
    sj = jobjective.Schedule(ramps={"node-degree": jobjective.Ramp(
        "cosine", 0.0, 1.0)})
    st = tobjective.Schedule.from_json(sj.to_json())
    assert st.to_dict() == sj.to_dict()
    for t in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(
            tobjective.compile_schedule(st, ot).weights_at(t),
            jobjective.compile_schedule(sj, oj).weights_at(t))


def test_experiment_config_json_roundtrips_both_ways():
    cj = japi.ExperimentConfig(
        arch="homog64", config="placeit", algorithms=("sa", "ga"),
        repetitions=2, budget=japi.Budget(evals=100, seconds=12.5),
        norm_samples=16, seed=7, backend="fw-pallas", chunk=8,
        params={"sa": {"chains": 4}, "ga": {"population": 10}},
        objective=_objective_dict(),
        schedule={"ramps": {"node-degree": {"kind": "linear"}}})
    ct = interop.config_from_json(cj.to_json())
    assert ct.backend == "fw-cuda"
    # "fw-cuda" is written back under the reference's name for it.
    assert ct.to_dict() == cj.to_dict()
    assert tapi.ExperimentConfig.from_json(ct.to_json()) == ct
    back = japi.ExperimentConfig.from_json(ct.to_json())
    assert back.to_dict() == cj.to_dict()
    assert ct.resolved_params("sa") == tapi.SAParams(
        **dataclasses.asdict(cj.resolved_params("sa")))
    assert tapi.ExperimentConfig(arch="homog32").backend == "fw-tiled"
    assert tapi.ExperimentConfig(arch="homog32").to_dict()["backend"] == \
        "fw-tiled"


@pytest.mark.parametrize("backend", [None, "fw-cuda"])
def test_port_json_runs_in_the_reference(backend):
    """A port config's JSON, on the default backend and on "fw-cuda", runs
    through the reference's run_experiment (its Pallas kernels in
    interpret mode on the CPU) and reaches the port's placement."""
    kw = {} if backend is None else {"backend": backend}
    ct = tapi.ExperimentConfig(
        arch="homog32", config="baseline", algorithms=("ga",),
        budget=tapi.Budget(evals=16), norm_samples=8, chunk=4,
        params={"ga": {"population": 8, "elitism": 2, "tournament": 2}},
        **kw)
    cj = japi.ExperimentConfig.from_json(ct.to_json())
    assert cj.backend == {None: "fw-tiled", "fw-cuda": "fw-pallas"}[backend]
    rj = japi.run_experiment(cj)[0].result
    rt = tapi.run_experiment(ct, device="cpu")[0].result
    assert rj.n_evaluated == rt.n_evaluated
    for a, b in zip(interop.sol_from_arrays(*rj.best_sol), rt.best_sol):
        np.testing.assert_array_equal(a, b)
    assert rt.best_cost == pytest.approx(rj.best_cost, rel=1e-5)


def test_objective_cost_host_float64_identical():
    rng = np.random.default_rng(3)
    P, E = 6, 20
    metrics = {f"lat_{t}": rng.uniform(100, 300, P).astype(np.float32)
               for t in jchiplets.TRAFFIC_TYPES}
    metrics.update({f"thr_{t}": rng.uniform(0.05, 1, P).astype(np.float32)
                    for t in jchiplets.TRAFFIC_TYPES})
    metrics["area"] = np.full(P, 540.0, np.float32)
    batch = {"edges": rng.integers(0, 30, (P, E, 2)).astype(np.int32),
             "edge_mask": rng.random((P, E)) < 0.7,
             "edge_len": rng.uniform(1, 4, (P, E)).astype(np.float32)}
    nj = jcost.CostNormalizers.from_samples(metrics)
    nt = tcost.CostNormalizers.from_samples(metrics)
    assert dataclasses.asdict(nt) == dataclasses.asdict(nj)
    for obj in (_objective_dict(), {}):
        oj = jobjective.Objective.from_dict(obj)
        ot = tobjective.Objective.from_dict(obj)
        cj = jobjective.objective_cost_host(metrics, oj, nj, batch=batch)
        ct = tobjective.objective_cost_host(metrics, ot, nt, batch=batch)
        assert ct.dtype == np.float64
        np.testing.assert_array_equal(ct, cj)
    arch = tchiplets.paper_arch("homog32")
    np.testing.assert_array_equal(
        tcost.total_cost(metrics, arch, nt),
        jcost.total_cost(metrics, jchiplets.paper_arch("homog32"), nj))


def test_interop_normalizers_roundtrip():
    vec = np.array([130, 190, 165, 235, 3, 8, 8, 1.5, 540], np.float32)
    norm = interop.normalizers_from_vec(vec)
    np.testing.assert_array_equal(tobjective.norms_vec(norm), vec)
    np.testing.assert_array_equal(interop.norms_tensor(vec).numpy(), vec)
    with pytest.raises(ValueError):
        interop.norms_tensor(vec[:4])
    with pytest.raises(ValueError):
        interop.sol_from_arrays(np.zeros((2, 2)), np.zeros((2, 3)))


def test_unported_parts_refuse_by_name():
    # The 3D families, the archive and sharding are ported (queue 1 items
    # 12 and 13), and so is the encoder-decoder family (15e-2): its
    # encoder's groups are carried across, and a subtree the reference's
    # parameters do not have is refused by name.
    assert interop.lm_params_from_jax({"enc_groups": []}) == {}
    with pytest.raises(ValueError, match="'extra'"):
        interop.lm_params_from_jax({"extra": {"w": np.zeros(2, np.float32)}})
    with pytest.raises(TypeError, match="device_stage_key"):
        DevicePipeline._stages(object(), "cpu")
    rep = tapi.make_rep(tchiplets.resolve_arch("stack3d32"), "stack3d32")
    assert rep.records and rep.R * rep.C * rep.Z == 32
    rep = tapi.make_rep(tchiplets.paper_arch("homog32"), "homog32")
    ev = tapi.make_evaluator(rep, rep.arch, rng=np.random.default_rng(0),
                             norm_samples=2, archive_k=4, device="cpu")
    assert ev.archive is not None and ev.archive.k == 4
    with pytest.raises(KeyError, match="unknown scorer backend"):
        tapi.get_scorer(rep.layout, chunk=4, backend="fw-pallas",
                        device="cpu")
