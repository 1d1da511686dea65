"""The port's 3D / hierarchical arch families (``repro_torch.arch3d``)
against the JAX package, on the CPU.

* **records** — ``family_records`` of all five families, both chiplet
  configs, equal the reference's record for record (the registered
  ``torus`` / ``express`` augmentations included); a custom augmentation
  registers; an unknown family, an unknown augmentation and a bad express
  stride raise.
* **host operators** — ``Homog3DRep.random`` / ``mutate`` / ``merge`` draw
  from numpy's generator exactly as the reference's do: the same seed
  gives the same placements, so host BR/GA/SA on a 3D family match the
  reference draw for draw (host GA on stack3d32: equal ``best_sol`` and
  ``best_cost``).
* **graph builds** — ``score_graph3d_host`` and the batched
  ``Grid3DGraphBatch.build`` (torch, on the CPU here) equal the
  reference's host build bit for bit, every stacked array slot for slot,
  on random and mutated placements of all five families.
* **device pipeline** — the batched operators keep the chiplet multiset
  and the record-backed rotations; reps that differ only in their tier
  factors share one stage-cache entry; ``scorer_shape_key`` keeps
  same-layout families with different edge counts on separate scorers;
  a ``gw3d64`` request through ``DesignEngine`` finishes with a
  ``[4, 4, 4]`` placement; a port JSON of a stack3d32 run runs in the
  reference and reaches the port's placement.

The reference runs on ``"fw-ref"``; the port on its default backend (the
plain FW on the CPU).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.arch3d import families as jfam
from repro.arch3d import topology as jtopo
from repro.core import api as japi
from repro.core import chiplets as jchiplets
from repro.core.topology import stack_graphs as jstack
from repro_torch import interop, testing
from repro_torch.arch3d import (FAMILIES3D, TIER_BACKBONE, AdjRecord,
                                default_tier_values, make_rep3d)
from repro_torch.arch3d import topology as ttopo
from repro_torch.core import api as tapi
from repro_torch.core import optimize as topt
from repro_torch.core.chiplets import resolve_arch
from repro_torch.core.objective import Objective, TermSpec
from repro_torch.core.registries import AUGMENTATIONS, register_augmentation
from repro_torch.core.topology import stack_graphs
from repro_torch.netsim import Workload
from repro_torch.serve.design import DesignEngine
from _torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
FAMILIES = tuple(FAMILIES3D)
CONFIGS = ("baseline", "placeit")
PIPELINE_ARCHS_3D = testing.PIPELINE_ARCHS_3D
KEYS = ("W", "edges", "edge_mask", "area", "edge_len")


def _reps(name, config="baseline"):
    """The family's rep in both packages."""
    tj = jfam.make_rep3d(jchiplets.resolve_arch(name, config), name)
    tt = make_rep3d(resolve_arch(name, config), name)
    return tj, tt


def _sols(rep, seed=123, n=3):
    rng = np.random.default_rng(seed)
    sols = [rep.random(rng) for _ in range(n)]
    sols += [rep.mutate(s, rng) for s in list(sols)]
    sols.append(rep.merge(sols[0], sols[1], rng))
    return sols


def test_family_names_match_reference():
    assert FAMILIES == tuple(jfam.FAMILIES3D)
    for name in FAMILIES:
        assert dataclasses.astuple(FAMILIES3D[name]) == \
            dataclasses.astuple(jfam.FAMILIES3D[name])
        assert tapi.arch_family(name) == japi.arch_family(name)
        assert tapi.paper_defaults(name).ga.population == \
            japi.paper_defaults(name).ga.population


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("name", FAMILIES)
def test_family_records_match_reference(name, config):
    rj, rt = _reps(name, config)
    assert [dataclasses.astuple(a) for a in rt.records] == \
        [dataclasses.astuple(a) for a in rj.records]
    assert rt.e_max == rj.e_max and rt.area == rj.area
    assert rt.scorer_shape_key == rj.scorer_shape_key
    np.testing.assert_array_equal(rt.tier_values, rj.tier_values)
    assert rt.layout.Vp == rj.layout.Vp
    assert rt._rot_other == rj._rot_other


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("name", FAMILIES)
def test_graph_builds_match_reference_host_build(name, config):
    """Host operators draw for draw, ``score_graph3d_host`` and the
    batched build bit for bit, against the reference's host build."""
    rj, rt = _reps(name, config)
    sj, st = _sols(rj), _sols(rt)
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
        assert b[0].dtype == b[1].dtype == np.int8
    gj = [rj.score_graph(s) for s in sj]
    gt = [rt.score_graph(s) for s in st]
    assert [g.connected for g in gt] == [g.connected for g in gj]
    want = jstack(gj)
    host = stack_graphs(gt)
    dev = rt.graph_batch(CPU).build(
        torch.from_numpy(np.stack([s[0] for s in st])),
        torch.from_numpy(np.stack([s[1] for s in st])),
        torch.as_tensor(rt.tier_values))
    for k in KEYS:
        got = dev[k].numpy()
        assert host[k].dtype == want[k].dtype == got.dtype, k
        np.testing.assert_array_equal(host[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got, want[k], err_msg=k)


@pytest.mark.parametrize("tsv", [1.0, 16.0])
def test_tier_operand_matches_reference(tsv):
    """A non-default tier vector as the build's runtime operand equals the
    reference's host build with those tiers."""
    rj, rt = _reps("gw3d64", "placeit")
    rj = dataclasses.replace(rj, tsv_slowdown=tsv, backbone_factor=3.0)
    rt = dataclasses.replace(rt, tsv_slowdown=tsv, backbone_factor=3.0)
    np.testing.assert_array_equal(rt.tier_values, rj.tier_values)
    st = _sols(rt, seed=5, n=2)
    want = jstack([rj.score_graph(s) for s in st])
    got = rt.graph_batch(CPU).build(
        torch.from_numpy(np.stack([s[0] for s in st])),
        torch.from_numpy(np.stack([s[1] for s in st])),
        torch.as_tensor(rt.tier_values))
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_tier_values_formula():
    arch = resolve_arch("stack3d32")
    lp, ll = arch.latency.l_phy, arch.latency.l_link
    tv = default_tier_values(arch, tsv_slowdown=16.0, backbone_factor=3.0)
    np.testing.assert_array_equal(
        tv, np.float32([2 * lp + ll, 2 * lp + 3 * ll, 2 * lp + 16 * ll]))
    np.testing.assert_array_equal(
        tv, jtopo.default_tier_values(jchiplets.resolve_arch("stack3d32"),
                                      tsv_slowdown=16.0,
                                      backbone_factor=3.0))


@pytest.mark.parametrize("name", ["stack3d32", "gw3d64"])
def test_batched_operators_keep_multiset_and_record_rotations(name):
    _, rep = _reps(name, "baseline")
    ops = rep.batch_ops(CPU)
    gen = torch.Generator().manual_seed(0)
    t, r = ops.random_batch(gen, 12)
    mt, mr = ops.mutate_batch(gen, t, r)
    ct, cr = ops.merge_batch(gen, t, r, mt, mr)
    counts = tuple(len(rep._kind_instances[k]) for k in (0, 1, 2))
    for types, rot in ((t, r), (mt, mr), (ct, cr)):
        assert types.shape == (12, rep.R, rep.C, rep.Z)
        assert types.dtype == rot.dtype == torch.int8
        for b in range(12):
            tf = types[b].reshape(-1).numpy()
            rf = rot[b].reshape(-1).numpy()
            assert tuple(int((tf == k).sum()) for k in (0, 1, 2)) == counts
            for cell, k in enumerate(tf):
                if k >= 0 and rep._rotatable.get(int(k), False):
                    anyr = [i for i in range(4) if rep._rot_other[cell][i]]
                    assert int(rf[cell]) in (anyr or range(4))
                else:
                    assert rf[cell] == 0


def test_host_ga_on_stack3d32_matches_reference():
    d = dict(arch="stack3d32", algorithms=["ga"], budget={"evals": 16},
             norm_samples=6, chunk=4,
             params={"ga": {"population": 8, "elitism": 2, "tournament": 3}})
    cj = japi.ExperimentConfig.from_dict(dict(d, backend="fw-ref"))
    ct = tapi.ExperimentConfig.from_dict(d)
    rj = japi.run_experiment(cj)[0].result
    rt = tapi.run_experiment(ct, device=CPU)[0].result
    for a, b in zip(interop.sol_from_arrays(*rj.best_sol), rt.best_sol):
        np.testing.assert_array_equal(b, a)
    assert np.float32(rt.best_cost).tobytes() == \
        np.float32(rj.best_cost).tobytes()
    assert rt.n_evaluated == rj.n_evaluated
    assert rt.n_generated == rj.n_generated


def test_tier_swap_shares_one_stage_entry():
    _, rep_a = _reps("stack3d32")
    rep_b = dataclasses.replace(rep_a, tsv_slowdown=16.0,
                                backbone_factor=4.0)
    assert rep_a.device_stage_key() == rep_b.device_stage_key()
    topt.DevicePipeline.clear_stage_cache()
    assert topt.DevicePipeline._stages(rep_a, CPU) is \
        topt.DevicePipeline._stages(rep_b, CPU)
    assert len(topt.DevicePipeline._STAGE_CACHE) == 1
    # ... and the pipelines built on it bind different tier operands.
    arch = rep_a.arch
    evs = [tapi.make_evaluator(rep, arch, rng=np.random.default_rng(0),
                               norm_samples=2, chunk=4, device=CPU)
           for rep in (rep_a, rep_b)]
    sol = rep_a.random(np.random.default_rng(0))
    t, r = (torch.from_numpy(x[None]) for x in sol)
    Wa, Wb = (ev.pipeline().rebuild(t, r)["W"] for ev in evs)
    assert len(topt.DevicePipeline._STAGE_CACHE) == 1
    assert not torch.equal(Wa, Wb)
    np.testing.assert_array_equal(Wa[0].numpy(), rep_a.score_graph(sol).W)
    np.testing.assert_array_equal(Wb[0].numpy(), rep_b.score_graph(sol).W)


def test_unknown_family_and_bad_augment_raise():
    arch = resolve_arch("stack3d32")
    with pytest.raises(ValueError, match="unknown 3D arch family"):
        make_rep3d(arch, "stack3d999")
    _, rep = _reps("stack3d32")
    with pytest.raises(KeyError, match="unknown augmentation"):
        dataclasses.replace(rep, augment="no-such-augment")
    _, rep = _reps("express3d32")
    with pytest.raises(ValueError, match="stride"):
        dataclasses.replace(rep, augment_params={"stride": 1})
    with pytest.raises(ValueError, match="unknown 3D family kind"):
        ttopo.grid3d_adjacency(arch, 4, 4, 2, kind="pyramid")
    with pytest.raises(ValueError, match="does not tile"):
        ttopo.grid3d_adjacency(arch, 4, 4, 2, kind="gateway", cluster=(3, 2))


def test_custom_augmentation_registers():
    if "diag-test" not in AUGMENTATIONS.names():
        @register_augmentation("diag-test")
        def diag(R, C, Z, sz_mm, params):
            return [AdjRecord(cell1=ttopo._cid(0, 0, 0, C, Z),
                              cell2=ttopo._cid(1, 1, 0, C, Z),
                              loc1=1, loc2=3, rot1=1, rot2=3,
                              tier=TIER_BACKBONE, length=float(sz_mm))]

    _, base = _reps("stack3d32")
    rep = dataclasses.replace(base, augment="diag-test")
    assert len(rep.records) == len(base.records) + 1
    assert rep.device_stage_key() != base.device_stage_key()
    assert rep.scorer_shape_key != base.scorer_shape_key


def test_same_layout_families_get_separate_scorers():
    """stack3d32 and torus3d32 share a layout but not their edge counts:
    ``scorer_shape_key`` keeps their scorers apart, so a sweep never
    stacks unlike batches."""
    tapi.clear_scorer_cache()
    cfgs = [tapi.ExperimentConfig(
        arch=name, algorithms=("ga-batched",), budget=tapi.Budget(evals=12),
        norm_samples=3, chunk=4,
        params={"ga-batched": dict(population=6, elitism=2, tournament=2)})
        for name in ("stack3d32", "torus3d32")]
    res = tapi.run_sweep(cfgs, device=CPU)
    assert res.stats.scorers_built == 2
    assert res.stats.stacked_groups == 0
    for run in res.runs:
        rec = run.records[0]
        assert np.isfinite(rec.result.best_cost)
        assert rec.result.best_sol[0].shape == (4, 4, 2)


def test_design_engine_runs_gw3d64():
    arch = resolve_arch("gw3d64", "placeit")
    wl = Workload.synthetic(arch.kinds(), "c2m", 0.01)
    obj = Objective().with_terms(TermSpec("trace-lat", weight=0.5))
    cfg = tapi.ExperimentConfig(
        arch="gw3d64", config="placeit", algorithms=("ga-batched",),
        budget=tapi.Budget(evals=16), norm_samples=4, chunk=4,
        objective=obj, workload=wl,
        params={"ga-batched": dict(population=8, elitism=2, tournament=2)})
    eng = DesignEngine(device=CPU)
    rid = eng.submit(tapi.DesignRequest(config=cfg, request_id="t3d"))
    eng.run()
    resp = eng.result(rid)
    assert resp.status == "done", resp.error
    (rec,) = resp.records
    assert np.isfinite(rec.result.best_cost)
    assert rec.result.best_sol[0].shape == (4, 4, 4)
    assert rec.result.best_metrics["connected"]
    assert [u.kind for u in resp.updates][-1] == "done"


def test_port_json_of_stack3d32_runs_in_the_reference():
    """A port stack3d32 config's JSON runs through the reference's
    run_experiment and reaches the port's placement; the port's winner
    goes back through the reference's ``sol`` form and scores there."""
    ct = tapi.ExperimentConfig(
        arch="stack3d32", config="placeit", algorithms=("ga",),
        budget=tapi.Budget(evals=16), norm_samples=6, chunk=4,
        params={"ga": {"population": 8, "elitism": 2, "tournament": 2}})
    cj = japi.ExperimentConfig.from_json(ct.to_json())
    assert cj.backend == "fw-tiled" and cj.arch == "stack3d32"
    rj = japi.run_experiment(cj)[0].result
    rt = tapi.run_experiment(ct, device=CPU)[0].result
    assert rj.n_evaluated == rt.n_evaluated
    sol = interop.sol_from_arrays(*rj.best_sol)
    assert sol[0].shape == (4, 4, 2)
    for a, b in zip(sol, rt.best_sol):
        np.testing.assert_array_equal(a, b)
    assert rt.best_cost == pytest.approx(rj.best_cost, rel=1e-6)


def test_sol_from_arrays_takes_3d_solutions():
    t, r = interop.sol_from_arrays(np.zeros((4, 4, 2)), np.ones((4, 4, 2)))
    assert t.shape == r.shape == (4, 4, 2) and t.dtype == np.int8
    with pytest.raises(ValueError, match=r"\[R, C, Z\]"):
        interop.sol_from_arrays(np.zeros((2, 2, 2, 2)),
                                np.zeros((2, 2, 2, 2)))


@pytest.mark.parametrize("arch_name,config", [
    pytest.param(a, c, id=f"{a}-{c}") for a, c in PIPELINE_ARCHS_3D])
def test_batched_build_parity_helper_on_3d(arch_name, config):
    """``testing.batched_build_parity`` (the smoke's 3D parity phase) on
    the CPU: every stacked array bit for bit and the scorer's metrics and
    cost from both builds bit-equal."""
    out = testing.batched_build_parity(arch_name, config, 4, device=CPU,
                                       chunk=4)
    assert out["n"] == 4 and out["links"] > 0
