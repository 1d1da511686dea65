"""The port's Pareto sweeps against the JAX package, on the CPU.

* **dominance** — ``nondominated_mask`` (one ``[B, B, n]`` comparison in
  torch) equals ``nondominated_mask_host`` and the reference's mask
  exactly, duplicate rows included (they do not dominate each other);
* **hypervolume** — the torch sweeps compute in float32, as the
  reference's jitted paths do (JAX runs without x64 here), and agree with
  the reference's to rel 1e-6 for n = 2 and 3 (the sums run in another
  order) and with the port's float64 ``_hv_rec`` to rel 1e-6;
* **fronts** — ``run_pareto_sweep`` on homog32 and hetero32 host configs
  gives the reference's front: the same labels and placements, the same
  ``n_candidates``, and the cost matrix (``term_matrix``) bit for bit, as
  exact as the costs (the same float32 term functions on the same
  metrics); the hypervolume to rel 1e-6.  A GA-winner front holds the
  matrix bit for bit against the reference's term functions evaluated op
  by op, and within one ulp of XLA's compiled forms;
* **serde** — a front's JSON from either package loads in the other's
  ``ParetoFront.from_dict``; ``ParetoGridSpec`` and ``SweepConfig``
  round-trip and cross-load.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import pareto as jpareto
from repro_torch.core import api as tapi
from repro_torch.core import pareto as tpareto
from repro_torch.core.chiplets import paper_arch
from repro_torch.core.objective import Objective, TrafficMix, weights_vec
from repro_torch.core.topology import stack_graphs
from _torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
GRID = {"term_weights": {"lat": (0.5, 2.0), "area": (0.5, 2.0)}}
HV_RTOL = 1e-6


def tiny_pair(arch, **kw):
    d = dict(arch=arch, algorithms=["br"], budget={"evals": 4},
             norm_samples=3, chunk=4, params={"br": {"batch": 4}})
    d.update(kw)
    cj = japi.ExperimentConfig.from_dict(dict(d, backend="fw-ref"))
    ct = tapi.ExperimentConfig.from_dict(d)
    return cj, ct


# ---------------------------------------------------------------------------
# Dominance + hypervolume primitives.
# ---------------------------------------------------------------------------

def test_dominance_hand_computed():
    Y = np.array([[1, 5], [2, 2], [5, 1], [3, 3], [1, 5]], np.float32)
    mask = tpareto.nondominated_mask(Y, device=CPU)
    # (3,3) is dominated by (2,2); duplicates never dominate each other
    assert mask.tolist() == [True, True, True, False, True]
    assert np.array_equal(mask, tpareto.nondominated_mask_host(Y))
    assert tpareto.nondominated_mask(np.array([[1.0, 2.0]]),
                                     device=CPU).tolist() == [True]


@pytest.mark.parametrize("b,d", [(32, 2), (64, 3), (128, 4)])
def test_dominance_matches_host_and_reference(b, d):
    rng = np.random.default_rng(b)
    Y = (rng.random((b, d)) * 10).astype(np.float32)
    Y[rng.integers(0, b, b // 4)] = Y[rng.integers(0, b, b // 4)]
    got = tpareto.nondominated_mask(Y, device=CPU)
    np.testing.assert_array_equal(got, tpareto.nondominated_mask_host(Y))
    np.testing.assert_array_equal(got, jpareto.nondominated_mask(Y))


def test_hypervolume_hand_computed():
    Y = np.array([[1, 5], [2, 2], [5, 1]], np.float64)
    assert tpareto.hypervolume(Y, [6, 6], device=CPU) == pytest.approx(18.0)
    assert tpareto.hypervolume(Y, [6, 6], device=False) == pytest.approx(
        18.0)
    Y3 = np.array([[1, 0, 0], [0, 1, 1]], np.float64)
    want = (1 * 2 * 2) + (2 * 1 * 1) - (1 * 1 * 1)
    assert tpareto.hypervolume(Y3, [2, 2, 2], device=CPU) \
        == pytest.approx(want)
    assert tpareto.hypervolume(np.array([[7.0, 7.0]]), [6, 6],
                               device=CPU) == 0.0
    assert tpareto.hypervolume(np.zeros((0, 2)), [6, 6]) == 0.0
    with pytest.warns(UserWarning, match="no device path"):
        assert tpareto.hypervolume(np.ones((1, 4)), [2] * 4) == 1.0


@pytest.mark.parametrize("n", [2, 3])
def test_hypervolume_matches_reference_and_host_recursion(n):
    rng = np.random.default_rng(n)
    for _ in range(5):
        Y = rng.random((12, n)) * 4
        Y[3] = Y[7]                                   # a duplicate point
        ref = [4.5] * n
        got = tpareto.hypervolume(Y, ref, device=CPU)
        assert got == pytest.approx(jpareto.hypervolume(Y, ref),
                                    rel=HV_RTOL)
        assert got == pytest.approx(tpareto.hypervolume(Y, ref,
                                                        device=False),
                                    rel=HV_RTOL)
    assert tpareto._hv_rec(np.minimum(Y, ref), np.asarray(ref)) \
        == jpareto._hv_rec(np.minimum(Y, ref), np.asarray(ref))


# ---------------------------------------------------------------------------
# Grid expansion.
# ---------------------------------------------------------------------------

def test_grid_points_match_reference_and_roundtrip():
    gt = tpareto.ParetoGridSpec(**GRID)
    gj = jpareto.ParetoGridSpec(**GRID)
    pt, pj = gt.points(Objective()), gj.points(japi.Objective())
    assert [lab for lab, _ in pt] == [lab for lab, _ in pj] \
        == ["area=0.5|lat=0.5", "area=0.5|lat=2", "area=2|lat=0.5",
            "area=2|lat=2"]
    assert [o.to_dict() for _, o in pt] == [o.to_dict() for _, o in pj]
    assert len({o.structure_key() for _, o in pt}) == 1
    w = weights_vec(pt[0][1])
    assert w[9] == 0.5 and w[11] == 0.5
    assert tpareto.ParetoGridSpec.from_json(gt.to_json()) == gt
    assert tpareto.ParetoGridSpec.from_json(gj.to_json()) == gt
    mixes = tpareto.ParetoGridSpec(mixes=(
        TrafficMix(), TrafficMix(lat=(1, 1, 1, 1), thr=(1, 1, 1, 1))))
    assert mixes.n_points == len(mixes.points(Objective())) == 2
    with pytest.raises(ValueError, match="unknown objective term"):
        tpareto.ParetoGridSpec(term_weights={"bogus": (1.0,)}).points(
            Objective())
    with pytest.raises(ValueError, match="empty weight axis"):
        tpareto.ParetoGridSpec(term_weights={"lat": ()})
    with pytest.raises(ValueError, match="unknown ParetoGridSpec keys"):
        tpareto.ParetoGridSpec.from_dict({"bogus": 1})


# ---------------------------------------------------------------------------
# Fronts against the reference.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_name", ["homog32", "hetero32"])
def test_front_matches_reference(arch_name):
    cj, ct = tiny_pair(arch_name)
    rj = jpareto.run_pareto_sweep(cj, jpareto.ParetoGridSpec(**GRID))
    rt = tpareto.run_pareto_sweep(ct, GRID, device=CPU)
    (fj,), (ft,) = rj.fronts, rt.fronts
    Yj = np.asarray(fj.matrix, np.float32)
    Yt = np.asarray(ft.matrix, np.float32)
    assert Yt.shape == (4, 3)
    np.testing.assert_array_equal(Yt, Yj)
    mask = tpareto.nondominated_mask(Yt, device=CPU)
    np.testing.assert_array_equal(mask, tpareto.nondominated_mask_host(Yt))
    assert ft.n_candidates == fj.n_candidates == 4
    assert ft.term_names == fj.term_names == ("lat", "inv-thr", "area")
    assert [p.label for p in ft.points] == [p.label for p in fj.points]
    assert len(ft.points) == int(mask.sum()) >= 1
    for a, b in zip(fj.points, ft.points):
        assert b.placement == a.placement
        assert b.terms == a.terms
        assert (b.cfg_index, b.algorithm, b.repetition) \
            == (a.cfg_index, a.algorithm, a.repetition)
        assert b.objective.to_dict() == a.objective.to_dict()
        assert b.cost == a.cost
        assert rt.runs[b.cfg_index].config.objective == b.objective
    assert ft.ref_point == fj.ref_point
    assert ft.hypervolume == pytest.approx(fj.hypervolume, rel=HV_RTOL)
    assert ft.hypervolume > 0
    # JSON from either package loads in the other's ParetoFront.
    assert tpareto.ParetoFront.from_json(fj.to_json()).to_dict() \
        == fj.to_dict()
    assert jpareto.ParetoFront.from_json(ft.to_json()).to_dict() \
        == ft.to_dict()
    assert tpareto.ParetoFront.from_json(ft.to_json()).to_dict() \
        == ft.to_dict()
    rep = tapi.make_rep(paper_arch(arch_name), arch_name)
    for p in ft.points:
        assert rep.score_graph(p.sol()).connected


def test_front_of_ga_winners_matches_reference_term_values():
    """A GA-winner front (homog32, ``br`` and ``ga`` at 8 evaluations, a
    ``lat`` {0.5, 2} grid).  On the same metrics, the port's cost matrix
    equals, bit for bit, the reference's ``CompiledObjective.term_values``
    with the norm and weight rows as runtime operands, evaluated op by op
    (the formula as written).  It is held within one float32 ulp of the
    reference's ``term_matrix``, because that function closes over the
    norms and weights as constants in its jitted vmap
    (``src/repro/core/pareto.py:260-280``) and XLA folds each
    ``w * x / n`` into one multiply by a folded constant; and within one
    ulp of the same term functions jitted with runtime rows, because XLA
    also rewrites ``a / b / c`` into ``a / (b * c)`` (this case's ``br``
    row's ``inv-thr`` rounds one ulp apart that way)."""
    import jax
    import jax.numpy as jnp

    from repro.core import objective as jobjective

    grid = {"term_weights": {"lat": (0.5, 2.0)}}
    kw = dict(algorithms=["br", "ga"], budget={"evals": 8},
              params={"br": {"batch": 4},
                      "ga": {"population": 4, "elitism": 1,
                             "tournament": 2}})
    cj, ct = tiny_pair("homog32", **kw)
    rj = jpareto.run_pareto_sweep(cj, jpareto.ParetoGridSpec(**grid))
    rt = tpareto.run_pareto_sweep(ct, grid, device=CPU)
    (fj,), (ft,) = rj.fronts, rt.fronts
    assert ft.n_candidates == fj.n_candidates == 4
    assert [p.label for p in ft.points] == [p.label for p in fj.points]
    for a, b in zip(fj.points, ft.points):
        assert b.placement == a.placement
    Yt = np.asarray(ft.matrix, np.float32)
    np.testing.assert_array_max_ulp(Yt, np.asarray(fj.matrix, np.float32),
                                    maxulp=1)
    # The same candidates' metrics through both packages' term functions
    # with runtime rows.
    arch = paper_arch("homog32")
    rep = tapi.make_rep(arch, "homog32")
    entries = [("x", i, run.config.objective, rec)
               for i, run in enumerate(rt.runs) for rec in run.records]
    cands = tpareto.candidates_from_records(entries)
    assert [c.algorithm for c in cands] == ["br", "ga", "br", "ga"]
    ev = tapi.make_evaluator(rep, arch, rng=np.random.default_rng(0),
                             norm_samples=3, chunk=4, objective=ct.objective,
                             norm=cands[0].normalizers, device=CPU)
    batch = stack_graphs([rep.score_graph(c.sol) for c in cands])
    metrics = ev.score_batch(batch)
    got = tpareto.term_matrix(metrics, batch, ct.objective, ev.norm,
                              rep.layout.Vp, device=CPU)
    np.testing.assert_array_equal(got, Yt)
    jobj = jobjective.Objective.from_dict(ct.objective.to_dict())
    cobj = jobjective.compile_objective(jobj)
    n = len(cands)
    rows = jnp.asarray(np.broadcast_to(
        jobjective.norms_vec(ev.norm), (n, jobjective.NORM_DIM)))
    wrows = jnp.asarray(np.broadcast_to(jobjective.weights_vec(jobj),
                                        (n, len(weights_vec(ct.objective)))))
    sample = {k: jnp.asarray(np.asarray(v)) for k, v in metrics.items()
              if k not in ("cost", "connected")}
    for k in ("edges", "edge_mask", "edge_len"):
        sample[k] = jnp.asarray(batch[k])
    vp = rep.layout.Vp

    def mat(s, r, w):
        return jax.vmap(lambda si, ri, wi: jnp.stack(
            cobj.term_values(dict(si, Vp=vp), ri, wi)))(s, r, w)

    np.testing.assert_array_equal(
        got, np.asarray(mat(sample, rows, wrows), np.float32))
    np.testing.assert_array_max_ulp(
        got, np.asarray(jax.jit(mat)(sample, rows, wrows), np.float32),
        maxulp=1)


def test_term_matrix_columns_sum_to_cost():
    arch = paper_arch("homog32")
    rep = tapi.make_rep(arch, "homog32")
    obj = Objective.from_dict({"terms": [
        "lat", "inv-thr", "area",
        {"name": "link-length-cap", "weight": 0.5, "params": {"cap_mm": 2}},
        {"name": "node-degree", "weight": 0.25,
         "params": {"max_degree": 1}}]})
    ev = tapi.make_evaluator(rep, arch, rng=np.random.default_rng(0),
                             norm_samples=4, chunk=4, objective=obj,
                             device=CPU)
    _, graphs = ev.generate_valid(rep.random, np.random.default_rng(2), 6)
    batch = stack_graphs(graphs)
    metrics = ev.score_batch(batch)
    Y = tpareto.term_matrix(metrics, batch, obj, ev.norm, rep.layout.Vp,
                            device=CPU)
    assert Y.shape == (6, 5) and Y.dtype == np.float32
    # the scorer's cost is the sequential float32 sum of the same columns
    total = np.zeros(6, np.float32)
    for j in range(Y.shape[1]):
        total = total + Y[:, j]
    np.testing.assert_array_equal(total, metrics["cost"])


def test_incremental_front_equals_compute_front():
    _, ct = tiny_pair("homog32", algorithms=["br", "ga"],
                      budget={"evals": 8},
                      params={"br": {"batch": 4},
                              "ga": {"population": 4, "elitism": 1,
                                     "tournament": 2}})
    res = tpareto.run_pareto_sweep(ct, GRID, device=CPU)
    entries = [(run.config.objective.to_json(), i, run.config.objective,
                rec) for i, run in enumerate(res.runs)
               for rec in run.records]
    whole = tpareto.compute_front(ct, entries, device=CPU)
    inc = tpareto.IncrementalFront(ct, device=CPU)
    cands = tpareto.candidates_from_records(entries)
    inc.add(cands[:3])
    part = inc.add(cands[3:])
    assert part.to_dict() == whole.to_dict()
    assert whole.n_candidates == 8
    # the stats of a grid sweep: one scorer, one group, one norm draw
    tapi.clear_scorer_cache()
    again = tpareto.run_pareto_sweep(ct, GRID, device=CPU)
    assert again.stats.scorers_built == 1
    assert again.stats.stacked_groups == 1
    assert again.stats.evaluators_built == 1
    assert len(again.runs) == 4
    # a grid point's stacked records are bit for bit its solo run's
    solo = tapi.run_experiment(again.runs[2].config, device=CPU)
    assert [r.result.best_cost for r in again.runs[2].records] \
        == [r.result.best_cost for r in solo]


def test_archive_candidates_and_records():
    snap = {"costs": np.array([1.0, 2.0], np.float32),
            "a": np.zeros((2, 8, 5), np.int8),
            "b": np.ones((2, 8, 5), np.int8)}
    cands = tpareto.archive_candidates("x", 3, Objective(), snap)
    assert [(c.label, c.algorithm, c.repetition, c.cost) for c in cands] \
        == [("x|archive", "archive", -1, 1.0), ("x|archive", "archive", -1,
                                                2.0)]
    assert cands[1].sol[1].sum() == 40


def test_sweep_config_roundtrip_dispatch_and_cross_load():
    cj, ct = tiny_pair("homog32")
    sc = tapi.SweepConfig(configs=(ct,), pareto_grid=GRID)
    assert tapi.SweepConfig.from_json(sc.to_json()) == sc
    assert isinstance(sc.pareto_grid, tpareto.ParetoGridSpec)
    # the port's JSON loads in the reference and back
    scj = japi.SweepConfig.from_json(sc.to_json())
    assert scj.to_dict() == sc.to_dict()
    assert tapi.SweepConfig.from_json(scj.to_json()) == sc
    assert tapi.SweepConfig.from_dict(japi.SweepConfig(
        configs=(cj,), pareto_grid=GRID).to_dict()).configs[0] \
        == dataclasses.replace(ct, backend="fw-ref")
    res = tapi.run_sweep(sc, device=CPU)
    assert res.fronts is not None and len(res.fronts) == 1
    assert res.fronts[0].n_candidates == 4
    with pytest.raises(ValueError, match="unknown SweepConfig keys"):
        tapi.SweepConfig.from_dict({"bogus": 1})
    plain = tapi.run_sweep(tapi.SweepConfig(configs=(ct,)), device=CPU)
    assert plain.fronts is None
