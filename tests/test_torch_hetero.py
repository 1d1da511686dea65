"""The port's heterogeneous archs (hetero32, hetero64) against the JAX
package, on the CPU.

Host stages must match exactly: the Fig. 7 corner placement (scalar and
batched), the numpy-seeded operators and the score-graph arrays.  Small
GA / BR / SA runs on hetero32 through both packages' ``run_experiment``
must reach the same ``best_sol`` and agree on ``best_cost`` to rel 1e-5
(the tolerance ``tests/test_torch_api.py`` holds homog32 to: the search
compares float32 costs whose link loads sum in another order).
"""
import numpy as np
import pytest

from repro.core import api as japi
from repro.core import chiplets as jchiplets
from repro.core import placement_hetero as jhetero
from repro.core import topology as jtopology
from repro_torch import interop
from repro_torch.core import api as tapi
from repro_torch.core import chiplets as tchiplets
from repro_torch.core import placement_hetero as thetero
from repro_torch.core import topology as ttopology
from _torch_threads import one_torch_thread  # noqa: F401

GRAPH_KEYS = ("W", "edges", "edge_mask", "edge_len", "area")
ARCHS = [(a, c) for a in ("hetero32", "hetero64")
         for c in ("baseline", "placeit")]
# Placements a case draws: hetero64's host corner placement is the slowest
# host step of any arch.
N_SOLS = {"hetero32": 6, "hetero64": 3}
SMALL = dict(arch="hetero32", budget={"evals": 12}, norm_samples=6,
             chunk=4, params={"ga": {"population": 6, "elitism": 2,
                                     "tournament": 3},
                              "br": {"batch": 6}, "sa": {"chains": 2}})


def _reps(arch_name, config):
    rj = japi.make_rep(jchiplets.paper_arch(arch_name, config), arch_name)
    rt = tapi.make_rep(tchiplets.paper_arch(arch_name, config), arch_name)
    return rj, rt


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_corner_place_matches_reference(seed):
    """Random dims, half of them drawn from a small set so that equal
    sides (and equal selection keys) are common, as with real chiplets."""
    rng = np.random.default_rng(seed)
    n = 14
    w = np.where(rng.random(n) < 0.5, rng.choice([2.0, 3.0, 4.0], n),
                 rng.uniform(0.5, 5.0, n))
    h = np.where(rng.random(n) < 0.5, rng.choice([2.0, 3.0, 5.0], n),
                 rng.uniform(0.5, 5.0, n))
    dims = list(zip(w.tolist(), h.tolist()))
    want = jhetero.corner_place(dims)
    got = thetero.corner_place(dims)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    batch = thetero.corner_place_batch(np.array(dims)[None])
    np.testing.assert_array_equal(batch[0], want)


def test_corner_place_fig7_step4():
    """The hand-computed Fig. 7 step-4 case of tests/test_placements.py."""
    dims = [(2.0, 2.0), (2.0, 4.0), (4.0, 2.0)]
    pos = thetero.corner_place(dims)
    assert np.array_equal(pos, np.array([[0.0, 0.0], [2.0, 0.0],
                                         [0.0, 4.0]]))
    np.testing.assert_array_equal(pos, jhetero.corner_place(dims))


@pytest.mark.parametrize("arch_name", ["hetero32", "hetero64"])
def test_make_rep_builds_hetero_reps(arch_name):
    _, rt = _reps(arch_name, "baseline")
    assert isinstance(rt, thetero.HeteroRep)
    assert rt.mutation_mode == tapi.paper_defaults(arch_name).mutation_mode


@pytest.mark.parametrize("arch_name,config", ARCHS)
def test_host_ops_and_score_graphs_match_reference(arch_name, config):
    """Same seed -> the same random / mutate / merge Sols and bit-equal
    score-graph arrays, including ``connected``."""
    rj, rt = _reps(arch_name, config)
    gj, gt = np.random.default_rng(7), np.random.default_rng(7)
    n = N_SOLS[arch_name]
    sj = [rj.random(gj) for _ in range(n)]
    st = [rt.random(gt) for _ in range(n)]
    sj += [rj.mutate(sj[0], gj), rj.merge(sj[0], sj[1], gj)]
    st += [rt.mutate(st[0], gt), rt.merge(st[0], st[1], gt)]
    for a, b in zip(sj, st):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.int8
            np.testing.assert_array_equal(y, x)
    host_j = [rj.score_graph(s) for s in sj[:n]]
    host_t = [rt.score_graph(s) for s in st[:n]]
    bj, bt = jtopology.stack_graphs(host_j), ttopology.stack_graphs(host_t)
    for k in GRAPH_KEYS:
        assert bt[k].dtype == bj[k].dtype, k
        np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
    assert [g.connected for g in host_t] == [g.connected for g in host_j]
    assert rt.layout == tapi.make_rep(rt.arch, arch_name).layout
    assert (rt.layout.Vp, rt.e_max) == (rj.layout.Vp, rj.e_max)


@pytest.mark.parametrize("arch_name,config", ARCHS)
def test_geometry_batch_matches_scalar_and_reference(arch_name, config):
    """``geometry_batch`` (``corner_place_batch`` inside) equals the scalar
    ``geometry`` row for row, and the reference's batch, bit for bit."""
    rj, rt = _reps(arch_name, config)
    rng = np.random.default_rng(3)
    sols = [rt.random(rng) for _ in range(N_SOLS[arch_name])]
    o = np.stack([s[0] for s in sols])
    r = np.stack([s[1] for s in sols])
    ppos, area = rt.batch_ops("cpu").geometry_batch(o, r)
    assert (ppos.dtype, area.dtype) == (np.float32, np.float32)
    for i, s in enumerate(sols):
        geo = rt.geometry(s)
        np.testing.assert_array_equal(ppos[i], geo.pos)
        assert area[i] == np.float32(geo.area)
    pj, aj = rj.batch_ops().geometry_batch(o, r)
    np.testing.assert_array_equal(ppos, np.asarray(pj))
    np.testing.assert_array_equal(area, np.asarray(aj))


def test_sol_from_arrays_takes_hetero_sols():
    """A reference hetero Sol (1-D int8 ``(order, rots)``) reaches the port
    as it is; the 2-D homogeneous form still does, and unequal shapes do
    not."""
    rj, rt = _reps("hetero32", "baseline")
    sol = rj.random(np.random.default_rng(0))
    got = interop.sol_from_arrays(*sol)
    for x, y in zip(sol, got):
        assert y.dtype == x.dtype == np.int8 and y.shape == x.shape
        np.testing.assert_array_equal(y, x)
    g = rt.score_graph(got)
    np.testing.assert_array_equal(g.W, rj.score_graph(sol).W)
    t, r = interop.sol_from_arrays(np.zeros((8, 5)), np.zeros((8, 5)))
    assert t.dtype == r.dtype == np.int8 and t.shape == (8, 5)
    with pytest.raises(ValueError):
        interop.sol_from_arrays(sol[0], sol[1][:-1])
    # [R, C, Z] is the 3D families' Sol since they were ported; four axes
    # are no Sol.
    t, r = interop.sol_from_arrays(np.zeros((2, 2, 2)), np.zeros((2, 2, 2)))
    assert t.shape == (2, 2, 2)
    with pytest.raises(ValueError):
        interop.sol_from_arrays(np.zeros((2, 2, 2, 2)),
                                np.zeros((2, 2, 2, 2)))


def _configs(algo, seed=1):
    cj = japi.ExperimentConfig.from_dict(
        dict(SMALL, algorithms=[algo], seed=seed, backend="fw-ref"))
    return cj, interop.config_from_json(cj.to_json())


@pytest.mark.parametrize("algo", ["ga", "br", "sa"])
def test_hetero32_run_experiment_matches_reference(algo):
    cj, ct = _configs(algo)
    rj = japi.run_experiment(cj)[0].result
    rt = tapi.run_experiment(ct, device="cpu")[0].result
    for a, b in zip(interop.sol_from_arrays(*rj.best_sol), rt.best_sol):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    assert rt.best_cost == pytest.approx(rj.best_cost, rel=1e-5)
    assert rt.n_evaluated == rj.n_evaluated
    assert rt.n_generated == rj.n_generated
    for k, v in rj.best_metrics.items():
        assert rt.best_metrics[k] == pytest.approx(v, rel=1e-5), k


def test_hetero32_baseline_cost_matches_reference():
    cj, ct = _configs("ga")
    cost_j, mj = japi.baseline_cost(cj)
    cost_t, mt = tapi.baseline_cost(ct, device="cpu")
    assert set(mt) == set(mj)
    for k, v in mj.items():
        assert mt[k] == pytest.approx(v, rel=1e-5), k
    assert cost_t == pytest.approx(cost_j, rel=1e-5)
