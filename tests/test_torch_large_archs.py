"""The 100+-chiplet families (homog100, homog144, homog256, hex127) in the
port against the JAX package, on the CPU.

Arch specs, family and defaults, the hexagonal mask, seeded placements and
score graphs must be identical between ``repro`` and ``repro_torch``; a
small homog100 run on backend ``"fw-tiled"`` must reach the reference's
``best_sol`` and agree on ``best_cost`` to rel 1e-5 (the tolerance of
``tests/test_torch_api.py``: link loads sum in another float32 order).
The reference runs on ``"fw-ref"``: its Pallas interpreter is far too slow
at V = 552, and every FW backend is bit for bit the same function.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import api as japi
from repro.core import chiplets as jchiplets
from repro.core import placement_homog as jplacement
from repro.core import topology as jtopology
from repro_torch import interop, testing
from repro_torch.core import api as tapi
from repro_torch.core import chiplets as tchiplets
from repro_torch.core import placement_homog as tplacement
from repro_torch.core import proxies as tproxies
from repro_torch.core import topology as ttopology
from repro_torch.kernels import fw_counts_tiled as fwt
from repro_torch.kernels import ops
from _torch_threads import one_torch_thread  # noqa: F401

LARGE = [(a, c) for a in testing.LARGE_ARCHS for c in ("baseline", "placeit")]
GRAPH_FIELDS = ("W", "edges", "edge_mask", "area", "edge_len")


@pytest.mark.parametrize("arch_name,config", LARGE)
def test_large_arch_host_parity(arch_name, config):
    ja = jchiplets.resolve_arch(arch_name, config)
    ta = tchiplets.resolve_arch(arch_name, config)
    assert dataclasses.asdict(ta) == dataclasses.asdict(ja)
    assert ta.counts() == ja.counts()
    assert tapi.arch_family(arch_name) == japi.arch_family(arch_name)
    assert dataclasses.asdict(tapi.paper_defaults(arch_name)) == \
        dataclasses.asdict(japi.paper_defaults(arch_name))
    assert tapi.LARGE_GRIDS[arch_name] == japi.LARGE_GRIDS[arch_name]
    rj, rt = japi.make_rep(ja, arch_name), tapi.make_rep(ta, arch_name)
    assert (rt.R, rt.C) == (rj.R, rj.C)
    if rj.allowed is None:
        assert rt.allowed is None
    else:
        np.testing.assert_array_equal(rt.allowed, rj.allowed)
        side = japi.LARGE_GRIDS[arch_name][2]
        np.testing.assert_array_equal(tplacement.hex_mask(side),
                                      jplacement.hex_mask(side))
    assert rt.layout == tproxies.Layout(rj.layout.Vp, rj.layout.kinds)
    assert rt.area == rj.area
    gj_rng, gt_rng = np.random.default_rng(3), np.random.default_rng(3)
    sj, st = rj.random(gj_rng), rt.random(gt_rng)
    sj = rj.merge(sj, rj.mutate(sj, gj_rng), gj_rng)
    st = rt.merge(st, rt.mutate(st, gt_rng), gt_rng)
    for a, b in zip(sj, st):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    gj, gt = rj.score_graph(sj), rt.score_graph(st)
    for f in GRAPH_FIELDS:
        a, b = np.asarray(getattr(gj, f)), np.asarray(getattr(gt, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, f)
    assert gt_rng.random() == gj_rng.random()
    stacked_j = jtopology.stack_graphs([gj])
    stacked_t = ttopology.stack_graphs([gt])
    for k in stacked_j:
        np.testing.assert_array_equal(stacked_t[k], stacked_j[k])


def test_fw_tiled_config_loads_and_scores():
    cj = japi.ExperimentConfig(arch="homog100", backend="fw-tiled")
    ct = interop.config_from_json(cj.to_json())
    assert ct.backend == "fw-tiled"
    assert ct.to_dict() == cj.to_dict()
    assert tapi.ExperimentConfig(arch="homog100").backend == "fw-tiled"
    rep = tapi.make_rep(tchiplets.resolve_arch("homog32"), "homog32")
    scorer = tapi.get_scorer(rep.layout, chunk=4, backend="fw-tiled",
                             device="cpu")
    g = rep.score_graph(rep.random(np.random.default_rng(0)))
    assert ttopology.stack_graphs([g])["W"].shape[-1] >= ops.FW_TILED_FROM_V
    launches = fwt.launches
    out = scorer(ttopology.stack_graphs([g]))
    assert out["lat_c2c"].shape == (1,) and fwt.launches == launches


def test_homog100_run_experiment_fw_tiled_matches_reference():
    small = dict(arch="homog100", config="baseline", algorithms=["ga"],
                 budget={"evals": 4}, norm_samples=2, chunk=8, seed=0,
                 params={"ga": {"population": 4, "elitism": 1,
                                "tournament": 2}})
    cj = japi.ExperimentConfig.from_dict(dict(small, backend="fw-ref"))
    ct = interop.config_from_json(dict(small, backend="fw-tiled"))
    rj = japi.run_experiment(cj)[0].result
    rt = tapi.run_experiment(ct, device="cpu")[0].result
    for a, b in zip(interop.sol_from_arrays(*rj.best_sol), rt.best_sol):
        np.testing.assert_array_equal(b, a)
    assert rt.best_cost == pytest.approx(rj.best_cost, rel=1e-5)
    assert rt.n_evaluated == rj.n_evaluated
    for k, v in rj.best_metrics.items():
        assert rt.best_metrics[k] == pytest.approx(v, rel=1e-5), k
    assert (rt.best_sol[0] >= 0).sum() == 100
