"""The multi-run paths and the rate model on the card.

* ``run_sweep`` stacked equals unstacked bit for bit on the card for all
  six optimizers (host loops and ``-batched`` drivers in one lockstep
  group, so host graph lists and device batch dicts stack into one call),
  for a homogeneous and a heterogeneous arch, with a proxy objective and
  with the trace terms;
* the rate model (``netsim.make_trace_model``) through the FW kernels on
  the card against the port's CPU result (plain FW) on the same placements,
  rtol 1e-5, 1e-4 for ``trace_thr_*`` (the kernels equal the plain FW bit
  for bit; the model's float32 sums run in another order on the card, and
  ``trace_thr_*`` divides a difference of two of them, as in
  ``tests/test_torch_netsim.py``);
* ``pareto.nondominated_mask`` on the card equals the host brute force
  exactly, duplicates included, and the card's hypervolume agrees with the
  host float64 recursion to rel 1e-6.

Skips without a card; run it on the H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_sweep_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import api as tapi
from repro_torch.core import pareto as tpareto
from repro_torch.core.chiplets import paper_arch
from repro_torch.core.objective import Objective, TermSpec
from repro_torch.core.topology import stack_graphs
from repro_torch.kernels import fw_counts_tiled as fwt
from repro_torch.kernels import ops
from repro_torch.netsim import Workload, make_trace_model

pytestmark = pytest.mark.gpu

ALGOS = ("br", "ga", "sa", "br-batched", "ga-batched", "sa-batched")
PARAMS = {"br": {"batch": 8}, "br-batched": {"batch": 8},
          "ga": {"population": 8, "elitism": 2, "tournament": 3},
          "ga-batched": {"population": 8, "elitism": 2, "tournament": 3},
          "sa": {"chains": 2}, "sa-batched": {"chains": 3}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _configs(arch_name, trace=False):
    extra = {}
    if trace:
        wl = Workload.synthetic(paper_arch(arch_name).kinds(), "c2m", 0.01)
        extra = dict(workload=wl, objective=Objective().with_terms(
            TermSpec("trace-lat", weight=0.5),
            TermSpec("trace-thr", weight=0.25)))
    return [tapi.ExperimentConfig(
        arch=arch_name, config="placeit", algorithms=ALGOS,
        budget=tapi.Budget(evals=24), norm_samples=8, chunk=4, seed=s,
        params=PARAMS, **extra) for s in (0, 1)]


def _assert_records_equal(a_recs, b_recs):
    assert len(a_recs) == len(b_recs)
    for a, b in zip(a_recs, b_recs):
        assert (a.algorithm, a.repetition) == (b.algorithm, b.repetition)
        ra, rb = a.result, b.result
        for x, y in zip(ra.best_sol, rb.best_sol):
            np.testing.assert_array_equal(x, y)
        assert np.float32(ra.best_cost).tobytes() \
            == np.float32(rb.best_cost).tobytes(), a.algorithm
        assert ra.n_evaluated == rb.n_evaluated
        assert ra.n_generated == rb.n_generated
        assert [(n, c) for _, n, c in ra.history] \
            == [(n, c) for _, n, c in rb.history]


@pytest.mark.parametrize("arch_name,trace", [("homog64", False),
                                             ("hetero32", False),
                                             ("homog32", True)])
def test_stacked_sweep_equals_unstacked_on_card(cuda, arch_name, trace):
    cfgs = _configs(arch_name, trace)
    launches = fwt.launches
    stacked = tapi.run_sweep(cfgs, device=cuda)
    assert fwt.launches > launches
    unstacked = tapi.run_sweep(cfgs, stack_scoring=False, device=cuda)
    assert stacked.stats.stacked_groups == 1
    assert stacked.stats.score_calls < unstacked.stats.score_calls
    _assert_records_equal(stacked.records, unstacked.records)
    for r in stacked.records:
        assert r.result.best_metrics["connected"]


@pytest.mark.parametrize("arch_name", ["homog32", "hetero32", "homog64"])
def test_rate_model_on_card_matches_cpu(cuda, arch_name):
    arch = paper_arch(arch_name, "placeit")
    rep = tapi.make_rep(arch, arch_name)
    rng = np.random.default_rng(3)
    graphs = []
    while len(graphs) < 6:
        g = rep.score_graph(rep.random(rng))
        if g.connected:
            graphs.append(g)
    batch = stack_graphs(graphs)
    dem = np.stack([Workload.synthetic(arch.kinds(), t, 0.02).vec()
                    for t in ("c2c", "c2m", "c2m", "m2i", "c2i", "c2m")])
    launches = fwt.launches
    got = make_trace_model(rep.layout, device=cuda)(batch, dem)
    assert fwt.launches > launches
    want = make_trace_model(rep.layout, fw_impl=ops.fw_impl_ref,
                            device="cpu")(batch, dem)
    for k, v in want.items():
        rtol = 1e-4 if k.startswith("trace_thr_") else 1e-5
        np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=k)


def test_nondominated_mask_on_card_matches_host(cuda):
    rng = np.random.default_rng(0)
    for b, d in ((32, 2), (64, 3), (128, 4), (500, 3)):
        Y = (rng.random((b, d)) * 10).astype(np.float32)
        Y[rng.integers(0, b, b // 4)] = Y[rng.integers(0, b, b // 4)]
        np.testing.assert_array_equal(
            tpareto.nondominated_mask(Y, device=cuda),
            tpareto.nondominated_mask_host(Y))
    for n in (2, 3):
        Y = rng.random((24, n)) * 4
        ref = [4.5] * n
        assert tpareto.hypervolume(Y, ref, device=cuda) == pytest.approx(
            tpareto.hypervolume(Y, ref, device=False), rel=1e-6)
