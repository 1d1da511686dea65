"""The device-resident pipeline on the card.

The batched score-graph builds on ``cuda`` (``HomogGraphBatch`` for
homog64, homog256 and hex127, ``HeteroBatch.geometry_batch`` +
``HeteroGraphBatch`` for hetero32 and hetero64, the archs of
``chip_smoke.py``'s parity phase, both configs) equal the host build bit for
bit, slot for slot, and the scorer's metrics and cost from both builds,
through the FW kernels, are bit-equal (``testing.batched_build_parity``).
The batched operators keep ``tests/_invariants.py`` on the card, and one
``ga-batched`` run per family through ``run_experiment`` returns a
connected, valid placement with its FW launches counted.  Skips without a
card; run it on the H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_pipeline_gpu.py
"""
import numpy as np
import pytest
import torch

from _invariants import assert_valid_hetero_batch, assert_valid_homog_batch
from repro_torch import testing
from repro_torch.core import api as tapi
from repro_torch.core.chiplets import resolve_arch
from repro_torch.kernels import fw_counts_tiled as fwt

pytestmark = pytest.mark.gpu

ARCHS = [(a, c) for a, _ in testing.PIPELINE_ARCHS
         for c in ("baseline", "placeit")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("arch_name,config", ARCHS)
def test_batched_build_matches_host_on_card(cuda, arch_name, config):
    n = 16 if arch_name == "hetero64" else 32
    out = testing.batched_build_parity(arch_name, config, n, seed=1,
                                       device=cuda, chunk=4)
    assert out["n"] == n


@pytest.mark.parametrize("arch_name,config", ARCHS)
def test_batch_operators_keep_invariants_on_card(cuda, arch_name, config):
    rep = tapi.make_rep(resolve_arch(arch_name, config), arch_name)
    ops = rep.batch_ops(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    check = (assert_valid_hetero_batch if arch_name.startswith("hetero")
             else assert_valid_homog_batch)
    a, b = ops.random_batch(gen, 16)
    assert a.device == b.device == cuda
    check(rep, a.cpu(), b.cpu())
    ma, mb = ops.mutate_batch(gen, a, b)
    check(rep, ma.cpu(), mb.cpu())
    a2, b2 = ops.random_batch(gen, 16)
    ga, gb = ops.merge_batch(gen, a, b, a2, b2)
    check(rep, ga.cpu(), gb.cpu())


@pytest.mark.parametrize("arch_name,config", [("homog64", "placeit"),
                                              ("hetero32", "placeit")])
def test_ga_batched_runs_on_card(cuda, arch_name, config):
    cfg = tapi.ExperimentConfig(
        arch=arch_name, config=config, algorithms=("ga-batched",),
        budget=tapi.Budget(evals=40), norm_samples=8,
        params={"ga-batched": {"population": 16, "elitism": 4,
                               "tournament": 4}})
    launches = fwt.launches
    res = tapi.run_experiment(cfg, device=cuda)[0].result
    assert fwt.launches > launches
    rep = tapi.make_rep(resolve_arch(arch_name, config), arch_name)
    a, b = res.best_sol
    assert a.dtype == b.dtype == np.int8
    check = (assert_valid_hetero_batch if arch_name.startswith("hetero")
             else assert_valid_homog_batch)
    check(rep, a[None], b[None])
    assert rep.score_graph((a, b)).connected
    assert np.isfinite(res.best_cost) and res.best_metrics["connected"]
    assert res.n_evaluated == 16 + 12 * ((40 - 16) // 12 - 1)
