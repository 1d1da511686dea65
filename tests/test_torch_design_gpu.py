"""The population archive, the design service with population sharding
and the 3D families on the card.

* ``DesignEngine`` with sharding off and on (``shard=True``: every CUDA
  device) equals ``run_sweep(fold_repetitions=False)`` bit for bit on the
  card, host and ``-batched`` tenants of a paper arch and a 3D family
  stacked in one engine;
* the batched 3D graph builds on the card equal the host build bit for
  bit (``testing.batched_build_parity``, every family of
  ``testing.PIPELINE_ARCHS_3D``), the scorer's metrics and cost included;
* ``PopArchive`` merges on the card exactly as on the CPU (NaN sorts after
  +inf in ``torch.sort(stable=True)`` there too, -0.0 ties +0.0), and a
  run's archive head is its ``best_cost`` for the host drivers (at most
  it for the ``-batched`` drivers).

Skips without a card; run it on the H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_design_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import testing
from repro_torch.core import api as tapi
from repro_torch.core import optimize as topt
from repro_torch.serve.design import DesignEngine

pytestmark = pytest.mark.gpu

PARAMS = {"br": {"batch": 8}, "br-batched": {"batch": 8},
          "ga": {"population": 8, "elitism": 2, "tournament": 3},
          "ga-batched": {"population": 8, "elitism": 2, "tournament": 3},
          "sa": {"chains": 2}, "sa-batched": {"chains": 3}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _cfg(arch, algos, seed, **kw):
    return tapi.ExperimentConfig(
        arch=arch, config="placeit", algorithms=algos,
        budget=tapi.Budget(evals=24), norm_samples=8, chunk=4, seed=seed,
        params={a: PARAMS[a] for a in algos}, **kw)


CFGS = (("homog32", ("br", "ga", "sa"), 0, {}),
        ("homog32", ("br-batched", "ga-batched", "sa-batched"), 1,
         {"archive_k": 8}),
        ("stack3d32", ("ga", "ga-batched"), 0, {"archive_k": 8}),
        ("gw3d64", ("ga-batched",), 2, {}))


def _same(a, b):
    ra, rb = a.result, b.result
    assert (a.algorithm, a.repetition) == (b.algorithm, b.repetition)
    for x, y in zip(ra.best_sol, rb.best_sol):
        np.testing.assert_array_equal(x, y)
    assert np.float32(ra.best_cost).tobytes() == \
        np.float32(rb.best_cost).tobytes()
    assert ra.n_evaluated == rb.n_evaluated
    assert [(n, c) for _, n, c in ra.history] == \
        [(n, c) for _, n, c in rb.history]
    assert (ra.archive is None) == (rb.archive is None)
    if ra.archive is not None:
        for k in ("costs", "a", "b"):
            np.testing.assert_array_equal(ra.archive[k], rb.archive[k])


@pytest.mark.parametrize("shard", [False, True])
def test_engine_equals_run_sweep_on_card(cuda, shard):
    cfgs = [_cfg(a, al, s, **kw) for a, al, s, kw in CFGS]
    sweep = tapi.run_sweep(cfgs, fold_repetitions=False, device=cuda)
    eng = DesignEngine(device=cuda, shard=shard)
    rids = [eng.submit(tapi.DesignRequest(config=c)) for c in cfgs]
    eng.run()
    recs = []
    for rid in rids:
        resp = eng.result(rid)
        assert resp.status == "done", resp.error
        recs += resp.records
    assert len(recs) == len(sweep.records)
    for a, b in zip(sweep.records, recs):
        _same(a, b)
    assert eng.stats.stacked_rounds >= 1
    assert eng.stats.shard_devices == (torch.cuda.device_count()
                                       if shard else 1)
    for r in recs:
        if r.arch == "gw3d64":
            assert r.result.best_sol[0].shape == (4, 4, 4)


def test_run_sweep_sharded_equals_unsharded_on_card(cuda):
    cfgs = [_cfg(a, al, s, **kw) for a, al, s, kw in CFGS[1:3]]
    plain = tapi.run_sweep(cfgs, device=cuda)
    sharded = tapi.run_sweep(cfgs, shard=True, device=cuda)
    assert sharded.stats.shard_devices == torch.cuda.device_count()
    for a, b in zip(plain.records, sharded.records):
        _same(a, b)


@pytest.mark.parametrize("arch_name,config", [
    pytest.param(a, c, id=f"{a}-{c}") for a, c in testing.PIPELINE_ARCHS_3D])
def test_batched_3d_builds_equal_host_on_card(cuda, arch_name, config):
    out = testing.batched_build_parity(arch_name, config, 64, device=cuda)
    assert out["n"] == 64 and out["connected"] > 0


def test_archive_merge_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(0)
    arcs = [topt.PopArchive(6, d) for d in ("cpu", cuda)]
    for i in range(6):
        n = int(rng.integers(3, 12))
        c = rng.choice(np.float32([0.5, 1.0, 2.0, np.inf, np.nan]), n)
        if i == 2:
            c[:2] = np.float32([-0.0, 0.0])
        a = rng.integers(-1, 3, (n, 4, 4, 2)).astype(np.int8)
        b = rng.integers(0, 4, (n, 4, 4, 2)).astype(np.int8)
        valid = rng.random(n) < 0.8
        for arc in arcs:
            arc.add(c, torch.from_numpy(a).to(arc.device), b, valid=valid)
        for x, y in zip(*(arc._state for arc in arcs)):
            torch.testing.assert_close(x.cpu(), y.cpu(), rtol=0, atol=0,
                                       equal_nan=True)
    c = torch.tensor([np.nan, np.inf, 1.0, -0.0, 0.0, np.nan], device=cuda)
    idx = torch.sort(c, stable=True).indices.cpu().tolist()
    assert idx == [3, 4, 2, 1, 0, 5]


@pytest.mark.parametrize("algo", ["ga", "sa", "ga-batched", "sa-batched"])
def test_archive_head_is_best_cost_on_card(cuda, algo):
    """The archive holds every scored search row: its head is the run's
    ``best_cost`` for the host drivers.  A ``-batched`` resample round
    may score a second connected candidate for a slot and keep the
    first, so there the head is at most ``best_cost``."""
    cfg = _cfg("stack3d64", (algo,), 0, archive_k=8)
    (rec,) = tapi.run_experiment(cfg, device=cuda)
    snap = rec.result.archive
    assert 0 < len(snap["costs"]) <= 8
    assert np.all(np.diff(snap["costs"]) > 0)
    best = np.float32(rec.result.best_cost)
    if algo.endswith("-batched"):
        assert snap["costs"][0] <= best
    else:
        assert snap["costs"][0] == best
    assert snap["a"].shape[1:] == (4, 4, 4)
