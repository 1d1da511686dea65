"""The port's experiment API against the JAX package, on the CPU, and the
port's import hygiene.

Small GA / BR / SA runs on homog32 baseline through both packages'
``run_experiment`` must draw the same norm-sample placements, reach the
same ``best_sol`` and agree on ``best_cost`` to rel 1e-5 (the tolerance
``tests/test_api.py::test_named_backends_agree`` holds between backends:
the search compares float32 costs whose link loads sum in another order).
"""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import chiplets as jchiplets
from repro.core.optimize import Evaluator as JEvaluator
from repro_torch import interop
from repro_torch.core import api as tapi
from repro_torch.core import chiplets as tchiplets
from repro_torch.core.optimize import Evaluator as TEvaluator
from repro_torch.kernels import fw_counts as fwc
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(arch="homog32", budget={"evals": 16}, norm_samples=8, chunk=4,
             params={"ga": {"population": 8, "elitism": 2, "tournament": 3},
                     "br": {"batch": 8}, "sa": {"chains": 2}})


def _configs(algo, seed=1):
    cj = japi.ExperimentConfig.from_dict(
        dict(SMALL, algorithms=[algo], seed=seed, backend="fw-ref"))
    return cj, interop.config_from_json(cj.to_json())


def test_norm_sample_placements_identical():
    cj, ct = _configs("ga")
    rj = japi.make_rep(jchiplets.paper_arch("homog32"), "homog32")
    rt = tapi.make_rep(tchiplets.paper_arch("homog32"), "homog32")
    ej = JEvaluator(rj, rj.arch, rng=np.random.default_rng(ct.seed),
                    norm_samples=ct.norm_samples, chunk=ct.chunk)
    et = TEvaluator(rt, rt.arch, rng=np.random.default_rng(ct.seed),
                    norm_samples=ct.norm_samples, chunk=ct.chunk,
                    device="cpu")
    assert et.n_generated == ej.n_generated
    # The Evaluators' norm-sample draw, repeated from the same seed.
    sj, _ = ej.generate_valid(rj.random, np.random.default_rng(ct.seed),
                              ct.norm_samples)
    st, _ = et.generate_valid(rt.random, np.random.default_rng(ct.seed),
                              ct.norm_samples)
    assert len(st) == len(sj) == ct.norm_samples
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
    np.testing.assert_allclose(et.norm_vec, ej.norm_vec, rtol=1e-6)
    assert et.degenerate_norms == ej.degenerate_norms


@pytest.mark.parametrize("algo", ["ga", "br", "sa"])
def test_run_experiment_matches_reference(algo):
    cj, ct = _configs(algo)
    rj = japi.run_experiment(cj)[0].result
    rt = tapi.run_experiment(ct, device="cpu")[0].result
    for a, b in zip(interop.sol_from_arrays(*rj.best_sol), rt.best_sol):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    assert rt.best_cost == pytest.approx(rj.best_cost, rel=1e-5)
    assert rt.n_evaluated == rj.n_evaluated
    assert rt.n_generated == rj.n_generated
    assert [h[1] for h in rt.history] == [h[1] for h in rj.history]
    nj, nt = dataclasses.asdict(rj.normalizers), dataclasses.asdict(
        rt.normalizers)
    for f in ("lat", "inv_thr"):
        for t, v in nj[f].items():
            assert nt[f][t] == pytest.approx(v, rel=1e-6)
    assert nt["area"] == pytest.approx(nj["area"], rel=1e-6)
    for k, v in rj.best_metrics.items():
        assert rt.best_metrics[k] == pytest.approx(v, rel=1e-5), k


def test_baseline_cost_matches_reference():
    cj, ct = _configs("ga")
    cost_j, mj = japi.baseline_cost(cj)
    cost_t, mt = tapi.baseline_cost(ct, device="cpu")
    assert set(mt) == set(mj)
    for k, v in mj.items():
        assert mt[k] == pytest.approx(v, rel=1e-5), k
    assert cost_t == pytest.approx(cost_j, rel=1e-5)


def test_kernel_backend_on_cpu_counts_no_launch():
    _, ct = _configs("br")
    launches = fwc.launches
    recs = tapi.run_experiment(dataclasses.replace(ct, backend="fw-cuda"),
                               device="cpu")
    assert np.isfinite(recs[0].result.best_cost)
    assert fwc.launches == launches


def test_entry_points_refuse_without_card_or_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, ct = _configs("br")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.run_experiment(ct)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.baseline_cost(ct)
    rep = tapi.make_rep(tchiplets.paper_arch("homog32"), "homog32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.make_evaluator(rep, rep.arch, rng=np.random.default_rng(0),
                            norm_samples=2)


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_repro():
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_port_import_leaves_jax_and_repro_unloaded():
    code = ("import sys; import repro_torch.core.api, repro_torch.interop, "
            "repro_torch.testing, repro_torch.core.pareto, "
            "repro_torch.core.traces, repro_torch.netsim; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code],
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
