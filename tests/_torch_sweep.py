"""Helpers of the port's sweep tests against the JAX package
(``test_torch_sweep.py``, ``test_torch_sweep_reference.py``): one config in
both packages, and the record comparison."""
import numpy as np
import torch

from repro.core import api as japi
from repro_torch import interop
from repro_torch.core import api as tapi

CPU = torch.device("cpu")
PARAMS = {"ga": {"population": 8, "elitism": 2, "tournament": 3},
          "br": {"batch": 8}, "sa": {"chains": 2},
          "ga-batched": {"population": 6, "elitism": 2, "tournament": 3},
          "br-batched": {"batch": 6}, "sa-batched": {"chains": 3}}
STATS = ("scorers_built", "evaluators_built", "stacked_groups",
         "score_calls", "n_evaluated")


def _pair(**kw):
    """The same config in both packages (reference on "fw-ref")."""
    d = dict(arch="homog32", budget={"evals": 16}, norm_samples=8, chunk=4,
             params={a: p for a, p in PARAMS.items()
                     if a in kw.get("algorithms", ())})
    d.update(kw)
    cj = japi.ExperimentConfig.from_dict(dict(d, backend="fw-ref"))
    ct = tapi.ExperimentConfig.from_dict(dict(d, params=cj.to_dict()[
        "params"]))
    return cj, ct


def _history(res):
    return [(n, c) for _, n, c in res.history]


def _assert_same_record(a, b, bitwise_history=True):
    """``a`` the reference's (or unstacked) record, ``b`` the port's."""
    assert (b.algorithm, b.repetition) == (a.algorithm, a.repetition)
    ra, rb = a.result, b.result
    for x, y in zip(interop.sol_from_arrays(*ra.best_sol), rb.best_sol):
        np.testing.assert_array_equal(y, x)
    assert np.float32(rb.best_cost).tobytes() \
        == np.float32(ra.best_cost).tobytes()
    assert rb.n_evaluated == ra.n_evaluated
    assert rb.n_generated == ra.n_generated
    assert [h[1] for h in rb.history] == [h[1] for h in ra.history]
    if bitwise_history:
        assert _history(rb) == _history(ra)
