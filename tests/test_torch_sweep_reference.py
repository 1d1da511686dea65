"""The port's ``api.run_sweep`` against the JAX package's on homog32 and
homog100, on the CPU (split from ``test_torch_sweep.py`` so that the two
files' slowest tests run on two pytest-xdist workers).

* homog32 host configs (``br`` / ``ga`` / ``sa``, two seeds, SA
  repetitions folded and unfolded, stacked and unstacked) give the
  reference's records: the same ``best_sol``, bit-equal ``best_cost``,
  equal ``n_evaluated``, ``n_generated`` and history counts, and the
  reference's ``SweepStats``.  The reference runs on ``"fw-ref"``, the port
  on its default backend (the plain FW on the CPU).
* homog100 ``br`` through ``run_sweep`` reaches the reference's placement.
"""
import pytest

from repro.core import api as japi
from repro_torch.core import api as tapi
from _torch_sweep import CPU, STATS, _assert_same_record, _pair
from _torch_threads import one_torch_thread  # noqa: F401


SWEEP_MODES = [dict(), dict(fold_repetitions=False),
               dict(stack_scoring=False)]


@pytest.mark.parametrize("mode", SWEEP_MODES,
                         ids=["folded-stacked", "unfolded", "unstacked"])
def test_run_sweep_matches_reference(mode):
    pairs = [_pair(algorithms=("br", "ga", "sa"), seed=s) for s in (0, 1)]
    pairs.append(_pair(algorithms=("sa",), seed=2, repetitions=2))
    japi.clear_scorer_cache()
    tapi.clear_scorer_cache()
    rj = japi.run_sweep([cj for cj, _ in pairs], **mode)
    rt = tapi.run_sweep([ct for _, ct in pairs], device=CPU, **mode)
    assert len(rt.runs) == len(rj.runs)
    assert len(rt.records) == len(rj.records)
    for a, b in zip(rj.records, rt.records):
        _assert_same_record(a, b)
    for f in STATS:
        assert getattr(rt.stats, f) == getattr(rj.stats, f), f
    folded = [r for r in rt.records if r.repetition == -1]
    assert len(folded) == (0 if mode.get("fold_repetitions") is False
                           else 1)


def test_homog100_br_sweep_reaches_reference_placement():
    cj, ct = _pair(arch="homog100", algorithms=("br",),
                   budget={"evals": 4}, norm_samples=2,
                   params={"br": {"batch": 4}})
    (rj,) = japi.run_sweep([cj]).records
    (rt,) = tapi.run_sweep([ct], device=CPU).records
    _assert_same_record(rj, rt)
    assert (rt.result.best_sol[0] >= 0).sum() == 100
