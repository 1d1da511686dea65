"""The port's batched scorer against the JAX package's jitted one, on the CPU.

Stacked homog32 / homog64 batches go through ``repro.core.proxies.
make_scorer`` and ``repro_torch.core.proxies.make_scorer`` with the same
normalizer and weight vectors.  Tolerances: ``connected`` and ``area``
exact; ``lat_*`` rtol 1e-6 (float32 sums of integer latencies, exact below
2^24); ``thr_*`` and ``cost`` rtol 1e-5 (the float32 link-load contraction
sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import api as japi
from repro.core import chiplets as jchiplets
from repro.core import objective as jobjective
from repro.core import proxies as jproxies
from repro.core import topology as jtopology
from repro_torch import interop
from repro_torch.core import objective as tobjective
from repro_torch.core import proxies as tproxies
from _torch_threads import one_torch_thread  # noqa: F401

NORMS = np.array([130, 190, 165, 235, 3.0, 8.0, 8.0, 1.5, 540], np.float32)
OBJ = {"terms": ["lat", "inv-thr", "area",
                 {"name": "link-length-cap", "weight": 0.5,
                  "params": {"cap_mm": 2.5}},
                 {"name": "node-degree", "weight": 0.25,
                  "params": {"max_degree": 0}}]}
METRICS = ([f"lat_{t}" for t in jchiplets.TRAFFIC_TYPES]
           + [f"thr_{t}" for t in jchiplets.TRAFFIC_TYPES] + ["cost"])

_BATCHES = {}


def _batch(arch_name, config, n_conn=6, n_disc=2, seed=4):
    """Seeded random placements, ``n_conn`` connected then ``n_disc`` not
    connected, as stacked arrays."""
    key = (arch_name, config)
    if key not in _BATCHES:
        arch = jchiplets.paper_arch(arch_name, config)
        rep = japi.make_rep(arch, arch_name)
        rng = np.random.default_rng(seed)
        conn, disc = [], []
        while len(conn) < n_conn or len(disc) < n_disc:
            g = rep.score_graph(rep.random(rng))
            (conn if g.connected else disc).append(g)
        graphs = conn[:n_conn] + disc[:n_disc]
        _BATCHES[key] = (rep.layout, jtopology.stack_graphs(graphs),
                         np.array([g.connected for g in graphs]))
    return _BATCHES[key]


def _score_both(arch_name, config, chunk=4):
    layout, batch, conn = _batch(arch_name, config)
    oj = jobjective.Objective.from_dict(OBJ)
    ot = interop.objective_from_json(oj.to_json())
    w = jobjective.weights_vec(oj)
    sj = jproxies.make_scorer(layout, chunk=chunk, objective=oj)
    want = sj({k: jnp.asarray(v) for k, v in batch.items()},
              jnp.asarray(NORMS), jnp.asarray(w))
    want = {k: np.asarray(v) for k, v in want.items()}
    st = tproxies.make_scorer(tproxies.Layout(layout.Vp, layout.kinds),
                              chunk=chunk, objective=ot, device="cpu")
    got = st(interop.graph_batch(batch), interop.norms_tensor(NORMS),
             interop.weights_tensor(w, ot))
    return want, got, conn, (layout, batch, ot, w)


@pytest.mark.parametrize("arch_name,config", [("homog32", "baseline"),
                                              ("homog64", "baseline")])
def test_scorer_matches_reference(arch_name, config):
    want, got, conn, _ = _score_both(arch_name, config)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        assert v.shape == want[k].shape, k
    np.testing.assert_array_equal(got["connected"], want["connected"])
    np.testing.assert_array_equal(got["connected"], conn)
    np.testing.assert_array_equal(got["area"], want["area"])
    ok = want["connected"]
    assert ok.sum() == 6 and not ok.all()
    for k in METRICS:
        rtol = 1e-6 if k.startswith("lat_") else 1e-5
        np.testing.assert_allclose(got[k][ok], want[k][ok], rtol=rtol,
                                   err_msg=k)


def test_scorer_is_chunk_invariant_bitwise():
    layout, batch, _ = _batch("homog32", "baseline")
    ot = tobjective.Objective.from_dict(OBJ)
    lt = tproxies.Layout(layout.Vp, layout.kinds)
    outs = [tproxies.make_scorer(lt, chunk=c, objective=ot, device="cpu")(
        batch, NORMS) for c in (1, 3, 16)]
    for other in outs[1:]:
        for k, v in outs[0].items():
            np.testing.assert_array_equal(other[k], v, k)


def test_ranker_matches_reference_topk():
    layout, batch, conn = _batch("homog32", "baseline")
    oj = jobjective.Objective.from_dict(OBJ)
    ot = tobjective.Objective.from_dict(OBJ)
    rj = jproxies.make_ranker(jproxies.make_scorer(layout, chunk=4,
                                                   objective=oj))
    cj, ij = rj({k: jnp.asarray(v) for k, v in batch.items()},
                jnp.asarray(NORMS), k=3, valid=jnp.asarray(conn))
    rt = tproxies.make_ranker(tproxies.make_scorer(
        tproxies.Layout(layout.Vp, layout.kinds), chunk=4, objective=ot,
        device="cpu"))
    ct, it = rt(batch, NORMS, k=3, valid=conn)
    np.testing.assert_array_equal(it, np.asarray(ij))
    np.testing.assert_allclose(ct, np.asarray(cj), rtol=1e-5)
