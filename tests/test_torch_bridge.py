"""The port's co-design bridge against the reference's, on the CPU.

- ``signature_from_artifact`` on synthetic dry-run artifact dicts (train,
  prefill and decode shapes; single-pod, and with a multi-pod artifact),
  with the reference's three rate constants passed in as
  ``DeviceRates``: every field equal to the reference's (the same float
  operations in the same order).
- ``weights_from_signature`` and ``tpu_like_package``: the
  ``round(w * scale, 3)`` weights and the package's counts, chiplets and
  weights equal.
- ``codesign`` on the CPU (backend "fw-tiled", whose plain FW runs
  there) against the reference's on "fw-ref", same seed: the same
  ``best_sol``, ``package``, ``weights``, ``n_evaluated`` and keys; the
  costs within 2e-7 relative (the float32 link-load sums of the two
  packages differ in order, ROADMAP "Not port faults"), the improvement
  (a difference of the two over one of them) within 4e-7, the metrics
  within 1e-6.
- The rates: the default is the current card's table entry, which needs a
  card; the H100 entry is the data sheet's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import bridge as jb
from repro_torch.core import bridge as tb

from _torch_threads import one_torch_thread  # noqa: F401

RATES = tb.DeviceRates(peak_flops=jb.PEAK_FLOPS, hbm_bw=jb.HBM_BW,
                       link_bw=jb.LINK_BW)
COST_RTOL = 2e-7


def _artifact(shape: str, flops: float, bytes_: float, wire: float,
              arch: str = "smollm-360m") -> dict:
    return {"arch": arch, "shape": shape, "flops_total": flops,
            "bytes_accessed_total": bytes_,
            "collectives": {"wire_bytes_per_chip": wire}}


ARTIFACTS = {
    "train": _artifact("train_4k", 3.1e15, 2.2e13, 4.0e11),
    "prefill": _artifact("prefill_32k", 7.7e14, 9.0e12, 1.1e11),
    "decode": _artifact("decode_32k", 2.0e12, 1.9e12, 3.3e10),
    "decode, no collectives": _artifact("decode_32k", 1.0e12, 5.0e11, 0.0),
}
MULTI = {"train": 9.5e11, "prefill": 1.1e11, "decode": 3.4e11,
         "decode, no collectives": 1e9}


def _sig_fields(sig) -> tuple:
    return (sig.arch, sig.shape, sig.kind, sig.t_comp, sig.t_mem,
            sig.t_coll, sig.io_share, sig.total)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_signature_weights_and_package_equal_reference(name, multi):
    rec = ARTIFACTS[name]
    mp = (dict(rec, collectives={"wire_bytes_per_chip": MULTI[name]})
          if multi else None)
    js = jb.signature_from_artifact(rec, multi_pod_rec=mp)
    ts = tb.signature_from_artifact(rec, multi_pod_rec=mp, rates=RATES)
    assert _sig_fields(ts) == _sig_fields(js)
    assert tb.weights_from_signature(ts) == jb.weights_from_signature(js)
    ja, ta = jb.tpu_like_package(js), tb.tpu_like_package(ts)
    assert ta.name == ja.name and ta.counts() == ja.counts()
    assert (ta.w_lat, ta.w_thr, ta.w_area) == (ja.w_lat, ja.w_thr, ja.w_area)
    assert [dataclasses.astuple(c) for c in ta.chiplets] == \
        [dataclasses.astuple(c) for c in ja.chiplets]


def test_signature_reads_a_json_path(tmp_path):
    import json
    p = tmp_path / "a__single.json"
    p.write_text(json.dumps(ARTIFACTS["train"]))
    q = tmp_path / "a__multi.json"
    q.write_text(json.dumps(dict(ARTIFACTS["train"], collectives={
        "wire_bytes_per_chip": MULTI["train"]})))
    assert _sig_fields(tb.signature_from_artifact(
        str(p), multi_pod_rec=str(q), rates=RATES)) == _sig_fields(
        jb.signature_from_artifact(str(p), multi_pod_rec=str(q)))


@pytest.mark.parametrize("kind,sig", [
    ("decode", dict(t_comp=0.2, t_mem=2.0, t_coll=0.6, io_share=0.15)),
    ("train", dict(t_comp=2.0, t_mem=0.5, t_coll=1.0, io_share=0.05)),
])
def test_codesign_matches_reference(kind, sig):
    shape = {"decode": "decode_32k", "train": "train_4k"}[kind]
    js = jb.TrafficSignature("demo", shape, kind, **sig)
    ts = tb.TrafficSignature("demo", shape, kind, **sig)
    want = jb.codesign(js, max_evals=40, norm_samples=12)
    got = tb.codesign(ts, max_evals=40, norm_samples=12, device="cpu")
    assert set(got) == set(want)
    for key in ("workload", "signature", "weights", "package",
                "n_evaluated"):
        assert got[key] == want[key], key
    for a, b in zip(got["best_sol"], want["best_sol"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    for key in ("placeit_cost", "baseline_cost"):
        np.testing.assert_allclose(got[key], want[key], rtol=COST_RTOL,
                                   err_msg=key)
    # (base - best) / base: each cost's 2e-7 becomes about 4e-7 of it.
    np.testing.assert_allclose(got["improvement"], want["improvement"],
                               rtol=0, atol=2 * COST_RTOL)
    for key in ("best_metrics", "baseline_metrics"):
        assert set(got[key]) == set(want[key])
        for m, v in want[key].items():
            np.testing.assert_allclose(float(got[key][m]), float(v),
                                       rtol=1e-6, err_msg=f"{key} {m}")


def test_rates_default_to_the_card():
    h100 = tb.DEVICE_RATES["NVIDIA H100 80GB HBM3"]
    assert (h100.peak_flops, h100.hbm_bw, h100.link_bw) == (989e12, 3.35e12,
                                                            50e9)
    with pytest.raises(ValueError, match="rates"):
        tb.device_rates("cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.signature_from_artifact(ARTIFACTS["train"])
