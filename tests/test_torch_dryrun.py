"""The port's dry run (``launch.dryrun``) and sharded serving, on the CPU.

One spawn of two gloo ranks (``tests/_torch_dist.py``) runs:

- the dry run's cells (``launch.dryrun.build_cell``: the production
  overrides, microbatch counts and layouts) of reduced float32 configs
  of each family on real tensors over meshes (1, 2) and (2, 1), counted
  by ``launch.op_cost.OpCost``.  The same cells on fake tensors over a
  fake process group of two ranks (``launch.dryrun.count_cell``, as the
  production dry run runs them at 256 and 512) must count the same:
  FLOPs, bytes, converted bytes, every collective's count and wire
  bytes, every kernel's calls and the argument, output and alias bytes,
  exactly; the fake group's temp bytes at most the real ranks' (a real
  collective's result stays registered until it is waited on).
- sharded ``prefill`` and ``decode_step`` (parameters, batch and caches
  laid out by the rules) against the plain model from the same seed:
  logits and caches within 1e-5 (float32; the shards sum in other
  orders, seen about 2e-6).  The cases hold a cache split over its
  positions with one KV head (qwen3-1.7b cut to one KV head), a windowed
  ring cache split over its positions (recurrentgemma-9b, window 8 under
  a 12-token prompt), rows whose length lies wholly on one rank (so the
  other sees none), the encoder-decoder's cross cache, the recurrent
  states, and the MoE blocks.

In one process: the wrappers route fake tensors to the custom ops and
real CPU tensors to the plain versions; an artifact of ``run_cell`` (a
full-size config on a reduced fake mesh) read by ``roofline.report`` and
``core.bridge.signature_from_artifact``; a failing cell records its error.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import testing
from repro_torch.configs import get_config
from repro_torch.configs.registry import ShapeSpec
from repro_torch.core import bridge
from repro_torch.kernels import (custom_ops, flash_attention_bwd, ops, ref,
                                 rglru_scan_bwd, selective_scan_bwd)
from repro_torch.launch import dryrun, roofline

from _torch_dist import dryrun_rank, start_ranks
from _torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
SERVE_TOL = 1e-5


def _cfg(arch, **kw):
    n = 3 if arch == "recurrentgemma-9b" else 2
    if arch == "seamless-m4t-medium":
        kw.setdefault("n_enc_layers", 2)
    return get_config(arch).reduced(n_layers=kw.pop("n_layers", n), **kw)


TRAIN = ShapeSpec("train_4k", 16, 4, "train")
PREFILL = ShapeSpec("prefill_32k", 16, 2, "prefill")
DECODE = ShapeSpec("decode_32k", 16, 2, "decode")
# (name, arch, cfg, shape, mesh, microbatches: None = the override's):
# smollm-360m's replicated weights and sequence parallelism, moonshot's
# experts and FSDP over "data" with two microbatches, the selective scan's
# backward, recurrentgemma's position-split ring cache, the
# encoder-decoder's prefill, and a position-split global cache.
COUNT_CASES = [
    ("smollm train (1, 2)", "smollm-360m", _cfg("smollm-360m"), TRAIN,
     (1, 2), None),
    ("moonshot train (2, 1)", "moonshot-v1-16b-a3b",
     _cfg("moonshot-v1-16b-a3b"), TRAIN, (2, 1), None),
    ("falcon-mamba train (1, 2)", "falcon-mamba-7b",
     _cfg("falcon-mamba-7b"), TRAIN, (1, 2), 1),
    ("recurrentgemma decode (1, 2)", "recurrentgemma-9b",
     _cfg("recurrentgemma-9b", window=8), DECODE, (1, 2), None),
    ("seamless prefill (1, 2)", "seamless-m4t-medium",
     _cfg("seamless-m4t-medium"), PREFILL, (1, 2), None),
    ("qwen3 one KV head decode (1, 2)", "qwen3-1.7b",
     _cfg("qwen3-1.7b", n_kv_heads=1), DECODE, (1, 2), None),
]
# (name, cfg, mesh, B, S, cache_len, lengths so far)
SERVE_CASES = [
    ("qwen3 one KV head (1, 2)", _cfg("qwen3-1.7b", n_kv_heads=1), (1, 2),
     2, 12, 16, [3, 12]),
    ("recurrentgemma window 8 (1, 2)", _cfg("recurrentgemma-9b", window=8),
     (1, 2), 2, 12, 16, [3, 12]),
    ("seamless (1, 2)", _cfg("seamless-m4t-medium"), (1, 2), 2, 12, 16,
     [5, 12]),
    ("smollm (2, 1)", _cfg("smollm-360m"), (2, 1), 2, 12, 16, [3, 12]),
    ("falcon-mamba (1, 2)", _cfg("falcon-mamba-7b"), (1, 2), 2, 12, 16,
     [3, 12]),
    ("moonshot (1, 2)", _cfg("moonshot-v1-16b-a3b"), (1, 2), 2, 12, 16,
     [3, 12]),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo ranks' results, and the fake group's counts of the count
    cases (made while the ranks run)."""
    results = start_ranks(dryrun_rank, 2, tmp_path_factory.mktemp("dryrun"),
                          COUNT_CASES, SERVE_CASES)
    fake = {}
    try:
        for name, arch, cfg, spec, shape, mb in COUNT_CASES:
            mesh = dryrun.fake_mesh("single", "cpu", dims=shape)
            got = dryrun.count_cell(arch, spec, mesh, CPU, cfg=cfg,
                                    microbatches=mb)
            fake[name] = {k: v for k, v in got.items()
                          if k not in ("cfg", "mi", "microbatches")}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return results(), fake


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def fake_counts(runs):
    return runs[1]


FIELDS = ("flops_total", "bytes_accessed_total", "convert_bytes_total",
          "collectives", "n_collective_lines", "kernel_calls", "flops_by_op")
MEMORY = ("argument_size_in_bytes", "output_size_in_bytes",
          "alias_size_in_bytes")


@pytest.mark.parametrize("name", [c[0] for c in COUNT_CASES])
def test_fake_group_counts_equal_gloo_ranks(name, ranks, fake_counts):
    real, fake = ranks[0]["counts"][name], fake_counts[name]
    for key in FIELDS:
        assert fake[key] == real[key], key
    for key in MEMORY:
        assert fake["memory_analysis"][key] == real["memory_analysis"][key]
    # The real ranks' collectives keep their results registered until
    # waited on (torch's functional collectives); the fake group's do
    # not, so its temp is the smaller.
    assert (fake["memory_analysis"]["temp_size_in_bytes"]
            <= real["memory_analysis"]["temp_size_in_bytes"])
    assert fake["flops_total"] > 0 and fake["bytes_accessed_total"] > 0
    assert fake["collectives"]["wire_bytes_per_chip"] > 0
    assert sum(fake["kernel_calls"].values()) > 0


def test_two_ranks_count_alike(ranks):
    """Rank 1 runs the same program as rank 0 (the meshes are even)."""
    for name in ranks[0]["counts"]:
        a, b = ranks[0]["counts"][name], ranks[1]["counts"][name]
        assert a["flops_total"] == b["flops_total"], name
        assert a["collectives"] == b["collectives"], name


@pytest.mark.parametrize("name", [c[0] for c in SERVE_CASES])
def test_sharded_prefill_and_decode_equal_plain(name, ranks):
    got = ranks[0]["serve"][name]
    for key in ("prefill_logits", "prefill_caches", "decode_logits",
                "decode_caches"):
        assert got[key] <= SERVE_TOL, (key, got[key])
    assert ranks[1]["serve"][name]["decode_logits"] <= SERVE_TOL
    if "one KV head" in name or "window" in name:
        # k and v [n, B, S, Hkv, d]: the positions split over "model".
        assert any("Shard(dim=2))" in p for p in got["placements"]), \
            got["placements"]


def test_position_split_decode_merges_like_the_uncut_call():
    for f in list(testing.decode_cases().values()):
        q, kc, vc, lens, kw = map(lambda x: torch.from_numpy(x)
                                  if not isinstance(x, dict) else x, f())
        want, lse = ref.decode_attention_ref(q, kc, vc, lens, **kw,
                                             return_lse=True)
        assert torch.equal(ref.decode_attention_ref(q, kc, vc, lens, **kw),
                           want)
        assert torch.isneginf(lse[lens == 0]).all()
        for n in (2, 4):
            got = testing.decode_pieces(ref.decode_attention_ref, q, kc, vc,
                                        lens, n, **kw)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _wrapper_calls():
    """Each LM wrapper on operands from ``make(shape, dtype)``."""
    f32 = torch.float32

    def calls(make):
        q, k = make((1, 4, 2, 16), f32), make((1, 4, 1, 16), f32)
        lse = make((1, 2, 4), f32)
        x, A = make((1, 4, 8), f32), make((8, 4), f32)
        Bm, D = make((1, 4, 4), f32), make((8,), f32)
        st = make((1, 1, 8, 4), f32)
        return {
            "flash_attention": lambda: ops.flash_attention(q, k, k),
            "flash_attention_bwd": lambda: (
                flash_attention_bwd.flash_attention_bwd(q, k, k, q, q, lse)),
            "decode_attention": lambda: ops.decode_attention(
                q[:, 0], k, k, make((1,), torch.int32)),
            "selective_scan": lambda: ops.selective_scan(x, x, A, Bm, Bm, D),
            "selective_scan_bwd": lambda: (
                selective_scan_bwd.selective_scan_bwd(
                    x, x, A, Bm, Bm, D, None, x, None, states=st)),
            "rglru_scan": lambda: ops.rglru_scan(x, x),
            "rglru_scan_bwd": lambda: rglru_scan_bwd.rglru_scan_bwd(
                x, x, None, x, None, states=x),
        }
    return calls


def test_wrappers_route_fake_tensors_to_the_custom_ops():
    from repro_torch.launch.op_cost import OpCost

    calls = _wrapper_calls()
    before = dict(ref.calls)
    with FakeTensorMode():
        for name, call in calls(lambda s, dt: torch.zeros(s, dtype=dt)
                                ).items():
            cost = OpCost()
            with cost:
                call()
            assert dict(cost.kernel_calls) == {name: 1}, name
    assert dict(ref.calls) == before
    # Real CPU tensors run the plain versions, counted or not.
    real = calls(lambda s, dt: torch.ones(s, dtype=dt) * 0.5)
    for name, call in real.items():
        cost = OpCost()
        with cost:
            call()
        assert not cost.kernel_calls, name
    plain = {"flash_attention": "attention_ref",
             "flash_attention_bwd": "attention_bwd_ref",
             "decode_attention": "decode_attention_ref",
             "selective_scan": "selective_scan_ref",
             "selective_scan_bwd": "selective_scan_bwd_ref",
             "rglru_scan": "rglru_ref", "rglru_scan_bwd": "rglru_bwd_ref"}
    for name, call in calls(lambda s, dt: torch.ones(s, dtype=dt) * 0.5
                            ).items():
        n = ref.calls[plain[name]]
        call()
        assert ref.calls[plain[name]] == n + 1, name
    assert set(plain) == set(custom_ops.OPS)


def test_artifact_reads_into_roofline_and_bridge(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TEST_MESH", "1x2")
    try:
        rec = dryrun.run_cell("smollm-360m", "decode_32k", "single",
                              out_dir=str(tmp_path), device="cpu")
    finally:
        dist.destroy_process_group()
    assert rec["ok"], rec.get("error")
    assert rec["card"] == dryrun.DEFAULT_CARD and rec["n_chips"] == 2
    assert rec["kernel_calls"] == {"decode_attention": 32}
    rows = roofline.report("single", str(tmp_path))
    assert len(rows) == 1 and rows[0]["t_compute_s"] > 0
    rates = bridge.DEVICE_RATES[rec["card"]]
    assert rows[0]["t_compute_s"] == rec["flops_total"] / rates.peak_flops
    sig = bridge.signature_from_artifact(
        str(tmp_path / "smollm-360m__decode_32k__single.json"), rates=rates)
    assert (sig.kind, sig.t_comp) == ("decode", rows[0]["t_compute_s"])
    assert sig.t_coll > 0


def test_a_failing_cell_records_its_error(tmp_path, monkeypatch):
    def fail(*args, **kwargs):
        raise ValueError("no such layout")

    monkeypatch.setattr(dryrun, "count_cell", fail)
    monkeypatch.setenv("REPRO_TEST_MESH", "1x2")
    try:
        rec = dryrun.run_cell("smollm-360m", "decode_32k", "single",
                              out_dir=str(tmp_path), device="cpu")
    finally:
        dist.destroy_process_group()
    assert not rec["ok"] and rec["error"] == "ValueError: no such layout"
    assert roofline.report("single", str(tmp_path))[0]["error"] == \
        rec["error"]


def test_without_a_card_the_dry_run_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                     "--mesh", "single", "--out", str(tmp_path)])
    assert dryrun.card_for("cpu") == dryrun.DEFAULT_CARD
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "a card")
    with pytest.raises(KeyError, match="no rates"):
        dryrun.card_for("cuda")
    assert dataclasses.asdict(bridge.DEVICE_RATES[dryrun.DEFAULT_CARD])[
        "dci_bw"] == 50e9
