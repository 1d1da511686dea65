"""The port's roofline and counting (``launch.roofline``,
``launch.op_cost``, ``kernels.custom_ops``, the registry's specs and the
dry run's production knobs) against the reference's, on the CPU.

- ``active_params`` for all ten ``ARCHS`` and ``model_flops`` for all 32
  cells equal to the reference's (exactly: integer counts, the same
  float arithmetic).
- ``roofline_row`` field for field equal to
  ``repro.launch.roofline.roofline_row`` given the reference's v5e rates
  and 16 GB, on records without convert bytes (the one deliberate
  difference: the port keeps them in the memory term): the reference
  test's record, a cross-pod record, and an error record through
  ``report``.
- ``input_specs`` and ``cache_specs``: the reference's shapes and dtypes
  for every cell; ``OVERRIDES``, ``prod_config`` (field for field) and
  ``mesh_info_for`` on both production meshes and for B == 1.
- Each kernel's flop formula equal to ``analyze_hlo`` of the reference's
  plain version (its backward: of ``jax.vjp`` less the forward), at two
  shapes, exactly.
- The product FLOPs of the unsharded train, prefill and decode steps of
  reduced configs (one arch of each family: dense, moe, ssm, hybrid,
  encdec) against ``analyze_hlo`` of the reference's compiled step,
  within ``STEP_FLOPS_RTOL`` (0: equal).
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import registry as jreg
from repro.launch import roofline as jr
from repro.launch.hlo_cost import analyze_hlo
from repro_torch.configs import registry as treg
from repro_torch.core.bridge import DeviceRates
from repro_torch.kernels import ops as tops
from repro_torch.kernels import selective_scan_bwd, rglru_scan_bwd
from repro_torch.kernels import flash_attention_bwd
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import roofline as tr
from repro_torch.launch.mesh import ShapeMesh, make_production_mesh
from repro_torch.launch.op_cost import OpCost

from _torch_threads import one_torch_thread  # noqa: F401

# The reference's TPU v5e rates, for the comparison only.
V5E = DeviceRates(peak_flops=jr.PEAK_FLOPS, hbm_bw=jr.HBM_BW,
                  link_bw=jr.LINK_BW, dci_bw=jr.DCI_BW, hbm_bytes=16e9)
# The unsharded steps' product FLOPs against analyze_hlo of the compiled
# reference step: equal, to the FLOP (both sides count the same products
# of the same shapes; the FLOPs are integers well inside float64).
STEP_FLOPS_RTOL = 0.0


def _ref_dryrun():
    """``repro.launch.dryrun`` imported without leaving its XLA_FLAGS (512
    host devices) for a later JAX start in this process."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


@functools.lru_cache(maxsize=None)
def _ref_active(arch):
    return jr.active_params(arch)


@pytest.mark.parametrize("arch", list(jreg.ARCHS))
def test_active_params_match_reference(arch):
    assert tr.active_params(arch) == _ref_active(arch)


@pytest.mark.parametrize("cell", jreg.all_cells(), ids="-".join)
def test_model_flops_match_reference(cell, monkeypatch):
    monkeypatch.setattr(jr, "active_params", _ref_active)
    assert tr.model_flops(*cell) == jr.model_flops(*cell)


def _records():
    base = {"arch": "qwen3-1.7b", "shape": "decode_32k", "mesh": "single",
            "n_chips": 256, "ok": True,
            "flops_total": 197e12 * 0.001,
            "bytes_accessed_total": 819e9 * 0.004,
            "collectives": {"wire_bytes_per_chip": 50e9 * 0.002},
            "memory_analysis": {"argument_size_in_bytes": int(8e9),
                                "temp_size_in_bytes": int(2e9),
                                "output_size_in_bytes": int(1e9),
                                "alias_size_in_bytes": int(1e9)}}
    cross = dict(base, arch="grok-1-314b", shape="train_4k", mesh="multi",
                 n_chips=512, flops_total=3.1e15,
                 bytes_accessed_total=2.2e13,
                 collectives={"wire_bytes_per_chip": 9e11,
                              "cross_pod_bytes_per_chip": 4e10},
                 memory_analysis={"argument_size_in_bytes": int(9e9),
                                  "temp_size_in_bytes": int(9e9),
                                  "output_size_in_bytes": int(9e9),
                                  "alias_size_in_bytes": int(9e9)})
    error = {"arch": "smollm-360m", "shape": "prefill_32k",
             "mesh": "single", "n_chips": 256, "ok": False,
             "error": "RuntimeError: no"}
    return {"reference_test": base, "cross_pod": cross, "error": error}


@pytest.mark.parametrize("name", list(_records()))
def test_roofline_row_matches_reference(name, tmp_path, monkeypatch):
    monkeypatch.setattr(jr, "active_params", _ref_active)
    rec = _records()[name]
    with open(tmp_path / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
              ".json", "w") as f:
        import json
        json.dump(rec, f)
    want = jr.report(rec["mesh"], str(tmp_path))
    got = tr.report(rec["mesh"], str(tmp_path), rates=V5E)
    assert len(want) == len(got) == 1
    want, got = want[0], got[0]
    if not rec["ok"]:
        assert got == want
        return
    want["fits_hbm"] = want.pop("fits_16gb")
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key] == value, key
    if name == "reference_test":
        assert got["dominant"] == "memory"
        assert got["hbm_gb_per_chip"] == pytest.approx(10.0)


def test_roofline_row_keeps_convert_bytes():
    rec = dict(_records()["reference_test"], convert_bytes_total=819e9 * 0.001)
    row = tr.roofline_row(rec, V5E)
    assert row["t_memory_s"] == pytest.approx(0.004)
    assert jr.roofline_row(rec)["t_memory_s"] == pytest.approx(0.003)


def test_roofline_fraction_shows_an_undercount(monkeypatch):
    """Counted FLOPs below the model's give a fraction above 1, which the
    reference caps at 1 and the port reports as it is."""
    monkeypatch.setattr(jr, "active_params", _ref_active)
    rec = _records()["reference_test"]
    mf = tr.model_flops(rec["arch"], rec["shape"]) / rec["n_chips"]
    rec = dict(rec, flops_total=mf / 4, bytes_accessed_total=0.0,
               collectives={"wire_bytes_per_chip": 0.0})
    row = tr.roofline_row(rec, V5E)
    assert row["dominant"] == "compute"
    assert row["roofline_fraction"] == pytest.approx(4.0)
    assert jr.roofline_row(rec)["roofline_fraction"] == 1.0


def test_rates_come_from_the_artifacts_card():
    rec = dict(_records()["reference_test"], card="NVIDIA H100 80GB HBM3")
    row = tr.roofline_row(rec)
    assert row["t_compute_s"] == pytest.approx(197e12 * 0.001 / 989e12)
    assert row["fits_hbm"]
    with pytest.raises(KeyError, match="no rates"):
        tr.roofline_row(dict(rec, card="a card"))


def _tree_specs(tree):
    """(path, shape, dtype name) of every leaf, in key order."""
    if isinstance(tree, (list, tuple)):
        return [(f"{i}/{p}", s, d) for i, t in enumerate(tree)
                for p, s, d in _tree_specs(t)]
    if isinstance(tree, dict):
        return [(f"{k}/{p}", s, d) for k in sorted(tree)
                for p, s, d in _tree_specs(tree[k])]
    dt = str(tree.dtype)
    return [("", tuple(tree.shape), dt.replace("torch.", ""))]


@pytest.mark.parametrize("cell", jreg.all_cells(), ids="-".join)
def test_specs_match_reference(cell):
    got = treg.input_specs(*cell)
    want = jreg.input_specs(*cell)
    assert _tree_specs(got) == _tree_specs(want)
    assert all(t.device.type == "meta" for t in got.values())
    if jreg.SHAPES[cell[1]].kind == "decode":
        assert _tree_specs(treg.cache_specs(*cell)) == _tree_specs(
            jreg.cache_specs(*cell))


def test_overrides_prod_config_and_mesh_roles():
    jd = _ref_dryrun()
    assert tdry.OVERRIDES == jd.OVERRIDES
    assert tdry.SERVING_TP_ONLY_LIMIT == jd.SERVING_TP_ONLY_LIMIT
    for arch, shape in jreg.all_cells():
        tcfg, tmb = tdry.prod_config(arch, shape)
        jcfg, jmb = jd.prod_config(arch, shape)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tmb == jmb
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for B in (1, 32, 128, 256, 3 * 16):
            got = tdry.mesh_info_for(mesh, B)
            want = jd.mesh_info_for(mesh, B)
            assert (got.dp, got.tp, got.fsdp_over) == (want.dp, want.tp,
                                                      want.fsdp_over)
            assert got.dp_size == want.dp_size
    with pytest.raises(ValueError, match="unshardable"):
        tdry.mesh_info_for(ShapeMesh({"data": 16, "model": 16}), 24)


# ---------------------------------------------------------------------------
# Flop formulas against analyze_hlo of the reference's plain versions
# ---------------------------------------------------------------------------

def _hlo_flops(f, *args) -> float:
    return analyze_hlo(jax.jit(f).lower(*args).compile().as_text(),
                       1)["flops"]


def _fake_flops(fn, *shapes) -> tuple:
    """FLOPs and kernel calls that OpCost counts for ``fn`` on fake CPU
    float32 tensors of ``shapes`` (int shapes: int32 lengths)."""
    with FakeTensorMode():
        args = [torch.empty(s, dtype=torch.int32 if name == "lengths"
                            else torch.float32) for s, name in shapes]
        cost = OpCost()
        with cost:
            fn(*args)
    return cost.flops, dict(cost.kernel_calls)


ATTN = [(2, 16, 16, 4, 2, 32), (1, 24, 40, 6, 3, 64)]
SCAN = [(2, 16, 8, 4), (1, 24, 16, 16)]


def _f32(*s):
    return jnp.zeros(s, jnp.float32)


@pytest.mark.parametrize("shape", ATTN, ids=str)
@pytest.mark.parametrize("kernel", ["flash_attention", "flash_attention_bwd",
                                    "decode_attention"])
def test_attention_flop_formulas_match_analyze_hlo(kernel, shape):
    from repro.kernels import ref as jref

    B, Sq, Sk, Hq, Hkv, d = shape
    q, k = _f32(B, Sq, Hq, d), _f32(B, Sk, Hkv, d)
    att = lambda q, k, v: jref.attention_ref(q, k, v)  # noqa: E731
    if kernel == "flash_attention":
        want = _hlo_flops(att, q, k, k)
        got, calls = _fake_flops(
            lambda q, k, v: tops.flash_attention(q, k, v),
            ((B, Sq, Hq, d), "q"), ((B, Sk, Hkv, d), "k"),
            ((B, Sk, Hkv, d), "v"))
    elif kernel == "flash_attention_bwd":
        def vjp(q, k, v, do):
            o, f = jax.vjp(att, q, k, v)
            return o, f(do)
        want = _hlo_flops(vjp, q, k, k, q) - _hlo_flops(att, q, k, k)
        got, calls = _fake_flops(
            lambda q, k, v, o, lse: flash_attention_bwd.flash_attention_bwd(
                q, k, v, o, o, lse),
            ((B, Sq, Hq, d), "q"), ((B, Sk, Hkv, d), "k"),
            ((B, Sk, Hkv, d), "v"), ((B, Sq, Hq, d), "o"),
            ((B, Hq, Sq), "lse"))
    else:
        lens = jnp.ones((B,), jnp.int32)
        want = _hlo_flops(lambda q, k, v, n: jref.decode_attention_ref(
            q, k, v, n), _f32(B, Hq, d), k, k, lens)
        got, calls = _fake_flops(
            lambda q, k, v, n: tops.decode_attention(q, k, v, n),
            ((B, Hq, d), "q"), ((B, Sk, Hkv, d), "k"),
            ((B, Sk, Hkv, d), "v"), ((B,), "lengths"))
    assert want > 0 and got == want
    assert calls == {kernel: 1}


@pytest.mark.parametrize("shape", SCAN, ids=str)
@pytest.mark.parametrize("kernel", ["selective_scan", "selective_scan_bwd",
                                    "rglru_scan", "rglru_scan_bwd"])
def test_scan_flop_formulas_match_analyze_hlo(kernel, shape):
    from repro.kernels import ref as jref

    Bt, S, Di, N = shape
    x, A, Bm, D = _f32(Bt, S, Di), _f32(Di, N), _f32(Bt, S, N), _f32(Di)
    h = _f32(Bt, Di, N)
    sel = lambda *a: jref.selective_scan_ref(*a)  # noqa: E731
    rg = lambda x, a: jref.rglru_ref(x, a)  # noqa: E731
    xs = ((Bt, S, Di), "x")
    if kernel == "selective_scan":
        want = _hlo_flops(sel, x, x, A, Bm, Bm, D)
        got, calls = _fake_flops(tops.selective_scan, xs, xs,
                                 ((Di, N), "A"), ((Bt, S, N), "B"),
                                 ((Bt, S, N), "C"), ((Di,), "D"))
    elif kernel == "selective_scan_bwd":
        def vjp(x, dt, A, B, C, D, dy, dh):
            o, f = jax.vjp(sel, x, dt, A, B, C, D)
            return o, f((dy, dh))
        want = (_hlo_flops(vjp, x, x, A, Bm, Bm, D, x, h)
                - _hlo_flops(sel, x, x, A, Bm, Bm, D))
        got, calls = _fake_flops(
            lambda x, dt, A, B, C, D, dy, st:
            selective_scan_bwd.selective_scan_bwd(
                x, dt, A, B, C, D, None, dy, None, states=st),
            xs, xs, ((Di, N), "A"), ((Bt, S, N), "B"), ((Bt, S, N), "C"),
            ((Di,), "D"), xs, ((Bt, -(-S // 32), Di, N), "states"))
    elif kernel == "rglru_scan":
        want = _hlo_flops(rg, x, x)
        got, calls = _fake_flops(tops.rglru_scan, xs, xs)
    else:
        def vjp(x, a, dy):
            o, f = jax.vjp(lambda x, a: rg(x, a)[0], x, a)
            return o, f(dy)
        want = _hlo_flops(vjp, x, x, x) - _hlo_flops(rg, x, x)
        got, calls = _fake_flops(
            lambda x, a, dy: rglru_scan_bwd.rglru_scan_bwd(
                x, a, None, dy, None, states=dy), xs, xs, xs)
    assert got == want
    if kernel.startswith("selective"):
        assert want > 0
    assert calls == {kernel: 1}


# ---------------------------------------------------------------------------
# The unsharded steps of reduced configs against the compiled reference
# ---------------------------------------------------------------------------

FAMILIES = {"dense": "qwen3-1.7b", "moe": "moonshot-v1-16b-a3b",
            "ssm": "falcon-mamba-7b", "hybrid": "recurrentgemma-9b",
            "encdec": "seamless-m4t-medium"}
B_, S_ = 2, 16


def _reduced(pkg_get_config, arch):
    n = 3 if arch == "recurrentgemma-9b" else 2
    kw = dict(n_layers=n, attn_impl="ref")
    if arch == "seamless-m4t-medium":
        kw["n_enc_layers"] = 2
    if arch == "recurrentgemma-9b":
        kw["window"] = 8
    return pkg_get_config(arch).reduced(**kw)


def _ref_step_flops(cfg, kind) -> float:
    from repro.models.model import build_model, init_cache, init_params
    from repro.train.optimizer import OptConfig, adamw_init
    from repro.train.step import build_train_step

    model = build_model(cfg)
    params = jax.eval_shape(functools.partial(init_params, cfg),
                            jax.random.PRNGKey(0))
    i32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.int32)  # noqa: E731
    mem = S_ + 3 if cfg.family == "encdec" else 0
    if kind == "decode":
        batch = {"tokens": i32(B_, 1), "lengths": i32(B_)}
        if mem:
            batch["mem_len"] = i32(B_)
        caches = jax.eval_shape(lambda: init_cache(cfg, B_, S_, mem))
        return _hlo_flops(model.decode_step, params, batch, caches)
    batch = {"tokens": i32(B_, S_)}
    if mem:
        batch["src_embeds"] = jax.ShapeDtypeStruct((B_, mem, cfg.d_model),
                                                   jnp.dtype(cfg.dtype))
    if kind == "prefill":
        return _hlo_flops(lambda p, b: model.prefill(p, b, S_), params,
                          batch)
    batch["labels"] = i32(B_, S_)
    opt = OptConfig()
    state = {"params": params,
             "opt": jax.eval_shape(functools.partial(adamw_init, opt),
                                   params)}
    return _hlo_flops(build_train_step(model, opt), state, batch)


def _port_step_flops(cfg, kind) -> tuple:
    from repro_torch.models.model import LM
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import build_train_step, init_state

    mem = S_ + 3 if cfg.family == "encdec" else 0
    with FakeTensorMode():
        model = LM(cfg, "cpu")
        batch = treg.make_inputs(cfg, kind, B_, S_, "cpu")
        if mem and kind != "decode":
            batch["src_embeds"] = torch.zeros(B_, mem, cfg.d_model)
        if kind == "train":
            state = init_state(model, OptConfig())
            run = lambda: build_train_step(  # noqa: E731
                model, OptConfig())(state, batch)
        elif kind == "prefill":
            run = lambda: model.prefill(batch, S_)  # noqa: E731
        else:
            caches = model.init_cache(B_, S_, mem)
            run = lambda: model.decode_step(batch, caches)  # noqa: E731
        cost = OpCost()
        with cost:
            run()
    return cost.flops, dict(cost.kernel_calls)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_step_flops_match_analyze_hlo(family, kind):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget

    arch = FAMILIES[family]
    want = _ref_step_flops(_reduced(jget, arch), kind)
    got, calls = _port_step_flops(_reduced(tget, arch), kind)
    assert abs(got - want) <= STEP_FLOPS_RTOL * want
    if family != "ssm":
        assert calls.get("decode_attention" if kind == "decode"
                         else "flash_attention", 0) > 0
    if kind == "train" and family in ("ssm", "hybrid"):
        assert calls[{"ssm": "selective_scan_bwd",
                      "hybrid": "rglru_scan_bwd"}[family]] > 0
    np.testing.assert_array_less(0, got)
