"""The port's recurrent serving paths (falcon-mamba-7b, recurrentgemma-9b)
against the reference's, on the CPU.

The reduced configs (``reduced()``): falcon-mamba four ``mamba`` layers
(d_inner 256, N = 8); recurrentgemma the plan ``[("super", 1),
("rec", 1)]``, so one griffin super-block (rec, rec, local attention with
window 32) and a recurrent tail, d_rnn 128.

- The model, with the reference's parameters loaded: ``prefill`` logits
  and caches, then decode steps with ragged lengths, against the
  reference's model.  falcon-mamba with a 300-token prompt, longer than
  the reference's scan chunk of 256 (its ``_scan_chunked`` against the
  port's one call); recurrentgemma with a prompt longer than the window
  (the ring in prefill) and with a prompt just under it that decodes past
  it (the ring in decode).  float32: rtol = atol = 2e-4 (seen: about
  3e-6).  bfloat16: the two frameworks round bfloat16 intermediates at
  other places (``jax.nn.silu`` and ``jax.nn.gelu`` round each step of
  their formulas to bfloat16 on the CPU, torch rounds once), a few
  bfloat16 ulps in the logits: falcon-mamba to rtol = atol = 3e-2 (seen:
  0.89 of it), recurrentgemma, whose four layers each add a rec or
  attention block and an MLP, to 6e-2 (seen: 0.65 of it, 1.31 of 3e-2 at
  the third decode step).
- Traps pinned one by one: the GeLU is ``jax.nn.gelu``'s tanh
  approximation; prefill hands the scan ``a`` and the gated input rounded
  to the model dtype, decode steps with the float32 ``a``.
- The full-sequence ``forward`` of each layer against ``stack_train``.
- ``ServeEngine`` emits the reference engine's tokens, for both models.
- ``interop.lm_params_from_jax`` carries the nested super-block
  parameters across bit for bit; the full-width models' parameter names,
  shapes and dtypes (on the meta device) equal ``jax.eval_shape`` of the
  reference's ``init_params``.
- ``python -m repro_torch.launch.serve --smoke --device cpu`` for both
  archs.

Each (arch, overrides) pair of models is built once for the module, and
the reference's ``init``, ``prefill`` and ``decode_step`` run under
``jax.jit``.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from numpy.testing import assert_allclose

from repro.configs import registry as jreg
from repro.models import model as jmodel
from repro.models import rglru as jrglru
from repro.models import transformer as jtrans
from repro.serve import engine as jengine
from repro_torch.configs import registry as treg
from repro_torch.interop import lm_params_from_jax
from repro_torch.models import rglru as trglru
from repro_torch.models.model import LM
from repro_torch.models.transformer import Layer, leaf_kinds
from repro_torch.models.tree import tree_map
from repro_torch.serve import engine as tengine

from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 2e-4
BF16_TOL = {"falcon-mamba-7b": 3e-2, "recurrentgemma-9b": 6e-2}
ARCHS = ("falcon-mamba-7b", "recurrentgemma-9b")


def _np(a):
    """A reference array as numpy, bfloat16 viewed as uint16."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _torch(a):
    """A reference array as a CPU tensor of the same dtype."""
    a = _np(a)
    t = torch.from_numpy(a.copy())
    return t.view(torch.bfloat16) if a.dtype == np.uint16 else t


def _pair(arch, **over):
    """The reference's model (prefill and decode step jitted) and
    parameters from key 0, and the port's model with the same parameters
    loaded, on the CPU; built once per (arch, overrides)."""
    return _built(arch, tuple(sorted(over.items())))


@functools.lru_cache(maxsize=None)
def _built(arch, over):
    jcfg = jreg.get_config(arch).reduced(**dict(over))
    cfg = treg.get_config(arch).reduced(**dict(over))
    jm = jmodel.build_model(jcfg)
    jm = dataclasses.replace(
        jm, prefill=jax.jit(jm.prefill, static_argnums=2),
        decode_step=jax.jit(jm.decode_step))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = LM(cfg, "cpu")
    tp.load_state_dict(lm_params_from_jax(jax.tree.map(_np, jp)))
    return jm, jp, tp


def _assert_caches(tc, jc, tol):
    """Every leaf of the port's nested caches against the reference's."""
    flat = jax.tree_util.tree_flatten_with_path(jc)[0]
    leaves = []
    for c in tc:
        tree_map(leaves.append, c)
    assert len(leaves) == len(flat)
    for path, leaf in flat:
        t = tc
        for p in path:
            t = t[p.idx if isinstance(p, jax.tree_util.SequenceKey)
                  else p.key]
        assert t.shape == leaf.shape, path
        assert_allclose(_f32(t), _f32(leaf), rtol=tol, atol=tol,
                        err_msg=str(path))


# ---------------------------------------------------------------------------
# The models against the reference's
# ---------------------------------------------------------------------------

# (arch, overrides, prompt length, decode steps)
MODEL_CASES = {
    "falcon-mamba f32 S=300 (over the reference's scan chunk)":
        ("falcon-mamba-7b", {}, 300, 3),
    "falcon-mamba bf16": ("falcon-mamba-7b", dict(dtype="bfloat16"), 40, 3),
    "recurrentgemma f32 S=40 (prefill past the window)":
        ("recurrentgemma-9b", {}, 40, 3),
    "recurrentgemma f32 S=28 (decode past the window)":
        ("recurrentgemma-9b", {}, 28, 7),
    "recurrentgemma bf16": ("recurrentgemma-9b", dict(dtype="bfloat16"), 40,
                            3),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_prefill_and_decode_match_reference(case):
    arch, over, S, steps = MODEL_CASES[case]
    tol = BF16_TOL[arch] if over.get("dtype") == "bfloat16" else F32_TOL
    jm, jp, tp = _pair(arch, **over)
    rng = np.random.default_rng(0)
    toks = rng.integers(3, tp.cfg.vocab, size=(2, S)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 64)
    tl, tc = tp.prefill({"tokens": torch.as_tensor(toks).long()}, 64)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    assert_allclose(_f32(tl), _f32(jl), rtol=tol, atol=tol)
    _assert_caches(tc, jc, tol)
    lens = np.array([S, S - 5], np.int32)
    nxt = np.argmax(_f32(jl), -1).astype(np.int32)
    for _ in range(steps):
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(nxt[:, None]),
                                     "lengths": jnp.asarray(lens)}, jc)
        tl = tp.decode_step({
            "tokens": torch.as_tensor(nxt[:, None]).long(),
            "lengths": torch.as_tensor(lens)}, tc)
        assert_allclose(_f32(tl), _f32(jl), rtol=tol, atol=tol)
        nxt = np.argmax(_f32(jl), -1).astype(np.int32)
        lens = lens + 1
    _assert_caches(tc, jc, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_matches_reference(arch):
    jm, jp, tp = _pair(arch)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 40, tp.cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40)).copy()
    jy, _ = jax.jit(lambda g, x, pos: jtrans.stack_train(
        g, x, jm.cfg, pos))(jp["groups"], jnp.asarray(x), jnp.asarray(pos))
    ty = torch.from_numpy(x)
    with torch.no_grad():
        for group in tp.groups:
            for layer in group:
                ty = layer(ty, torch.from_numpy(pos))
    assert_allclose(_f32(ty), _f32(jy), rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------------------------
# The traps of the RG-LRU block
# ---------------------------------------------------------------------------

def _rglru_block(dtype):
    """The reference's parameters of one recurrent block, the port's block
    with them loaded, and an input x [2, 24, D] in ``dtype``."""
    cfg = treg.get_config("recurrentgemma-9b").reduced(dtype=dtype)
    jcfg = jreg.get_config("recurrentgemma-9b").reduced(dtype=dtype)
    jp = jrglru.rglru_init(jax.random.PRNGKey(3), jcfg)
    # With the init's Lambda, a = exp(-8 softplus(Lambda) r) is nearly 0
    # for these random weights; this Lambda puts a in about (0.4, 0.99),
    # where rounding it to bfloat16 shows.
    rng = np.random.default_rng(3)
    jp["rg_lambda"] = jnp.asarray(rng.uniform(-6, -2, cfg.d_rnn_).astype(
        np.float32))
    tp = trglru.RGLRU(cfg, "cpu")
    for key, val in jp.items():
        getattr(tp, key).data.copy_(_torch(val))
    jx = jnp.asarray(rng.standard_normal((2, 24, cfg.d_model),
                                         dtype=np.float32)).astype(dtype)
    return cfg, jcfg, jp, tp, jx, _torch(jx)


def test_rglru_gate_is_the_tanh_gelu():
    cfg, jcfg, jp, tp, jx, tx = _rglru_block("float32")
    with torch.no_grad():
        gate, _, _ = trglru._in(tp, tx, cfg)
        pre = trglru.rms_norm(tx, tp.norm, cfg.norm_eps) @ tp.rg_gate
    want = jax.jit(lambda p, x: jax.nn.gelu(
        jrglru.rms_norm(x, p["norm"], jcfg.norm_eps) @ p["rg_gate"]))(jp, jx)
    assert_allclose(_f32(gate), _f32(want), rtol=1e-6, atol=1e-6)
    # torch's default GeLU (erf) is another function: 1e-4 apart here.
    assert float((F.gelu(pre) - gate).abs().max()) > 1e-4


def test_rglru_prefill_rounds_a_and_decode_does_not(monkeypatch):
    cfg, jcfg, jp, tp, jx, tx = _rglru_block("bfloat16")
    seen = {}
    scan = trglru.ops.rglru_scan

    def spy(x, a, h0=None):
        seen["x"], seen["a"] = x, a
        return scan(x, a, h0)

    monkeypatch.setattr(trglru.ops, "rglru_scan", spy)
    with torch.no_grad():
        _, u, _ = trglru._in(tp, tx, cfg)
        a, xin = trglru._gates(tp, u)
        _, cache = trglru.rglru_train(tp, tx, cfg, return_cache=True)
    # Prefill: the scan takes a and the gated input in bfloat16, rounded
    # from the float32 gates, and the reference rounds the same a.
    assert seen["a"].dtype == torch.bfloat16
    assert torch.equal(seen["a"], a.to(torch.bfloat16))
    assert torch.equal(seen["x"], xin.to(torch.bfloat16))
    ja, _ = jax.jit(jrglru._gates)(jp, jnp.asarray(_f32(u)).astype(
        jnp.bfloat16))
    assert_allclose(_f32(seen["a"]), _f32(ja.astype(jnp.bfloat16)),
                    rtol=2.0 ** -7, atol=0)
    # Decode: the new state steps with the float32 a0, as the reference's
    # rglru_decode does (its lines, on the reference's gates of the same
    # u); a bfloat16 a0 would give another state.
    h_before = cache["h"].clone()
    x1 = tx[:, :1]
    with torch.no_grad():
        _, u1, _ = trglru._in(tp, x1, cfg, cache["conv"].clone())
        trglru.rglru_decode(tp, x1, cache, cfg)
    ja, jxin = jax.jit(jrglru._gates)(jp, jnp.asarray(_f32(u1)).astype(
        jnp.bfloat16))
    a0, h0 = ja[:, 0], jnp.asarray(h_before.numpy())
    want = a0 * h0 + jnp.sqrt(jnp.maximum(1 - a0 * a0, 0.0)) * jxin[:, 0]
    assert_allclose(cache["h"].numpy(), np.asarray(want), rtol=1e-5,
                    atol=1e-5)
    r0 = a0.astype(jnp.bfloat16).astype(jnp.float32)
    alt = r0 * h0 + jnp.sqrt(jnp.maximum(1 - r0 * r0, 0.0)) * jxin[:, 0]
    assert float(jnp.abs(alt - want).max()) > 1e-3


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_emits_reference_tokens(arch):
    # Prompts of 30-42 tokens: recurrentgemma's window of 32 rings in
    # prefill for some requests and in decode for the others.
    jm, jp, tp = _pair(arch)
    outs = []
    for mod, args in ((jengine, (jm, jp)), (tengine, (tp,))):
        eng = mod.ServeEngine(*args, mod.EngineConfig(n_slots=2, cache_len=64,
                                                      eos=-1))
        rng = np.random.default_rng(0)
        reqs = [mod.Request(i, rng.integers(3, tp.cfg.vocab, size=30 + 3 * i)
                            .astype(np.int32), max_tokens=4)
                for i in range(5)]
        for r in reqs:
            eng.submit(r)
        ticks = eng.run()
        assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
        outs.append(([r.out_tokens for r in reqs], ticks))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def test_lm_params_from_jax_round_trip_nested():
    _, jp, tp = _pair("recurrentgemma-9b", dtype="bfloat16")
    sd = lm_params_from_jax(jax.tree.map(_np, jp))
    back = tp.state_dict()
    assert set(back) == set(sd)
    for key, t in sd.items():
        assert back[key].dtype == t.dtype and torch.equal(back[key], t), key
    g = jp["groups"]
    for name, leaf, dtype in (
            ("groups.0.0.s2.attn.wq", g[0]["s2"]["attn"]["wq"][0],
             torch.bfloat16),
            ("groups.0.0.s0.rec.rg_a", g[0]["s0"]["rec"]["rg_a"][0],
             torch.float32),
            ("groups.0.0.s1.mlp.w2", g[0]["s1"]["mlp"]["w2"][0],
             torch.bfloat16),
            ("groups.1.0.rec.rg_lambda", g[1]["rec"]["rg_lambda"][0],
             torch.float32)):
        assert sd[name].dtype == dtype
        raw = (sd[name].view(torch.int16).numpy().view(np.uint16)
               if dtype == torch.bfloat16 else sd[name].numpy())
        np.testing.assert_array_equal(raw, _np(leaf))
    _, jpm, _ = _pair("falcon-mamba-7b")
    sdm = lm_params_from_jax(jax.tree.map(_np, jpm))
    np.testing.assert_array_equal(
        sdm["groups.0.3.mamba.A_log"].numpy(),
        np.asarray(jpm["groups"][0]["mamba"]["A_log"][3]))


def _unstacked_shapes(tree) -> dict:
    out = {}
    for key, val in tree.items():
        if key == "groups":
            for g, group in enumerate(val):
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                        group)[0]:
                    name = ".".join(p.key for p in path)
                    for i in range(leaf.shape[0]):
                        out[f"groups.{g}.{i}.{name}"] = (
                            tuple(leaf.shape[1:]), str(leaf.dtype))
        else:
            out[key] = (tuple(val.shape), str(val.dtype))
    return out


@pytest.mark.parametrize("arch,lo,hi", [
    ("falcon-mamba-7b", 7.27e9, 7.28e9),      # 7.277 B parameters
    ("recurrentgemma-9b", 9.39e9, 9.40e9)])   # 9.396 B parameters
def test_full_parameter_shapes(arch, lo, hi):
    want = _unstacked_shapes(jax.eval_shape(
        lambda: jmodel.init_params(jreg.get_config(arch),
                                   jax.random.PRNGKey(0))))
    port = LM(treg.get_config(arch), "meta")
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in port.state_dict().items()}
    assert got == want
    n = port.param_count()
    assert n == sum(np.prod(s) for s, _ in want.values())
    assert lo < n < hi


@pytest.mark.parametrize("arch,reduced", [
    (a, r) for a in ("qwen3-1.7b", *ARCHS) for r in (False, True)])
def test_leaf_kinds_count_the_models_leaf_layers(arch, reduced):
    cfg = treg.get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    port = LM(cfg, "meta")
    leaves = [m.kind for m in port.modules()
              if isinstance(m, Layer) and m.kind != "super"]
    want = {k: leaves.count(k) for k in set(leaves)}
    assert dict(leaf_kinds(cfg)) == want
    assert len(leaves) == cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_smoke_on_cpu(arch):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--requests", "3", "--max-tokens",
         "4"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[serve] 3 requests, 12 tokens" in proc.stdout
    assert "all done: True" in proc.stdout
