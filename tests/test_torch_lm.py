"""The port's LM serving path against the reference's, on the CPU.

- Configs: every ``LMConfig`` field of the ten archs and their
  ``reduced()`` copies, the shapes and the eligibility rule, equal.
- Parameters: names, shapes and dtypes of the full qwen3-1.7b model equal
  to ``jax.eval_shape`` of the reference's ``init_params`` (the port's
  model is built on the meta device: nothing is allocated), and
  ``interop.lm_params_from_jax`` carries the reference's parameters
  across bit for bit, bfloat16 included.
- The model: with the reference's parameters loaded, ``prefill`` logits
  and caches and three ``decode_step`` logits (ragged lengths) against the
  reference's model.  qwen3-1.7b ``reduced(n_layers=2,
  attn_impl="pallas")`` (the reference through its Pallas kernels in
  interpret mode), the same with query chunks, and tinyllama-1.1b
  ``reduced(n_layers=2)``, all float32, agree to rtol = atol = 2e-4 (seen:
  about 2e-6).  qwen3 in bfloat16 agrees to rtol = atol = 3e-2: the two
  frameworks round bfloat16 intermediates (silu, the residual adds) at
  other places, one or two bfloat16 ulps (1.6e-2 below 4) in the logits.
  The bfloat16 embedding, whose scale the reference rounds to bfloat16
  first, is equal bit for bit.
- The engine: the port's ``ServeEngine`` emits the reference's tokens on
  ``tests/test_sharding_serve.py::test_engine_serves_all_requests``'s
  requests, and its decode path agrees with a re-prefill (the port's
  counterpart of ``test_engine_greedy_matches_prefill_extension``).
- The parts of the slice's modules that qwen3 serving does not reach, at
  float32 and 2e-4 against the reference's functions: a windowed layer's
  ring cache through ``attn_prefill`` and ``attn_decode``, the training
  forward (the layers' ``forward`` against ``stack_train``, causal and
  bidirectional), and the VLM stub's patch prefix through ``prefill`` and
  ``decode_step``.
- Every one of the ten archs, reduced, builds from a generator and runs
  ``prefill``, ``decode_step`` and ``loss_fn`` with its gradients (the
  aux metric positive exactly for the MoE family); the one raise left
  (``launch.train --model-par 2``) names its ROADMAP item.
- ``python -m repro_torch.launch.serve --smoke --device cpu`` prints its
  summary line.

Each (arch, overrides) pair of models is built once for the module, and
the reference's ``init``, ``prefill`` and ``decode_step`` run under
``jax.jit`` (eagerly they compile op by op).
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
from numpy.testing import assert_allclose

from repro.configs import registry as jreg
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import transformer as jtrans
from repro.serve import engine as jengine
from repro_torch.configs import registry as treg
from repro_torch.interop import lm_params_from_jax
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as tlayers
from repro_torch.models.model import LM
from repro_torch.serve import engine as tengine

from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 2e-4
BF16_TOL = 3e-2


def _np(a):
    """A reference array as numpy, bfloat16 viewed as uint16."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(arch, **over):
    """The reference's model (its prefill and decode step jitted) and
    parameters from key 0, and the port's model with the same parameters
    loaded, on the CPU.  Built once per (arch, overrides)."""
    return _built(arch, tuple(sorted(over.items())))


@functools.lru_cache(maxsize=None)
def _built(arch, over):
    jcfg = jreg.get_config(arch).reduced(n_layers=2, **dict(over))
    cfg = treg.get_config(arch).reduced(n_layers=2, **dict(over))
    jm = jmodel.build_model(jcfg)
    jm = dataclasses.replace(
        jm, prefill=jax.jit(jm.prefill, static_argnums=2),
        decode_step=jax.jit(jm.decode_step))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = LM(cfg, "cpu")
    tp.load_state_dict(lm_params_from_jax(jax.tree.map(_np, jp)))
    return jm, jp, tp


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_configs_equal_field_for_field(arch):
    j, t = jreg.get_config(arch), treg.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.layer_plan() == j.layer_plan()
    for prop in ("hd", "n_heads_p", "vocab_padded", "d_inner", "dt_rank_",
                 "d_rnn_", "attention_free", "bounded_state"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert treg.eligible_shapes(arch) == jreg.eligible_shapes(arch)


def test_shapes_and_cells_equal():
    assert ({k: dataclasses.asdict(v) for k, v in treg.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jreg.SHAPES.items()})
    assert treg.all_cells() == jreg.all_cells()


def _unstacked_shapes(tree) -> dict:
    """The reference's parameter tree as the port's state-dict names,
    shapes and dtypes."""
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


def test_full_qwen3_parameter_shapes():
    cfg = treg.get_config("qwen3-1.7b")
    want = _unstacked_shapes(jax.eval_shape(
        lambda: jmodel.init_params(jreg.get_config("qwen3-1.7b"),
                                   jax.random.PRNGKey(0))))
    port = LM(cfg, "meta")
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in port.state_dict().items()}
    assert got == want
    n = port.param_count()
    assert n == sum(np.prod(s) for s, _ in want.values())
    assert 2.0e9 < n < 2.1e9            # about 2.04 B parameters


def test_lm_params_from_jax_round_trip():
    _, jp, _ = _pair("qwen3-1.7b", dtype="bfloat16")
    jp = jax.tree.map(_np, jp)
    sd = lm_params_from_jax(jp)
    tp = LM(treg.get_config("qwen3-1.7b").reduced(n_layers=2,
                                                  dtype="bfloat16"), "cpu")
    tp.load_state_dict(sd)
    back = tp.state_dict()
    assert set(back) == set(sd)
    for key, t in sd.items():
        assert back[key].dtype == t.dtype and torch.equal(back[key], t), key

    def raw(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    assert back["groups.0.1.attn.wq"].dtype == torch.bfloat16
    assert back["groups.0.1.attn.q_norm"].dtype == torch.float32
    np.testing.assert_array_equal(raw(sd["embed"]), jp["embed"])
    np.testing.assert_array_equal(raw(sd["lm_head"]), jp["lm_head"])
    for i in range(2):
        for part, leaf in (("attn", "wq"), ("attn", "k_norm"),
                           ("mlp", "w2"), ("mlp", "norm")):
            np.testing.assert_array_equal(
                raw(sd[f"groups.0.{i}.{part}.{leaf}"]),
                jp["groups"][0][part][leaf][i])
    with pytest.raises(TypeError):
        lm_params_from_jax({"embed": np.zeros(3, np.float64)})


def test_unported_kinds_name_their_roadmap_item(tmp_path):
    # Every layer kind and family builds, and model parallelism is ported:
    # in one process --model-par 2 fails on the reference's assertion that
    # the model axis divides the ranks.
    for arch in ("grok-1-314b", "seamless-m4t-medium"):
        LM(treg.get_config(arch).reduced(), "meta")
    with pytest.raises(AssertionError):
        launch_train.main(["--smoke", "--device", "cpu", "--model-par", "2",
                           "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("arch", sorted(treg.ARCHS))
def test_every_arch_builds_serves_and_trains(arch):
    """Every one of the ten archs, reduced, builds on the CPU from a
    generator and runs prefill, a decode step and loss_fn with its
    gradients (encoder-decoder with src_embeds and mem_len)."""
    cfg = treg.get_config(arch).reduced()
    model = LM(cfg, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(3, cfg.vocab, (2, 12)))
    extra = {}
    if cfg.family == "encdec":
        extra["src_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, 10, cfg.d_model), dtype=np.float32))
    logits, caches = model.prefill({"tokens": toks, **extra}, 32)
    dec = {"tokens": logits.argmax(-1)[:, None],
           "lengths": torch.full((2,), 12, dtype=torch.int32)}
    if cfg.family == "encdec":
        dec["mem_len"] = torch.tensor([10, 6], dtype=torch.int32)
    out = model.decode_step(dec, caches)
    assert out.shape == (2, cfg.vocab_padded) and torch.isfinite(out).all()
    model.requires_grad_(True)
    loss, metrics = model.loss_fn({"tokens": toks, "labels": toks, **extra})
    loss.backward()
    assert torch.isfinite(loss) and (float(metrics["aux"].detach()) > 0) == (
        cfg.family == "moe")
    assert all(p.grad is not None for p in model.parameters())


def test_entry_points_refuse_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = treg.get_config("qwen3-1.7b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(cfg, "cuda")


# ---------------------------------------------------------------------------
# The model against the reference's
# ---------------------------------------------------------------------------

MODEL_CASES = {
    "qwen3 f32 pallas": ("qwen3-1.7b", dict(attn_impl="pallas"), F32_TOL),
    "qwen3 f32 q_chunk": ("qwen3-1.7b", dict(q_chunk=5), F32_TOL),
    "tinyllama f32": ("tinyllama-1.1b", {}, F32_TOL),
    "qwen3 bf16": ("qwen3-1.7b", dict(dtype="bfloat16"), BF16_TOL),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_prefill_and_decode_match_reference(case):
    arch, over, tol = MODEL_CASES[case]
    jm, jp, tp = _pair(arch, **over)
    rng = np.random.default_rng(0)
    toks = rng.integers(3, tp.cfg.vocab, size=(2, 12)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc = tp.prefill({"tokens": torch.as_tensor(toks).long()}, 32)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    assert_allclose(_f32(tl), _f32(jl), rtol=tol, atol=tol)
    for key in ("k", "v"):
        assert tc[0][key].shape == jc[0][key].shape
        assert_allclose(_f32(tc[0][key]), _f32(jc[0][key]), rtol=tol,
                        atol=tol)
    # Ragged lengths: row 1 decodes from position 9, over its prefill.
    lens = np.array([12, 9], np.int32)
    nxt = np.argmax(_f32(jl), -1).astype(np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(nxt[:, None]),
                                     "lengths": jnp.asarray(lens)}, jc)
        tl = tp.decode_step({
            "tokens": torch.as_tensor(nxt[:, None]).long(),
            "lengths": torch.as_tensor(lens)}, tc)
        assert_allclose(_f32(tl), _f32(jl), rtol=tol, atol=tol)
        nxt = np.argmax(_f32(jl), -1).astype(np.int32)
        lens = lens + 1
    assert_allclose(_f32(tc[0]["v"]), _f32(jc[0]["v"]), rtol=tol, atol=tol)


def test_windowed_ring_cache_matches_reference():
    # A window-sized cache (8) under a 12-token prefill wraps; decode then
    # writes at length % 8 and attends min(length + 1, 8) positions.
    cfg = treg.get_config("qwen3-1.7b").reduced(n_layers=1)
    jcfg = jreg.get_config("qwen3-1.7b").reduced(n_layers=1)
    jp = jlayers.attn_init(jax.random.PRNGKey(4), jcfg)
    tp = tlayers.Attention(cfg, "cpu")
    for key, val in jp.items():
        getattr(tp, key).data.copy_(torch.from_numpy(np.array(val)))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    jprefill = jax.jit(lambda p, x, pos: jlayers.attn_prefill(
        p, x, jcfg, pos, window=8, cache_len=8))
    jdecode = jax.jit(lambda p, x, c, length: jlayers.attn_decode(
        p, x, c, jcfg, length, window=8))
    jx, jc = jprefill(jp, jnp.asarray(x), jnp.asarray(pos))
    tx, tc = tlayers.attn_prefill(tp, torch.from_numpy(x), cfg,
                                  torch.from_numpy(pos.copy()), window=8,
                                  cache_len=8)
    assert_allclose(_f32(tx), _f32(jx), rtol=F32_TOL, atol=F32_TOL)
    assert_allclose(_f32(tc["k"]), _f32(jc["k"]), rtol=F32_TOL, atol=F32_TOL)
    length = np.array([12, 12], np.int32)
    for _ in range(3):
        x1 = rng.standard_normal((2, 1, cfg.d_model), dtype=np.float32)
        jy, jc = jdecode(jp, jnp.asarray(x1), jc, jnp.asarray(length))
        ty = tlayers.attn_decode(tp, torch.from_numpy(x1), tc, cfg,
                                 torch.from_numpy(length), window=8)
        assert_allclose(_f32(ty), _f32(jy), rtol=F32_TOL, atol=F32_TOL)
        length = length + 1
    assert_allclose(_f32(tc["v"]), _f32(jc["v"]), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("bidir", [False, True])
def test_train_forward_matches_reference(bidir):
    jm, jp, tp = _pair("tinyllama-1.1b")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 10, tp.cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(10), (2, 10)).copy()
    extra = {"bidir": True} if bidir else {}
    jy, _ = jtrans.stack_train(jp["groups"], jnp.asarray(x), jm.cfg,
                                 jnp.asarray(pos), extra=extra)
    ty = torch.from_numpy(x)
    with torch.no_grad():
        for group in tp.groups:
            for layer in group:
                ty = layer(ty, torch.from_numpy(pos), causal=not bidir)
    assert_allclose(_f32(ty), _f32(jy), rtol=F32_TOL, atol=F32_TOL)


def test_vlm_patch_prefix_matches_reference():
    jm, jp, tp = _pair("llava-next-34b")
    rng = np.random.default_rng(6)
    toks = rng.integers(3, tp.cfg.vocab, size=(2, 12)).astype(np.int32)
    pe = rng.standard_normal((2, tp.cfg.n_frontend_tokens, tp.cfg.d_model),
                             dtype=np.float32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "patch_embeds": jnp.asarray(pe)}, 48)
    tl, tc = tp.prefill({"tokens": torch.as_tensor(toks).long(),
                         "patch_embeds": torch.from_numpy(pe)}, 48)
    assert_allclose(_f32(tl), _f32(jl), rtol=F32_TOL, atol=F32_TOL)
    lens = np.full(2, tp.cfg.n_frontend_tokens + 12, np.int32)
    nxt = np.argmax(_f32(jl), -1).astype(np.int32)[:, None]
    jl, _ = jm.decode_step(jp, {"tokens": jnp.asarray(nxt),
                                "lengths": jnp.asarray(lens)}, jc)
    tl = tp.decode_step({"tokens": torch.as_tensor(nxt).long(),
                         "lengths": torch.as_tensor(lens)}, tc)
    assert_allclose(_f32(tl), _f32(jl), rtol=F32_TOL, atol=F32_TOL)


def test_bf16_embedding_equals_reference_bitwise():
    jm, jp, tp = _pair("qwen3-1.7b", dtype="bfloat16")
    toks = np.arange(3, 40, dtype=np.int32)[None]
    want = jmodel._embed(jm.cfg, jp, jnp.asarray(toks))
    got = tp._embed(torch.as_tensor(toks).long())
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  _np(want).view(np.int16))
    # The scale rounded to bfloat16 (45.25) is not sqrt(128) (45.2548...):
    # multiplying by the float would round other products differently.
    unrounded = tp.embed[torch.as_tensor(toks).long()] * 128 ** 0.5
    assert not torch.equal(unrounded, got)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _requests(mod, vocab):
    rng = np.random.default_rng(0)
    return [mod.Request(i, rng.integers(3, vocab, size=5 + i)
                        .astype(np.int32), max_tokens=4) for i in range(5)]


def test_engine_emits_reference_tokens():
    jm, jp, tp = _pair("qwen3-1.7b")
    outs = []
    for mod, args in ((jengine, (jm, jp)), (tengine, (tp,))):
        eng = mod.ServeEngine(*args, mod.EngineConfig(n_slots=2, cache_len=64,
                                                      eos=-1))
        reqs = _requests(mod, tp.cfg.vocab)
        for r in reqs:
            eng.submit(r)
        ticks = eng.run()
        assert all(r.done for r in reqs)
        assert all(len(r.out_tokens) == 4 for r in reqs)
        outs.append(([r.out_tokens for r in reqs], ticks))
    assert outs[0] == outs[1]
    stats = eng.stats
    assert stats["prefill_tokens"] == sum(5 + i for i in range(5))
    assert stats["decode_tokens"] == 5 * 3
    assert all(r.t_first is not None for r in reqs)


def test_engine_greedy_matches_prefill_extension():
    """The engine's token 2 is the greedy next token after re-prefilling
    with (prompt + token 1), and the decode step's logits for it agree
    with the re-prefill's: the KV-cache path is consistent."""
    cfg = treg.get_config("tinyllama-1.1b").reduced(n_layers=2)
    model = LM(cfg, "cpu", torch.Generator().manual_seed(1))
    eng = tengine.ServeEngine(model, tengine.EngineConfig(
        n_slots=1, cache_len=64, eos=-1))
    prompt = np.arange(3, 11, dtype=np.int32)
    req = tengine.Request(0, prompt, max_tokens=3)
    eng.submit(req)
    eng.run()
    t1, t2 = req.out_tokens[0], req.out_tokens[1]
    ext = torch.as_tensor(np.concatenate([prompt, [t1]])[None]).long()
    logits, _ = model.prefill({"tokens": ext}, 64)
    assert int(logits[0].argmax()) == t2
    _, caches = model.prefill({"tokens": ext[:, :-1]}, 64)
    dec = model.decode_step({
        "tokens": ext[:, -1:], "lengths": torch.tensor([len(prompt)],
                                                       dtype=torch.int32)},
        caches)
    assert_allclose(dec.numpy(), logits.numpy(), rtol=1e-5, atol=1e-5)


def test_serve_launcher_smoke_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--requests", "3", "--max-tokens", "4"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[serve] 3 requests, 12 tokens" in proc.stdout
    assert "all done: True" in proc.stdout
