"""The port's encoder-decoder family (seamless-m4t-medium) against the
reference's, on the CPU.

The reference's parameters reach the port through ``interop``; the inputs
are numpy arrays from a seed; float32 throughout, to 2e-4 (the frameworks
sum in float32 in other orders; seen: about 1e-6), bfloat16 where named to
3e-2 (one or two bfloat16 ulps).

- Cross-attention: ``xattn`` (decoder queries over a memory of another
  length, with and without query chunks), ``xattn_kv`` and
  ``xattn_decode`` (ragged ``mem_len``, 0 included) against
  ``repro.models.layers``.
- The encoder (``LM._encode``: bidirectional ``attn`` layers, then
  ``enc_norm``) against ``repro.models.model._encode``.
- The model: prefill logits and caches (self and cross) and three decode
  steps with ragged ``lengths`` and ``mem_len`` against the reference's
  model, in float32 and bfloat16; the reference's prefill/decode
  consistency property (``tests/test_models.py``); ``loss_fn`` and every
  gradient at ``tests/test_torch_train.py``'s LOSS_TOL / GRAD_TOL
  (2e-6 / 2e-5 of the largest entry), with and without remat.
- ``interop``: ``enc_groups`` and ``enc_norm`` carried across bit for bit
  (bfloat16), and an 8-bit AdamW state of the encoder's stacked leaves;
  ``train.optimizer.stacks`` lays the encoder's layers over one leaf.
- ``init_cache(B, cache_len, mem_len)`` shapes equal to the reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import registry as jreg
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.train import optimizer as jopt
from repro_torch.configs import registry as treg
from repro_torch.interop import adamw_state_from_jax, lm_params_from_jax
from repro_torch.models import layers as tlayers
from repro_torch.models.model import LM
from repro_torch.train import optimizer as topt

from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "seamless-m4t-medium"
F32_TOL = 2e-4
BF16_TOL = 3e-2
LOSS_TOL = 2e-6
GRAD_TOL = 2e-5


def _np(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _pair(over=()):
    """The reference's seamless model (reduced, 2 decoder and 2 encoder
    layers) with its jitted callables and key-0 parameters, and the port's
    model with the same parameters."""
    over = {"n_layers": 2, **dict(over)}
    jcfg = jreg.get_config(ARCH).reduced(**over)
    cfg = treg.get_config(ARCH).reduced(**over)
    jm = jmodel.build_model(jcfg)
    jm = dataclasses.replace(
        jm, prefill=jax.jit(jm.prefill, static_argnums=2),
        decode_step=jax.jit(jm.decode_step))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = LM(cfg, "cpu")
    tm.load_state_dict(lm_params_from_jax(jax.tree.map(_np, jp)))
    return jm, jp, tm


def _src(cfg, B, Se, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, Se, cfg.d_model), dtype=np.float32)


# ---------------------------------------------------------------------------
# Cross-attention and the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,Sm,q_chunk", [(12, 20, 0), (20, 7, 0),
                                          (20, 13, 8)])
def test_xattn_matches_reference(S, Sm, q_chunk):
    cfg = treg.get_config(ARCH).reduced(q_chunk=q_chunk)
    jcfg = jreg.get_config(ARCH).reduced(q_chunk=q_chunk)
    jp = jlayers.xattn_init(jax.random.PRNGKey(3), jcfg)
    tp = tlayers.CrossAttention(cfg, "cpu")
    tp.load_state_dict(lm_params_from_jax(jax.tree.map(_np, jp)))
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model), dtype=np.float32)
    mem = rng.standard_normal((2, Sm, cfg.d_model), dtype=np.float32)
    want = jax.jit(lambda p, x, m: jlayers.xattn(p, x, m, jcfg))(jp, x, mem)
    kv = jlayers.xattn_kv(jp, jnp.asarray(mem), jcfg)
    with torch.no_grad():
        got = tlayers.xattn(tp, _t(x), _t(mem), cfg)
        tkv = tlayers.xattn_kv(tp, _t(mem), cfg)
    assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                    atol=F32_TOL)
    for key in ("k", "v"):
        assert tkv[key].shape == kv[key].shape == (2, Sm, cfg.n_kv_heads,
                                                   cfg.hd)
        assert_allclose(tkv[key].numpy(), np.asarray(kv[key]), rtol=F32_TOL,
                        atol=F32_TOL)
    # One decode token per row over the first mem_len memory positions.
    x1 = rng.standard_normal((3, 1, cfg.d_model), dtype=np.float32)
    mem3 = rng.standard_normal((3, Sm, cfg.d_model), dtype=np.float32)
    mem_len = np.array([Sm, Sm // 2, 1], np.int32)
    kv3 = jlayers.xattn_kv(jp, jnp.asarray(mem3), jcfg)
    want = jlayers.xattn_decode(jp, jnp.asarray(x1), kv3, jcfg,
                                jnp.asarray(mem_len))
    with torch.no_grad():
        got = tlayers.xattn_decode(tp, _t(x1), tlayers.xattn_kv(
            tp, _t(mem3), cfg), cfg, _t(mem_len))
    assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                    atol=F32_TOL)


def test_encoder_matches_reference():
    jm, jp, tm = _pair()
    src = _src(tm.cfg, 2, 17, seed=1)
    want = jax.jit(lambda p, s: jmodel._encode(jm.cfg, p, s))(jp, src)
    with torch.no_grad():
        got = tm._encode(_t(src))
    assert got.shape == (2, 17, tm.cfg.d_model)
    assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                    atol=F32_TOL)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_prefill_and_ragged_decode_match_reference(dtype, tol):
    jm, jp, tm = _pair((("dtype", dtype),))
    rng = np.random.default_rng(2)
    B, S, Se = 3, 10, 14
    toks = rng.integers(3, tm.cfg.vocab, size=(B, S)).astype(np.int32)
    src = jnp.asarray(_src(tm.cfg, B, Se, seed=2)).astype(dtype)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks), "src_embeds": src},
                        24)
    tl, tc = tm.prefill({"tokens": _t(toks).long(),
                         "src_embeds": lm_params_from_jax(
                             {"x": _np(src)})["x"]}, 24)
    assert_allclose(_f32(tl), _f32(jl), rtol=tol, atol=tol)
    for part in ("self", "cross"):
        for key in ("k", "v"):
            assert tc[0][part][key].shape == jc[0][part][key].shape
            assert_allclose(_f32(tc[0][part][key]), _f32(jc[0][part][key]),
                            rtol=tol, atol=tol, err_msg=f"{part} {key}")
    # Ragged rows: lengths below the prefill and mem_len below the memory
    # (0 included: a row that attends no memory position).
    lens = np.array([10, 7, 4], np.int32)
    mem_len = np.array([14, 9, 0], np.int32)
    nxt = np.argmax(_f32(jl), -1).astype(np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(nxt[:, None]),
                                     "lengths": jnp.asarray(lens),
                                     "mem_len": jnp.asarray(mem_len)}, jc)
        tl = tm.decode_step({"tokens": _t(nxt[:, None]).long(),
                             "lengths": _t(lens), "mem_len": _t(mem_len)},
                            tc)
        assert_allclose(_f32(tl), _f32(jl), rtol=tol, atol=tol)
        nxt = np.argmax(_f32(jl), -1).astype(np.int32)
        lens = lens + 1
    assert_allclose(_f32(tc[0]["self"]["v"]), _f32(jc[0]["self"]["v"]),
                    rtol=tol, atol=tol)


def test_prefill_decode_consistency():
    """``tests/test_models.py::test_arch_prefill_decode_consistency`` on
    the port: a prefill of S tokens and one decode step (mem_len = the
    memory's length) give the full forward's logits at S + 1."""
    _, _, tm = _pair()
    rng = np.random.default_rng(1)
    B, S = 2, 24
    toks = _t(rng.integers(3, tm.cfg.vocab, size=(B, S + 1))).long()
    src = _t(rng.standard_normal((B, S + 1, tm.cfg.d_model)).astype(
        np.float32))
    with torch.no_grad():
        _, caches = tm.prefill({"tokens": toks[:, :S], "src_embeds": src},
                               S + 8)
        dec = tm.decode_step({"tokens": toks[:, S:], "lengths": torch.full(
            (B,), S, dtype=torch.int32), "mem_len": torch.full(
            (B,), S + 1, dtype=torch.int32)}, caches)
        full, _ = tm.prefill({"tokens": toks, "src_embeds": src}, S + 8)
    assert_allclose(dec.numpy(), full.numpy(), rtol=1e-4, atol=1e-4)
    assert (dec.argmax(-1) == full.argmax(-1)).all()


def _batch(cfg, B=2, S=20, Se=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1, np.int32)],
                            axis=1)
    labels[rng.random((B, S)) < 0.2] = -1
    return {"tokens": tokens, "labels": labels,
            "src_embeds": _src(cfg, B, Se, seed)}


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_reference(remat):
    jm, jp, tm = _pair()
    batch = _batch(tm.cfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(jp, batch)
    tm.cfg = dataclasses.replace(tm.cfg, remat=remat)
    tm.requires_grad_(True)
    try:
        loss, metrics = tm.loss_fn({k: _t(v) for k, v in batch.items()})
        params = dict(tm.named_parameters())
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
    finally:
        tm.requires_grad_(False)
        tm.cfg = dataclasses.replace(tm.cfg, remat=True)
    assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_TOL)
    for key in ("ce", "aux", "ntok"):
        assert_allclose(float(metrics[key].detach()), float(jmet[key]),
                        rtol=LOSS_TOL, err_msg=key)
    want = lm_params_from_jax(jax.tree.map(_np, jgrads))
    assert set(want) == set(grads)
    assert any(n.startswith("enc_groups.") for n in grads)
    for name, g in grads.items():
        w = want[name].numpy()
        assert float(np.abs(w).max()) > 0, name
        assert_allclose(g.numpy(), w, rtol=0,
                        atol=GRAD_TOL * np.abs(w).max(), err_msg=name)


def test_init_cache_matches_reference():
    jm, jp, tm = _pair()
    want = jax.eval_shape(lambda: jm.init_cache(3, 40, mem_len=17))
    got = tm.init_cache(3, 40, mem_len=17)
    assert len(got) == len(want) == 1
    for part in ("self", "cross"):
        for key in ("k", "v"):
            assert tuple(got[0][part][key].shape) == want[0][part][key].shape
            assert not got[0][part][key].any()


# ---------------------------------------------------------------------------
# interop and the optimizer's stacked leaves
# ---------------------------------------------------------------------------

def test_enc_groups_carried_across_bitwise():
    _, jp, _ = _pair((("dtype", "bfloat16"),))
    jp = jax.tree.map(_np, jp)
    sd = lm_params_from_jax(jp)
    cfg = treg.get_config(ARCH).reduced(n_layers=2, dtype="bfloat16")
    tm = LM(cfg, "cpu")
    assert set(tm.state_dict()) == set(sd)
    tm.load_state_dict(sd)
    assert all(torch.equal(tm.state_dict()[k], t) for k, t in sd.items())

    def raw(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    np.testing.assert_array_equal(raw(sd["enc_norm"]), jp["enc_norm"])
    for i in range(cfg.n_enc_layers):
        for part, leaf in (("attn", "wq"), ("attn", "norm"), ("mlp", "w2")):
            t = sd[f"enc_groups.0.{i}.{part}.{leaf}"]
            assert t.dtype == (torch.float32 if leaf == "norm"
                               else torch.bfloat16)
            np.testing.assert_array_equal(
                raw(t), jp["enc_groups"][0][part][leaf][i])
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(raw(sd[f"groups.0.{i}.xattn.wk"]),
                                      jp["groups"][0]["xattn"]["wk"][i])


def test_encoder_adamw_state_carried_across():
    jm, jp, tm = _pair()
    names = [n for n, _ in tm.named_parameters()]
    leaves = topt.stacks(names)
    enc = [ns for ns in leaves if ns[0].startswith("enc_groups.")]
    # One stacked leaf a path, the encoder's layers in order.
    assert ["enc_groups.0.0.attn.wq", "enc_groups.0.1.attn.wq"] in enc
    assert len(leaves) == len(jax.tree.leaves(jp))
    jcfg = jopt.OptConfig(state_int8=True, compress_int8=True)
    rng = np.random.default_rng(5)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.int8:
            return rng.integers(-127, 128, x.shape).astype(np.int8)
        return rng.standard_normal(x.shape).astype(x.dtype)

    jstate = jax.tree.map(fill, jopt.adamw_init(jcfg, jp))
    carried = adamw_state_from_jax(jstate)
    fresh = topt.adamw_init(topt.OptConfig(state_int8=True,
                                           compress_int8=True),
                            dict(tm.named_parameters()))
    for key in ("m", "v", "err"):
        assert set(carried[key]) == set(fresh[key])
        for name, t in fresh[key].items():
            assert type(carried[key][name]) is type(t), name
    # The encoder's stacked norms have two axes there: 8-bit, as the port's
    # own state keeps them; enc_norm has one: float32.
    got = carried["v"]["enc_groups.0.1.attn.norm"]
    src = jstate["v"]["enc_groups"][0]["attn"]["norm"]
    np.testing.assert_array_equal(got["q"].numpy(), src["q"][1])
    np.testing.assert_array_equal(got["s"].numpy(), src["s"][1])
    assert carried["m"]["enc_norm"].dtype == torch.float32
