"""The port's LM training (``LM.loss_fn``, ``train.optimizer``,
``train.step``) against the reference's, on the CPU.

Both models hold the same parameters (``interop.lm_params_from_jax``) and
both optimizers the same state (``interop.adamw_state_from_jax``); the
inputs are numpy arrays from a seed.

- ``loss_fn`` and the gradient of every parameter against
  ``jax.value_and_grad`` of the reference's ``loss_fn``, float32, for
  reduced (2-layer) smollm-360m, qwen3-1.7b (qk_norm), qwen2.5-3b
  (qkv_bias), llava-next-34b (the patch prefix) and falcon-mamba-7b (the
  selective scan's gradient), and 3-layer recurrentgemma-9b (one rec, rec,
  attention block: the RG-LRU scan's gradient, and S = 40 past its
  32-token window), with labels of -1 masked: loss and metrics to rtol
  2e-6, each gradient to 2e-5 of its largest entry (seen: about 1e-6;
  both sum in float32 in other orders).
- ``adamw_update``: two updates from the same state on the same gradients,
  plain, with ``compress_int8`` and with ``state_int8``, float32 and
  bfloat16 parameters, against the reference's update run op by op (under
  ``jit`` XLA turns its divisions by constants into multiplies, which
  moves the int8 scales by an ulp and the error feedback, a small
  residual, by much more of itself): parameters, moments, error feedback,
  ``lr`` and ``grad_norm`` to rtol 2e-6 (the global norm sums the
  reference's stacked leaves in another order, and the two libraries'
  ``pow`` may differ in the last bit); the 8-bit codes equal but for at
  most one code step in a few places where a moment one ulp apart crosses
  a rounding boundary; bfloat16 parameters within one bfloat16 ulp.
- ``lr_at`` bit for bit against the reference run op by op (its cosine
  schedule within one float32 ulp of the peak rate: the two libraries'
  cos differ in the last bit at some steps, and 1 + cos cancels near the
  schedule's end); ``quantize_int8``, ``_q8`` and ``_dq8`` bit for bit.
- Two microbatches against one (float32 accumulation) and against the
  reference's two: loss and gradient norm to rtol 2e-6.
- ``cfg.remat`` on and off: loss and gradients bit for bit.
- Three train steps from one state: the losses match the reference's to
  rtol 2e-6.
- About 30 steps of the port alone: the loss falls.

The reference's calls run under ``jax.jit``; each model pair is built
once for the module.
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
from repro.data import pipeline as jdata
from repro.models import model as jmodel
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs import registry as treg
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.interop import adamw_state_from_jax, lm_params_from_jax
from repro_torch.models.model import LM
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

from _torch_threads import one_torch_thread  # noqa: F401

LOSS_TOL = 2e-6
GRAD_TOL = 2e-5
OPT_TOL = 2e-6
ARCHS = ("smollm-360m", "qwen3-1.7b", "qwen2.5-3b", "llava-next-34b")
# The recurrent families: (overrides of the reduced config, S).
RECURRENT = {"falcon-mamba-7b": ((), 24),
             "recurrentgemma-9b": ((("n_layers", 3),), 40)}


def _np(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@functools.lru_cache(maxsize=None)
def _pair(arch, over=()):
    """The reference's model (``loss_fn`` under ``value_and_grad`` and
    ``jit``) and parameters from key 0, and the port's model with the same
    parameters, unfrozen."""
    over = {"n_layers": 2, **dict(over)}
    jcfg = jreg.get_config(arch).reduced(**over)
    cfg = treg.get_config(arch).reduced(**over)
    jm = jmodel.build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    vg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))
    tm = LM(cfg, "cpu")
    tm.load_state_dict(lm_params_from_jax(jax.tree.map(_np, jp)))
    tm.requires_grad_(True)
    return jm, jp, vg, tm


def _batch(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1, np.int32)],
                            axis=1)
    labels[rng.random((B, S)) < 0.2] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.frontend == "patch":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads(model, batch):
    loss, metrics = model.loss_fn(_torch_batch(batch))
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, metrics, dict(zip(params, grads))


@pytest.mark.parametrize("arch", ARCHS + tuple(RECURRENT))
def test_loss_and_grads_match_reference(arch):
    over, S = RECURRENT.get(arch, ((), 24))
    jm, jp, vg, tm = _pair(arch, over)
    assert tm.cfg.window == 0 or S > tm.cfg.window
    batch = _batch(tm.cfg, S=S)
    (jloss, jmet), jgrads = vg(jp, batch)
    loss, metrics, grads = _grads(tm, batch)
    assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_TOL)
    for key in ("ce", "aux", "ntok"):
        assert_allclose(float(metrics[key].detach()), float(jmet[key]),
                        rtol=LOSS_TOL, err_msg=key)
    want = lm_params_from_jax(jax.tree.map(_np, jgrads))
    assert set(want) == set(grads)
    for name, g in grads.items():
        w = want[name].numpy()
        assert g.dtype == torch.float32, name
        assert_allclose(g.numpy(), w, rtol=0,
                        atol=GRAD_TOL * max(np.abs(w).max(), 1e-30),
                        err_msg=name)


def test_patch_prefix_is_cut_before_the_logits():
    *_, tm = _pair("llava-next-34b")
    batch = _torch_batch(_batch(tm.cfg))
    loss, metrics = tm.loss_fn(batch)
    n = int((batch["labels"] >= 0).sum())
    assert float(metrics["ntok"]) == n
    with torch.no_grad():
        without = tm.loss_fn({k: v for k, v in batch.items()
                              if k != "patch_embeds"})[0]
    assert float(loss.detach()) != float(without)


def test_remat_is_bitwise_neutral():
    *_, tm = _pair("smollm-360m")
    batch = _batch(tm.cfg, seed=3)
    assert tm.cfg.remat
    loss_r, _, g_r = _grads(tm, batch)
    tm.cfg = dataclasses.replace(tm.cfg, remat=False)
    try:
        loss_p, _, g_p = _grads(tm, batch)
    finally:
        tm.cfg = dataclasses.replace(tm.cfg, remat=True)
    assert torch.equal(loss_r, loss_p)
    assert all(torch.equal(g_r[n], g_p[n]) for n in g_r)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _opt_inputs(dtype: str, scale: float, seed: int = 0):
    """Reference parameters of a reduced smollm-360m and two gradient
    trees (numpy normals times ``scale``)."""
    jm, jp, _, _ = _pair("smollm-360m", (("dtype", dtype),))
    rng = np.random.default_rng(seed)
    grads = [jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape, dtype=np.float32) * scale,
        x.dtype), jp) for _ in range(2)]
    return jp, grads


def _opt_cfgs(**kw):
    return jopt.OptConfig(warmup_steps=3, **kw), topt.OptConfig(
        warmup_steps=3, **kw)


def _close_state(got, want, name):
    if isinstance(want, dict):
        q, wq = got["q"].numpy().astype(int), want["q"].numpy().astype(int)
        assert np.abs(q - wq).max() <= 1, name
        assert (q != wq).mean() < 1e-3, name
        assert_allclose(got["s"].numpy(), want["s"].numpy(), rtol=OPT_TOL,
                        err_msg=name)
    else:
        assert_allclose(got.numpy(), want.numpy(), rtol=OPT_TOL,
                        atol=OPT_TOL * float(want.abs().max()), err_msg=name)


@pytest.mark.parametrize("mode", ["plain", "state_int8"])
def test_adamw_update_donated_equals_functional(mode):
    """``donate=True`` gives the functional update's bits and takes every
    gradient and old moment out of its inputs."""
    jp, grads = _opt_inputs("bfloat16", 1e-3)
    _, tcfg = _opt_cfgs(**({} if mode == "plain" else {mode: True}))
    params = lm_params_from_jax(jax.tree.map(_np, jp))
    g = lm_params_from_jax(jax.tree.map(_np, grads[0]))
    state = topt.adamw_init(tcfg, params)
    want = topt.adamw_update(tcfg, g, state, params)
    got = topt.adamw_update(tcfg, dict(g), {**state, "m": dict(state["m"]),
                                            "v": dict(state["v"])},
                            params, donate=True)
    for a, b in zip(jax.tree.leaves(got[:2]), jax.tree.leaves(want[:2])):
        assert torch.equal(a, b)
    donated_g = dict(g)
    donated = {**state, "m": dict(state["m"]), "v": dict(state["v"])}
    topt.adamw_update(tcfg, donated_g, donated, params, donate=True)
    assert donated_g == {} and donated["m"] == {} and donated["v"] == {}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["plain", "compress_int8", "state_int8"])
def test_adamw_update_matches_reference(mode, dtype):
    # Gradients small enough that the global norm stays under clip_norm:
    # both clip by exactly 1, so the int8 compression sees equal inputs.
    jp, grads = _opt_inputs(dtype, 1e-3)
    kw = {} if mode == "plain" else {mode: True}
    jcfg, tcfg = _opt_cfgs(**kw)
    jstate = jopt.adamw_init(jcfg, jp)
    tparams = lm_params_from_jax(jax.tree.map(_np, jp))
    tstate = topt.adamw_init(tcfg, tparams)
    carried = adamw_state_from_jax(jax.tree.map(_np, jstate))
    assert set(carried) == set(tstate)
    upd = functools.partial(jopt.adamw_update, jcfg)       # op by op
    for g in grads:
        jp, jstate, jmet = upd(g, jstate, jp)
        tg = lm_params_from_jax(jax.tree.map(_np, g))
        tparams, tstate, tmet = topt.adamw_update(tcfg, tg, tstate, tparams)
    assert float(jmet["grad_norm"]) < 1.0
    assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=OPT_TOL)
    assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                    rtol=OPT_TOL)
    want_p = lm_params_from_jax(jax.tree.map(_np, jp))
    for name, p in tparams.items():
        w = want_p[name]
        assert p.dtype == w.dtype, name
        if p.dtype == torch.bfloat16:
            ulp = 2.0 ** -7 * w.float().abs()
            assert bool(((p.float() - w.float()).abs() <= ulp).all()), name
        else:
            assert_allclose(p.numpy(), w.numpy(), rtol=OPT_TOL,
                            atol=OPT_TOL * float(w.abs().max()),
                            err_msg=name)
    want_s = adamw_state_from_jax(jax.tree.map(_np, jstate))
    assert int(tstate["step"]) == int(want_s["step"]) == 2
    for key in ("m", "v", "err"):
        assert (key in tstate) == (key in want_s)
        for name in want_s.get(key, {}):
            _close_state(tstate[key][name], want_s[key][name],
                         f"{key} {name}")


def test_lr_at_matches_reference():
    steps = np.arange(0, 130, dtype=np.int32)
    for sched in ("cosine", "linear", "const"):
        kw = dict(warmup_steps=7, total_steps=100, schedule=sched, lr=3e-3)
        jcfg, tcfg = jopt.OptConfig(**kw), topt.OptConfig(**kw)
        want = np.array([np.asarray(jopt.lr_at(jcfg, jnp.int32(s)))
                         for s in steps])
        got = np.array([topt.lr_at(tcfg, torch.tensor(s)).numpy()
                        for s in steps])
        if sched == "cosine":
            assert_allclose(got, want, rtol=0, atol=2.0 ** -23 * tcfg.lr)
        else:
            np.testing.assert_array_equal(got, want)


def test_int8_quantizers_are_bitwise():
    x = np.random.default_rng(1).standard_normal((37, 300)).astype(
        np.float32)
    x[3] = 0.0                                   # a zero block / row
    for block in (256, 64):
        qj, sj = jopt.quantize_int8(x, block)
        qt, st = topt.quantize_int8(torch.from_numpy(x), block)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(
            topt.dequantize_int8(qt, st, x.shape, block).numpy(),
            np.asarray(jopt.dequantize_int8(qj, sj, x.shape, block)))
    j8, t8 = jopt._q8(x), topt._q8(torch.from_numpy(x))
    np.testing.assert_array_equal(t8["q"].numpy(), np.asarray(j8["q"]))
    np.testing.assert_array_equal(t8["s"].numpy(), np.asarray(j8["s"]))
    np.testing.assert_array_equal(topt._dq8(t8).numpy(),
                                  np.asarray(jopt._dq8(j8)))


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _fresh(arch="smollm-360m", **over):
    """A port model with the reference's key-0 parameters, and them."""
    jm, jp, _, tm = _pair(arch)
    model = LM(tm.cfg if not over else dataclasses.replace(tm.cfg, **over),
               "cpu")
    model.load_state_dict(lm_params_from_jax(jax.tree.map(_np, jp)))
    return jm, jp, model


def _stream_batches(cfg, n, B=4, S=32):
    stream = jdata.TokenStream(jdata.DataConfig(vocab=cfg.vocab, seq_len=S,
                                                global_batch=B))
    return [stream.batch_at(i) for i in range(n)]


def test_three_steps_match_reference():
    jm, jp, model = _fresh()
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=3)
    jcfg, tcfg = jopt.OptConfig(**ocfg), topt.OptConfig(**ocfg)
    jtrain = jax.jit(jstep.build_train_step(jm, jcfg))
    jstate = {"params": jp, "opt": jopt.adamw_init(jcfg, jp)}
    state = tstep.init_state(model, tcfg)
    train = tstep.build_train_step(model, tcfg)
    for batch in _stream_batches(model.cfg, 3):
        jstate, jmet = jtrain(jstate, batch)
        state, met = train(state, _torch_batch(batch))
        assert_allclose(float(met["loss"]), float(jmet["loss"]),
                        rtol=LOSS_TOL)
        assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                        rtol=1e-5)
    assert int(state["opt"]["step"]) == 3
    assert state["params"]["embed"] is model.embed


def test_microbatches_match_one_batch_and_reference():
    jm, jp, model = _fresh()
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=3)
    jcfg, tcfg = jopt.OptConfig(**ocfg), topt.OptConfig(**ocfg)
    batch = _stream_batches(model.cfg, 1)[0]
    jtrain2 = jax.jit(jstep.build_train_step(jm, jcfg, microbatches=2))
    _, jmet2 = jtrain2({"params": jp, "opt": jopt.adamw_init(jcfg, jp)},
                       batch)
    met = {}
    for mb in (1, 2):
        _, _, m = _fresh()
        step = tstep.build_train_step(m, tcfg, microbatches=mb)
        _, met[mb] = step(tstep.init_state(m, tcfg), _torch_batch(batch))
    assert set(met[2]) == {"loss", "grad_norm", "lr"}
    for key in ("loss", "grad_norm"):
        assert_allclose(float(met[2][key]), float(met[1][key]),
                        rtol=LOSS_TOL, err_msg=key)
        assert_allclose(float(met[2][key]), float(jmet2[key]),
                        rtol=LOSS_TOL, err_msg=key)
    _, _, m = _fresh()
    step = tstep.build_train_step(m, tcfg, microbatches=2,
                                  accum_dtype="bfloat16")
    _, met_bf = step(tstep.init_state(m, tcfg), _torch_batch(batch))
    assert_allclose(float(met_bf["loss"]), float(met[1]["loss"]), rtol=1e-5)


def test_loss_falls_over_thirty_steps():
    cfg = treg.get_config("smollm-360m").reduced(n_layers=2)
    model = LM(cfg, "cpu", torch.Generator().manual_seed(0))
    tcfg = topt.OptConfig(lr=3e-3, warmup_steps=5, total_steps=30)
    state = tstep.init_state(model, tcfg)
    train = tstep.build_train_step(model, tcfg)
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=64,
                                    global_batch=8), device="cpu")
    losses = []
    for i in range(30):
        state, met = train(state, stream.batch_at(i))
        losses.append(float(met["loss"]))
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses
