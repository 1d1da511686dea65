"""The three dense archs that serve and train on the card from slice 23 --
llava-next-34b (the VLM stub's patch prefix), qwen2.5-3b (QKV biases)
and tinyllama-1.1b -- against the reference, on the CPU.

Each config is ``reduced(n_layers=2)`` with the arch's query heads a KV
head kept (llava 14 on 2, seven a KV head; qwen2.5 and tinyllama 16 on 2,
eight), so that the models group their heads as the full ones do.  The
parameters are the reference's from key 0, with qwen2.5's QKV biases
replaced by normals from a numpy seed (the reference initialises them to
zero, which would leave their add unseen), carried across by
``interop.lm_params_from_jax``.

- The port's ``ServeEngine`` emits the reference engine's tokens for each
  arch in float32 (text-only requests: neither engine takes
  ``patch_embeds``).
- llava in bfloat16: ``prefill`` with 16 patch rows in front of a
  57-token prompt (73 rows, no multiple of 64), then three
  ``decode_step``s at ragged lengths that count the prefix, logits and
  caches within the bfloat16 tolerance of ``tests/test_torch_lm.py``
  (3e-2: the frameworks round bfloat16 intermediates at other places).
- One AdamW step of each arch (llava with ``patch_embeds``) through
  ``train.step.build_train_step`` against the reference's, with
  ``tests/test_torch_train.py``'s limits: the loss to ``LOSS_TOL``; the
  gradient norm and the first moments (0.1 times the clipped gradient)
  to ``GRAD_TOL`` (the gradients agree to that share of their largest
  entry); the learning rate to ``OPT_TOL``; and the next batch's loss on
  the new parameters to ``LOSS_TOL``.  The parameters are not compared
  entry by entry: AdamW's first step moves each by about lr g / (|g| +
  eps), so an entry whose gradient lies within the gradients' limit of
  0 moves by an amount that the limit does not bound (a few entries of
  qwen2.5's ``lm_head`` move 1.3e-3 lr apart).
- ``LM.prefill`` holds one copy of the caches: under
  ``launch.op_cost.OpCost`` its peak of live storage above the parameters
  stays below 1.5 times the stacked caches (four layers write theirs
  into the stack one by one: 1.25 times and the activations; stacking
  them all at the end held two copies).

The reference's model calls run under ``jax.jit``, each (arch, dtype)
pair is built once for the module.
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
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs import registry as treg
from repro_torch.interop import lm_params_from_jax
from repro_torch.launch.op_cost import OpCost
from repro_torch.models.model import LM
from repro_torch.serve import engine as tengine
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ("qwen2.5-3b", "tinyllama-1.1b", "llava-next-34b")
# Query heads on 2 KV heads: each arch's heads a KV head.
HEADS = {"qwen2.5-3b": 16, "tinyllama-1.1b": 16, "llava-next-34b": 14}
# tests/test_torch_lm.py's and tests/test_torch_train.py's limits.
BF16_TOL = 3e-2
LOSS_TOL = 2e-6
GRAD_TOL = 2e-5
OPT_TOL = 2e-6
BIAS_STD = 0.5


def _np(a):
    """A reference array as numpy, bfloat16 viewed as uint16."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _over(arch, dtype, n_layers=2):
    return dict(n_layers=n_layers, n_heads=HEADS[arch], n_kv_heads=2,
                dtype=dtype)


def _with_biases(jp):
    """The reference's parameters with every ``bq``, ``bk`` and ``bv``
    drawn from a numpy seed (normals times ``BIAS_STD``)."""
    rng = np.random.default_rng(7)

    def draw(path, x):
        if path[-1].key in ("bq", "bk", "bv"):
            return jnp.asarray(BIAS_STD * rng.standard_normal(
                x.shape, dtype=np.float32), x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(draw, jp)


@functools.lru_cache(maxsize=None)
def _ref(arch, dtype):
    """The reference's model (prefill and decode step jitted) and its
    key-0 parameters."""
    jcfg = jreg.get_config(arch).reduced(**_over(arch, dtype))
    jm = jmodel.build_model(jcfg)
    jm = dataclasses.replace(
        jm, prefill=jax.jit(jm.prefill, static_argnums=2),
        decode_step=jax.jit(jm.decode_step))
    return jm, _with_biases(jax.jit(jm.init)(jax.random.PRNGKey(0)))


def _port(arch, dtype):
    """A fresh port model holding the reference's parameters."""
    _, jp = _ref(arch, dtype)
    tm = LM(treg.get_config(arch).reduced(**_over(arch, dtype)), "cpu")
    tm.load_state_dict(lm_params_from_jax(jax.tree.map(_np, jp)))
    return tm


def test_reduced_configs_keep_the_heads_a_kv_head():
    for arch in ARCHS:
        full = treg.get_config(arch)
        small = _port(arch, "float32").cfg
        assert (small.n_heads // small.n_kv_heads
                == full.n_heads // full.n_kv_heads)
    assert treg.get_config("qwen2.5-3b").qkv_bias
    bq = _port("qwen2.5-3b", "float32").groups[0][1].attn.bq
    assert float(bq.abs().max()) > 0.1


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_emits_reference_tokens(arch):
    jm, jp = _ref(arch, "float32")
    tm = _port(arch, "float32")
    outs = []
    for mod, args in ((jengine, (jm, jp)), (tengine, (tm,))):
        eng = mod.ServeEngine(*args, mod.EngineConfig(n_slots=2, cache_len=64,
                                                      eos=-1))
        rng = np.random.default_rng(0)
        reqs = [mod.Request(i, rng.integers(3, tm.cfg.vocab, size=5 + i)
                            .astype(np.int32), max_tokens=4)
                for i in range(4)]
        for r in reqs:
            eng.submit(r)
        ticks = eng.run()
        assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
        outs.append(([r.out_tokens for r in reqs], ticks))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# The patch prefix in bfloat16
# ---------------------------------------------------------------------------

def test_vlm_bf16_patch_prefix_prefill_and_decode_match_reference():
    arch = "llava-next-34b"
    jm, jp = _ref(arch, "bfloat16")
    tm = _port(arch, "bfloat16")
    cfg = tm.cfg
    assert cfg.frontend == "patch" and cfg.n_heads // cfg.n_kv_heads == 7
    rng = np.random.default_rng(6)
    P = 57
    toks = rng.integers(3, cfg.vocab, size=(2, P)).astype(np.int32)
    pe = rng.standard_normal((2, cfg.n_frontend_tokens, cfg.d_model),
                             dtype=np.float32)
    S = cfg.n_frontend_tokens + P
    assert S % 64
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "patch_embeds": jnp.asarray(pe)}, 96)
    tl, tc = tm.prefill({"tokens": torch.as_tensor(toks).long(),
                         "patch_embeds": torch.from_numpy(pe)}, 96)
    assert_allclose(_f32(tl), _f32(jl), rtol=BF16_TOL, atol=BF16_TOL)
    for key in ("k", "v"):
        assert tc[0][key].dtype == torch.bfloat16
        assert_allclose(_f32(tc[0][key]), _f32(jc[0][key]), rtol=BF16_TOL,
                        atol=BF16_TOL)
    # Ragged: row 1 decodes from position S - 3, over its prefill.
    lens = np.array([S, S - 3], np.int32)
    nxt = np.argmax(_f32(jl), -1).astype(np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(nxt[:, None]),
                                     "lengths": jnp.asarray(lens)}, jc)
        tl = tm.decode_step({"tokens": torch.as_tensor(nxt[:, None]).long(),
                             "lengths": torch.as_tensor(lens)}, tc)
        assert_allclose(_f32(tl), _f32(jl), rtol=BF16_TOL, atol=BF16_TOL)
        nxt = np.argmax(_f32(jl), -1).astype(np.int32)
        lens = lens + 1
    assert_allclose(_f32(tc[0]["k"]), _f32(jc[0]["k"]), rtol=BF16_TOL,
                    atol=BF16_TOL)


# ---------------------------------------------------------------------------
# One AdamW step
# ---------------------------------------------------------------------------

def _batch(cfg, seed, B=2, S=24):
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


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_reference(arch):
    jm, jp = _ref(arch, "float32")
    tm = _port(arch, "float32")
    ocfg = dict(lr=3e-3, warmup_steps=1, total_steps=4)
    jcfg, tcfg = jopt.OptConfig(**ocfg), topt.OptConfig(**ocfg)
    jtrain = jax.jit(jstep.build_train_step(jm, jcfg))
    jstate = {"params": jp, "opt": jopt.adamw_init(jcfg, jp)}
    state = tstep.init_state(tm, tcfg)
    train = tstep.build_train_step(tm, tcfg)
    batch = _batch(tm.cfg, 0)
    jstate, jmet = jtrain(jstate, batch)
    state, met = train(state, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=LOSS_TOL)
    assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                    rtol=GRAD_TOL)
    assert_allclose(float(met["lr"]), float(jmet["lr"]), rtol=OPT_TOL)
    want = lm_params_from_jax(jax.tree.map(_np, jstate["opt"]["m"]))
    assert set(want) == set(state["opt"]["m"]) == set(state["params"])
    for name, m in state["opt"]["m"].items():
        w = want[name].numpy()
        assert_allclose(m.numpy(), w, rtol=0,
                        atol=GRAD_TOL * float(np.abs(w).max()),
                        err_msg=name)
    nxt = _batch(tm.cfg, 1)
    (jloss, _), _ = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jstate["params"], nxt)
    with torch.no_grad():
        loss, _ = tm.loss_fn({k: torch.from_numpy(v)
                              for k, v in nxt.items()})
    assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL)


# ---------------------------------------------------------------------------
# The prefill's memory
# ---------------------------------------------------------------------------

def test_prefill_holds_one_copy_of_the_caches():
    """Eight rows at 1024 cache positions through four layers: the
    prefill's peak of live storage (``OpCost``, above the parameters and
    the batch) against the bytes of the caches it returns."""
    cfg = treg.get_config("llava-next-34b").reduced(
        **_over("llava-next-34b", "float32", n_layers=4))
    model = LM(cfg, "cpu", torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.as_tensor(rng.integers(
        3, cfg.vocab, size=(8, 12))).long(),
        "patch_embeds": torch.from_numpy(rng.standard_normal(
            (8, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32))}
    with OpCost() as oc:
        oc.arguments((dict(model.named_parameters()), batch))
        logits, caches = model.prefill(batch, 1024)
    cache_bytes = sum(t.numel() * t.element_size() for c in caches
                      for t in c.values())
    assert cache_bytes == 4 * 2 * 8 * 1024 * 2 * 32 * 4
    assert oc.peak < 1.5 * cache_bytes, (oc.peak, cache_bytes)
    # The same caches as one stack of the layers' prefills.
    x, pos, _ = model._prep_inputs(batch)
    with torch.no_grad():
        for i, layer in enumerate(model.groups[0]):
            x, c = layer.prefill(x, pos, 1024, None, None)
            for key in ("k", "v"):
                assert torch.equal(caches[0][key][i], c[key])
    assert logits.shape == (8, cfg.vocab_padded)
