"""The port's MoE block and MoE models against the reference's, on the CPU.

The reference's parameters reach the port through ``interop`` and the
inputs are numpy arrays from a seed.

- ``tests/test_moe_layers.py``'s cases on the port: with ample capacity
  the capacity-sort dispatch equals the explicit top-k mixture of expert
  MLPs (rtol = atol = 2e-4), a tiny capacity factor drops tokens and the
  output stays finite (a dropped token passes through), and decode's
  capacity is 1; ``capacity`` equal to the reference's ``_capacity``.
- ``moe_mlp`` against ``repro.models.moe.moe_mlp`` for reduced grok-1 and
  moonshot, and moonshot with 16 experts and top 6 (so that the combine
  adds six terms), float32 and bfloat16: the chosen experts first (equal,
  so that a routing flip shows as one), then the output to 2e-4 (float32)
  or 3e-2 (bfloat16: the two frameworks round silu and the products'
  bfloat16 results at other places, a bfloat16 ulp or two), and the aux
  loss to rtol 1e-6 (the reference adds 1 / (B S K) once per assignment,
  the port multiplies a count by it: one rounding against many).
- The dispatch (slot table, tokens, validity) equal to the reference's
  steps, and the combine bit for bit against the reference's scatter-add
  on the same bfloat16 expert outputs with K = 6.
- Tied router probabilities (a zero router, and pairs of equal router
  columns): the port chooses the experts ``jax.lax.top_k`` does, the
  lower index first.
- The MoE models: prefill and ragged decode against the reference's model
  (float32, 2e-4), the prefill/decode consistency property (the
  reference's ``test_arch_prefill_decode_consistency``, dropless), and
  ``loss_fn`` with every gradient at ``tests/test_torch_train.py``'s
  LOSS_TOL / GRAD_TOL for reduced grok-1 and moonshot.
- ``interop``: the expert leaves (bfloat16) and the float32 router carried
  across bit for bit, and AdamW states (float32 and 8-bit) of an MoE model.
- ``launch.train`` and ``launch.serve`` on the MoE archs (reduced, CPU).
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
from repro.models import moe as jmoe
from repro.models.layers import rms_norm as jrms_norm
from repro.train import optimizer as jopt
from repro_torch.configs import registry as treg
from repro_torch.interop import adamw_state_from_jax, lm_params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import moe as tmoe
from repro_torch.models.model import LM
from repro_torch.train import optimizer as topt

from _torch_threads import one_torch_thread  # noqa: F401

F32_TOL = 2e-4
BF16_TOL = 3e-2
AUX_RTOL = 1e-6
LOSS_TOL = 2e-6
GRAD_TOL = 2e-5
MOE_ARCHS = ("grok-1-314b", "moonshot-v1-16b-a3b")


def _np(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _torch(x):
    """A reference array as a torch tensor, bfloat16 bit for bit."""
    return lm_params_from_jax({"x": _np(x)})["x"]


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _block(arch, over=()):
    """The reference's MoE parameters (key 0) and its ``moe_mlp`` under
    ``jit``, and the port's block with the same parameters."""
    jcfg = jreg.get_config(arch).reduced(n_layers=1, **dict(over))
    cfg = treg.get_config(arch).reduced(n_layers=1, **dict(over))
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    tp = tmoe.MoE(cfg, "cpu")
    tp.load_state_dict(lm_params_from_jax(jax.tree.map(_np, jp)))
    return jcfg, cfg, jp, jax.jit(lambda p, x: jmoe.moe_mlp(p, x, jcfg)), tp


def _x(cfg, B, S, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model), dtype=np.float32)
    return jnp.asarray(x).astype(dtype)


def _ref_routing(jp, x, jcfg):
    """The reference's router steps (``moe_mlp``'s first lines)."""
    h = jrms_norm(x, jp["norm"], jcfg.norm_eps)
    probs = jax.nn.softmax(h.astype(jnp.float32) @ jp["router"], axis=-1)
    return h, probs, jax.lax.top_k(probs, jcfg.top_k)


def _ref_dispatch(eidx, E, C):
    """The reference's per-row capacity sort (``moe_mlp``'s dispatch
    lines), returning (tok, valid, assign)."""
    B, S, K = eidx.shape
    flat_e = eidx.reshape(B, S * K)
    sort_idx = jnp.argsort(flat_e, axis=-1)
    counts = jax.vmap(lambda r: jnp.bincount(r, length=E))(flat_e)
    starts = jnp.cumsum(counts, axis=-1) - counts
    slot = starts[:, :, None] + jnp.arange(C)[None, None]
    valid = jnp.arange(C)[None, None] < counts[:, :, None]
    slot_c = jnp.minimum(slot, S * K - 1)
    assign = jnp.take_along_axis(sort_idx, slot_c.reshape(B, E * C),
                                 axis=-1).reshape(B, E, C)
    return assign // K, valid, assign


def _ref_combine(ye, tok, S):
    """The reference's combine: a scatter-add of [E C, D] rows into a
    zeroed [S, D] buffer per row, in ye's dtype."""
    B, E, C, D = ye.shape
    return jax.vmap(lambda ye_row, tok_row: jnp.zeros((S, D), ye.dtype).at[
        tok_row.reshape(-1)].add(ye_row.reshape(E * C, D), mode="drop"))(
            ye, tok)


BLOCK_CASES = {
    "grok f32": ("grok-1-314b", (), "float32", F32_TOL),
    "moonshot f32": ("moonshot-v1-16b-a3b", (), "float32", F32_TOL),
    "moonshot E16 K6 f32": ("moonshot-v1-16b-a3b",
                            (("n_experts", 16), ("top_k", 6)), "float32",
                            F32_TOL),
    "grok bf16": ("grok-1-314b", (("dtype", "bfloat16"),), "bfloat16",
                  BF16_TOL),
    "moonshot E16 K6 bf16": ("moonshot-v1-16b-a3b",
                             (("n_experts", 16), ("top_k", 6),
                              ("dtype", "bfloat16")), "bfloat16", BF16_TOL),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
@pytest.mark.parametrize("S", [1, 24])
def test_moe_mlp_matches_reference(case, S):
    arch, over, dtype, tol = BLOCK_CASES[case]
    jcfg, cfg, jp, jmlp, tp = _block(arch, over)
    x = _x(cfg, 3, S, seed=S, dtype=dtype)
    tx = _torch(x)
    # The chosen experts first: a flip would show here, not as a large
    # numeric error below.
    _, jprobs, (_, jeidx) = _ref_routing(jp, x, jcfg)
    with torch.no_grad():
        h = tmoe.rms_norm(tx, tp.norm, cfg.norm_eps)
        probs, _, eidx = tmoe.route(tp, h, cfg)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(jeidx))
    assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-6, atol=1e-7)
    jy, jaux = jmlp(jp, x)
    with torch.no_grad():
        ty, taux = tmoe.moe_mlp(tp, tx, cfg)
    assert ty.dtype == tx.dtype and taux.dtype == torch.float32
    assert_allclose(_f32(ty), _f32(jy), rtol=tol, atol=tol)
    assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)


def test_dispatch_and_k6_combine_bitwise():
    jcfg, cfg, jp, _, tp = _block("moonshot-v1-16b-a3b", (
        ("n_experts", 16), ("top_k", 6), ("dtype", "bfloat16")))
    B, S, E = 2, 40, cfg.n_experts
    x = _x(cfg, B, S, seed=7, dtype="bfloat16")
    for C in (tmoe.capacity(cfg, S), 4):           # 4: most rows drop
        _, _, (_, jeidx) = _ref_routing(jp, x, jcfg)
        jtok, jvalid, jassign = _ref_dispatch(jeidx, E, C)
        eidx = torch.from_numpy(np.array(jeidx)).long()
        tok, valid, assign, slot = tmoe.dispatch(eidx, E, C)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(assign.numpy(), np.asarray(jassign))
        assert (C == 4) == bool((slot == E * C).any())
        # The same bfloat16 expert outputs, zero in the empty slots as the
        # gates make them, through both combines.
        rng = np.random.default_rng(C)
        ye = rng.standard_normal((B, E, C, cfg.d_model), dtype=np.float32)
        ye = jnp.asarray(ye * np.asarray(jvalid)[..., None]).astype(
            jnp.bfloat16)
        want = _ref_combine(ye, jtok, S)
        got = tmoe.combine(_torch(ye), slot, eidx)
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(), _np(want).view(np.int16))


def test_tied_router_probabilities():
    jcfg, cfg, jp, _, tp = _block("moonshot-v1-16b-a3b", (
        ("n_experts", 16), ("top_k", 6)))
    x = _x(cfg, 2, 12, seed=3, dtype="float32")
    router = np.array(jp["router"])
    for label, r in (("zero", np.zeros_like(router)),
                     ("pairs", router[:, [0, 1, 2, 3, 4, 5, 6, 7] * 2])):
        jq = {**jp, "router": jnp.asarray(r)}
        _, jprobs, (_, jeidx) = _ref_routing(jq, x, jcfg)
        tp.router.data.copy_(torch.from_numpy(r))
        with torch.no_grad():
            h = tmoe.rms_norm(_torch(x), tp.norm, cfg.norm_eps)
            _, _, eidx = tmoe.route(tp, h, cfg)
        np.testing.assert_array_equal(eidx.numpy(), np.asarray(jeidx),
                                      err_msg=label)
        if label == "zero":
            assert (eidx.numpy() == np.arange(6)).all()
        else:
            # Columns e and e + 8 tie: both chosen, the lower index first.
            assert np.asarray(jprobs)[..., 8:].tolist() == np.asarray(
                jprobs)[..., :8].tolist()
    tp.router.data.copy_(torch.from_numpy(router))


def _moe_cfgs(E, K, cf=64.0):
    over = dict(n_experts=E, top_k=K, capacity_factor=cf, d_model=32,
                d_ff=48, n_layers=1)
    return (jreg.get_config("moonshot-v1-16b-a3b").reduced(**over),
            treg.get_config("moonshot-v1-16b-a3b").reduced(**over))


@pytest.mark.parametrize("E,K,seed", [(2, 1, 0), (4, 2, 11), (8, 3, 402),
                                      (5, 3, 77), (8, 1, 999)])
def test_dropless_matches_dense_mixture(E, K, seed):
    """``tests/test_moe_layers.py``'s property on the port: with ample
    capacity the dispatch equals the explicit top-k mixture."""
    _, cfg = _moe_cfgs(E, K)
    p = tmoe.MoE(cfg, "cpu", torch.Generator().manual_seed(seed))
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 8, cfg.d_model), dtype=np.float32))
    with torch.no_grad():
        y, aux = tmoe.moe_mlp(p, x, cfg)
        h = tmoe.rms_norm(x, p.norm, cfg.norm_eps)
        _, gates, eidx = tmoe.route(p, h, cfg)
        hh = (torch.nn.functional.silu(torch.einsum("bsd,edf->bsef", h,
                                                    p.we1))
              * torch.einsum("bsd,edf->bsef", h, p.we3))
        ye = torch.einsum("bsef,efd->bsed", hh, p.we2)
        mix = torch.zeros_like(x)
        for k in range(K):
            sel = torch.gather(ye, 2, eidx[..., k, None, None].expand(
                -1, -1, 1, cfg.d_model))[:, :, 0]
            mix = mix + gates[..., k, None] * sel
    assert_allclose((y - x).numpy(), mix.numpy(), rtol=2e-4, atol=2e-4)
    assert np.isfinite(float(aux))


def test_capacity_drops_tokens_and_matches_reference():
    jcfg, cfg = _moe_cfgs(4, 2, cf=0.01)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    p = tmoe.MoE(cfg, "cpu")
    p.load_state_dict(lm_params_from_jax(jax.tree.map(_np, jp)))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (1, 64, cfg.d_model), jnp.float32))
    C = tmoe.capacity(cfg, 64)
    assert C == 8
    with torch.no_grad():
        y, _ = tmoe.moe_mlp(p, torch.tensor(x), cfg)
        h = tmoe.rms_norm(torch.tensor(x), p.norm, cfg.norm_eps)
        slot = tmoe.dispatch(tmoe.route(p, h, cfg)[2], 4, C)[3]
    assert np.isfinite(y.numpy()).all()
    # 32 slots for 128 assignments: 96 are dropped, and a token whose
    # every assignment is dropped passes through unchanged.
    assert int((slot == 4 * C).sum()) == 96
    dropped = (slot == 4 * C).reshape(64, 2).all(-1).numpy()
    assert dropped.any()
    np.testing.assert_array_equal(y.numpy()[0, dropped], x[0, dropped])
    jy, _ = jmoe.moe_mlp(jp, jnp.asarray(x), jcfg)
    assert_allclose(y.numpy(), np.asarray(jy), rtol=F32_TOL, atol=F32_TOL)


def test_decode_capacity_one():
    jcfg, cfg = _moe_cfgs(8, 2, cf=1.25)
    assert tmoe.capacity(cfg, 1) == 1
    assert tmoe.capacity(cfg, 128) >= 128 * 2 / 8
    for arch in MOE_ARCHS:
        jc, tc = jreg.get_config(arch), treg.get_config(arch)
        for S in (1, 2, 7, 8, 100, 2048, 4096, 4097):
            assert tmoe.capacity(tc, S) == jmoe._capacity(jc, S), (arch, S)


def test_block_pieces_run_under_profiler_ranges():
    """Each piece of the block opens its ``RANGES`` entry, so that a
    profile attributes its time."""
    _, cfg, _, _, tp = _block("moonshot-v1-16b-a3b")
    x = torch.as_tensor(_x(cfg, 2, 16, 0, "float32"))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tp(x, cfg)
    seen = {e.key: e.count for e in prof.key_averages()}
    assert {name: seen.get(name) for name in tmoe.RANGES} == dict.fromkeys(
        tmoe.RANGES, 1)


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model_pair(arch, over=()):
    over = {"n_layers": 2, **dict(over)}
    jcfg = jreg.get_config(arch).reduced(**over)
    cfg = treg.get_config(arch).reduced(**over)
    jm = jmodel.build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = LM(cfg, "cpu")
    tm.load_state_dict(lm_params_from_jax(jax.tree.map(_np, jp)))
    return jm, jp, tm


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_ragged_decode_match_reference(arch):
    jm, jp, tm = _model_pair(arch)
    jprefill = jax.jit(jm.prefill, static_argnums=2)
    jdecode = jax.jit(jm.decode_step)
    toks = np.random.default_rng(0).integers(
        3, tm.cfg.vocab, size=(2, 12)).astype(np.int32)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc = tm.prefill({"tokens": torch.as_tensor(toks).long()}, 32)
    assert_allclose(_f32(tl), _f32(jl), rtol=F32_TOL, atol=F32_TOL)
    assert_allclose(_f32(tc[0]["k"]), _f32(jc[0]["k"]), rtol=F32_TOL,
                    atol=F32_TOL)
    lens = np.array([12, 9], np.int32)
    nxt = np.argmax(_f32(jl), -1).astype(np.int32)
    for _ in range(3):
        jl, jc = jdecode(jp, {"tokens": jnp.asarray(nxt[:, None]),
                              "lengths": jnp.asarray(lens)}, jc)
        tl = tm.decode_step({"tokens": torch.as_tensor(nxt[:, None]).long(),
                             "lengths": torch.as_tensor(lens)}, tc)
        assert_allclose(_f32(tl), _f32(jl), rtol=F32_TOL, atol=F32_TOL)
        nxt = np.argmax(_f32(jl), -1).astype(np.int32)
        lens = lens + 1


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_decode_consistency(arch):
    """The reference's consistency property (dropless, as its test runs
    MoE): the decode step's logits after a prefill of S tokens equal the
    full forward's at S + 1."""
    _, _, tm = _model_pair(arch, (("capacity_factor", 64.0),))
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(3, tm.cfg.vocab, size=(2, 25)))
    with torch.no_grad():
        full, _ = tm.prefill({"tokens": toks}, 40)
        _, caches = tm.prefill({"tokens": toks[:, :-1]}, 40)
        dec = tm.decode_step({"tokens": toks[:, -1:], "lengths": torch.full(
            (2,), 24, dtype=torch.int32)}, caches)
    assert_allclose(dec.numpy(), full.numpy(), rtol=1e-4, atol=1e-4)
    assert (dec.argmax(-1) == full.argmax(-1)).all()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_capacity_factor_argument(arch):
    """``LM.prefill``'s ``capacity_factor`` acts as the config's would: at
    0.25 (capacity 8 of a 64-token prompt's 128 assignments over 8
    experts, so experts drop tokens) the logits and caches equal, bit for
    bit, those of a model whose config holds 0.25, and differ from a
    dropless prefill's."""
    cfg = treg.get_config(arch).reduced(n_layers=2)
    tm = LM(cfg, "cpu", torch.Generator().manual_seed(0))
    low = LM(dataclasses.replace(cfg, capacity_factor=0.25), "cpu")
    low.load_state_dict(tm.state_dict())
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        3, cfg.vocab, size=(2, 64)))
    got, got_c = tm.prefill({"tokens": toks}, 80, capacity_factor=0.25)
    want, want_c = low.prefill({"tokens": toks}, 80)
    assert torch.equal(got, want)
    for a, b in zip(jax.tree.leaves(got_c), jax.tree.leaves(want_c)):
        assert torch.equal(a, b)
    dropless, _ = tm.prefill({"tokens": toks}, 80,
                             capacity_factor=cfg.n_experts / cfg.top_k)
    assert not torch.equal(got, dropless)


def _batch(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1, np.int32)],
                            axis=1)
    labels[rng.random((B, S)) < 0.2] = -1
    return {"tokens": tokens, "labels": labels}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_grads_match_reference(arch):
    jm, jp, tm = _model_pair(arch)
    batch = _batch(tm.cfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(jp, batch)
    tm.requires_grad_(True)
    try:
        loss, metrics = tm.loss_fn({k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        params = dict(tm.named_parameters())
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
    finally:
        tm.requires_grad_(False)
    assert float(metrics["aux"].detach()) > 0
    assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_TOL)
    assert_allclose(float(metrics["ce"].detach()), float(jmet["ce"]),
                    rtol=LOSS_TOL)
    assert_allclose(float(metrics["aux"].detach()), float(jmet["aux"]),
                    rtol=AUX_RTOL)
    assert float(metrics["ntok"]) == float(jmet["ntok"])
    want = lm_params_from_jax(jax.tree.map(_np, jgrads))
    assert set(want) == set(grads)
    for name, g in grads.items():
        w = want[name].numpy()
        assert_allclose(g.numpy(), w, rtol=0,
                        atol=GRAD_TOL * max(np.abs(w).max(), 1e-30),
                        err_msg=name)


# ---------------------------------------------------------------------------
# interop and the launchers
# ---------------------------------------------------------------------------

def test_expert_leaves_carried_across_bitwise():
    jm, jp, _ = _model_pair("moonshot-v1-16b-a3b", (("dtype", "bfloat16"),))
    jp = jax.tree.map(_np, jp)
    sd = lm_params_from_jax(jp)
    moe = jp["groups"][0]["moe"]
    assert sd["groups.0.1.moe.router"].dtype == torch.float32
    assert sd["groups.0.1.moe.norm"].dtype == torch.float32
    for leaf in ("we1", "we3", "we2", "router"):
        t = sd[f"groups.0.1.moe.{leaf}"]
        raw = (t.view(torch.int16).numpy().view(np.uint16)
               if t.dtype == torch.bfloat16 else t.numpy())
        assert t.dtype == (torch.float32 if leaf == "router"
                           else torch.bfloat16)
        np.testing.assert_array_equal(raw, moe[leaf][1])
    cfg = treg.get_config("moonshot-v1-16b-a3b").reduced(n_layers=2,
                                                          dtype="bfloat16")
    tm = LM(cfg, "cpu")
    tm.load_state_dict(sd)
    assert set(tm.state_dict()) == set(sd)
    assert all(torch.equal(tm.state_dict()[k], t) for k, t in sd.items())


def test_adamw_state_of_an_moe_model_carried_across():
    """The reference's AdamW state of an MoE model with int8 compression
    and 8-bit moments, its codes and scales random, carried across: the
    port's keys, forms and dtypes (``topt.adamw_init``'s), layer i of each
    stacked leaf bit for bit."""
    jm, jp, tm = _model_pair("grok-1-314b")
    jcfg = jopt.OptConfig(state_int8=True, compress_int8=True)
    rng = np.random.default_rng(4)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.int8:
            return rng.integers(-127, 128, x.shape).astype(np.int8)
        return rng.standard_normal(x.shape).astype(x.dtype)

    jstate = jax.tree.map(fill, jopt.adamw_init(jcfg, jp))
    jstate["step"] = np.int32(3)
    carried = adamw_state_from_jax(jstate)
    fresh = topt.adamw_init(topt.OptConfig(state_int8=True,
                                           compress_int8=True),
                            dict(tm.named_parameters()))
    assert int(carried["step"]) == 3
    for key in ("m", "v", "err"):
        assert set(carried[key]) == set(fresh[key])
        for name, t in fresh[key].items():
            got = carried[key][name]
            assert type(got) is type(t), name
            for a, b in ((got, t),) if not isinstance(t, dict) else (
                    (got["q"], t["q"]), (got["s"], t["s"])):
                assert a.shape == b.shape and a.dtype == b.dtype, name
    # The experts' [E, D, F] leaves and the router are 8-bit (so is a
    # layer's norm: stacked, it has two axes), the final norm and the error
    # feedback float32; layer 1 is row 1 of the stacked leaf.
    moe_m = jstate["m"]["groups"][0]["moe"]
    for leaf in ("we1", "we3", "we2", "router"):
        got = carried["m"][f"groups.0.1.moe.{leaf}"]
        np.testing.assert_array_equal(got["q"].numpy(), moe_m[leaf]["q"][1])
        np.testing.assert_array_equal(got["s"].numpy(), moe_m[leaf]["s"][1])
    assert carried["v"]["final_norm"].dtype == torch.float32
    np.testing.assert_array_equal(
        carried["err"]["groups.0.1.moe.we2"].numpy(),
        jstate["err"]["groups"][0]["moe"]["we2"][1])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launchers_run_the_moe_archs(arch, tmp_path, capsys):
    logs = []
    _, ls = launch_train.main(
        ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)],
        log=logs.append)
    assert ls.step == 2 and any("[train] done" in line for line in logs)
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "2", "--max-tokens", "3"])
    out = capsys.readouterr().out
    assert "[serve] 2 requests, 6 tokens" in out and "all done: True" in out
