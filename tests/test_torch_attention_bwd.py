"""The gradient of the port's flash attention against the reference's, on
the CPU.

On every case of ``repro_torch.testing.attention_cases`` (causal,
bidirectional, GQA, a window, a soft-cap, an explicit ``pos_offset``,
more queries than keys so that some rows see no key), in float32:

- ``ref.attention_bwd_ref`` (the backward kernel's order of operations,
  from the forward's output and log-sum-exp) and the autograd Function
  (``ops.flash_attention`` on operands that require a gradient) against
  ``jax.vjp`` of ``repro.kernels.ref.attention_ref``, to rtol = atol =
  2e-5 (seen: about 4e-6; both sum in float32 in other orders, and the
  port forms ``D = rowsum(dO o O)`` where autodiff sums ``P dP``);
- ``ref.attention_ref(..., return_lse=True)``'s log-sum-exp against the
  reference's logits' ``jax.nn.logsumexp``, to 2e-6, -inf in the same
  places (the rows that see no key), and its output equal bit for bit to
  the output without the lse;
- a row that sees no key gets a zero gradient.

The rounding of the bfloat16 backward kernel: its plain model
``testing.attention_bwd_rounded`` (P and dS rounded once to bfloat16
before their products, float32 sums) on bfloat16 operands against
``ref.attention_bwd_ref``, within ``chip_smoke.py``'s ``BWD_LIMIT`` at
reduced shapes of the training runs' heads (smollm-360m's 3 query heads
a KV head of 64, qwen3-1.7b's 2 of 128; causal, one with a soft-cap), and
within the bfloat16 cases' 2e-2 on every case above.  So the kernel
needs no bf16 hi + lo split of P or dS (the forward's device for P V).

Also the guard of the kernels without a backward: ``build.needs_grad``
is the condition under which their wrappers refuse CUDA operands (here on
CPU tensors, whose plain versions autograd differentiates).  The
reference's calls run under ``jax.jit``, cached by case.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels import ref as jref
from repro_torch import testing
from repro_torch.kernels import build, ops
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_attention_bwd as tfb
from repro_torch.kernels import ref as tref

from _torch_threads import one_torch_thread  # noqa: F401

CASES = testing.attention_cases()
TOL = 2e-5
LSE_TOL = 2e-6
# chip_smoke.py's BWD_LIMIT: |kernel - plain| <= 2^-8 max|plain| +
# 2^-6 |plain| (the training shapes), and its bfloat16 BWD_TOL (the cases).
BWD_RTOL, BWD_ATOL_SHARE = 2.0 ** -6, 2.0 ** -8
BF16_TOL = 2e-2
# Reduced heads of the training runs (bfloat16, causal).
ROUNDING_CASES = {
    "smollm-360m heads B=1 S=256 Hq=3 Hkv=1 d=64":
        (dict(B=1, Sq=256, Sk=256, Hq=3, Hkv=1, d=64), {}),
    "smollm-360m heads B=1 S=256 Hq=3 Hkv=1 d=64 softcap=30.0":
        (dict(B=1, Sq=256, Sk=256, Hq=3, Hkv=1, d=64), dict(softcap=30.0)),
    "qwen3-1.7b heads B=1 S=256 Hq=2 Hkv=1 d=128":
        (dict(B=1, Sq=256, Sk=256, Hq=2, Hkv=1, d=128), {}),
}


def _kw(kw):
    return tuple(sorted(kw.items()))


@functools.lru_cache(maxsize=None)
def _jax_vjp(kw):
    f = functools.partial(jref.attention_ref, **dict(kw))

    @jax.jit
    def vjp(q, k, v, g):
        return jax.vjp(f, q, k, v)[1](g)
    return vjp


@functools.lru_cache(maxsize=None)
def _jax_lse(kw, Sq, Sk):
    """The reference's masked logits (``repro.kernels.ref.attention_ref``'s
    formula) and their log-sum-exp, [B, Hq, Sq]."""
    kw = dict(kw)

    @jax.jit
    def lse(q, k):
        B, _, Hq, d = q.shape
        Hkv = k.shape[2]
        g = Hq // Hkv
        qh = q.reshape(B, Sq, Hkv, g, d)
        logits = jnp.einsum("bqhgd,bkhd->bhgqk", qh, k) * d ** -0.5
        if kw.get("softcap") is not None:
            logits = kw["softcap"] * jnp.tanh(logits / kw["softcap"])
        off = kw.get("pos_offset")
        qpos = jnp.arange(Sq) + (Sk - Sq if off is None else off)
        kpos = jnp.arange(Sk)
        mask = jnp.ones((Sq, Sk), bool)
        if kw.get("causal", True):
            mask &= kpos[None] <= qpos[:, None]
        if kw.get("window") is not None:
            mask &= kpos[None] > qpos[:, None] - kw["window"]
        logits = jnp.where(mask, logits, -jnp.inf)
        return jax.nn.logsumexp(logits, axis=-1).reshape(B, Hq, Sq)
    return lse


def _case(name):
    q, k, v, kw = CASES[name]()
    g = np.random.default_rng(7).standard_normal(q.shape, dtype=np.float32)
    return q, k, v, g, kw


def _want(q, k, v, g, kw):
    return [np.asarray(x) for x in _jax_vjp(_kw(kw))(q, k, v, g)]


@pytest.mark.parametrize("name", list(CASES))
def test_attention_bwd_ref_matches_jax_vjp(name):
    q, k, v, g, kw = _case(name)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = tref.attention_ref(tq, tk, tv, return_lse=True, **kw)
    got = tref.attention_bwd_ref(tq, tk, tv, o, tg, lse, **kw)
    for a, b, what in zip(got, _want(q, k, v, g, kw), ("dq", "dk", "dv")):
        assert a.dtype == torch.float32
        assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_autograd_function_matches_jax_vjp(name):
    q, k, v, g, kw = _case(name)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = (tfa.launches, tfb.launches)
    tref.calls.clear()
    out = ops.flash_attention(tq, tk, tv, **kw)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    # The CPU path is the plain forward and the plain backward, once each.
    assert dict(tref.calls) == {"attention_ref": 1, "attention_bwd_ref": 1}
    assert (tfa.launches, tfb.launches) == before
    for a, b, what in zip(got, _want(q, k, v, g, kw), ("dq", "dk", "dv")):
        assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL, err_msg=what)
    # The output is the plain forward's, bit for bit.
    plain = tref.attention_ref(*(x.detach() for x in (tq, tk, tv)), **kw)
    assert torch.equal(out.detach(), plain)


@pytest.mark.parametrize("name", list(CASES))
def test_lse_matches_reference_logsumexp(name):
    q, k, v, _, kw = _case(name)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = tref.attention_ref(tq, tk, tv, return_lse=True, **kw)
    assert torch.equal(out, tref.attention_ref(tq, tk, tv, **kw))
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    want = np.asarray(_jax_lse(_kw(kw), q.shape[1], k.shape[1])(q, k))
    got = lse.numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert_allclose(got[fin], want[fin], rtol=LSE_TOL, atol=LSE_TOL)


def test_rows_that_see_no_key_get_zero_gradients():
    name = next(n for n in CASES if "Sq=40 Sk=24" in n)
    q, k, v, g, kw = _case(name)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, **kw)
    dq, _, _ = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    # End-aligned, queries 0..15 sit at positions -16..-1: no key.
    blind = q.shape[1] - k.shape[1]
    assert torch.equal(out[:, :blind].detach(),
                       torch.zeros_like(out[:, :blind]))
    assert torch.equal(dq[:, :blind], torch.zeros_like(dq[:, :blind]))
    _, lse = tref.attention_ref(*(x.detach() for x in (tq, tk, tv)),
                                return_lse=True, **kw)
    assert bool(torch.isneginf(lse[:, :, :blind]).all())
    assert bool(torch.isfinite(lse[:, :, blind:]).all())


def test_bwd_wrapper_checks_its_operands():
    q, k, v, g, kw = _case(next(iter(CASES)))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = tref.attention_ref(tq, tk, tv, return_lse=True, **kw)
    with pytest.raises(ValueError, match="lse"):
        tfb.flash_attention_bwd(tq, tk, tv, o, tg, lse[:, :1], **kw)
    with pytest.raises(ValueError, match="dout"):
        tfb.flash_attention_bwd(tq, tk, tv, o, tg[:, :1], lse, **kw)
    # A strided gradient is taken (made contiguous in its last axis).
    gt = tg.transpose(1, 2).contiguous().transpose(1, 2)
    a = tfb.flash_attention_bwd(tq, tk, tv, o, gt, lse, **kw)
    b = tfb.flash_attention_bwd(tq, tk, tv, o, tg, lse, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _bf16_inputs(q, k, v, kw, seed):
    """bfloat16 operands, the plain forward's output and lse, and a
    seeded bfloat16 output gradient (as chip_smoke.py's parity phase)."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o, lse = tref.attention_ref(q, k, v, return_lse=True, **kw)
    g = np.random.default_rng(seed).standard_normal(q.shape,
                                                    dtype=np.float32)
    return q, k, v, o, torch.from_numpy(g).to(torch.bfloat16), lse


@pytest.mark.parametrize("name", list(ROUNDING_CASES))
def test_bf16_rounding_model_within_bwd_limit(name):
    shape, kw = ROUNDING_CASES[name]
    args = _bf16_inputs(*testing.attention_operands(**shape, seed=11), kw,
                        seed=12)
    got = testing.attention_bwd_rounded(*args, **kw)
    want = tref.attention_bwd_ref(*args, **kw)
    moved = False
    for a, b, what in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        a, b = a.float(), b.float()
        limit = BWD_ATOL_SHARE * b.abs().max() + BWD_RTOL * b.abs()
        share = float(((a - b).abs() / limit).max())
        assert share <= 1.0, f"{what}: {share:.3f} of BWD_LIMIT"
        moved |= not torch.equal(a, b)
    assert moved       # the model rounds where the plain version does not


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_rounding_model_within_case_tolerance(name):
    q, k, v, _, kw = _case(name)
    args = _bf16_inputs(q, k, v, kw, seed=7)
    got = testing.attention_bwd_rounded(*args, **kw)
    want = tref.attention_bwd_ref(*args, **kw)
    for a, b, what in zip(got, want, ("dq", "dk", "dv")):
        assert_allclose(a.float().numpy(), b.float().numpy(), rtol=BF16_TOL,
                        atol=BF16_TOL, err_msg=what)


def test_grad_guard_condition():
    x = torch.zeros(2)
    w = torch.zeros(2, requires_grad=True)
    assert not build.needs_grad(x, None)
    assert build.needs_grad(x, w)
    with torch.no_grad():
        assert not build.needs_grad(x, w)
        build.refuse_grad("k", x, w)
    assert not build.needs_grad(w.detach())
    with pytest.raises(RuntimeError, match="no backward kernel"):
        build.refuse_grad("decode_attention", x, w)
    build.refuse_grad("decode_attention", x)


def test_plain_decode_keeps_its_gradient_on_the_cpu():
    """The guard applies to the card's raw-pointer launches only: on CPU
    tensors the plain versions run under autograd."""
    *arrays, lens, kw = next(iter(testing.decode_cases().values()))()
    q, kc, vc = (torch.from_numpy(a).requires_grad_() for a in arrays)
    out = tda.decode_attention(q, kc, vc, torch.from_numpy(lens), **kw)
    (dq,) = torch.autograd.grad(out.sum(), (q,))
    assert out.grad_fn is not None and bool(dq.abs().sum() > 0)
