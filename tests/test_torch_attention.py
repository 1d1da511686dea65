"""The port's plain attention against the reference's Pallas kernels and
oracles, on the CPU.

Every case of ``repro_torch.testing.attention_cases`` and
``decode_cases`` (the ``tests/test_kernels.py`` cases, plus ragged
lengths 0 and 1, windows, soft-caps and head dims 64 to 256):
``ref.attention_ref`` / ``ref.decode_attention_ref`` of the port against
``repro.kernels.ref``'s oracles, in float32 and in bfloat16.  In float32
the ``tests/test_kernels.py`` cases and one ragged case per kernel (head
dim 128 over 130 positions for flash, lengths 0, 1, 17 and 40 for decode)
are also held against ``repro.kernels.ops.flash_attention(...,
impl="pallas")`` / ``decode_attention(..., impl="pallas")`` in interpret
mode.  ``tests/test_kernels.py`` holds the Pallas kernels to the oracles
in both dtypes; interpret mode costs 1 to 2 s a call here, so the other
cases meet the Pallas kernels only through the oracles.  The oracles run
under ``jax.jit`` (eagerly they compile op by op, about 1 s a shape).
The inputs are numpy standard normals from a seed; bfloat16 inputs are
the same float32 values rounded to nearest even on both sides.
Tolerances are the reference's own kernel tests': 2e-5 (flash, float32),
3e-5 (decode, float32) and 2e-2 (both, bfloat16: one bfloat16 rounding of
outputs below 4 is at most 1.6e-2).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import testing
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

from _torch_threads import one_torch_thread  # noqa: F401

ATTN = testing.attention_cases()
DECODE = testing.decode_cases()
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DECODE_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
# The cases also held against the Pallas kernels in interpret mode.
FLASH_PALLAS = list(ATTN)[:6] + [
    "B=2 Sq=130 Sk=130 Hq=4 Hkv=2 d=128 causal=True"]
DECODE_PALLAS = list(DECODE)[:3] + [
    "S=40 Hq=8 Hkv=2 d=32 lengths=[0, 1, 17, 40]"]


def _jit(fn, **kw):
    return jax.jit(functools.partial(fn, **kw))


def _jax(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _torch(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _flash(name, dtype, pallas):
    q, k, v, kw = ATTN[name]()
    got = tref.attention_ref(*(_torch(x, dtype) for x in (q, k, v)), **kw)
    jq, jk, jv = (_jax(x, dtype) for x in (q, k, v))
    want = [_jit(jref.attention_ref, **kw)(jq, jk, jv)]
    if pallas and name in FLASH_PALLAS:
        # With pos_offset the reference's ops take its oracle, not Pallas.
        want.append(jops.flash_attention(jq, jk, jv, impl="pallas", **kw))
    tol = FLASH_TOL[dtype]
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == q.shape
    for w in want:
        assert_allclose(_f32(got), _f32(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(ATTN))
def test_plain_flash_matches_pallas_and_oracle(name):
    _flash(name, "float32", pallas=True)


@pytest.mark.parametrize("name", list(ATTN))
def test_plain_flash_bf16_matches_oracle(name):
    _flash(name, "bfloat16", pallas=False)


def _decode(name, dtype, pallas):
    q, kc, vc, lens, kw = DECODE[name]()
    got = tref.decode_attention_ref(
        *(_torch(x, dtype) for x in (q, kc, vc)), torch.from_numpy(lens),
        **kw)
    jq, jk, jv = (_jax(x, dtype) for x in (q, kc, vc))
    jl = jnp.asarray(lens)
    want = [_jit(jref.decode_attention_ref, **kw)(jq, jk, jv, jl)]
    if pallas and name in DECODE_PALLAS:
        want.append(jops.decode_attention(jq, jk, jv, jl, impl="pallas",
                                          **kw))
    tol = DECODE_TOL[dtype]
    assert got.dtype == getattr(torch, dtype)
    for w in want:
        assert_allclose(_f32(got), _f32(w), rtol=tol, atol=tol)
    # A row of length 0 sees nothing and gives zeros.
    for b in np.flatnonzero(lens == 0):
        assert not got[b].any()


@pytest.mark.parametrize("name", list(DECODE))
def test_plain_decode_matches_pallas_and_oracle(name):
    _decode(name, "float32", pallas=True)


@pytest.mark.parametrize("name", list(DECODE))
def test_plain_decode_bf16_matches_oracle(name):
    _decode(name, "bfloat16", pallas=False)


def test_rows_that_see_nothing_give_zeros():
    # More queries than keys, end-aligned: the first Sq - Sk rows come
    # before key 0.
    q, k, v, kw = ATTN["B=1 Sq=40 Sk=24 Hq=2 Hkv=1 d=32 causal=True"]()
    got = tref.attention_ref(*map(torch.from_numpy, (q, k, v)), **kw)
    assert not got[:, :16].any()
    assert got[:, 16:].abs().amax() > 0


def test_cpu_tensors_take_the_plain_versions():
    q, k, v, kw = ATTN["B=2 Sq=24 Sk=24 Hq=4 Hkv=2 d=32 causal=True"]()
    flash0, decode0 = tfa.launches, tda.launches
    calls0 = dict(tref.calls)
    out = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    assert torch.equal(out, tref.attention_ref(
        *map(torch.from_numpy, (q, k, v)), **kw))
    q, kc, vc, lens, kw = DECODE[list(DECODE)[3]]()
    out = ops.decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                               torch.from_numpy(lens), **kw)
    assert torch.equal(out, tref.decode_attention_ref(
        *map(torch.from_numpy, (q, kc, vc)), torch.from_numpy(lens), **kw))
    assert (tfa.launches, tda.launches) == (flash0, decode0)
    for name in ("attention_ref", "decode_attention_ref"):
        assert tref.calls[name] == calls0.get(name, 0) + 2


def test_flash_takes_strided_queries():
    # The model's query chunks are views with the full sequence's strides.
    q, k, v, kw = ATTN["B=1 Sq=16 Sk=100 Hq=4 Hkv=2 d=32 causal=True "
                       "pos_offset=40"]()
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    full = torch.cat([torch.zeros_like(qt), qt], 2)[:, :, 4:]
    assert not full.is_contiguous()
    assert torch.equal(ops.flash_attention(full, kt, vt, **kw),
                       ops.flash_attention(qt, kt, vt, **kw))


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "mixed", "groups",
                                 "last_axis", "softcap"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    kw = {}
    if bad == "head_dim":
        q, k = torch.zeros(1, 8, 4, 48), torch.zeros(1, 8, 2, 48)
    elif bad == "dtype":
        q, k = q.half(), k.half()
    elif bad == "mixed":
        q = q.to(torch.bfloat16)
    elif bad == "groups":
        k = torch.zeros(1, 8, 3, 32)
    elif bad == "last_axis":
        q = torch.zeros(1, 8, 32, 4).transpose(2, 3)
    else:
        kw = {"softcap": 0.0}
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, k, **kw)
    with pytest.raises((ValueError, TypeError)):
        ops.decode_attention(q[:, 0], k, k, torch.ones(1, dtype=torch.int32),
                             **kw)
