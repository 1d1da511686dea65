"""Decode at the long_500k cell's positions, the port against the
reference, on the CPU.

The long_500k cell decodes a bounded-state model (falcon-mamba-7b,
recurrentgemma-9b: ``eligible_shapes``) at position 524 287.  A prefill of
that length is out of a CPU test's reach, so the decode starts from caches
drawn from a numpy seed in the reference's layout (``init_cache`` at
``cache_len`` 524 288) and carried across bit for bit
(``interop.lm_cache_from_jax``): recurrentgemma-9b reduced to one "rra"
super-block (3 layers) with a 16-position window (its local attention's
cache a 16-slot ring) and its real head_dim 256, so that the RoPE table is
recurrentgemma-9b's own; falcon-mamba-7b reduced to 2 layers.  Two rows at
lengths 524 287 and 524 280, four ``decode_step``s against the
reference's, each step's logits and the caches after them, in float32 at
``F32_TOL`` and in bfloat16 at ``BF16_TOL``
(``tests/test_torch_lm.py``'s).  recurrentgemma's float32 case failed
before the RoPE table was built as the reference's (``layers.rope_freq``):
one ulp in five of its 128 frequencies turns into an angle error that
grows with the position.
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
from repro_torch.configs import registry as treg
from repro_torch.interop import lm_cache_from_jax, lm_params_from_jax
from repro_torch.models.model import LM

from _torch_threads import one_torch_thread  # noqa: F401

F32_TOL = 2e-4
BF16_TOL = 3e-2
CACHE_LEN = 524_288
LENGTHS = (524_287, 524_280)
STEPS = 4
OVER = {"recurrentgemma-9b": dict(n_layers=3, pattern="rra", window=16,
                                  head_dim=256),
        "falcon-mamba-7b": dict(n_layers=2)}
CASES = [(arch, dtype) for arch in OVER
         for dtype in ("float32", "bfloat16")]


def _np(a):
    """A reference array as numpy, bfloat16 viewed as uint16."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _built(arch: str, dtype: str):
    """The reference's model (its decode step jitted) and parameters from
    key 0, and the port's model with them loaded, on the CPU."""
    over = dict(OVER[arch], dtype=dtype)
    jcfg = jreg.get_config(arch).reduced(**over)
    cfg = treg.get_config(arch).reduced(**over)
    jm = jmodel.build_model(jcfg)
    jm = dataclasses.replace(jm, decode_step=jax.jit(jm.decode_step))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = LM(cfg, "cpu")
    tp.load_state_dict(lm_params_from_jax(jax.tree.map(_np, jp)))
    return jm, jp, tp


def _seeded_caches(jm, seed: int):
    """The reference's caches for two rows at ``CACHE_LEN``, every leaf
    drawn from a numpy seed (normals of scale 0.5 in the leaf's dtype)."""
    rng = np.random.default_rng(seed)
    empty = jm.init_cache(len(LENGTHS), CACHE_LEN)
    return jax.tree.map(lambda t: jnp.asarray(
        0.5 * rng.standard_normal(t.shape, dtype=np.float32)).astype(
            t.dtype), empty)


def _assert_caches(tc, jc, tol):
    flat = jax.tree_util.tree_flatten_with_path(jc)[0]
    for path, leaf in flat:
        t = tc
        for p in path:
            t = t[p.idx if isinstance(p, jax.tree_util.SequenceKey)
                  else p.key]
        assert tuple(t.shape) == leaf.shape, path
        assert_allclose(_f32(t), _f32(leaf), rtol=tol, atol=tol,
                        err_msg=str(path))


@pytest.mark.parametrize("arch,dtype", CASES)
def test_decode_at_long_positions_matches_the_reference(arch, dtype):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jm, jp, tp = _built(arch, dtype)
    jc = _seeded_caches(jm, 3)
    tc = lm_cache_from_jax(jax.tree.map(_np, jc))
    _assert_caches(tc, jc, 0.0)
    if arch == "recurrentgemma-9b":
        # The local attention's cache is a ring of the window's slots.
        assert tc[0]["s2"]["k"].shape[2] == OVER[arch]["window"]
    rng = np.random.default_rng(4)
    nxt = rng.integers(3, tp.cfg.vocab, size=len(LENGTHS)).astype(np.int32)
    lens = np.array(LENGTHS, np.int32)
    for _ in range(STEPS):
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(nxt[:, None]),
                                     "lengths": jnp.asarray(lens)}, jc)
        tl = tp.decode_step({"tokens": torch.as_tensor(nxt[:, None]).long(),
                             "lengths": torch.as_tensor(lens)}, tc)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
        assert np.isfinite(_f32(tl)).all()
        assert_allclose(_f32(tl), _f32(jl), rtol=tol, atol=tol)
        nxt = np.argmax(_f32(jl), -1).astype(np.int32)
        lens = lens + 1
    _assert_caches(tc, jc, tol)

