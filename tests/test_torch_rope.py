"""The port's RoPE against the reference's, at the long positions.

- The frequency table ``theta ** (-i / half)`` of each of the ten archs'
  (half, theta) equals the reference's bit for bit
  (``repro.models.layers.rope`` builds it in float32 under XLA; the port
  takes the power in float64 and rounds once, ``layers.rope_freq``).
  torch's float32 ``pow`` differed in 2 to 33 entries an arch.
- ``rope`` at positions 4 095, 32 767 and 524 287 (the long_500k cell
  decodes at the last) against ``repro.models.layers.rope`` at
  ``F32_TOL``: an entry of the table one ulp off turns into an error of
  the angle that grows with the position (1.35e-2 in ``cos`` at 524 287
  with recurrentgemma-9b's head_dim 256).
- The table is built once a (half, theta, device), and at each call
  under a dispatch mode (the dry run's counts), where it is not kept.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from torch._subclasses.fake_tensor import FakeTensorMode, is_fake

from repro.configs import registry as jreg
from repro.models import layers as jlayers
from repro_torch.configs import registry as treg
from repro_torch.models import layers as tlayers

from _torch_threads import one_torch_thread  # noqa: F401

F32_TOL = 2e-4
POSITIONS = (4095, 32767, 524287)
ARCHS = sorted(jreg.ARCHS)


def _half_theta(arch):
    cfg = treg.get_config(arch)
    return cfg.hd // 2, cfg.rope_theta


@pytest.mark.parametrize("arch", ARCHS)
def test_table_equals_the_reference_s(arch):
    half, theta = _half_theta(arch)
    # The expression of ``repro.models.layers.rope``, compiled as the
    # reference's model compiles it.
    want = np.asarray(jax.jit(lambda: theta ** (
        -jnp.arange(0, half, dtype=jnp.float32) / half))())
    got = tlayers.rope_freq(half, theta, "cpu").numpy()
    assert got.dtype == np.float32 and got.shape == (half,)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
        f"{int((got != want).sum())} of {half} entries differ"


@pytest.mark.parametrize("arch", ARCHS)
def test_rope_at_long_positions_matches_the_reference(arch):
    cfg = treg.get_config(arch)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, len(POSITIONS), 2, cfg.hd)).astype(np.float32)
    pos = np.array([POSITIONS, POSITIONS[::-1]], dtype=np.int32)
    want = np.asarray(jax.jit(jlayers.rope, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(pos), cfg.rope_theta))
    got = tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                       cfg.rope_theta).numpy()
    assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_table_is_built_once_a_key():
    half, theta = _half_theta("recurrentgemma-9b")
    first = tlayers.rope_freq(half, theta, "cpu")
    assert tlayers.rope_freq(half, theta, torch.device("cpu")) is first
    assert tlayers.rope_freq(half, 2 * theta, "cpu") is not first
    # Under a mode that watches the ops (the dry run counts under one)
    # it is built at each call and not kept.
    with FakeTensorMode():
        fake = tlayers.rope_freq(half, theta, "cpu")
        assert is_fake(fake)
        assert tlayers.rope_freq(half, theta, "cpu") is not fake
    assert tlayers.rope_freq(half, theta, "cpu") is first
