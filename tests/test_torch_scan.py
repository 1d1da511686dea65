"""The port's scan plain versions and wrappers against the reference, on
the CPU.

- ``ref.selective_scan_ref`` and ``ref.rglru_ref`` against ``repro``'s
  Pallas kernels in interpret mode on the three shapes of each kernel's
  test in ``tests/test_kernels.py`` (Di = 130 and D = 130 ragged over the
  Pallas block of 8) plus one more ragged case with a starting state, in
  float32 at the JAX tests' rtol = atol = 3e-5.
- A sequence split across two wrapper calls (the state carried through
  ``h0``) equals one call, as ``test_selective_scan_carries_state`` holds
  the Pallas kernel.
- bfloat16 inputs against ``repro.kernels.ref`` on the same bfloat16
  inputs: both sum in float32 and round once, so the outputs may differ by
  one bfloat16 ulp where the float32 results straddle a rounding boundary
  (rtol = 2**-7, atol = 1e-5); the float32 final states to 3e-5.
- The wrappers on CPU tensors take the plain versions (their call
  counters move, the kernels' launch counters do not), and refuse what the
  kernels do not take.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_scan_pallas
from repro.kernels.selective_scan import selective_scan_pallas
from repro_torch import testing
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import selective_scan as tss

from _torch_threads import one_torch_thread  # noqa: F401

F32_TOL = 3e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5

SSCAN_SHAPES = [dict(Bt=1, S=8, Di=16, N=4), dict(Bt=2, S=12, Di=20, N=8),
                dict(Bt=2, S=7, Di=130, N=4),
                dict(Bt=2, S=19, Di=37, N=16, h0=True)]
RGLRU_SHAPES = [dict(B=1, S=8, D=16), dict(B=2, S=20, D=40),
                dict(B=2, S=5, D=130), dict(B=2, S=19, D=37, h0=True)]


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@functools.lru_cache(maxsize=None)
def _pallas(kernel):
    if kernel == "selective_scan":
        return jax.jit(lambda *a: selective_scan_pallas(*a, bd=8,
                                                        interpret=True))
    return jax.jit(lambda *a: rglru_scan_pallas(*a, bd=8, interpret=True))


@pytest.mark.parametrize("shape", SSCAN_SHAPES,
                         ids=lambda s: " ".join(f"{k}={v}"
                                                for k, v in s.items()))
def test_selective_scan_ref_matches_pallas(shape):
    args = testing.sscan_operands(**shape, seed=1)
    y1, h1 = _pallas("selective_scan")(*map(_j, args))
    y2, h2 = tref.selective_scan_ref(*map(_t, args))
    assert y2.dtype == torch.float32 and h2.dtype == torch.float32
    assert_allclose(y2.numpy(), np.asarray(y1), rtol=F32_TOL, atol=F32_TOL)
    assert_allclose(h2.numpy(), np.asarray(h1), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("shape", RGLRU_SHAPES,
                         ids=lambda s: " ".join(f"{k}={v}"
                                                for k, v in s.items()))
def test_rglru_ref_matches_pallas(shape):
    args = testing.rglru_operands(**shape, seed=2)
    y1, h1 = _pallas("rglru")(*map(_j, args))
    y2, h2 = tref.rglru_ref(*map(_t, args))
    assert_allclose(y2.numpy(), np.asarray(y1), rtol=F32_TOL, atol=F32_TOL)
    assert_allclose(h2.numpy(), np.asarray(h1), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("kernel", ["selective_scan", "rglru"])
def test_scan_carries_state_across_calls(kernel):
    """Splitting a sequence across two wrapper calls == one call == the
    Pallas kernel over the whole sequence."""
    if kernel == "selective_scan":
        x, dt, A, B, C, D, _ = map(_t, testing.sscan_operands(
            1, 16, 8, 4, seed=3))
        seq = (x, dt, B, C)
        call = lambda s, h: ops.selective_scan(s[0], s[1], A, s[2], s[3], D,
                                               h)
        want = _pallas(kernel)(*map(_j, (x, dt, A, B, C, D)))
    else:
        x, a, _ = map(_t, testing.rglru_operands(2, 16, 24, seed=3))
        seq = (x, a)
        call = lambda s, h: ops.rglru_scan(s[0], s[1], h)
        want = _pallas(kernel)(_j(x), _j(a))
    y_full, h_full = call(seq, None)
    y1, h = call([t[:, :5] for t in seq], None)
    y2, h = call([t[:, 5:] for t in seq], h)
    y = torch.cat([y1, y2], 1)
    assert torch.allclose(y, y_full, rtol=1e-6, atol=1e-6)
    assert torch.allclose(h, h_full, rtol=1e-6, atol=1e-6)
    assert_allclose(y.numpy(), np.asarray(want[0]), rtol=F32_TOL,
                    atol=F32_TOL)
    assert_allclose(h.numpy(), np.asarray(want[1]), rtol=F32_TOL,
                    atol=F32_TOL)


@functools.lru_cache(maxsize=None)
def _jref(kernel):
    fn = jref.selective_scan_ref if kernel == "sscan" else jref.rglru_ref
    return jax.jit(fn)


def _bf16(a):
    """A float32 array rounded to bfloat16, as (numpy uint16 view for the
    port, jax array for the reference)."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.uint16).copy()).view(
        torch.bfloat16)
    return t, j


@pytest.mark.parametrize("dt_bf16", [False, True])
def test_selective_scan_bf16_matches_reference(dt_bf16):
    x, dt, A, B, C, D, h0 = testing.sscan_operands(2, 40, 70, 16, seed=4,
                                                   h0=True)
    tx, jx = _bf16(x)
    tdt, jdt = _bf16(dt) if dt_bf16 else (_t(dt), _j(dt))
    rest = (A, B, C, D, h0)
    y1, h1 = _jref("sscan")(jx, jdt, *map(_j, rest))
    y2, h2 = ops.selective_scan(tx, tdt, *map(_t, rest))
    assert y2.dtype == torch.bfloat16 and h2.dtype == torch.float32
    assert_allclose(y2.float().numpy(), np.asarray(y1.astype(jnp.float32)),
                    rtol=BF16_RTOL, atol=BF16_ATOL)
    assert_allclose(h2.numpy(), np.asarray(h1), rtol=F32_TOL, atol=F32_TOL)


def test_rglru_bf16_matches_reference():
    x, a, h0 = testing.rglru_operands(2, 40, 70, seed=5, h0=True)
    (tx, jx), (ta, ja) = _bf16(x), _bf16(a)
    y1, h1 = _jref("rglru")(jx, ja, _j(h0))
    y2, h2 = ops.rglru_scan(tx, ta, _t(h0))
    assert y2.dtype == torch.bfloat16 and h2.dtype == torch.float32
    assert_allclose(y2.float().numpy(), np.asarray(y1.astype(jnp.float32)),
                    rtol=BF16_RTOL, atol=BF16_ATOL)
    assert_allclose(h2.numpy(), np.asarray(h1), rtol=F32_TOL, atol=F32_TOL)


def test_wrappers_take_the_plain_versions_on_cpu():
    tref.calls.clear()
    launches = (tss.launches, trg.launches)
    x, dt, A, B, C, D, _ = map(_t, testing.sscan_operands(1, 6, 8, 4))
    y, h = ops.selective_scan(x, dt, A, B, C, D)
    ww = tref.selective_scan_ref(x, dt, A, B, C, D)
    assert torch.equal(y, ww[0]) and torch.equal(h, ww[1])
    xr, a, _ = map(_t, testing.rglru_operands(1, 6, 8))
    y, h = ops.rglru_scan(xr, a)
    ww = tref.rglru_ref(xr, a)
    assert torch.equal(y, ww[0]) and torch.equal(h, ww[1])
    assert tref.calls["selective_scan_ref"] == 2
    assert tref.calls["rglru_ref"] == 2
    assert (tss.launches, trg.launches) == launches


def _sscan_args(**over):
    x, dt, A, B, C, D, _ = map(_t, testing.sscan_operands(1, 6, 8, 4))
    args = dict(x=x, dt=dt, A=A, B=B, C=C, D=D, h0=None)
    args.update(over)
    return args


SSCAN_BAD = {
    "x not 3-d": (dict(x=torch.zeros(6, 8)), ValueError),
    "state size 17": (dict(A=torch.zeros(8, 17)), ValueError),
    "dt shape": (dict(dt=torch.zeros(1, 5, 8)), ValueError),
    "B shape": (dict(B=torch.zeros(1, 6, 5)), ValueError),
    "D shape": (dict(D=torch.zeros(9)), ValueError),
    "h0 shape": (dict(h0=torch.zeros(1, 8, 5)), ValueError),
    "A float64": (dict(A=torch.zeros(8, 4, dtype=torch.float64)),
                  TypeError),
    "x float16": (dict(x=torch.zeros(1, 6, 8, dtype=torch.float16)),
                  TypeError),
    "B bfloat16": (dict(B=torch.zeros(1, 6, 4, dtype=torch.bfloat16)),
                   TypeError),
    "C not a tensor": (dict(C=np.zeros((1, 6, 4), np.float32)), TypeError),
    "meta device": (dict(x=torch.zeros(1, 6, 8, device="meta"),
                         dt=torch.zeros(1, 6, 8, device="meta"),
                         A=torch.zeros(8, 4, device="meta"),
                         B=torch.zeros(1, 6, 4, device="meta"),
                         C=torch.zeros(1, 6, 4, device="meta"),
                         D=torch.zeros(8, device="meta")), ValueError),
}


@pytest.mark.parametrize("case", list(SSCAN_BAD))
def test_selective_scan_rejects_bad_input(case):
    over, err = SSCAN_BAD[case]
    with pytest.raises(err):
        ops.selective_scan(**_sscan_args(**over))


RGLRU_BAD = {
    "x not 3-d": (dict(x=torch.zeros(6, 8)), ValueError),
    "a shape": (dict(a=torch.zeros(1, 6, 9)), ValueError),
    "h0 shape": (dict(h0=torch.zeros(2, 8)), ValueError),
    "x and a dtypes": (dict(a=torch.zeros(1, 6, 8, dtype=torch.bfloat16)),
                       TypeError),
    "h0 bfloat16": (dict(h0=torch.zeros(1, 8, dtype=torch.bfloat16)),
                    TypeError),
    "x int": (dict(x=torch.zeros(1, 6, 8, dtype=torch.int32)), TypeError),
}


@pytest.mark.parametrize("case", list(RGLRU_BAD))
def test_rglru_scan_rejects_bad_input(case):
    over, err = RGLRU_BAD[case]
    x, a, _ = map(_t, testing.rglru_operands(1, 6, 8))
    args = dict(x=x, a=a, h0=None)
    args.update(over)
    with pytest.raises(err):
        ops.rglru_scan(**args)
