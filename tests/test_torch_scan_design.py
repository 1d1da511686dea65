"""The arithmetic of the scan kernels' designs, on the CPU.

- ``ref.selective_scan_kernel_order_ref`` (``csrc/selective_scan.cu``'s
  order of operations in plain PyTorch: the exp as 2^(dt (A log2 e)) with A
  prescaled in float32, the update as one fmaf, two states a lane and the
  8-lane transpose-reduce's summation order) and
  ``ref.rglru_kernel_order_ref`` (``csrc/rglru_scan.cu``'s: b computed for
  the chunk before the walk, the walk one fmaf a step) against the plain
  versions ``ref.selective_scan_ref`` / ``ref.rglru_ref`` and against the
  reference's ``repro.kernels.ref`` (under ``jax.jit``, arrays passed as
  numpy), at S = 2048 with falcon-mamba-7b's and recurrentgemma-9b's
  operand ranges (dt in [1e-3, 0.1), A = -(1..16); a in [0.5, 1)) at a
  narrow width (Di = D = 32), in float32, within the kernels' float32
  tolerances (``SCAN_TOL`` 3e-5 on outputs, ``STATE_TOL`` 3e-5 on final
  states), so that on the card only ex2.approx's 2 ulp come on top.
- The shuffle butterfly of the kernel's ``reduce_groups``, emulated lane by
  lane, leaves in lane q the sum of step q in ``ref.lane_tree_sum``'s
  order, bit for bit.
- Both models split across two calls (the final state handed on) equal one
  call bit for bit, wherever the cut falls: the designs keep every
  recurrence the same fmaf sequence from h0.
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
from repro_torch.kernels import ref as tref

from _torch_threads import one_torch_thread  # noqa: F401

SCAN_TOL = 3e-5          # chip_smoke.py's float32 SCAN_TOL
STATE_TOL = 3e-5         # chip_smoke.py's STATE_TOL
S_SERVE = 2048           # the serve runs' longest falcon-mamba prompt
WIDTH = 32


def _serve_ranges(seed: int):
    """falcon-mamba-7b's operand ranges at Di = 32, N = 16 (x, B, C, D, h0
    standard normal; dt in [1e-3, 0.1), its dt bias's range; A = -(1..16),
    the S4D-real init) and recurrentgemma-9b's at D = 32 (a in [0.5, 1))."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((1, S_SERVE, WIDTH), dtype=f)
    dt = (1e-3 + 0.099 * rng.random((1, S_SERVE, WIDTH))).astype(f)
    A = -np.broadcast_to(np.arange(1, 17, dtype=f), (WIDTH, 16)).copy()
    B = rng.standard_normal((1, S_SERVE, 16), dtype=f)
    C = rng.standard_normal((1, S_SERVE, 16), dtype=f)
    D = rng.standard_normal(WIDTH, dtype=f)
    h0 = rng.standard_normal((1, WIDTH, 16), dtype=f)
    xr = rng.standard_normal((1, S_SERVE, WIDTH), dtype=f)
    a = (0.5 + 0.5 * rng.random((1, S_SERVE, WIDTH))).astype(f)
    hr0 = rng.standard_normal((1, WIDTH), dtype=f)
    return (x, dt, A, B, C, D, h0), (xr, a, hr0)


@functools.lru_cache(maxsize=None)
def _jax(kernel: str):
    return jax.jit(jref.selective_scan_ref if kernel == "sscan"
                   else jref.rglru_ref)


def _close(got, want, tol, what):
    assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                    err_msg=what)


def test_selective_scan_kernel_order_at_serve_ranges():
    args, _ = _serve_ranges(0)
    t = [torch.from_numpy(a) for a in args]
    y, h = tref.selective_scan_kernel_order_ref(*t)
    yp, hp = tref.selective_scan_ref(*t)
    yj, hj = _jax("sscan")(*(jnp.asarray(a) for a in args))
    assert y.dtype == torch.float32 and y.shape == yp.shape
    assert h.shape == hp.shape
    _close(y, yp, SCAN_TOL, "y vs plain")
    _close(h, hp, STATE_TOL, "h_final vs plain")
    _close(y, yj, SCAN_TOL, "y vs reference")
    _close(h, hj, STATE_TOL, "h_final vs reference")


def test_rglru_kernel_order_at_serve_ranges():
    _, args = _serve_ranges(1)
    t = [torch.from_numpy(a) for a in args]
    y, h = tref.rglru_kernel_order_ref(*t)
    yp, hp = tref.rglru_ref(*t)
    yj, hj = _jax("rglru")(*(jnp.asarray(a) for a in args))
    _close(y, yp, SCAN_TOL, "h vs plain")
    _close(h, hp, STATE_TOL, "h_final vs plain")
    _close(y, yj, SCAN_TOL, "h vs reference")
    _close(h, hj, STATE_TOL, "h_final vs reference")


def test_exp2_of_prescaled_A_tracks_exp():
    """dt (A log2 e) rounded in float32, then 2^x, against exp(dt A) over
    the serve ranges: within 4 float32 ulp (the argument's two roundings
    at |dt A| <= 1.6), before ex2.approx's own 2 ulp."""
    args, _ = _serve_ranges(2)
    dt = torch.from_numpy(args[1][0])[..., None]
    A = torch.from_numpy(args[2])[None]
    got = torch.exp2(dt * (A * tref.LOG2E))
    want = torch.exp(dt.double() * A.double())
    rel = ((got.double() - want) / want).abs().max().item()
    assert rel <= 4 * 2.0 ** -24


@pytest.mark.parametrize("name", [n for n in testing.scan_cases()
                                  if n.startswith("selective")])
def test_selective_scan_kernel_order_on_scan_cases(name):
    """Ragged widths, N = 5 (lanes past N hold 0), one step, h0."""
    args = [None if a is None else torch.from_numpy(a)
            for a in testing.scan_cases()[name]()]
    y, h = tref.selective_scan_kernel_order_ref(*args)
    yp, hp = tref.selective_scan_ref(*args)
    _close(y, yp, SCAN_TOL, name)
    _close(h, hp, STATE_TOL, name)


def _butterfly(p: np.ndarray) -> np.ndarray:
    """The kernel's reduce_groups on one group, lane by lane: p[l, s] is
    lane l's partial of step s (float32); round o = L/2, ..., 1: lane l
    keeps the half of its steps whose bit o matches its own, receives its
    partner l ^ o's other half and adds it.  Returns each lane's result."""
    L = p.shape[0]
    p = p.copy()
    o = L // 2
    while o:
        sent = np.stack([p[l ^ o, o:2 * o] if l & o else p[l ^ o, :o]
                         for l in range(L)])
        keep = np.stack([p[l, o:2 * o] if l & o else p[l, :o]
                         for l in range(L)])
        p[:, :o] = keep + sent
        o //= 2
    return p[:, 0]


def test_transpose_reduce_order():
    rng = np.random.default_rng(3)
    L = tref.SSCAN_LANES
    for _ in range(50):
        p = (rng.standard_normal((L, L)) * 10.0 ** rng.integers(
            -3, 4, (L, L))).astype(np.float32)
        got = _butterfly(p)
        want = tref.lane_tree_sum(torch.from_numpy(p.T.copy())).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("kernel", ["selective_scan", "rglru"])
def test_kernel_order_split_calls_equal_one_call(kernel):
    if kernel == "selective_scan":
        args = [torch.from_numpy(a) for a in
                testing.sscan_operands(2, 100, 24, 16, seed=4, h0=True)]
        fn, seq = tref.selective_scan_kernel_order_ref, (0, 1, 3, 4)
    else:
        args = [torch.from_numpy(a) for a in
                testing.rglru_operands(2, 100, 24, seed=5, h0=True)]
        fn, seq = tref.rglru_kernel_order_ref, (0, 1)
    y, h = fn(*args)
    for cut in (1, 32, 45, 64, 99):
        first = [a[:, :cut] if i in seq else a for i, a in enumerate(args)]
        rest = [a[:, cut:] if i in seq else a for i, a in enumerate(args)]
        y1, h1 = fn(*first)
        rest[-1] = h1
        y2, h2 = fn(*rest)
        assert torch.equal(torch.cat([y1, y2], 1), y), cut
        assert torch.equal(h2, h), cut


def test_kernel_order_refs_count_their_calls():
    x, a, _ = testing.rglru_operands(1, 3, 4)
    args = [torch.from_numpy(x), torch.from_numpy(a)]
    before = tref.calls["rglru_kernel_order_ref"]
    tref.rglru_kernel_order_ref(*args)
    assert tref.calls["rglru_kernel_order_ref"] == before + 1
