"""The scans' gradients in the port against the reference's, on the CPU.

- ``ref.selective_scan_bwd_ref`` and ``ref.rglru_bwd_ref`` against
  ``jax.vjp`` of ``repro.kernels.ref.selective_scan_ref`` / ``rglru_ref``
  on every ``testing.scan_cases()`` case, with dh_final zero and random
  (numpy seeds), and dh0 (the reference's h0 defaults to zeros): every
  gradient within 1e-5 of its largest entry, float32 (seen: under 5e-7;
  the two sum over states, channels and steps in other orders).
- The autograd Functions through the wrappers (``ops.selective_scan`` and
  ``ops.rglru_scan`` on operands that require a gradient) against the same
  ``jax.vjp``: float32 to 1e-5 of the largest entry; bfloat16 x and dt (or
  x and a) within one bfloat16 rounding (2^-8 relative, plus 2^-8 of the
  largest entry where a cancellation leaves an entry small), since both
  sides sum in float32 and round the gradient once.
- RG-LRU where a is 0, 1 and 1 + 2^-8, x or G is 0 or not: da's NaN and
  +-inf in the same places as ``jax.vjp``'s (-inf sign(x G) where a = 1
  and x G != 0, NaN where x G = 0, NaN wherever 1 - a^2 < 0), its finite
  entries and dx, dh0 as above.
- The plain Functions of ``repro_torch.testing`` (which a check on the
  card puts in the wrappers' place) equal the Functions bit for bit on
  the CPU, and the plain versions count their calls.
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
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

from _torch_threads import one_torch_thread  # noqa: F401

GRAD_TOL = 1e-5
BF16_TOL = 2.0 ** -8
CASES = testing.scan_cases()
SSCAN_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
RGLRU_GRADS = ("dx", "da", "dh0")


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _jax_vjp(kind):
    f = jref.selective_scan_ref if kind == "selective" else jref.rglru_ref

    @jax.jit
    def vjp(primals, cts):
        return jax.vjp(f, *primals)[1](cts)
    return vjp


def _operands(name, dhf_kind, seed=9):
    """The case's operands (h0 zeros for the reference when None), and a
    seeded output gradient and dh_final (None when ``dhf_kind`` is
    "zero")."""
    ops_ = CASES[name]()
    kind = "selective" if name.startswith("selective") else "rglru"
    x = ops_[0]
    state = (x.shape[0], x.shape[2]) + ((ops_[2].shape[1],)
                                         if kind == "selective" else ())
    h0j = ops_[-1] if ops_[-1] is not None else np.zeros(state, np.float32)
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal(x.shape, dtype=np.float32)
    dhf = (rng.standard_normal(state, dtype=np.float32)
           if dhf_kind == "random" else None)
    return kind, ops_, h0j, dy, dhf


def _want(kind, ops_, h0j, dy, dhf):
    primals = tuple(jnp.asarray(a) for a in (*ops_[:-1], h0j))
    cts = (jnp.asarray(dy), jnp.asarray(
        dhf if dhf is not None else np.zeros(h0j.shape, np.float32)))
    return [np.asarray(g, np.float32) for g in _jax_vjp(kind)(primals, cts)]


def _close(got, want, names, tol=GRAD_TOL, rtol=0.0):
    for g, w, name in zip(got, want, names):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, name
        assert_allclose(g, w, rtol=rtol,
                        atol=tol * max(float(np.abs(w).max()), 1e-30),
                        err_msg=name)


@pytest.mark.parametrize("dhf_kind", ["zero", "random"])
@pytest.mark.parametrize("name", list(CASES))
def test_bwd_ref_matches_jax_vjp(name, dhf_kind):
    kind, ops_, h0j, dy, dhf = _operands(name, dhf_kind)
    want = _want(kind, ops_, h0j, dy, dhf)
    tref.calls.clear()
    if kind == "selective":
        got = tref.selective_scan_bwd_ref(*map(_t, ops_), _t(dy), _t(dhf))
        names = SSCAN_GRADS
    else:
        got = tref.rglru_bwd_ref(*map(_t, ops_), _t(dy), _t(dhf))
        names = RGLRU_GRADS
    bwd = "selective_scan_bwd_ref" if kind == "selective" else "rglru_bwd_ref"
    assert tref.calls == {bwd: 1}
    assert all(g.dtype == torch.float32 for g in got)
    _close(got, want, names)


def _through_wrapper(kind, ops_, dy, dhf, dtype):
    """The gradients of <y, dy> + <h_final, dhf> through the wrapper, with
    every operand requiring a gradient (h0 only when given)."""
    args = [None if a is None else _t(a) for a in ops_]
    args[0], args[1] = args[0].to(dtype), args[1].to(dtype)
    for a in args:
        if a is not None:
            a.requires_grad_()
    fn = ops.selective_scan if kind == "selective" else ops.rglru_scan
    y, hf = fn(*args)
    assert y.grad_fn is not None and y.dtype == dtype
    loss = (y.float() * _t(dy).to(dtype).float()).sum()
    if dhf is not None:
        loss = loss + (hf * _t(dhf)).sum()
    grads = torch.autograd.grad(loss, [a for a in args if a is not None])
    return grads, args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_functions_through_wrappers_match_jax_vjp(name, dtype):
    kind, ops_, h0j, dy, dhf = _operands(name, "random")
    dt = getattr(torch, dtype)
    if dtype == "bfloat16":
        # The reference on the same bfloat16 operands and output gradient.
        ops_ = [a.astype(jnp.bfloat16) if i < 2 else a
                for i, a in enumerate(ops_)]
        dy_j = dy.astype(jnp.bfloat16)
    else:
        dy_j = dy
    primals = tuple(jnp.asarray(a) for a in (*ops_[:-1], h0j))
    want = [np.asarray(g, np.float32) for g in _jax_vjp(kind)(
        primals, (jnp.asarray(dy_j), jnp.asarray(dhf)))]
    ops_np = [None if a is None else np.asarray(a, np.float32) for a in ops_]
    tref.calls.clear()
    grads, args = _through_wrapper(kind, ops_np, dy, dhf, dt)
    bwd = "selective_scan_bwd_ref" if kind == "selective" else "rglru_bwd_ref"
    assert tref.calls[bwd] == 1
    for g, a in zip(grads, [a for a in args if a is not None]):
        assert g.dtype == a.dtype and g.shape == a.shape
    if ops_[-1] is None:
        want = want[:-1]                        # no h0: no dh0
    names = SSCAN_GRADS if kind == "selective" else RGLRU_GRADS
    if dtype == "float32":
        _close(grads, want, names)
    else:
        _close(grads, want, names, BF16_TOL, BF16_TOL)


def _same_nonfinite(got, want, name):
    g = got.float().numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(want), err_msg=name)
    np.testing.assert_array_equal(np.isposinf(g), np.isposinf(want),
                                  err_msg=name)
    np.testing.assert_array_equal(np.isneginf(g), np.isneginf(want),
                                  err_msg=name)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(g[fin] == 0, want[fin] == 0, err_msg=name)
    assert_allclose(g[fin], want[fin], rtol=0,
                    atol=GRAD_TOL * max(float(np.abs(want[fin]).max()),
                                        1e-30), err_msg=name)


@pytest.mark.parametrize("route", ["bwd_ref", "function"])
def test_rglru_gradient_at_a_equal_one_and_above(route):
    x, a, h0, dy, dhf = testing.rglru_edge_operands()
    want = _want("rglru", (x, a, h0), h0, dy, dhf)
    assert np.isnan(want[1]).any() and np.isneginf(want[1]).any() \
        and np.isposinf(want[1]).any()
    if route == "bwd_ref":
        got = tref.rglru_bwd_ref(_t(x), _t(a), _t(h0), _t(dy), _t(dhf))
    else:
        got, _ = _through_wrapper("rglru", (x, a, h0), dy, dhf,
                                  torch.float32)
    for g, w, name in zip(got, want, RGLRU_GRADS):
        _same_nonfinite(g, w, name)


@pytest.mark.parametrize("kind", ["selective", "rglru"])
def test_plain_functions_equal_the_functions_on_the_cpu(kind):
    name = next(n for n in CASES if n.startswith(kind) and "h0=True" in n)
    _, ops_, _, dy, dhf = _operands(name, "random")
    got, _ = _through_wrapper(kind, ops_, dy, dhf, torch.float32)
    plain = {"selective": (ops, "selective_scan",
                           testing.plain_selective_scan),
             "rglru": (ops, "rglru_scan", testing.plain_rglru_scan)}[kind]
    keep = getattr(plain[0], plain[1])
    setattr(plain[0], plain[1], plain[2])
    try:
        want, _ = _through_wrapper(kind, ops_, dy, dhf, torch.float32)
    finally:
        setattr(plain[0], plain[1], keep)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
