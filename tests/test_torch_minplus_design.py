"""The min-plus kernel's arithmetic and tile fill, on the CPU.

The plain versions the kernel is held to on the card must equal the Pallas
kernel (interpret mode) bit for bit, NaN-aware, where operands hold NaN,
+-inf and negative entries: ``ref.minplus_ref``; the fused step
``ref.minplus_ref(A, B, C)`` (the kernel's accumulator starting at
``min(1e9, C)``, K walked in chunks of any size) against
``torch.minimum(C, minplus_ref(A, B))``; and ``ref.apsp_ref``, built from
the fused step, against ``apsp_tiled_pallas``.  ``minplus.tile_fill`` must
show the kernel's tiles filling the card at APSP's V = 1536.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import minplus as jminplus
from repro_torch import testing
from repro_torch.kernels import minplus as mp
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from _torch_threads import one_torch_thread  # noqa: F401

TILES = dict(bm=32, bn=32, bk=32)


def _nan_equal(got: torch.Tensor, want) -> None:
    assert testing.nan_equal(got, torch.from_numpy(np.array(want)))


def _fused_c(M: int, N: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    C = (20 * rng.random((M, N)) - 5).astype(np.float32)
    C[rng.random((M, N)) < 0.2] = np.float32(1e9)
    C[rng.random((M, N)) < 0.1] = np.inf
    C[rng.random((M, N)) < 0.05] = -np.inf
    C[rng.integers(M, size=2), rng.integers(N, size=2)] = np.nan
    return C


@pytest.mark.parametrize("kind", testing.MINPLUS_SPECIALS)
def test_minplus_ref_bitwise_pallas_with_special_values(kind):
    A, B = testing.minplus_special(40, 24, 72, kind, seed=3)
    want = jminplus.minplus_tiled_pallas(jnp.asarray(A), jnp.asarray(B),
                                         interpret=True, **TILES)
    got = tref.minplus_ref(torch.from_numpy(A), torch.from_numpy(B))
    _nan_equal(got, want)
    if kind == "nan in A":
        rows = np.isnan(A).any(1)
        assert torch.isnan(got[torch.from_numpy(rows)]).all()
        assert not torch.isnan(got[torch.from_numpy(~rows)]).any()
    if kind == "nan in B":
        cols = np.isnan(B).any(0)
        assert torch.isnan(got[:, torch.from_numpy(cols)]).all()
    if kind == "+inf":
        assert (got == np.float32(1e9)).any()       # sums at the ceiling
    if kind == "negative":
        assert (got < 0).all()


@pytest.mark.parametrize("k_chunk", [1, 5, 37, 100])
@pytest.mark.parametrize("kind", testing.MINPLUS_SPECIALS)
def test_fused_step_equals_min_of_c_and_product(kind, k_chunk):
    """The accumulator seeded with min(1e9, C), whatever chunks K is walked
    in (K = 37: chunks of one, ragged, whole and wider than K)."""
    A, B = testing.minplus_special(40, 37, 72, kind, seed=5)
    C = torch.from_numpy(_fused_c(40, 72, seed=5))
    A, B = torch.from_numpy(A), torch.from_numpy(B)
    got = tref.minplus_ref(A, B, C, k_chunk=k_chunk)
    assert testing.nan_equal(got, torch.minimum(C, tref.minplus_ref(A, B)))
    assert testing.nan_equal(got, mp.minplus(A, B, C))
    assert torch.isnan(got[torch.isnan(C)]).all()


def test_fused_step_bitwise_pallas_min():
    """min(C, Pallas product) in JAX equals the fused plain step."""
    A, B = testing.minplus_special(40, 24, 72, "negative", seed=7)
    C = _fused_c(40, 72, seed=7)
    want = jnp.minimum(jnp.asarray(C), jminplus.minplus_tiled_pallas(
        jnp.asarray(A), jnp.asarray(B), interpret=True, **TILES))
    got = tref.minplus_ref(*map(torch.from_numpy, (A, B, C)))
    _nan_equal(got, want)


def _tiny_apsp_graph(V):
    # tests/test_kernels.py::test_apsp_tiny_v
    W = np.full((V, V), 1e9, np.float32)
    np.fill_diagonal(W, 0.0)
    W[0, V - 1] = W[V - 1, 0] = 5.0
    if V == 3:
        W[0, 1] = W[1, 0] = 2.0
        W[1, 2] = W[2, 1] = 2.0
    return W


def _apsp_case(case: str) -> tuple[np.ndarray, dict]:
    if case in ("V=2", "V=3"):
        return _tiny_apsp_graph(int(case[2:])), dict(bm=8, bn=8, bk=8)
    if case == "V=48":                           # test_apsp_tiled_matches_fw
        return testing.random_graph(48, 150, seed=3)[0], TILES
    if case == "directed V=40":
        W = testing.directed_graph(40, 90, seed=8)
        assert not (W == W.T).all()
        return W, dict(bm=16, bn=16, bk=16)
    W = testing.random_graph(40, 120, seed=9)[0]     # "nan V=40"
    W[3, 11] = np.nan
    return W, dict(bm=16, bn=16, bk=16)


@pytest.mark.parametrize("case", ["V=2", "V=3", "V=48", "directed V=40",
                                  "nan V=40"])
def test_apsp_from_fused_step_bitwise_pallas(case):
    W, tiles = _apsp_case(case)
    want = jminplus.apsp_tiled_pallas(jnp.asarray(W), interpret=True,
                                      **tiles)
    Wt = torch.from_numpy(W)
    calls = dict(tref.calls)
    got = tref.apsp_ref(Wt)
    n = tref.apsp_squarings(W.shape[-1])
    assert tref.calls["minplus_ref"] == calls.get("minplus_ref", 0) + n
    _nan_equal(got, want)
    _nan_equal(ops.apsp(Wt), want)
    assert testing.nan_equal(Wt, torch.from_numpy(W))   # W not written
    if case.startswith("nan"):
        assert torch.isnan(got[3]).all()
    else:
        D, _ = tref.fw_counts_ref(Wt[None])
        assert torch.equal(got, D[0])


def test_tile_fill_at_the_timed_shapes():
    p = mp.tile_fill(1536, 1536)
    assert (p["tiles"], p["most"]) == (256, 2)
    assert p["share"] == pytest.approx(256 / 264) and p["share"] >= 0.9
    # hex127's V = 702 has 64 tiles for 132 SMs.
    q = mp.tile_fill(702, 702)
    assert (q["tiles"], q["most"]) == (64, 1)
    assert q["share"] == pytest.approx(64 / 132)
    # 128 x 128 tiles would leave 12 SMs with two and 120 with one.
    assert 144 / (132 * 2) < 0.9
    assert mp.tile_fill(1, 1)["tiles"] == 1
    assert mp.tile_fill(1536, 1536, sms=256)["share"] == 1.0
    assert mp.THREADS * mp.RESIDENT // 32 % 4 == 0   # even over schedulers


def test_wrapper_on_cpu_takes_the_fused_plain_version():
    A, B = (torch.from_numpy(x) for x in testing.minplus_operands(30, 20,
                                                                   10))
    C = torch.from_numpy(_fused_c(30, 10, seed=1))
    launches, calls = mp.launches, dict(tref.calls)
    out = ops.minplus(A, B, C)
    assert tref.calls["minplus_ref"] == calls.get("minplus_ref", 0) + 1
    assert mp.launches == launches
    assert testing.nan_equal(out, torch.minimum(C, ops.minplus(A, B)))
    with pytest.raises(ValueError):
        ops.minplus(A, B, C[:, :5].contiguous())
    with pytest.raises(TypeError):
        ops.minplus(A, B, C.double())
    with pytest.raises(ValueError):
        ops.apsp(torch.zeros(3, 4))


def test_nan_equal_is_bitwise_and_nan_aware():
    a = torch.tensor([1.0, float("nan"), float("inf")])
    assert testing.nan_equal(a, a.clone())
    assert not torch.equal(a, a.clone())
    assert not testing.nan_equal(a, torch.tensor([1.0, 0.0, float("inf")]))
    assert not testing.nan_equal(a, torch.tensor([1.0, float("nan"), 1e9]))
    assert not testing.nan_equal(a, a[:2])
