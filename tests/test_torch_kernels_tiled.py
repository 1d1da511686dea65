"""The port's blocked FW and min-plus kernel layer against the JAX package,
on the CPU.

``fw_counts_tiled_ref`` (the plain blocked FW) must be bit for bit equal to
the Pallas ``fw_counts_tiled_pallas`` in interpret mode and to both
packages' ``fw_counts_ref``; ``minplus_ref`` and ``apsp_ref`` must equal
the Pallas min-plus kernel and its APSP bit for bit, including the
kernel's 1e9 ceiling, which ``repro.kernels.ref.minplus_ref`` lacks.  The
wrappers must take the plain versions for CPU tensors without counting a
kernel launch and refuse inputs the kernels do not take.  The kernels
themselves run only on the card (``tests/test_torch_kernels_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import minplus as jminplus
from repro.kernels import ref as jref
from repro_torch import testing
from repro_torch.kernels import build
from repro_torch.kernels import fw_counts as fwc
from repro_torch.kernels import fw_counts_tiled as fwt
from repro_torch.kernels import minplus as mp
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from _torch_threads import one_torch_thread  # noqa: F401


def _equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# The cases of tests/test_kernels.py::test_fw_counts_tiled_bitforbit.
@pytest.mark.parametrize("V,edges,batch,bt", [
    (8, 12, 1, 4), (13, 30, 2, 4), (40, 120, 2, 16), (130, 400, 1, 64),
    (5, 0, 1, 4)])
def test_fw_tiled_ref_bitwise_pallas_interpret(V, edges, batch, bt):
    W = testing.random_graph(V, edges, seed=V + edges, batch=batch)
    D1, N1 = jminplus.fw_counts_tiled_pallas(jnp.asarray(W), bt=bt,
                                             interpret=True)
    D2, N2 = tref.fw_counts_tiled_ref(torch.from_numpy(W), bt)
    _equal(D2, D1)
    _equal(N2, N1)


def test_fw_tiled_ref_bitwise_homog100_score_graph():
    W = testing.score_graphs("homog100", "baseline", 1)
    D1, N1 = jref.fw_counts_ref(jnp.asarray(W))
    D2, N2 = tref.fw_counts_tiled_ref(torch.from_numpy(W), 64)
    _equal(D2, D1)
    _equal(N2, N1)
    D3, N3 = tref.fw_counts_ref(torch.from_numpy(W))
    assert torch.equal(D2, D3) and torch.equal(N2, N3)


def test_fw_tiled_ref_bitwise_count_clip():
    W = testing.count_clip_graph()
    D1, N1 = jref.fw_counts_ref(jnp.asarray(W))
    D2, N2 = tref.fw_counts_tiled_ref(torch.from_numpy(W), 16)
    _equal(D2, D1)
    _equal(N2, N1)
    assert float(N2[0, 1]) == np.float32(1e30)
    D3, N3 = tref.fw_counts_ref(torch.from_numpy(W))
    assert torch.equal(D2, D3) and torch.equal(N2, N3)


@pytest.mark.parametrize("bt", [16, fwt.BT])
@pytest.mark.parametrize("edge", ["bt-1", "bt", "bt+1", "2bt+3"])
def test_fw_tiled_ref_bitwise_at_tile_edges(bt, edge):
    V = {"bt-1": bt - 1, "bt": bt, "bt+1": bt + 1, "2bt+3": 2 * bt + 3}[edge]
    W = torch.from_numpy(testing.random_graph(V, 3 * V, seed=V, batch=3))
    D1, N1 = tref.fw_counts_ref(W)
    D2, N2 = tref.fw_counts_tiled_ref(W, bt)
    assert torch.equal(D1, D2) and torch.equal(N1, N2)


# The shapes and tiles of tests/test_kernels.py::test_minplus_tiled, and a
# case where every sum exceeds the kernel's 1e9 ceiling.
@pytest.mark.parametrize("m,k,n,tiles,offset", [
    (64, 64, 64, dict(bm=32, bn=32, bk=32), 0.0),
    (100, 70, 130, dict(bm=32, bn=128, bk=32), 0.0),
    (128, 128, 128, dict(), 0.0),
    (40, 24, 72, dict(bm=32, bn=32, bk=32), 6e8)])
def test_minplus_ref_bitwise_pallas_interpret(m, k, n, tiles, offset):
    A, B = testing.minplus_operands(m, k, n, seed=m + k + n,
                                    scale=1e8 if offset else 10.0,
                                    offset=offset)
    want = jminplus.minplus_tiled_pallas(jnp.asarray(A), jnp.asarray(B),
                                         interpret=True, **tiles)
    _equal(tref.minplus_ref(torch.from_numpy(A), torch.from_numpy(B)), want)


def test_minplus_ceiling_differs_from_jax_ref():
    A, B = testing.minplus_cases()["all sums > 1e9, M=40 K=24 N=72"]()
    got = tref.minplus_ref(torch.from_numpy(A), torch.from_numpy(B))
    assert (got == np.float32(1e9)).all()
    uncapped = np.asarray(jref.minplus_ref(jnp.asarray(A), jnp.asarray(B)))
    assert (uncapped > 1e9).all()
    np.testing.assert_array_equal(np.minimum(uncapped, np.float32(1e9)),
                                  got.numpy())


def _tiny_apsp_graph(V):
    # tests/test_kernels.py::test_apsp_tiny_v
    W = np.full((V, V), 1e9, np.float32)
    np.fill_diagonal(W, 0.0)
    W[0, V - 1] = W[V - 1, 0] = 5.0
    if V == 3:
        W[0, 1] = W[1, 0] = 2.0
        W[1, 2] = W[2, 1] = 2.0
    return W


@pytest.mark.parametrize("case", ["V=2", "V=3", "V=48"])
def test_apsp_ref_bitwise_pallas_interpret(case):
    if case == "V=48":
        W, tiles = testing.random_graph(48, 150, seed=3)[0], dict(
            bm=32, bn=32, bk=32)
    else:
        W, tiles = _tiny_apsp_graph(int(case[2:])), dict(bm=8, bn=8, bk=8)
    want = jminplus.apsp_tiled_pallas(jnp.asarray(W), interpret=True,
                                      **tiles)
    got = tref.apsp_ref(torch.from_numpy(W))
    _equal(got, want)
    _equal(ops.apsp(torch.from_numpy(W)), want)
    if case == "V=3":
        assert float(got[0, 2]) == 4.0
    if case == "V=48":
        _equal(got, jref.fw_counts_ref(jnp.asarray(W))[0])


def test_wrappers_take_plain_versions_on_cpu():
    W = torch.from_numpy(testing.random_graph(40, 120, seed=2, batch=2))
    before = (fwc.launches, fwt.launches, mp.launches)
    calls = dict(tref.calls)
    D, N = ops.fw_counts_tiled(W)
    assert tref.calls["fw_counts_tiled_ref"] == calls.get(
        "fw_counts_tiled_ref", 0) + 1
    D2, N2 = ops.fw_impl_ref(W)
    assert torch.equal(D, D2) and torch.equal(N, N2)
    D1, N1 = ops.fw_counts_tiled(W[0])          # [V, V] squeezes
    assert torch.equal(D1, D[0]) and torch.equal(N1, N[0])
    for V in (ops.FW_TILED_FROM_V - 1, ops.FW_TILED_FROM_V):
        Wv = torch.from_numpy(testing.random_graph(V, 3 * V, seed=V))
        Dv, Nv = ops.fw_impl_tiled(Wv)
        Dr, Nr = tref.fw_counts_ref(Wv)
        assert torch.equal(Dv, Dr) and torch.equal(Nv, Nr)
    A, B = testing.minplus_operands(30, 20, 10)
    out = ops.minplus(torch.from_numpy(A), torch.from_numpy(B))
    assert out.shape == (30, 10)
    assert (fwc.launches, fwt.launches, mp.launches) == before


def test_fw_impl_tiled_dispatches_by_size(monkeypatch):
    seen = []
    monkeypatch.setattr(ops, "fw_counts", lambda W: seen.append("one"))
    monkeypatch.setattr(ops, "fw_counts_tiled",
                        lambda W: seen.append("tiled"))
    for V in (ops.FW_TILED_FROM_V - 1, ops.FW_TILED_FROM_V, 1536):
        ops.fw_impl_tiled(torch.zeros(1, V, V))
    assert seen == ["one", "tiled", "tiled"]
    assert ops.FW_TILED_FROM_V != 768           # not the TPU's VMEM knee


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(2, 5, 5, dtype=torch.float64), TypeError),
    (torch.zeros(5), ValueError),
    (torch.zeros(2, 5, 4), ValueError),
    (torch.zeros(2, 5, 5).transpose(1, 2), ValueError),
    (torch.zeros(1, 2, 5, 5), ValueError),
    ([[0.0]], TypeError),
])
def test_fw_tiled_wrapper_rejects_bad_input(bad, err):
    with pytest.raises(err):
        fwt.fw_counts_tiled(bad)


@pytest.mark.parametrize("A,B,err", [
    (torch.zeros(3, 4, dtype=torch.float64), torch.zeros(4, 2), TypeError),
    (torch.zeros(3, 4), torch.zeros(5, 2), ValueError),
    (torch.zeros(2, 3, 4), torch.zeros(4, 2), ValueError),
    (torch.zeros(4, 3).t(), torch.zeros(4, 2), ValueError),
    (torch.zeros(3, 4), np.zeros((4, 2), np.float32), TypeError),
])
def test_minplus_wrapper_rejects_bad_input(A, B, err):
    with pytest.raises(err):
        mp.minplus(A, B)


def test_build_command_lists_every_source():
    # The flags of each compile are held by test_torch_kernels.py.
    compiles, _ = build.build_commands()
    names = [s.name for s in build.SOURCES]
    assert names == ["fw_counts.cu", "fw_counts_tiled.cu", "minplus.cu",
                     "flash_attention.cu", "decode_attention.cu",
                     "selective_scan.cu", "rglru_scan.cu",
                     "flash_attention_bwd.cu", "selective_scan_bwd.cu",
                     "rglru_scan_bwd.cu"]
    assert [c[-1] for c in compiles] == [str(s) for s in build.SOURCES]
    assert set(build.SIGNATURES) == {"fw_counts_f32", "fw_counts_tiled_f32",
                                     "fw_counts_cluster_f32",
                                     "fw_counts_cluster_size",
                                     "fw_counts_onchip_max_v",
                                     "fw_counts_tiled_threads",
                                     "fw_counts_tiled_traced_f32",
                                     "minplus_f32", "flash_attention_fwd",
                                     "flash_attention_bwd",
                                     "decode_attention_fwd",
                                     "selective_scan_fwd", "rglru_scan_fwd",
                                     "selective_scan_bwd",
                                     "selective_scan_bwd_block_channels",
                                     "selective_scan_bwd_tensor_maps",
                                     "rglru_scan_bwd"}
    for name in build.SIGNATURES:
        assert any(f"int {name}(" in s.read_text() for s in build.SOURCES)
