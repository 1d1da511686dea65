"""The CUDA kernels against their plain PyTorch versions, on the card.

The FW kernel on every case of ``repro_torch.testing.kernel_cases``
(random graphs for V in {5, 8, 13, 40, 130, 216, 480} x B in {1, 3, 16},
graphs that are not connected, the count-clip graph and real homog32/homog64
score graphs); the blocked FW kernel on every case of
``testing.tiled_cases`` (V at the tile edges, graphs that are
not connected, the count-clip graph and score graphs of the 100+-chiplet
families); the min-plus kernel on every case of ``testing.minplus_cases``.
All must be bit for bit equal, and each call must count one launch.
Skips without a card; run it on the H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import pytest
import torch

from repro_torch import testing
from repro_torch.kernels import fw_counts as fwc
from repro_torch.kernels import fw_counts_tiled as fwt
from repro_torch.kernels import minplus as mp
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

pytestmark = pytest.mark.gpu

CASES = testing.kernel_cases()
TILED = testing.tiled_cases(fwt.BT)
MINPLUS = testing.minplus_cases()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", list(CASES))
def test_fw_kernel_bitwise(cuda, name):
    W = torch.from_numpy(CASES[name]()).to(cuda)
    launches = fwc.launches
    D1, N1 = fwc.fw_counts(W)
    torch.cuda.synchronize()
    assert fwc.launches == launches + 1
    D2, N2 = tref.fw_counts_ref(W)
    assert torch.equal(D1, D2), name
    assert torch.equal(N1, N2), name


def test_fw_kernel_squeezes_2d(cuda):
    W = torch.from_numpy(testing.random_graph(40, 120, seed=1)[0]).to(cuda)
    D, N = fwc.fw_counts(W)
    D2, N2 = tref.fw_counts_ref(W)
    assert D.shape == (40, 40)
    assert torch.equal(D, D2) and torch.equal(N, N2)


def test_fw_kernel_rejects_non_contiguous(cuda):
    W = torch.zeros(2, 8, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        fwc.fw_counts(W)


@pytest.mark.parametrize("name", list(TILED))
def test_fw_tiled_kernel_bitwise(cuda, name):
    W = torch.from_numpy(TILED[name]()).to(cuda)
    launches = fwt.launches
    D1, N1 = fwt.fw_counts_tiled(W)
    torch.cuda.synchronize()
    assert fwt.launches == launches + 1
    D2, N2 = tref.fw_counts_ref(W)
    assert torch.equal(D1, D2), name
    assert torch.equal(N1, N2), name


def test_fw_tiled_kernel_squeezes_2d(cuda):
    W = torch.from_numpy(testing.random_graph(70, 210, seed=1)[0]).to(cuda)
    D, N = fwt.fw_counts_tiled(W)
    D2, N2 = tref.fw_counts_tiled_ref(W, fwt.BT)
    assert D.shape == (70, 70)
    assert torch.equal(D, D2) and torch.equal(N, N2)


def test_fw_impl_tiled_picks_the_tiled_kernel_from_the_measured_v(cuda):
    for V, tiled in ((ops.FW_TILED_FROM_V - 1, False),
                     (ops.FW_TILED_FROM_V, True)):
        W = torch.from_numpy(testing.random_graph(V, 3 * V, seed=V)).to(cuda)
        one, blocked = fwc.launches, fwt.launches
        D, N = ops.fw_impl_tiled(W)
        assert (fwt.launches - blocked, fwc.launches - one) == (
            (1, 0) if tiled else (0, 1))
        D2, N2 = tref.fw_counts_ref(W)
        assert torch.equal(D, D2) and torch.equal(N, N2)


@pytest.mark.parametrize("name", list(MINPLUS))
def test_minplus_kernel_bitwise(cuda, name):
    A, B = (torch.from_numpy(x).to(cuda) for x in MINPLUS[name]())
    launches = mp.launches
    out = mp.minplus(A, B)
    torch.cuda.synchronize()
    assert mp.launches == launches + 1
    assert torch.equal(out, tref.minplus_ref(A, B)), name


def test_apsp_matches_fw_distances(cuda):
    W = torch.from_numpy(testing.score_graphs("homog100", "placeit", 1)[0])
    W = W.to(cuda)
    launches = mp.launches
    D = ops.apsp(W)
    assert mp.launches == launches + tref.apsp_squarings(W.shape[-1])
    assert torch.equal(D, tref.fw_counts_ref(W)[0])
    assert torch.equal(D, tref.apsp_ref(W))
