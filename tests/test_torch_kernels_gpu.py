"""The CUDA FW kernel against its plain PyTorch version, on the card.

Every case of ``repro_torch.testing.kernel_cases`` (random graphs for
V in {5, 8, 13, 40, 130, 216, 480} x B in {1, 3, 16}, graphs that are not
connected, the count-clip graph and real homog32/homog64 score graphs)
must give bit-for-bit equal D and N.  Skips without a card; run it on the
H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import pytest
import torch

from repro_torch import testing
from repro_torch.kernels import fw_counts as fwc
from repro_torch.kernels import ref as tref

pytestmark = pytest.mark.gpu

CASES = testing.kernel_cases()


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
