"""The port's FW kernel layer against the JAX package, on the CPU.

The plain PyTorch ``fw_counts_ref`` must be bit for bit (``rtol=0``) equal
to ``repro.kernels.ref.fw_counts_ref`` and to the Pallas kernel in
interpret mode; the wrapper must take the plain version for CPU tensors
without counting a kernel launch, and refuse inputs the kernel does not
take.  The kernel itself runs only on the card
(``tests/test_torch_kernels_gpu.py``).
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
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from _torch_threads import one_torch_thread  # noqa: F401


def _assert_fw_equal(W: np.ndarray, want=None):
    D1, N1 = want if want is not None else jref.fw_counts_ref(jnp.asarray(W))
    D2, N2 = tref.fw_counts_ref(torch.from_numpy(W))
    np.testing.assert_array_equal(D2.numpy(), np.asarray(D1))
    np.testing.assert_array_equal(N2.numpy(), np.asarray(N1))


@pytest.mark.parametrize("V", [5, 8, 13, 40, 130])
@pytest.mark.parametrize("batch", [1, 3])
def test_fw_ref_bitwise_random(V, batch):
    _assert_fw_equal(testing.random_graph(V, 3 * V, seed=V, batch=batch))


@pytest.mark.parametrize("V", [13, 40])
def test_fw_ref_bitwise_disconnected(V):
    W = testing.disconnected_graph(V, seed=V, batch=3)
    _assert_fw_equal(W)
    D, N = tref.fw_counts_ref(torch.from_numpy(W))
    assert (D[:, 0, -1] == np.float32(1e9)).all() and (N[:, 0, -1] == 0).all()


def test_fw_ref_bitwise_count_clip():
    W = testing.count_clip_graph()
    _assert_fw_equal(W)
    _, N = tref.fw_counts_ref(torch.from_numpy(W))
    assert float(N[0, 1]) == np.float32(1e30)


@pytest.mark.parametrize("arch_name,config", [
    ("homog32", "baseline"), ("homog32", "placeit"),
    ("homog64", "baseline"), ("homog64", "placeit")])
def test_fw_ref_bitwise_score_graphs(arch_name, config):
    _assert_fw_equal(testing.score_graphs(arch_name, config, 2))


@pytest.mark.parametrize("V", [8, 40])
def test_fw_ref_bitwise_pallas_interpret(V):
    W = testing.random_graph(V, 3 * V, seed=V + 1, batch=2)
    _assert_fw_equal(W, jminplus.fw_counts_pallas(jnp.asarray(W),
                                                  interpret=True))


def test_wrapper_takes_plain_version_on_cpu():
    W = torch.from_numpy(testing.random_graph(13, 40, seed=2, batch=2))
    launches, calls = fwc.launches, tref.calls["fw_counts_ref"]
    D, N = ops.fw_counts(W)
    assert fwc.launches == launches
    assert tref.calls["fw_counts_ref"] == calls + 1
    D2, N2 = ops.fw_impl_ref(W)
    assert torch.equal(D, D2) and torch.equal(N, N2)
    # [V, V] squeezes like [B, V, V]
    D1, N1 = ops.fw_impl_cuda(W[0])
    assert torch.equal(D1, D[0]) and torch.equal(N1, N[0])
    assert fwc.launches == launches


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(2, 5, 5, dtype=torch.float64), TypeError),
    (torch.zeros(5), ValueError),
    (torch.zeros(2, 2, 5, 5), ValueError),
    (torch.zeros(2, 5, 4), ValueError),
    (torch.zeros(2, 5, 5).transpose(1, 2), ValueError),
])
def test_wrapper_rejects_bad_input(bad, err):
    with pytest.raises(err):
        fwc.fw_counts(bad)


def test_build_command_targets_hopper_exactly():
    compiles, link = build.build_commands()
    for cmd, src in zip(compiles, build.SOURCES):
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-fmad=false" in cmd
        assert not any("fast_math" in c or "fast-math" in c for c in cmd)
        assert cmd[-1] == str(src) and "-c" in cmd
    assert "-shared" in link and link[-len(compiles):] == [
        c[c.index("-o") + 1] for c in compiles]
    assert all(s.exists() for s in build.SOURCES)
