"""The scans' backward kernels on the card.

- ``selective_scan_bwd`` (``csrc/selective_scan_bwd.cu``) and
  ``rglru_scan_bwd`` (``csrc/rglru_scan_bwd.cu``) against
  ``ref.selective_scan_bwd_ref`` / ``ref.rglru_bwd_ref`` on the card, on
  every ``testing.scan_cases()`` case in float32 and bfloat16, with a
  random dh_final, within ``testing.SCAN_BWD_LIMITS["cases"]``; without a
  dh_final as well; one launch counted a call; two calls bit for bit.
- The selective scan's backward where its tensor-map boxes run past the
  channels (Di = 8, 56, 72, 200) and the steps (S = 37), staged by tensor
  maps (the library says so), and at Di = 45 by plain loads.
- RG-LRU's backward where a is 0, 1 and above 1 (``testing.
  rglru_edge_operands``) in both dtypes: da's NaN and +-inf in the plain
  version's places, the finite entries within the same limit.
- The forward kernels' y and h_final keep their bits when the autograd
  Function asks for the states the backward needs; the selective scan's
  chunk-boundary states equal the final states of the sequence cut at each
  chunk's start (h0 first), RG-LRU's float32 states round to its output.
- The wrappers under grad launch the forward and the backward kernel, and
  call no plain version; under ``torch.no_grad`` only the forward.

Skips without a card; run it on the H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_scan_bwd_gpu.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import testing
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import rglru_scan_bwd as trb
from repro_torch.kernels import selective_scan as tss
from repro_torch.kernels import selective_scan_bwd as tsb

pytestmark = pytest.mark.gpu

CASES = testing.scan_cases()
DTYPES = ("float32", "bfloat16")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(name, dtype, dev, dhf=True):
    """The case's operands on the card (x and dt, or x and a, in
    ``dtype``), an output gradient in that dtype and a float32 dh_final
    (None without ``dhf``)."""
    args = [None if a is None else torch.from_numpy(a).to(dev)
            for a in CASES[name]()]
    dt = getattr(torch, dtype)
    args[0], args[1] = args[0].to(dt), args[1].to(dt)
    rng = np.random.default_rng(11)
    dy = torch.from_numpy(rng.standard_normal(
        tuple(args[0].shape), dtype=np.float32)).to(dev).to(dt)
    state = ((args[0].shape[0], args[0].shape[2])
             + ((args[2].shape[1],) if name.startswith("selective") else ()))
    dhf = (torch.from_numpy(rng.standard_normal(state, dtype=np.float32))
           .to(dev) if dhf else None)
    return args, dy, dhf


def _bwd(name, args, dy, dhf):
    """(the backward module, its kernel's gradients from the states the
    forward kernel writes, the plain version's)."""
    if name.startswith("selective"):
        states = tss._launch(*tss._on_card(*args), states=True)[2]
        return (tsb, tsb.selective_scan_bwd(*args, dy, dhf, states=states),
                tref.selective_scan_bwd_ref(*args, dy, dhf))
    states = trg._launch(*trg._on_card(*args), states=True)[2]
    return (trb, trb.rglru_scan_bwd(*args, dy, dhf, states=states),
            tref.rglru_bwd_ref(*args, dy, dhf))


@pytest.mark.parametrize("dhf", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(CASES))
def test_backward_kernel_matches_plain(cuda, name, dtype, dhf):
    args, dy, dhf_ = _case(name, dtype, cuda, dhf)
    mod = tsb if name.startswith("selective") else trb
    before = mod.launches
    _, got, want = _bwd(name, args, dy, dhf_)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    again = _bwd(name, args, dy, dhf_)[1]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, b in zip(got, want):
        _, share = testing.scan_bwd_share(a, b, "cases")
        assert share <= 1.0, f"{share:.3f} of the limit"


@pytest.mark.parametrize("Di", [8, 56, 72, 200, 45])
def test_selective_backward_tensor_map_edges(cuda, Di):
    """The kernel's tensor-map staging where its boxes run past the
    operands: channel counts (multiples of 8, so the rows stay 16-byte
    aligned and the boxes must be used) short of one block
    (``selective_scan_bwd_block_channels()``), one box short of it, one box
    past it and ragged over several, S = 37 (inside a chunk), bfloat16 x
    and dt: within the cases' limit, bit for bit twice, staged by tensor
    maps; Di = 45 (rows of 90 bytes) staged by plain loads."""
    from repro_torch.kernels import build
    lib = build.load()
    span = lib.selective_scan_bwd_block_channels()
    assert Di % span
    args = [None if a is None else torch.from_numpy(a).to(cuda)
            for a in testing.sscan_operands(2, 37, Di, 16, seed=Di,
                                            h0=True)]
    args[0], args[1] = (a.to(torch.bfloat16) for a in args[:2])
    rng = np.random.default_rng(Di)
    dy = torch.from_numpy(rng.standard_normal(
        (2, 37, Di), dtype=np.float32)).to(cuda).to(torch.bfloat16)
    dhf = torch.from_numpy(rng.standard_normal(
        (2, Di, 16), dtype=np.float32)).to(cuda)
    _, got, want = _bwd("selective", args, dy, dhf)
    assert lib.selective_scan_bwd_tensor_maps() == (Di % 8 == 0)
    again = _bwd("selective", args, dy, dhf)[1]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, b in zip(got, want):
        _, share = testing.scan_bwd_share(a, b, "cases")
        assert share <= 1.0, f"{share:.3f} of the limit"


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_backward_at_a_equal_one_and_above(cuda, dtype):
    dt = getattr(torch, dtype)
    above = 2.0 ** -8 if dtype == "float32" else 2.0 ** -7
    x, a, h0, dy, dhf = (torch.from_numpy(t).to(cuda) for t in
                         testing.rglru_edge_operands(above=above))
    args = [x.to(dt), a.to(dt), h0]
    assert (args[1] > 1).any() and (args[1] == 1).any()
    _, got, want = _bwd("rglru", args, dy.to(dt), dhf)
    da = want[1].float()
    assert da.isnan().any() and (da == -math.inf).any() \
        and (da == math.inf).any()
    for g, w, what in zip(got, want, ("dx", "da", "dh0")):
        e, share = testing.scan_bwd_share(g, w, "cases")
        assert share <= 1.0, f"{what}: {e:.3g}, {share:.3f} of the limit"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["selective", "rglru"])
def test_forward_bits_unchanged_with_states(cuda, kernel, dtype):
    name = next(n for n in CASES if n.startswith(kernel) and "S=130" in n)
    args, _, _ = _case(name, dtype, cuda)
    if kernel == "selective":
        ops_ = tss._on_card(*args)
        y, hf, none = tss._launch(*ops_)
        y2, hf2, hb = tss._launch(*ops_, states=True)
        assert none is None
        assert torch.equal(y, y2) and torch.equal(hf, hf2)
        assert torch.equal(hb[:, 0], ops_[-1])
        for k in range(1, hb.shape[1]):
            cut = [a[:, :k * tss.CHUNK].contiguous() if i in (0, 1, 3, 4)
                   else a for i, a in enumerate(ops_)]
            assert torch.equal(hb[:, k], tss._launch(*cut)[1]), k
    else:
        ops_ = trg._on_card(*args)
        y, hf, none = trg._launch(*ops_)
        y2, hf2, h32 = trg._launch(*ops_, states=True)
        assert none is None
        assert torch.equal(y, y2) and torch.equal(hf, hf2)
        assert h32.dtype == torch.float32
        assert torch.equal(h32.to(y.dtype), y)
        assert torch.equal(h32[:, -1], hf)


@pytest.mark.parametrize("kernel", ["selective", "rglru"])
def test_scans_launch_both_kernels_under_grad(cuda, kernel):
    name = next(n for n in CASES if n.startswith(kernel) and "h0=True" in n)
    args, dy, dhf = _case(name, "bfloat16", cuda)
    fwd, bwd = (tss, tsb) if kernel == "selective" else (trg, trb)
    fn = ops.selective_scan if kernel == "selective" else ops.rglru_scan
    for a in args:
        a.requires_grad_()
    tref.calls.clear()
    n_fwd, n_bwd = fwd.launches, bwd.launches
    y, hf = fn(*args)
    grads = torch.autograd.grad((y, hf), args, (dy, dhf))
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (n_fwd + 1, n_bwd + 1)
    assert sum(tref.calls.values()) == 0
    assert all(g.dtype == a.dtype for g, a in zip(grads, args))
    with torch.no_grad():
        fn(*args)
    assert (fwd.launches, bwd.launches) == (n_fwd + 2, n_bwd + 1)
