"""The scan kernels and the recurrent serving paths on the card.

The selective-scan and RG-LRU kernels on every case of
``repro_torch.testing.scan_cases``, in float32 and bfloat16 (x, and dt or
a, rounded to bfloat16; the rest float32), against their plain versions
on the card, with one launch counted per call: float32 to the JAX tests'
rtol = atol = 3e-5 (the kernels use fused multiply-adds and sum the
states in another order), bfloat16 outputs to 2e-2 (both sum in float32
and round once; one bfloat16 ulp where they straddle a rounding
boundary), the float32 final states to 3e-5.  A sequence split across two
kernel calls equals one call.  The edges of the kernels' geometry
(``selective_scan.CHUNK`` / ``BLOCK_CHANNELS``, ``rglru_scan.CHUNK`` /
``BLOCK_CHANNELS``): sequences shorter than one chunk and ending one step
into a chunk, widths that end inside a block (16-byte and plain-load
staging), N = 5, three batch rows, a sequence split bit for bit at a chunk
edge and inside a chunk, and 80 calls at both serve shapes queued back to
back with every output checked.  Then reduced falcon-mamba-7b and
recurrentgemma-9b prefills and decode steps on the card against the same
models on the CPU (float32, rtol = atol = 2e-4, the CPU parity tests'
tolerance), through the kernels only.  Skips without a card; run it on
the H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_scan_gpu.py
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch import testing
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import selective_scan as tss
from repro_torch.launch import kernel_timing as kt

pytestmark = pytest.mark.gpu

CASES = testing.scan_cases()
DTYPES = ("float32", "bfloat16")
Y_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
H_TOL = 3e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    # The plain versions' float32 products must not run in TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(name, dtype, dev):
    """The case's operands on the card; the first two (x and dt, or x and
    a) in ``dtype``, the rest float32."""
    arrays = CASES[name]()
    out = [None if a is None else torch.from_numpy(a).to(dev)
           for a in arrays]
    out[0] = out[0].to(getattr(torch, dtype))
    out[1] = out[1].to(getattr(torch, dtype))
    return out


def _call(name, args):
    """(kernel output, plain output) of the case's scan on ``args``."""
    if name.startswith("selective_scan"):
        return ops.selective_scan(*args), tref.selective_scan_ref(*args)
    return ops.rglru_scan(*args), tref.rglru_ref(*args)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(CASES))
def test_scan_kernel_matches_plain(cuda, name, dtype):
    args = _operands(name, dtype, cuda)
    mod = tss if name.startswith("selective_scan") else trg
    launches = mod.launches
    (y, h), (yw, hw) = _call(name, args)
    torch.cuda.synchronize()
    assert mod.launches == launches + 1
    assert y.dtype == args[0].dtype and h.dtype == torch.float32
    assert y.shape == yw.shape and h.shape == hw.shape
    tol = Y_TOL[dtype]
    assert_allclose(y.float().cpu().numpy(), yw.float().cpu().numpy(),
                    rtol=tol, atol=tol)
    assert_allclose(h.cpu().numpy(), hw.cpu().numpy(), rtol=H_TOL,
                    atol=H_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["selective_scan", "rglru"])
def test_scan_kernel_carries_state(cuda, kernel, dtype):
    name = next(n for n in CASES if n.startswith(kernel) and "S=130" in n)
    args = _operands(name, dtype, cuda)
    (y_full, h_full), _ = _call(name, args)
    # Split the sequence operands after 45 steps: x and dt or a, and the
    # selective scan's B and C.
    seq = (0, 1, 3, 4) if kernel == "selective_scan" else (0, 1)
    first = [a[:, :45] if i in seq else a for i, a in enumerate(args)]
    rest = [a[:, 45:] if i in seq else a for i, a in enumerate(args)]
    (y1, h1), _ = _call(name, first)
    rest[-1] = h1
    (y2, h2), _ = _call(name, rest)
    torch.cuda.synchronize()
    assert torch.allclose(torch.cat([y1, y2], 1).float(), y_full.float(),
                          rtol=1e-6, atol=1e-6)
    assert torch.allclose(h2, h_full, rtol=1e-6, atol=1e-6)


def _edge_cases() -> dict:
    """Named operand factories at the edges of the kernels' geometry:
    S < one chunk, S one step into the second and third chunks, widths
    past a block's multiple (a multiple of 8: 16-byte staging; odd: plain
    loads), N = 5 and three batch rows."""
    cs, bs = tss.CHUNK, tss.BLOCK_CHANNELS
    cr, br = trg.CHUNK, trg.BLOCK_CHANNELS
    specs = [
        ("selective_scan", dict(Bt=1, S=cs // 2 + 1, Di=bs, N=16)),
        ("selective_scan", dict(Bt=1, S=cs + 1, Di=2 * bs + 8, N=16)),
        ("selective_scan", dict(Bt=2, S=2 * cs + 1, Di=3 * bs + 5, N=16,
                                h0=True)),
        ("selective_scan", dict(Bt=3, S=cs - 1, Di=bs + 8, N=5, h0=True)),
        ("selective_scan", dict(Bt=3, S=3 * cs, Di=2 * bs, N=5)),
        ("rglru", dict(B=1, S=cr // 2 + 3, D=br)),
        ("rglru", dict(B=1, S=cr + 1, D=2 * br + 8)),
        ("rglru", dict(B=2, S=2 * cr + 1, D=3 * br + 5, h0=True)),
        ("rglru", dict(B=3, S=cr - 1, D=br + 8, h0=True)),
        ("rglru", dict(B=3, S=7 * cr, D=2 * br)),
    ]
    cases = {}
    for i, (kernel, kw) in enumerate(specs):
        make = (testing.sscan_operands if kernel == "selective_scan"
                else testing.rglru_operands)
        name = kernel + " " + " ".join(f"{k}={v}" for k, v in kw.items())
        cases[name] = (lambda make=make, kw=kw, i=i:
                       make(**kw, seed=300 + i))
    return cases


EDGES = _edge_cases()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(EDGES))
def test_scan_kernel_geometry_edges(cuda, name, dtype):
    args = [None if a is None else torch.from_numpy(a).to(cuda)
            for a in EDGES[name]()]
    args[0], args[1] = (t.to(getattr(torch, dtype)) for t in args[:2])
    (y, h), (yw, hw) = _call(name, args)
    torch.cuda.synchronize()
    tol = Y_TOL[dtype]
    assert_allclose(y.float().cpu().numpy(), yw.float().cpu().numpy(),
                    rtol=tol, atol=tol)
    assert_allclose(h.cpu().numpy(), hw.cpu().numpy(), rtol=H_TOL,
                    atol=H_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["selective_scan", "rglru"])
def test_scan_kernel_split_at_chunk_edges_is_exact(cuda, kernel, dtype):
    """A sequence cut at a chunk edge, one step past it and inside a
    chunk: the two calls' outputs and final state equal one call's bit
    for bit (every recurrence is the same fmaf sequence from h0)."""
    if kernel == "selective_scan":
        chunk, arrays = tss.CHUNK, testing.sscan_operands(2, 200, 40, 16,
                                                          seed=7, h0=True)
        seq = (0, 1, 3, 4)
    else:
        chunk, arrays = trg.CHUNK, testing.rglru_operands(2, 200, 72,
                                                          seed=8, h0=True)
        seq = (0, 1)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    args[0], args[1] = (t.to(getattr(torch, dtype)) for t in args[:2])
    (y_full, h_full), _ = _call(kernel, args)
    for cut in (chunk, chunk + 1, chunk // 2 + 3, 2 * chunk):
        first = [a[:, :cut] if i in seq else a for i, a in enumerate(args)]
        rest = [a[:, cut:] if i in seq else a for i, a in enumerate(args)]
        (y1, h1), _ = _call(kernel, first)
        rest[-1] = h1
        (y2, h2), _ = _call(kernel, rest)
        torch.cuda.synchronize()
        assert torch.equal(torch.cat([y1, y2], 1), y_full), cut
        assert torch.equal(h2, h_full), cut


def test_scan_kernels_many_back_to_back_calls(cuda):
    """80 calls of each scan at its serve shape, two operand sets in turn,
    queued on one stream with no sync between them: each output bitwise
    equal to its set's first output, and that within chip_smoke.py's
    FULL_LIMIT (outputs) and 3e-5 (final states) of the plain version, so
    a fault in the kernels' ring or hand-offs shows up."""
    rtol, atol = 2.0 ** -6, 1e-5
    for kernel in ("selective_scan", "rglru"):
        sets = [kt.scan_serve_operands(
            "selective_scan" if kernel == "selective_scan" else "rglru_scan",
            2048, cuda, seed=s, h0=True) for s in (1, 2)]
        fn = ops.selective_scan if kernel == "selective_scan" else \
            ops.rglru_scan
        outs = [(i % 2, fn(*sets[i % 2])) for i in range(80)]
        torch.cuda.synchronize()
        for k in (0, 1):
            y0, h0 = outs[k][1]
            _, (yw, hw) = _call(kernel, sets[k])
            assert torch.allclose(y0.float(), yw.float(), rtol=rtol,
                                  atol=atol), kernel
            assert torch.allclose(h0, hw, rtol=H_TOL, atol=H_TOL), kernel
        for k, (y, h) in outs:
            assert torch.equal(y, outs[k][1][0]), kernel
            assert torch.equal(h, outs[k][1][1]), kernel


def test_scan_kernels_refuse_what_they_do_not_take(cuda):
    x, dt, A, B, C, D, _ = testing.sscan_operands(1, 6, 8, 4)
    x, dt, A, B, C, D = (torch.from_numpy(a).to(cuda)
                         for a in (x, dt, A, B, C, D))
    with pytest.raises(ValueError):
        ops.selective_scan(x, dt, torch.zeros(8, 17, device=cuda),
                           B, C, D)
    with pytest.raises(ValueError):
        ops.selective_scan(x, dt, A, B.cpu(), C, D)
    with pytest.raises(TypeError):
        ops.rglru_scan(x, dt.to(torch.bfloat16))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_reduced_model_on_card_matches_cpu(cuda, arch):
    from repro_torch.models.model import LM
    cfg = get_config(arch).reduced()
    cpu = LM(cfg, "cpu", torch.Generator().manual_seed(0))
    card = LM(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(3, cfg.vocab, size=(2, 40))).long()
    kernel = tss if arch == "falcon-mamba-7b" else trg
    before = kernel.launches
    lc, cc = cpu.prefill({"tokens": toks}, 64)
    lg, cg = card.prefill({"tokens": toks.to(cuda)}, 64)
    assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=2e-4, atol=2e-4)
    lens = torch.tensor([40, 35], dtype=torch.int32)
    nxt = lc.argmax(-1)[:, None]
    for _ in range(3):
        lc = cpu.decode_step({"tokens": nxt, "lengths": lens}, cc)
        lg = card.decode_step({"tokens": nxt.to(cuda),
                               "lengths": lens.to(cuda)}, cg)
        assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=2e-4, atol=2e-4)
        nxt, lens = lc.argmax(-1)[:, None], lens + 1
    # One scan launch per recurrent layer of the card's prefill: four
    # mamba layers; two rec sub-blocks of the super-block and the rec tail.
    assert kernel.launches - before == {"falcon-mamba-7b": 4,
                                        "recurrentgemma-9b": 3}[arch]
