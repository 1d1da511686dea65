"""The CUDA kernels against their plain PyTorch versions, on the card.

The FW kernel on every case of ``repro_torch.testing.kernel_cases``
(random graphs for V in {5, 8, 13, 40, 130, 216, 480} x B in {1, 3, 16},
graphs that are not connected, the count-clip graph and real homog32/homog64
score graphs); the blocked FW kernel on every case of
``testing.tiled_cases`` (V at the tile edges, graphs that are
not connected, the count-clip graph and score graphs of the 100+-chiplet
families); the min-plus kernel on every case of ``testing.minplus_cases``
(tile and K-step edges, NaN, +-inf and negative operands) with aligned
operands and with misaligned ones (every slab by guarded copies), with a
fused C against ``ref.minplus_ref(A, B, C)``, at 1536^3 on the homog256 W
and 40 calls queued back to back; APSP on the homog100 W, a directed W and
a W with a NaN.  All must be bit for bit equal (NaN-aware where NaN can
appear: ``testing.nan_equal``), and each call must count one launch.
Both FW kernels also at the edges of the redesigned kernels (V = 1, 2 and
the 64-tile edges, every cluster-size boundary of kernel 1 and its on-chip
limit, each +-1, at B = 1 and 16, disconnected and count-clip graphs), with
kernel 1 at every cluster size it takes, and two launches bitwise equal.
The blocked kernel's work queue as the card decodes it (its traced launch)
equals ``kernels/fw_schedule.py``'s, and 80 of its calls queued back to
back at the homog256 and homog100 shapes are each bitwise.
Skips without a card; run it on the H100 with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import testing
from repro_torch.kernels import build
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
    for V in ops.dispatch_edges():
        tiled = ops.fw_takes_tiled(V)
        W = torch.from_numpy(testing.random_graph(V, 3 * V, seed=V,
                                                  batch=16)).to(cuda)
        one, blocked = fwc.launches, fwt.launches
        D, N = ops.fw_impl_tiled(W)
        assert (fwt.launches - blocked, fwc.launches - one) == (
            (1, 0) if tiled else (0, 1)), V
        D2, N2 = tref.fw_counts_ref(W)
        assert torch.equal(D, D2) and torch.equal(N, N2)


def _cluster_edges() -> list:
    """Each V where kernel 1 changes its cluster size or path (the L2 loop
    above its on-chip limit), +-1, at the scorer's B = 16."""
    lib = build.load()
    top = lib.fw_counts_onchip_max_v()
    assert top == fwc.ONCHIP_MAX_V
    sizes = [lib.fw_counts_cluster_size(V, 16) for V in range(1, top + 3)]
    edges = {V + 1 for V in range(1, top + 2) if sizes[V] != sizes[V - 1]}
    return sorted({v for e in edges for v in (e - 1, e, e + 1) if v >= 1})


# V = 1 and 2, and the edges of the 64 tile (kernel 1's lanes walk 32
# columns, so these are its chunk edges too).
EDGE_V = (1, 2, 63, 64, 65, 127, 128, 129)


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("kernel", ["fw_counts", "fw_counts_tiled"])
def test_fw_kernels_bitwise_at_the_new_edges(cuda, kernel, B):
    fn = fwc.fw_counts if kernel == "fw_counts" else fwt.fw_counts_tiled
    for V in EDGE_V + tuple(_cluster_edges()):
        W = torch.from_numpy(testing.random_graph(V, 3 * V, seed=V + B,
                                                  batch=B)).to(cuda)
        D1, N1 = fn(W)
        D2, N2 = tref.fw_counts_ref(W)
        assert torch.equal(D1, D2) and torch.equal(N1, N2), (kernel, V, B)


@pytest.mark.parametrize("kernel", ["fw_counts", "fw_counts_tiled"])
def test_fw_kernels_bitwise_disconnected_and_clip_at_the_edges(cuda, kernel):
    fn = fwc.fw_counts if kernel == "fw_counts" else fwt.fw_counts_tiled
    for V in (2, 65, 129) + tuple(_cluster_edges()[1::3]):
        W = torch.from_numpy(testing.disconnected_graph(V, seed=V,
                                                        batch=3)).to(cuda)
        D1, N1 = fn(W)
        D2, N2 = tref.fw_counts_ref(W)
        assert torch.equal(D1, D2) and torch.equal(N1, N2), (kernel, V)
    W = torch.from_numpy(testing.count_clip_graph(M=10, K=48)[None]).to(cuda)
    D1, N1 = fn(W)
    D2, N2 = tref.fw_counts_ref(W)
    assert float(N2[0, 0, 1]) == float(np.float32(1e30))
    assert torch.equal(D1, D2) and torch.equal(N1, N2)


@pytest.mark.parametrize("V", [96, 130, 216, 300, 480, 512])
def test_fw_kernel_bitwise_at_every_cluster_size(cuda, V):
    W = torch.from_numpy(testing.random_graph(V, 3 * V, seed=V,
                                              batch=16)).to(cuda)
    D2, N2 = tref.fw_counts_ref(W)
    sizes = [C for C in fwc.CLUSTER_SIZES if fwc.cluster_fits(V, C)]
    assert sizes
    for C in sizes:
        D1, N1 = fwc.launch_at_cluster(W, C)
        assert torch.equal(D1, D2) and torch.equal(N1, N2), (V, C)


@pytest.mark.parametrize("kernel", ["fw_counts", "fw_counts_tiled"])
def test_fw_kernels_two_launches_bitwise_equal(cuda, kernel):
    fn = fwc.fw_counts if kernel == "fw_counts" else fwt.fw_counts_tiled
    for arch, cfg, B in (("homog64", "placeit", 16),
                         ("homog100", "baseline", 16)):
        W = torch.from_numpy(testing.score_graphs(arch, cfg, B)).to(cuda)
        D1, N1 = fn(W)
        D2, N2 = fn(W)
        assert torch.equal(D1, D2) and torch.equal(N1, N2), (kernel, arch)


def test_fw_tiled_lookahead_and_scratch_reuse(cuda):
    """nb = 2 to 9 tile rows (every group of the keyed queue present),
    calls of several shapes in a row on one scratch, in both of the kernel's
    layouts (512 threads where B * 2 (nb - 1) <= the SMs, else 256), each
    bitwise; the counters are left zero after every call."""
    for V, B in ((130, 4), (192, 2), (300, 16), (65, 16), (552, 3),
                 (191, 1), (480, 16), (400, 12)):
        W = torch.from_numpy(testing.random_graph(V, 3 * V, seed=V,
                                                  batch=B)).to(cuda)
        D1, N1 = fwt.fw_counts_tiled(W)
        D2, N2 = tref.fw_counts_ref(W)
        assert torch.equal(D1, D2) and torch.equal(N1, N2), (V, B)
        stream = torch.cuda.current_stream(cuda).cuda_stream
        _, cnt = fwt._scratch[(W.device.index, stream)]
        assert int(cnt.abs().sum()) == 0


def test_fw_tiled_trace_records_every_item(cuda):
    """The traced launch leaves the result bitwise and times every work
    item: dequeued <= waits met <= done, on a block of the grid."""
    W = torch.from_numpy(testing.random_graph(300, 900, seed=3,
                                              batch=4)).to(cuda)
    launches = fwt.launches
    D1, N1, tr = fwt.launch_traced(W)
    assert fwt.launches == launches + 1
    D2, N2 = tref.fw_counts_ref(W)
    assert torch.equal(D1, D2) and torch.equal(N1, N2)
    t = tr.cpu()
    assert t.shape == (fwt.queue_items(4, 300), fwt.TRACE_COLS)
    assert (t[:, 0] > 0).all()
    assert (t[:, 1] >= t[:, 0]).all() and (t[:, 2] >= t[:, 1]).all()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (t[:, 3] >= 0).all() and (t[:, 3] < 2 * sms).all()


# (B, V): nb = 1, 2, 3, 4, 5, 9 and 24 tile rows (homog256's V = 1536).
QUEUE_SHAPES = ((1, 64), (3, 40), (1, 128), (4, 100), (1, 192), (2, 130),
                (16, 256), (5, 300), (1, 576), (1, 1536))


@pytest.mark.parametrize("B,V", QUEUE_SHAPES)
def test_fw_tiled_queue_matches_fw_schedule(cuda, B, V):
    """The kernel decodes its work queue as ``fw_schedule.queue`` lists
    it (the Python copy that the CPU tests run under adversarial
    interleavings): every item's kind, pivot block, placement, tile and
    whether it stores the diagonal, in queue order."""
    from repro_torch.kernels import fw_schedule as fs
    W = torch.from_numpy(testing.random_graph(V, 3 * V, seed=V,
                                              batch=B)).to(cuda)
    D1, N1, tr = fwt.launch_traced(W)
    D2, N2 = tref.fw_counts_ref(W)
    assert torch.equal(D1, D2) and torch.equal(N1, N2)
    nb = -(-V // fwt.BT)
    want = [(0 if it.kind == "A" else 1, it.m, it.b, it.i, it.j,
             int(it.kind == "A" and fs.keeps_diag(it, nb)))
            for it in fs.queue(B, nb)]
    got = [tuple(r) for r in tr[:, 4:].cpu().tolist()]
    assert got == want


def test_fw_tiled_many_back_to_back_calls(cuda):
    """Calls at the homog256 placeit and homog100 baseline shapes, traced
    and untraced in turn, queued back to back on one stream with no sync
    between them: each result bitwise equal to the plain FW's, and the
    counters left zero (a stalled queue would fail the launch)."""
    shapes = [testing.score_graphs("homog256", "placeit", 1),
              testing.score_graphs("homog100", "baseline", 16)]
    Ws = [torch.from_numpy(x).to(cuda) for x in shapes]
    wants = [tref.fw_counts_ref(W) for W in Ws]
    outs = []
    for r in range(40):
        for k, W in enumerate(Ws):
            if r % 4 == 3:
                outs.append((k, fwt.launch_traced(W)[:2]))
            else:
                outs.append((k, fwt.fw_counts_tiled(W)))
    torch.cuda.synchronize()
    for k, (D, N) in outs:
        assert torch.equal(D, wants[k][0]) and torch.equal(N, wants[k][1])
    stream = torch.cuda.current_stream(cuda).cuda_stream
    _, cnt = fwt._scratch[(Ws[0].device.index, stream)]
    assert int(cnt.abs().sum()) == 0


def test_fw_tiled_kernel_no_host_sync(cuda):
    W = torch.from_numpy(testing.score_graphs("homog100", "placeit",
                                              4)).to(cuda)
    fwt.fw_counts_tiled(W)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fwt.fw_counts_tiled(W)
        fwc.fw_counts(W[:, :200, :200].contiguous())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", list(MINPLUS))
def test_minplus_kernel_bitwise(cuda, name):
    A, B = (torch.from_numpy(x).to(cuda) for x in MINPLUS[name]())
    launches = mp.launches
    out = mp.minplus(A, B)
    torch.cuda.synchronize()
    assert mp.launches == launches + 1
    assert testing.nan_equal(out, tref.minplus_ref(A, B)), name


def test_apsp_matches_fw_distances(cuda):
    W = torch.from_numpy(testing.score_graphs("homog100", "placeit", 1)[0])
    W = W.to(cuda)
    launches = mp.launches
    D = ops.apsp(W)
    assert mp.launches == launches + tref.apsp_squarings(W.shape[-1])
    assert torch.equal(D, tref.fw_counts_ref(W)[0])
    assert torch.equal(D, tref.apsp_ref(W))


# -- the redesigned min-plus kernel: both stagings, NaN, the fused C -------

def _misaligned(X: torch.Tensor) -> torch.Tensor:
    """X's values in a contiguous tensor whose data lies 4 bytes past a
    16-byte boundary (so the kernel takes its guarded copies)."""
    buf = torch.empty(X.numel() + 1, dtype=X.dtype, device=X.device)
    Y = buf[1:].view(X.shape)
    Y.copy_(X)
    assert Y.is_contiguous() and Y.data_ptr() % 16 == 4
    return Y


@pytest.mark.parametrize("name", list(MINPLUS))
def test_minplus_guarded_copies_bitwise(cuda, name):
    """Every case with A and B misaligned: every slab by guarded copies."""
    A, B = (_misaligned(torch.from_numpy(x).to(cuda))
            for x in MINPLUS[name]())
    launches = mp.launches
    out = mp.minplus(A, B)
    torch.cuda.synchronize()
    assert mp.launches == launches + 1
    assert testing.nan_equal(out, tref.minplus_ref(A, B)), name


def _fused_operands(M, K, N, seed):
    A, B = testing.minplus_special(M, K, N, "negative", seed=seed)
    rng = np.random.default_rng(seed)
    C = (20 * rng.random((M, N)) - 5).astype(np.float32)
    C[rng.random((M, N)) < 0.2] = np.float32(1e9)
    C[rng.random((M, N)) < 0.05] = np.inf
    C[rng.integers(M, size=3), rng.integers(N, size=3)] = np.nan
    return A, B, C


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("shape", [(70, 40, 90), (192, 160, 288),
                                   (97, 33, 95), (1, 1536, 200)])
def test_minplus_fused_c_bitwise(cuda, shape, misaligned):
    A, B, C = (torch.from_numpy(x).to(cuda)
               for x in _fused_operands(*shape, seed=sum(shape)))
    if misaligned:
        A, B, C = map(_misaligned, (A, B, C))
    launches = mp.launches
    out = mp.minplus(A, B, C)
    torch.cuda.synchronize()
    assert mp.launches == launches + 1
    assert testing.nan_equal(out, tref.minplus_ref(A, B, C))
    assert testing.nan_equal(out, torch.minimum(C, tref.minplus_ref(A, B)))


def test_minplus_homog256_1536(cuda):
    W = torch.from_numpy(testing.score_graphs("homog256", "placeit",
                                              1)[0]).to(cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    out = mp.minplus(W, W)
    torch.cuda.synchronize()
    assert W.shape == (1536, 1536)
    assert torch.equal(out, tref.minplus_ref(W, W))
    assert mp.tile_fill(1536, 1536, sms)["share"] >= 0.9


def test_apsp_directed_graph(cuda):
    W = torch.from_numpy(testing.directed_graph(300, 900, seed=4)).to(cuda)
    assert not torch.equal(W, W.t())
    W0 = W.clone()
    launches = mp.launches
    D = ops.apsp(W)
    torch.cuda.synchronize()
    assert mp.launches == launches + tref.apsp_squarings(300)
    assert torch.equal(W, W0)
    assert torch.equal(D, tref.apsp_ref(W))
    assert torch.equal(D, tref.fw_counts_ref(W[None])[0][0])


def test_apsp_with_nan_propagates(cuda):
    W = torch.from_numpy(testing.random_graph(130, 400, seed=6)[0])
    W[7, 9] = float("nan")
    W = W.to(cuda)
    D = ops.apsp(W)
    assert testing.nan_equal(D, tref.apsp_ref(W))
    assert torch.isnan(D[7]).all()


def test_minplus_many_back_to_back_calls(cuda):
    """40 calls queued without a sync between them, alternating shapes,
    aligned and misaligned operands and the fused C: each output
    bitwise."""
    ops_in = [[torch.from_numpy(x).to(cuda) for x in _fused_operands(
        *shape, seed=sum(shape))] for shape in ((192, 160, 288),
                                                 (97, 33, 95))]
    ops_in += [list(map(_misaligned, ops_in[0]))]
    outs = []
    for n in range(40):
        A, B, C = ops_in[n % 3]
        outs.append(mp.minplus(A, B, C if n % 4 < 2 else None))
    torch.cuda.synchronize()
    for n, out in enumerate(outs):
        A, B, C = ops_in[n % 3]
        want = tref.minplus_ref(A, B, C if n % 4 < 2 else None)
        assert testing.nan_equal(out, want), n
