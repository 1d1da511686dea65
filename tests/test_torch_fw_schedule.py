"""The blocked FW kernel's work queue (``kernels/fw_schedule.py``) and its
plain model ``ref.fw_counts_tiled_sched_ref``, on the CPU.

The queue must hold every pivot block's updates exactly once, in an order
where every wait of an item is met by items before it; the lookahead
segments must come where the kernel's comment says.  The model runs the
queue as 1 to 16 blocks of one persistent launch would, with adversarial
interleavings, and must be bit for bit equal to both packages' plain FW
and to the Pallas blocked kernel in interpret mode, at tile edges, on
graphs that are not connected and past the count clip.  The kernel itself
runs only on the card (``tests/test_torch_kernels_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import minplus as jminplus
from repro.kernels import ref as jref
from repro_torch import testing
from repro_torch.kernels import fw_schedule as fs
from repro_torch.kernels import ref as tref
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("B,nb", [(1, 1), (3, 1), (1, 2), (2, 3), (1, 4),
                                  (3, 5), (1, 7)])
def test_queue_holds_every_update_once(B, nb):
    q = fs.queue(B, nb)
    assert len(q) == fs.total(B, nb) and fs.decode(len(q), B, nb) is None
    for b in range(B):
        for m in range(nb):
            a = sorted((it.i, it.j) for it in q
                       if it.kind == "A" and it.b == b and it.m == m)
            if nb == 1:
                assert a == [(0, 0)]
            else:
                assert a == sorted([(m, p) for p in range(nb) if p != m]
                                   + [(p, m) for p in range(nb) if p != m])
            outer = sorted((it.i, it.j) for it in q
                           if it.kind == "B" and it.b == b and it.m == m)
            assert outer == [(i, j) for i in range(nb) for j in range(nb)
                             if i != m and j != m]
            keep = [it for it in q if it.kind == "A" and it.b == b
                    and it.m == m and fs.keeps_diag(it, nb)]
            last = [it for it in q if it.kind == "A" and it.b == b
                    and it.m == m][-1]
            assert keep == [last]


@pytest.mark.parametrize("B,nb", [(1, 2), (2, 3), (1, 5), (3, 6)])
def test_every_wait_is_met_by_earlier_items(B, nb):
    """Completing the items in queue order, each item's waits already hold
    when it is dequeued (the diagonal's keeper: once its own placement's
    A items of the pivot block, all before it, have loaded)."""
    nA, n_out = fs.n_a(nb), fs.n_outer(nb)
    a_loaded, b_done = np.zeros((B, nb), int), np.zeros((B, nb), int)
    ver = np.zeros((B, nb, nb), int)
    for it in fs.queue(B, nb):
        m, b = it.m, it.b
        if it.kind == "A":
            assert m < 3 or b_done[b, m - 3] == n_out
            assert ver[b, m, m] >= m and ver[b, it.i, it.j] >= m
            a_loaded[b, m] += 1
            ver[b, it.i, it.j] = m + 1
            if fs.keeps_diag(it, nb):
                assert a_loaded[b, m] == nA
                ver[b, m, m] = m + 1
        else:
            assert ver[b, it.i, m] >= m + 1 and ver[b, m, it.j] >= m + 1
            assert ver[b, it.i, it.j] == m
            ver[b, it.i, it.j] = m + 1
            b_done[b, m] += 1
    assert (ver == nb).all()


def test_lookahead_segments_come_first():
    B, nb = 2, 6
    q = fs.queue(B, nb)
    seen_a = set()
    for e, it in enumerate(q):
        if it.kind == "A":
            seen_a.add(it.m)
            if it.m >= 1:
                # Every tile of row or column m of B(m - 1) is before A(m).
                prev = [x for x in q[:e] if x.kind == "B" and x.m == it.m - 1
                        and it.m in (x.i, x.j) and x.b == it.b]
                assert len(prev) == fs.n_lookahead(nb, it.m - 1)
    # The rest of B(m) lists its tiles in row or column m + 2 first.
    for m in range(nb - 2):
        rest = [fs.rest_tile(nb, m, t) for t in range(
            fs.n_outer(nb) - fs.n_lookahead(nb, m))]
        head = rest[:2 * (nb - 2) - 1]
        assert all(m + 2 in t for t in head)
        assert not any(m + 2 in t for t in rest[len(head):])
        assert not any(m in t or m + 1 in t for t in rest)
    assert seen_a == set(range(nb))


@pytest.mark.parametrize("bt", [4, 16])
@pytest.mark.parametrize("edge", ["bt-1", "bt", "bt+1", "2bt+3", "3bt+1"])
@pytest.mark.parametrize("blocks,seed", [(1, None), (2, 0), (5, 1), (16, 2)])
def test_sched_ref_bitwise_at_tile_edges(bt, edge, blocks, seed):
    V = {"bt-1": bt - 1, "bt": bt, "bt+1": bt + 1, "2bt+3": 2 * bt + 3,
         "3bt+1": 3 * bt + 1}[edge]
    W = torch.from_numpy(testing.random_graph(V, 3 * V, seed=V, batch=3))
    D1, N1 = tref.fw_counts_ref(W)
    D2, N2 = tref.fw_counts_tiled_sched_ref(W, bt, blocks, seed)
    assert torch.equal(D1, D2) and torch.equal(N1, N2)


@pytest.mark.parametrize("V", [13, 41])
def test_sched_ref_bitwise_disconnected(V):
    W = torch.from_numpy(testing.disconnected_graph(V, seed=V, batch=2))
    D1, N1 = tref.fw_counts_ref(W)
    D2, N2 = tref.fw_counts_tiled_sched_ref(W, 8, blocks=7, seed=V)
    assert torch.equal(D1, D2) and torch.equal(N1, N2)
    assert (D2 == 1e9).any() and (N2 == 0).any()


def test_sched_ref_bitwise_count_clip():
    W = testing.count_clip_graph()
    D1, N1 = jref.fw_counts_ref(jnp.asarray(W))
    D2, N2 = tref.fw_counts_tiled_sched_ref(torch.from_numpy(W), 64,
                                            blocks=9, seed=3)
    np.testing.assert_array_equal(D2.numpy(), np.asarray(D1))
    np.testing.assert_array_equal(N2.numpy(), np.asarray(N1))
    assert float(N2[0, 1]) == np.float32(1e30)


# Cases of tests/test_kernels.py::test_fw_counts_tiled_bitforbit.
@pytest.mark.parametrize("V,edges,batch,bt", [
    (8, 12, 1, 4), (13, 30, 2, 4), (40, 120, 2, 16), (5, 0, 1, 4)])
def test_sched_ref_bitwise_pallas_interpret(V, edges, batch, bt):
    W = testing.random_graph(V, edges, seed=V + edges, batch=batch)
    D1, N1 = jminplus.fw_counts_tiled_pallas(jnp.asarray(W), bt=bt,
                                             interpret=True)
    D2, N2 = tref.fw_counts_tiled_sched_ref(torch.from_numpy(W), bt,
                                            blocks=4, seed=V)
    np.testing.assert_array_equal(D2.numpy(), np.asarray(D1))
    np.testing.assert_array_equal(N2.numpy(), np.asarray(N1))


def test_sched_ref_counts_by_pivot_block():
    """Sixteen blocks, eight tile rows: an interleaving where items of a
    later pivot block load before the last of an earlier one, so that a
    count over all pivot blocks would let the diagonal's keeper store it
    before every A item has loaded it (a fault of an earlier draft of the
    queue, found by this model)."""
    W = torch.from_numpy(testing.random_graph(29, 87, seed=29, batch=2))
    D1, N1 = tref.fw_counts_ref(W)
    D2, N2 = tref.fw_counts_tiled_sched_ref(W, 4, blocks=16, seed=7)
    assert torch.equal(D1, D2) and torch.equal(N1, N2)


def test_sched_ref_buffer_reuse_waits():
    """64 blocks, twelve tile rows: an interleaving where a B item of pivot
    block m lags until A(m + 3) refills the snapshot buffer it reads,
    unless A(m + 3) waits for every B(m) item of its placement."""
    W = torch.from_numpy(testing.random_graph(45, 135, seed=45))
    D1, N1 = tref.fw_counts_ref(W)
    D2, N2 = tref.fw_counts_tiled_sched_ref(W, 4, blocks=64, seed=3)
    assert torch.equal(D1, D2) and torch.equal(N1, N2)


def test_sched_ref_runs_with_one_block_in_order():
    """One block runs the queue in order: the waits never block it (no
    deadlock however few blocks the card holds)."""
    W = torch.from_numpy(testing.random_graph(30, 90, seed=4, batch=2))
    D1, N1 = tref.fw_counts_ref(W)
    D2, N2 = tref.fw_counts_tiled_sched_ref(W, 8, blocks=1, seed=11)
    assert torch.equal(D1, D2) and torch.equal(N1, N2)
