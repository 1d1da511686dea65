"""The work queue of the blocked FW kernel (``csrc/fw_counts_tiled.cu``),
in plain Python: the items, their order and what each waits for.

The kernel runs one persistent launch whose blocks take items in queue
order.  For a call with B placements and nb = Vt / BT tile rows:

* ``A(m, b, tile)``, fused phases 1 and 2: the diagonal tile (m, m) of
  placement b and one panel tile, (m, p) (row panel) or (p, m) (column
  panel), p != m; 2 (nb - 1) items a placement and pivot block (the
  diagonal alone when nb = 1).  The last of them in the queue (the column
  panel with the largest p) stores the diagonal.
* ``B(m, b, i, j)``, phase 3: the outer tile (i, j), i != m != j.

Queue order, for m = 0 .. nb: A(m) (m < nb); the rest of B(m - 1)
(m >= 1), its tiles in row or column m + 1 first; B(m)'s tiles in row or
column m + 1 (m + 1 < nb), which are all that A(m + 1) needs.  Within a
segment, item e is placement e % B of tile e / B.

Waits (each on items earlier in the queue, so the queue cannot
deadlock), with a tile's version = the pivot blocks done on it:

* A(m): every B(m - 3) item of the placement done (the snapshot buffer
  m % 3 is free), versions of (m, m) and the panel tile >= m; the item
  that stores the diagonal also waits until every A(m) item of the
  placement has loaded it.  Both counts are kept per pivot block: items
  of a later pivot block may finish (or load) before the last of an
  earlier one.
* B(m, i, j): the versions of the panels it reads, (i, m) and (m, j),
  >= m + 1 (they have written their snapshots), its own tile's >= m.

``kernels/ref.py::fw_counts_tiled_sched_ref`` runs this queue on plain
tensors, and ``tests/test_torch_fw_schedule.py`` checks it.
"""
from __future__ import annotations

from typing import NamedTuple


class Item(NamedTuple):
    kind: str   # "A" (fused diagonal + panel) or "B" (outer tile)
    m: int      # the pivot block
    b: int      # the placement
    i: int      # A: the panel tile (i == m: row panel, j == m: column
    j: int      # panel, i == j == m: the diagonal alone); B: the tile


def n_a(nb: int) -> int:
    """A items a placement and pivot block."""
    return 1 if nb == 1 else 2 * (nb - 1)


def n_outer(nb: int) -> int:
    """B items (outer tiles) a placement and pivot block."""
    return (nb - 1) ** 2


def _skip(x: int, a: int, n: int) -> int:
    """The x-th element of [0, nb) without the n values from a up."""
    return x if x < a else x + n


def n_lookahead(nb: int, m: int) -> int:
    """B(m)'s tiles in row or column m + 1."""
    return 2 * nb - 3 if m + 1 < nb else 0


def lookahead_tile(nb: int, m: int, t: int) -> tuple[int, int]:
    if t < nb - 1:
        return m + 1, _skip(t, m, 1)
    return _skip(t - (nb - 1), m, 2), m + 1


def rest_tile(nb: int, m: int, t: int) -> tuple[int, int]:
    if m + 1 >= nb:
        u = nb - 1
        return _skip(t // u, m, 1), _skip(t % u, m, 1)
    u = nb - 2
    if m + 2 >= nb:
        return _skip(t // u, m, 2), _skip(t % u, m, 2)
    q = m + 2
    if t < u:
        return q, _skip(t, m, 2)
    if t < 2 * u - 1:
        return _skip(t - u, m, 3), q
    x = t - (2 * u - 1)
    return _skip(x // (u - 1), m, 3), _skip(x % (u - 1), m, 3)


def total(B: int, nb: int) -> int:
    return B * nb * (n_a(nb) + n_outer(nb))


def _a_item(m: int, b: int, t: int, nb: int) -> Item:
    if nb == 1:
        return Item("A", m, b, 0, 0)
    if t < nb - 1:
        return Item("A", m, b, m, _skip(t, m, 1))
    return Item("A", m, b, _skip(t - (nb - 1), m, 1), m)


def decode(e: int, B: int, nb: int) -> Item | None:
    """Item e of the queue (the kernel's ``decode``), None past the end."""
    for m in range(nb + 1):
        if m < nb:
            n = B * n_a(nb)
            if e < n:
                return _a_item(m, e % B, e // B, nb)
            e -= n
        if m >= 1:
            n = B * (n_outer(nb) - n_lookahead(nb, m - 1))
            if e < n:
                return Item("B", m - 1, e % B,
                            *rest_tile(nb, m - 1, e // B))
            e -= n
        if m + 1 < nb:
            n = B * n_lookahead(nb, m)
            if e < n:
                return Item("B", m, e % B, *lookahead_tile(nb, m, e // B))
            e -= n
    return None


def queue(B: int, nb: int) -> list[Item]:
    return [decode(e, B, nb) for e in range(total(B, nb))]


def keeps_diag(it: Item, nb: int) -> bool:
    """Whether an A item stores the diagonal tile (the placement's last A
    item of the pivot block in the queue)."""
    if nb == 1:
        return True
    last_p = nb - 2 if it.m == nb - 1 else nb - 1
    return it.j == it.m and it.i == last_p
