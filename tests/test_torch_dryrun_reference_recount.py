"""The exact count of the collectives that cross pods, which the pod
parity files hold the port to (``_torch_dryrun_reference.exact_crosses``),
on hand-written lines of compiled HLO.

The reference's own rule (``repro.launch.hlo_cost._collective_wire``)
reads only the first of explicit groups, takes a group in iota form as
crossing only when it is larger than a pod, and takes every permute as
crossing on a mesh of two pods.  The recount expands the groups and reads
a permute's pairs; on each line it must agree with the port's rule
(``launch.op_cost.crosses_pods``) for rank 0's ranks, and a module of
such lines must give ``analyze_hlo`` the wire bytes of the lines that
cross and no others.
"""
import numpy as np
import pytest

from _torch_dryrun_reference import (exact_collective_wire, exact_crosses,
                                     hlo_groups)
from repro.launch import hlo_cost
from repro_torch.launch.op_cost import crosses_pods

# A (2, 2, 2) mesh of ("pod", "data", "model") axes, pods of 4 devices:
# device (p, d, m) is 4 p + 2 d + m.
MESH = np.arange(8).reshape(2, 2, 2)
POD = 4


def _groups(axes) -> list:
    """The device groups of a collective over the mesh ``axes``."""
    rest = [a for a in range(3) if a not in axes]
    ids = MESH.transpose(rest + list(axes))
    return ids.reshape(-1, int(np.prod([MESH.shape[a] for a in axes])
                       )).tolist()


def _line(op: str, groups: str) -> str:
    return (f"  %x.1 = f32[64,2048]{{1,0}} {op}(f32[64,2048]{{1,0}} %p.1), "
            f"channel_id=7, {groups}, use_global_device_ids=true, "
            f"to_apply=%add")


# (HLO groups, the mesh axes they are the groups of, crosses pods)
GROUP_CASES = [
    # ("pod", "data"), XLA's iota form with a transpose: the reference's
    # rule never counts it (4 is no larger than a pod).
    ("replica_groups=[2,4]<=[4,2]T(1,0)", (0, 1), True),
    # ("data", "model") inside each pod.
    ("replica_groups=[2,4]<=[8]", (1, 2), False),
    # "pod" alone, explicit groups: the reference reads the first.
    ("replica_groups={{0,4},{1,5},{2,6},{3,7}}", (0,), True),
    # "data" alone, explicit groups inside the pods.
    ("replica_groups={{0,2},{1,3},{4,6},{5,7}}", (1,), False),
    # ("pod", "model") in iota form, transposed.
    ("replica_groups=[2,4]<=[2,2,2]T(1,0,2)", (0, 2), True),
]


@pytest.mark.parametrize("groups,axes,crosses", GROUP_CASES,
                         ids=[c[0] for c in GROUP_CASES])
def test_groups_expand_and_agree_with_the_port(groups, axes, crosses):
    got = hlo_groups(_line("all-reduce", groups))
    assert sorted(map(sorted, got)) == sorted(map(sorted, _groups(axes)))
    line = _line("all-reduce", groups)
    assert exact_crosses(line, 8, POD) is crosses
    rank0 = next(g for g in _groups(axes) if 0 in g)
    assert crosses_pods(rank0, POD) is crosses


# (the permute's pairs, rank 0's partner, crosses pods)
PERMUTE_CASES = [
    # A swap along "model" inside each pod: the reference's rule counts
    # every permute on two pods as crossing.
    ("source_target_pairs={{0,1},{1,0},{2,3},{3,2},{4,5},{5,4},{6,7},"
     "{7,6}}", 1, False),
    # A swap along "pod".
    ("source_target_pairs={{0,4},{4,0},{1,5},{5,1},{2,6},{6,2},{3,7},"
     "{7,3}}", 4, True),
]


@pytest.mark.parametrize("pairs,partner,crosses", PERMUTE_CASES,
                         ids=["inside a pod", "across pods"])
def test_permute_pairs_agree_with_the_port(pairs, partner, crosses):
    line = _line("collective-permute", pairs)
    assert [0, partner] in hlo_groups(line)
    assert exact_crosses(line, 8, POD) is crosses
    assert crosses_pods((0, partner), POD) is crosses


def test_no_groups_is_every_device():
    line = _line("all-reduce", "replica_groups={}")
    assert hlo_groups(line) is None
    assert exact_crosses(line, 8, POD) and not exact_crosses(line, 4, POD)


def test_module_recount_sums_the_crossing_lines():
    """``analyze_hlo`` with the recount in place of the reference's rule:
    the wire bytes of the crossing lines, a permute's and a group's, are
    the cross-pod bytes, and the kinds and wire bytes are the rule's."""
    cases = [(g, c) for g, _, c in GROUP_CASES] + [
        (p, c) for p, _, c in PERMUTE_CASES]
    body = []
    for i, (groups, _) in enumerate(cases):
        op = ("collective-permute" if "pairs" in groups else "all-reduce")
        body.append(f"  %c.{i} = f32[64,2048]{{1,0}} {op}(f32[64,2048]{{1,0}}"
                    f" %p.0), channel_id={i + 1}, {groups}")
    hlo = ("ENTRY %main (p.0: f32[64,2048]) -> f32[64,2048] {\n"
           "  %p.0 = f32[64,2048]{1,0} parameter(0)\n"
           + "\n".join(body) + "\n  ROOT %r = f32[64,2048]{1,0} "
           "copy(f32[64,2048]{1,0} %p.0)\n}\n")
    raw = hlo_cost._collective_wire
    ref = hlo_cost.analyze_hlo(hlo, 8)
    hlo_cost._collective_wire = exact_collective_wire(raw, POD)
    try:
        got = hlo_cost.analyze_hlo(hlo, 8)
    finally:
        hlo_cost._collective_wire = raw
    assert got["wire_bytes_per_chip"] == ref["wire_bytes_per_chip"]
    R = 64 * 2048 * 4                   # the result's bytes
    want = 0.0
    for groups, crosses in cases:
        if crosses and "pairs" in groups:
            want += R
        elif crosses:
            g = len(hlo_groups(_line("all-reduce", groups))[0])
            want += 2 * R * (g - 1) / g
    assert got["cross_pod_bytes_per_chip"] == want > 0
