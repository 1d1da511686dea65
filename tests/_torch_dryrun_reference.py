"""The JAX package's dry-run cells, compiled on host devices: the yardstick
for the port's sharded programs (``repro_torch.launch.dryrun``).

The reference's own launcher (``repro.launch.dryrun._mesh_for``) builds
its meshes with ``jax.make_mesh``, whose axes are Explicit under jax 0.9,
and ``with_sharding_constraint`` refuses those.  ``build_cell`` takes any
mesh, so this helper gives it a ``jax.sharding.Mesh`` of host devices
with Auto axes ("data", "model"; "pod" before them on a mesh of pods),
lowers and compiles the cell and reads it with the reference's own
``analyze``.  Nothing of the JAX package is edited.

On a mesh with a "pod" axis both sides count a collective as crossing
pods of ``pod_size`` devices.  The reference's own rule
(``repro.launch.hlo_cost._collective_wire``) reads only the first of
explicit groups, never crosses with a group written in iota form no
larger than a pod, and always crosses with a permute; the helper keeps
its count and, on a mesh of more than one pod, beside it an exact
recount (``cross_pod_exact_bytes_per_chip``, by :func:`exact_crosses`:
every group, iota groups expanded, a permute's pairs), which is the
yardstick of the port's ``cross_pod_bytes_per_chip``.

JAX fixes its device count when it starts, so the cells run in a
subprocess (``JAX_PLATFORMS=cpu``, ``REPRO_DRYRUN_DEVICES`` = the mesh's
size): a :class:`Worker` compiles every cell it is given in one such
process and returns plain records.  A cell's depth is cut by patching
``repro.launch.dryrun.get_config`` inside that process; the port's side
(:func:`port_record`) patches ``repro_torch.launch.dryrun``'s the same
way, in a process of its own beside it (DTensor's caches keep the meshes
of a fake process group that a test destroys, and a later one of the
same shape would take them).

Run as a script, it writes ``tests/data/dryrun_reference_single.json``:
the reference's records of single-pod cells (16 x 16, Auto axes, 256
host devices), which the card, having no JAX, holds its counts to
(``chip_smoke.py``'s ``dryrun_phase``); with ``--mesh multi``,
``tests/data/dryrun_reference_multi.json``: the multi-pod cells (2 x 16
x 16, 512 host devices, pods of 256)::

    PYTHONPATH=src python tests/_torch_dryrun_reference.py [--cells ...]
    PYTHONPATH=src python tests/_torch_dryrun_reference.py --mesh multi

``--port FILE`` writes the port's records instead, without JAX: of the
(2, 4) parity cells, with ``--pod`` of the (2, 2, 2) ones, with ``--mesh
multi`` of the multi-pod cells (``tests/data/dryrun_port_multi.json``,
the torch release's counts that ``chip_smoke.py`` holds the card's
release to).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
SINGLE_JSON = os.path.join(HERE, "data", "dryrun_reference_single.json")
MULTI_JSON = os.path.join(HERE, "data", "dryrun_reference_multi.json")
PORT_MULTI_JSON = os.path.join(HERE, "data", "dryrun_port_multi.json")
# The single-pod cells whose reference records the card is held to,
# (arch, shape, cut): moonshot-v1-16b-a3b's train step at 8 of its 48
# layers, which the port counts in about 40 s (at full depth about 4 min).
SINGLE_CELLS = [("qwen3-1.7b", "train_4k", None),
                ("qwen3-1.7b", "decode_32k", None),
                ("moonshot-v1-16b-a3b", "prefill_32k", None),
                ("falcon-mamba-7b", "prefill_32k", None),
                ("recurrentgemma-9b", "prefill_32k", None),
                ("moonshot-v1-16b-a3b", "train_4k", {"n_layers": 8})]
# The parity cells on the (2, 4) mesh, (arch, shape, cut), at full width
# with their depth cut (recurrentgemma-9b keeps one whole "rra" block,
# seamless-m4t-medium's encoder is cut as its decoder): the dense, SSM,
# MoE and replicated sequence-parallel train cells; the hybrid and
# encoder-decoder ones (the longest compiles); and prefill and decode of
# one architecture of each family, with seamless's decode.
TRAIN_CELLS = [("qwen3-1.7b", "train_4k", {"n_layers": 2}),
               ("falcon-mamba-7b", "train_4k", {"n_layers": 2}),
               ("moonshot-v1-16b-a3b", "train_4k", {"n_layers": 2}),
               ("smollm-360m", "train_4k", {"n_layers": 2})]
LONG_CELLS = [("recurrentgemma-9b", "train_4k", {"n_layers": 3}),
              ("seamless-m4t-medium", "train_4k",
               {"n_layers": 2, "n_enc_layers": 2})]
SERVE_CELLS = [(arch, shape, {"n_layers": 3 if arch == "recurrentgemma-9b"
                              else 2})
               for arch in ("qwen3-1.7b", "moonshot-v1-16b-a3b",
                            "falcon-mamba-7b", "recurrentgemma-9b")
               for shape in ("prefill_32k", "decode_32k")] + [
    ("seamless-m4t-medium", "decode_32k", {"n_layers": 2, "n_enc_layers": 2})]
# The multi-pod cells whose reference records the card is held to, on
# (2, 16, 16) with pods of 256: moonshot-v1-16b-a3b's and qwen3-1.7b's
# train steps at 2 layers, and qwen3-1.7b's decode step whole.
MULTI_DIMS = (2, 16, 16)
MULTI_CELLS = [("moonshot-v1-16b-a3b", "train_4k", {"n_layers": 2}),
               ("qwen3-1.7b", "train_4k", {"n_layers": 2}),
               ("qwen3-1.7b", "decode_32k", None)]
# The parity cells on a (2, 2, 2) mesh of ("pod", "data", "model") axes,
# pods of 4 devices, cut as the (2, 4) cells: the train cells of the six
# families, prefill and decode of the MoE, dense and hybrid ones, and the
# SSM's and the encoder-decoder's decode.
POD_DIMS, POD_SIZE = (2, 2, 2), 4
POD_SERVE_CELLS = [
    (arch, shape, {"n_layers": 3 if arch == "recurrentgemma-9b" else 2})
    for arch in ("moonshot-v1-16b-a3b", "qwen3-1.7b", "recurrentgemma-9b")
    for shape in ("prefill_32k", "decode_32k")] + [
    ("falcon-mamba-7b", "decode_32k", {"n_layers": 2}),
    ("seamless-m4t-medium", "decode_32k", {"n_layers": 2, "n_enc_layers": 2})]
POD_CELLS = TRAIN_CELLS + LONG_CELLS + POD_SERVE_CELLS
# The fields of a record that are compared (and kept in the file).
FIELDS = ("flops_total", "bytes_accessed_total", "memory_analysis",
          "collectives", "n_collective_lines")


def cell_key(arch: str, shape: str, cut: dict | None = None) -> str:
    """A cell's name: ``arch/shape`` and its cut, e.g.
    ``qwen3-1.7b/train_4k/n_layers=2``."""
    tail = "".join(f"/{k}={v}" for k, v in sorted((cut or {}).items()))
    return f"{arch}/{shape}{tail}"


def parse_key(key: str) -> tuple:
    """(arch, shape, cut) of a :func:`cell_key`."""
    arch, shape, *rest = key.split("/")
    return arch, shape, {k: int(v) for k, v in (r.split("=")
                                                 for r in rest)} or None


def _cut_config(get_config, cut: dict | None):
    """``get_config`` with the config's fields in ``cut`` replaced."""
    if not cut:
        return get_config

    def patched(arch):
        return dataclasses.replace(get_config(arch), **cut)

    return patched


_IOTA_RE = re.compile(
    r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?")
_LIST_RE = re.compile(r"(?:replica_groups|source_target_pairs)="
                      r"\{((?:\{[\d,\s]*\},?\s*)*)\}")


def hlo_groups(line: str) -> list | None:
    """The device groups of a collective's HLO line: every replica group
    (an iota form ``[G,g]<=[dims]T(perm)`` expanded), or a permute's
    (source, target) pairs; None where the line names neither (one group
    of every device)."""
    m = _IOTA_RE.search(line)
    if m:
        import numpy as np

        n_groups, size = int(m.group(1)), int(m.group(2))
        dims = [int(d) for d in m.group(3).split(",")]
        ids = np.arange(int(np.prod(dims))).reshape(dims)
        if m.group(4):
            ids = ids.transpose([int(p) for p in m.group(4).split(",")])
        return ids.reshape(n_groups, size).tolist()
    m = _LIST_RE.search(line)
    lists = [] if m is None else [
        [int(i) for i in g.split(",") if i.strip()]
        for g in re.findall(r"\{([\d,\s]*)\}", m.group(1))]
    return [g for g in lists if g] or None


def exact_crosses(line: str, n_chips: int, pod_size: int) -> bool:
    """Whether a collective's HLO line moves data between pods of
    ``pod_size`` devices: a group of its holds devices of two pods, or a
    permute's pair joins two (an SPMD program's groups are alike, so this
    is each device's case, as ``op_cost.crosses_pods`` reads rank 0's)."""
    groups = hlo_groups(line)
    if groups is None:
        return n_chips > pod_size
    return any(len({i // pod_size for i in g}) > 1 for g in groups)


def exact_collective_wire(raw, pod_size: int):
    """``hlo_cost._collective_wire`` with its kind and wire bytes from
    ``raw`` and whether it crosses pods by :func:`exact_crosses`."""

    def wire(ins, n_chips, pod_size_=pod_size):
        kind, w, _ = raw(ins, n_chips, pod_size_)
        return kind, w, exact_crosses(ins.line, n_chips, pod_size_)

    return wire


class Worker:
    """This script run as a process of its own on ``cells`` ((arch, shape,
    cut) triples) on a ``dims`` mesh, started at once so that two run side
    by side: ``side`` "reference" compiles the reference's cells in one
    JAX process (``build_cell`` as it stands, its layers unrolled, on
    host devices), "port" counts the port's (:func:`port_record`, in a
    process whose fake group and DTensor caches no other test shares).
    Both count a collective as crossing pods of ``pod_size`` devices (the
    reference by its own rule and by :func:`exact_crosses`).
    :meth:`records` waits for them, keyed by :func:`cell_key`; a
    reference cell that fails carries ``error``."""

    def __init__(self, side: str, cells, dims=(2, 4), timeout: float = 1500,
                 pod_size: int = 256):
        n = 1
        for d in dims:
            n *= d
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
                   + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
        if side == "reference":
            env.update(JAX_PLATFORMS="cpu", REPRO_DRYRUN_DEVICES=str(n))
            env.pop("XLA_FLAGS", None)
        self.side, self.timeout = side, timeout
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", side],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, env=env, text=True)
        self.spec = json.dumps({"dims": list(dims), "pod_size": pod_size,
                                "cells": [[a, s, c or {}]
                                          for a, s, c in cells]})

    def records(self) -> dict:
        try:
            out, err = self.proc.communicate(self.spec, timeout=self.timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        if self.proc.returncode != 0:
            raise RuntimeError(f"{self.side} dry run failed "
                               f"({self.proc.returncode}):\n{err[-4000:]}")
        return json.loads(out.strip().splitlines()[-1])


def reference_records(cells, dims=(2, 4), **kw) -> dict:
    """The reference's records of ``cells``, waited for."""
    return Worker("reference", cells, dims, **kw).records()


def _port_worker() -> None:
    """The port's subprocess: read the cells from stdin, print the records
    as one JSON line."""
    import torch

    torch.set_num_threads(1)
    spec = json.loads(sys.stdin.read())
    print(json.dumps({cell_key(a, s, c): port_record(a, s, c, spec["dims"],
                                                     spec["pod_size"])
                      for a, s, c in spec["cells"]}))


def _worker() -> None:
    """The reference's subprocess: read the cells from stdin, print the
    records as one JSON line."""
    spec = json.loads(sys.stdin.read())
    import numpy as np
    import jax
    from jax.sharding import Mesh

    from repro.launch import dryrun, hlo_cost

    dims, pod_size = tuple(spec["dims"]), spec["pod_size"]
    n = int(np.prod(dims))
    raw_wire = hlo_cost._collective_wire
    heuristic = lambda ins, n_chips: raw_wire(ins, n_chips, pod_size)
    exact = exact_collective_wire(raw_wire, pod_size)
    axes = ("pod", "data", "model")[-len(dims):]
    devices = np.array(jax.devices()[:n]).reshape(dims)
    mesh = Mesh(devices, axes)
    raw = dryrun.get_config
    out = {}
    for arch, shape, cut in spec["cells"]:
        key = cell_key(arch, shape, cut)
        t0 = time.time()
        dryrun.get_config = _cut_config(raw, cut)
        try:
            jfn, args, _, _, mb = dryrun.build_cell(arch, shape, mesh)
            compiled = jfn.lower(*args).compile()
            with _patched(hlo_cost, "_collective_wire", heuristic):
                rec = dryrun.analyze(compiled, n)
            out[key] = {f: rec[f] for f in FIELDS}
            if n > pod_size:
                with _patched(hlo_cost, "_collective_wire", exact):
                    recount = hlo_cost.analyze_hlo(compiled.as_text(), n)
                out[key]["collectives"]["cross_pod_exact_bytes_per_chip"] = \
                    recount["cross_pod_bytes_per_chip"]
            out[key]["microbatches"] = mb
            # XLA's output buffer is a tuple of the leaves, with a table of
            # one 8-byte pointer a leaf in its size.
            out[key]["n_outputs"] = compiled.out_tree.num_leaves
        except Exception as e:  # noqa: BLE001 -- report it with the cell
            out[key] = {"error": f"{type(e).__name__}: {e}"}
        finally:
            dryrun.get_config = raw
        out[key]["seconds"] = round(time.time() - t0, 1)
        print(f"{key}: {out[key]['seconds']} s", file=sys.stderr, flush=True)
    print(json.dumps(out))


@contextlib.contextmanager
def _patched(module, name, value):
    raw = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, raw)


def port_record(arch: str, shape: str, cut: dict | None = None,
                dims=(2, 4), pod_size: int = 256) -> dict:
    """The port's counts of the same cell: rank 0's program on fake CPU
    tensors over a fake group of ``dims`` (``dryrun.count_cell``, pods of
    ``pod_size`` ranks), the config cut as :func:`reference_records`
    cuts it."""
    import torch

    from repro_torch.launch import dryrun

    mesh = dryrun.fake_mesh("single", "cpu", dims=tuple(dims))
    with _patched(dryrun, "get_config", _cut_config(dryrun.get_config, cut)):
        got = dryrun.count_cell(arch, shape, mesh, "cpu", pod_size=pod_size)
    rec = {f: got[f] for f in FIELDS}
    rec["microbatches"] = got["microbatches"]
    rec["top_collectives"] = got["top_collectives"]
    rec["collective_sites"] = got["collective_sites"]
    rec["torch"] = torch.__version__
    rec["flops_by_op"] = got["flops_by_op"]
    return rec


# XLA's output buffer is a tuple of the leaves: one 8-byte pointer a leaf
# more than the port's outputs.
POINTER = 8


def records(cells, dims=(2, 4), pod_size: int = 256) -> dict:
    """{cell key: (the reference's record, the port's)} of ``cells`` on a
    ``dims`` mesh with pods of ``pod_size`` devices, each side in a
    process of its own, side by side."""
    ref, port = (Worker(side, cells, dims, pod_size=pod_size)
                 for side in ("reference", "port"))
    got, counted = ref.records(), port.records()
    return {k: (got[k], counted[k]) for k in counted}


def params(cells) -> list:
    """pytest params of the cells' keys."""
    import pytest

    return [pytest.param(cell_key(*c), id=cell_key(*c)) for c in cells]


def _pair(recs, key):
    ref, port = recs[key]
    assert "error" not in ref, ref["error"]
    assert ref["microbatches"] == port["microbatches"]
    return ref, port


def check_flops(recs, key) -> None:
    """Rank 0's product FLOPs equal the reference's device's."""
    ref, port = _pair(recs, key)
    assert port["flops_total"] == ref["flops_total"], (
        f"rank 0 {port['flops_total']:.6e} vs the reference's "
        f"{ref['flops_total']:.6e}; the port's by op: "
        f"{port['flops_by_op']}")


def check_arguments(recs, key) -> None:
    """The device's argument bytes are equal."""
    ref, port = _pair(recs, key)
    assert (port["memory_analysis"]["argument_size_in_bytes"]
            == ref["memory_analysis"]["argument_size_in_bytes"])


def check_outputs(recs, key) -> None:
    """The output bytes differ by the reference's output tuple alone."""
    ref, port = _pair(recs, key)
    assert (ref["memory_analysis"]["output_size_in_bytes"]
            - port["memory_analysis"]["output_size_in_bytes"]
            == POINTER * ref["n_outputs"])


def check_wire(recs, key) -> None:
    """The port's wire bytes a chip are no more than the reference's."""
    ref, port = _pair(recs, key)
    assert (port["collectives"]["wire_bytes_per_chip"]
            <= ref["collectives"]["wire_bytes_per_chip"]), \
        "\n" + wire_table(ref, port)


def check_cross_pod(recs, key) -> None:
    """The port's bytes a chip that cross pods are no more than the
    reference's exact recount."""
    ref, port = _pair(recs, key)
    assert (port["collectives"]["cross_pod_bytes_per_chip"]
            <= ref["collectives"]["cross_pod_exact_bytes_per_chip"]), \
        "\n" + wire_table(ref, port)


def check_peak(recs, key) -> None:
    """The port's peak (arguments and temp) is no more than the
    reference's, as the card holds its dry-run cells
    (``chip_smoke.py``'s ``DRYRUN_REF_PEAK``)."""
    ref, port = _pair(recs, key)
    mr, mp = ref["memory_analysis"], port["memory_analysis"]
    assert (mp["argument_size_in_bytes"] + mp["temp_size_in_bytes"]
            <= mr["argument_size_in_bytes"] + mr["temp_size_in_bytes"])


def wire_table(ref: dict, port: dict) -> str:
    """Each collective kind's count and wire bytes a chip on both sides,
    for a failure's message."""
    kinds = sorted(set(ref["collectives"]["ops"]) | set(
        port["collectives"]["ops"]))
    lines = [f"{'kind':22s} {'ref n':>6s} {'ref GB':>12s} "
             f"{'port n':>6s} {'port GB':>12s}"]
    for k in kinds:
        r = ref["collectives"]["ops"].get(k, {})
        p = port["collectives"]["ops"].get(k, {})
        lines.append(f"{k:22s} {r.get('count', 0):6d} "
                     f"{r.get('wire_bytes_per_chip', 0) / 1e9:12.6f} "
                     f"{p.get('count', 0):6d} "
                     f"{p.get('wire_bytes_per_chip', 0) / 1e9:12.6f}")
    lines.append(f"{'total':22s} {'':6s} "
                 f"{ref['collectives']['wire_bytes_per_chip'] / 1e9:12.6f} "
                 f"{'':6s} "
                 f"{port['collectives']['wire_bytes_per_chip'] / 1e9:12.6f}")
    for t in port.get("top_collectives", [])[:8]:
        lines.append(f"  port: {t['kind']} {t['wire_bytes'] / 1e9:.4f} GB "
                     f"{t['shape']} {t['path']}")
    return "\n".join(lines)


def table(cells, dims=(2, 4), pod_size: int = 256) -> str:
    """A markdown row a cell: FLOPs of the reference's device and the
    port's rank 0 and their ratio, wire GB a chip (the all-gathers'
    share), the GB a chip that cross pods (the reference's exact recount,
    its own rule's and the port's), and whether the argument bytes are
    equal."""
    lines = ["| cell | FLOPs ref | FLOPs port | port/ref | wire GB ref / "
             "port (all-gather) | cross-pod GB ref exact / own / port | "
             "arguments |",
             "| --- | --- | --- | --- | --- | --- | --- |"]
    for key, (ref, port) in records(cells, dims, pod_size).items():
        if "error" in ref:
            lines.append(f"| {key} | {ref['error']} | | | | | |")
            continue

        def gathered(r):
            ops = r["collectives"]["ops"]
            return ops.get("all-gather", {}).get("wire_bytes_per_chip", 0)

        rc, pc = ref["collectives"], port["collectives"]
        eq = (ref["memory_analysis"]["argument_size_in_bytes"]
              == port["memory_analysis"]["argument_size_in_bytes"])
        lines.append(
            f"| {key} | {ref['flops_total']:.5e} | "
            f"{port['flops_total']:.5e} | "
            f"{port['flops_total'] / ref['flops_total']:.4f} | "
            f"{rc['wire_bytes_per_chip'] / 1e9:.4f} / "
            f"{pc['wire_bytes_per_chip'] / 1e9:.4f} "
            f"({gathered(ref) / 1e9:.4f} / {gathered(port) / 1e9:.4f}) | "
            f"{rc['cross_pod_exact_bytes_per_chip'] / 1e9:.4f} / "
            f"{rc['cross_pod_bytes_per_chip'] / 1e9:.4f} / "
            f"{pc['cross_pod_bytes_per_chip'] / 1e9:.4f} | "
            f"{'equal' if eq else 'differ'} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", choices=("reference", "port"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--cells", nargs="*", default=None,
                    help="arch/shape[/field=value...] names (default: the "
                         "single-pod set)")
    ap.add_argument("--mesh", choices=("single", "multi"), default="single",
                    help="the file to write: single-pod cells on (16, 16) "
                         "or multi-pod ones on (2, 16, 16), pods of 256")
    ap.add_argument("--out", default=None,
                    help="the file (default: the mesh's in tests/data)")
    ap.add_argument("--table", action="store_true",
                    help="print the parity cells and qwen3-1.7b train_4k "
                         "at full depth, the reference's counts beside the "
                         "port's, as a markdown table")
    ap.add_argument("--pod", action="store_true",
                    help="with --table or --port: the pod parity cells on "
                         "(2, 2, 2), pods of 4")
    ap.add_argument("--port", metavar="FILE",
                    help="write the port's records of the parity cells "
                         "(with --mesh multi: of the multi-pod cells) to "
                         "FILE instead (no JAX: a check of another torch "
                         "release)")
    args = ap.parse_args(argv)
    if args.worker:
        _worker() if args.worker == "reference" else _port_worker()
        return
    if args.table:
        print(table(POD_CELLS, POD_DIMS, POD_SIZE) if args.pod else
              table(TRAIN_CELLS + LONG_CELLS + SERVE_CELLS
                    + [("qwen3-1.7b", "train_4k", None)]))
        return
    if args.port:
        if args.mesh == "multi":
            recs = {cell_key(*c): port_record(*c, MULTI_DIMS, 256)
                    for c in MULTI_CELLS}
        elif args.pod:
            recs = {cell_key(*c): port_record(*c, POD_DIMS, POD_SIZE)
                    for c in POD_CELLS}
        else:
            recs = {cell_key(*c): port_record(*c)
                    for c in TRAIN_CELLS + LONG_CELLS + SERVE_CELLS}
        with open(args.port, "w") as f:
            json.dump(recs, f, indent=1, sort_keys=True)
        return
    multi = args.mesh == "multi"
    dims, axes = ((MULTI_DIMS, ["pod", "data", "model"]) if multi
                  else ((16, 16), ["data", "model"]))
    out = args.out or (MULTI_JSON if multi else SINGLE_JSON)
    cells = ([parse_key(c) for c in args.cells] if args.cells
             else MULTI_CELLS if multi else SINGLE_CELLS)
    recs = {}
    if os.path.exists(out):
        with open(out) as f:
            recs = json.load(f)["cells"]
    for arch, shape, cut in cells:
        # One process a cell: a compile on hundreds of devices holds much
        # memory.
        got = reference_records([(arch, shape, cut)], dims=dims,
                                timeout=3600)
        recs.update(got)
        rec = got[cell_key(arch, shape, cut)]
        print(f"{arch} {shape}: {rec.get('error') or 'ok'} "
              f"({rec['seconds']} s)", flush=True)
    head = {"mesh": list(dims), "axes": axes, "devices": math.prod(dims)}
    if multi:
        head["pod_size"] = 256
    with open(out, "w") as f:
        json.dump(head | {"cells": recs}, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
