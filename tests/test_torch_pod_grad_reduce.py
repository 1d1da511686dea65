"""One reduction over the pods a train step, not one a microbatch.

On a ("pod", "data", "model") mesh the batch splits over ("pod", "data")
and the parameters over "data", so each pod's rows give a part of every
gradient.  The train step keeps those parts as ``Partial()`` sums over
"pod" through the backward (``sharding.partition.local_part``, the
gradient's redistribution in ``train.step``'s ``grads_of``) and the
microbatch accumulation, and reduces them once, where the AdamW update
moves each FSDP leaf to its state's ("pod", "data") shard: one
reduce-scatter over "pod" a leaf (``train.optimizer._reduce_over_pods``).

Rank 0's program of moonshot-v1-16b-a3b's train_4k cell (2 layers) on a
fake (2, 2, 2) mesh, pods of 4 ranks, counted at 2 and at 4 microbatches
(each count in a process of its own, side by side):

- the collectives that cross pods at ``grads_of`` are the same, in count
  and in bytes, at both: none grows with the microbatches;
- there are no more of them than FSDP leaves;
- the update's reduce-scatters over the pods run once a step, one an
  FSDP leaf, at both counts.

The values of such steps are held to the plain step by the eight-rank
cases of ``tests/test_torch_model_parallel.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from _torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
ARCH, SHAPE, LAYERS = "moonshot-v1-16b-a3b", "train_4k", 2
DIMS, POD_SIZE = (2, 2, 2), 4
MICROBATCHES = (2, 4)


def _count(microbatches: int) -> dict:
    """This process's count of the cell at ``microbatches``: each line's
    collectives by kind (``collective_sites``)."""
    import torch

    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    cfg = dataclasses.replace(dryrun.prod_config(ARCH, SHAPE)[0],
                              n_layers=LAYERS)
    mesh = dryrun.fake_mesh("single", "cpu", dims=DIMS)
    got = dryrun.count_cell(ARCH, SHAPE, mesh, "cpu", pod_size=POD_SIZE,
                            cfg=cfg, microbatches=microbatches)
    assert got["microbatches"] == microbatches
    return got["collective_sites"]


@pytest.fixture(scope="module")
def sites() -> dict:
    """{microbatches: collective sites}, each counted by this file run as
    a process of its own (DTensor's caches keep a fake group's meshes)."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = {mb: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(mb)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for mb in MICROBATCHES}
    out = {}
    for mb, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-4000:]
        out[mb] = json.loads(stdout.strip().splitlines()[-1])
    return out


def _at(sites: dict, func: str, cross: bool) -> dict:
    """{kind: [count, wire bytes]} of the lines of the port's function
    ``func`` (``file.py name``), the kinds that cross pods or the others."""
    file, name = func.split(" ")
    out: dict = {}
    for path, kinds in sites.items():
        if not (path.startswith(file + ":") and path.endswith(" " + name)):
            continue
        for kind, (n, w) in kinds.items():
            if kind.endswith("/cross-pod") == cross:
                e = out.setdefault(kind, [0, 0.0])
                e[0] += n
                e[1] += w
    return out


def _fsdp_leaves() -> int:
    """The leaves whose AdamW state splits over ("pod", "data") and whose
    parameter over "data" alone."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import mesh_info_for, prod_config
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.models.model import LM
    from repro_torch.sharding import rules

    cfg = dataclasses.replace(prod_config(ARCH, SHAPE)[0], n_layers=LAYERS)
    mi = mesh_info_for(ShapeMesh(dict(zip(("pod", "data", "model"), DIMS))),
                       SHAPES[SHAPE].global_batch)
    mi_opt = dataclasses.replace(mi, fsdp_over=tuple(mi.dp))
    params = dict(LM(cfg, "meta").named_parameters())
    p_specs = rules.param_pspecs(cfg, params, mi)
    s_specs = rules.param_pspecs(cfg, params, mi_opt)
    return sum(p_specs[n] != s_specs[n] for n in params)


def test_cross_pod_collectives_at_grads_of_do_not_grow(sites):
    few, many = (_at(sites[mb], "step.py grads_of", cross=True)
                 for mb in MICROBATCHES)
    assert few == many, (few, many)
    assert sum(n for n, _ in many.values()) <= _fsdp_leaves()
    # The backward still runs (the reductions within each pod).
    assert _at(sites[MICROBATCHES[-1]], "step.py grads_of", cross=False)


def test_gradients_cross_pods_once_a_step(sites):
    leaves = _fsdp_leaves()
    assert leaves > 0
    for mb in MICROBATCHES:
        got = _at(sites[mb], "optimizer.py _reduce_over_pods", cross=True)
        assert got["reduce-scatter/cross-pod"][0] == leaves, (mb, got)
    wires = [_at(sites[mb], "optimizer.py _reduce_over_pods", cross=True)
             for mb in MICROBATCHES]
    assert wires[0] == wires[1]


if __name__ == "__main__":
    print(json.dumps(_count(int(sys.argv[1]))))
