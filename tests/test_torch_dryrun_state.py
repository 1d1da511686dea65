"""The dry run's counts do not depend on what the process ran before.

DTensor caches each op's sharding propagation, and runs an op that has
no sharding rule of its own through its decomposition on meta tensors,
once a layout (recurrentgemma-9b's RG-LRU gates: ``softplus``'s backward
on torch 2.13, ``softplus`` itself on 2.11).  That is host work, not the
device's program, and ``launch.op_cost.OpCost`` counts none of it; and
``launch.dryrun.fake_mesh`` clears DTensor's caches when it makes a new
fake group, whose entries hold the meshes (and so the process groups)
of the layouts they saw.  So a cell counts the same the first time in a
process, again on the same group with DTensor's caches warm, and after
cells on fake groups of other sizes (as ``--all`` runs the single-pod
cells and then the multi-pod ones): every field ``count_cell`` returns.
"""
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.registry import ShapeSpec
from repro_torch.launch import dryrun

from _torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
TRAIN = ShapeSpec("train_4k", 16, 4, "train")
DECODE = ShapeSpec("decode_32k", 16, 2, "decode")
# (arch, shape, mesh, reduced-config overrides)
CELL = ("recurrentgemma-9b", TRAIN, (1, 2), {"n_layers": 3})
OTHERS = [("smollm-360m", DECODE, (2, 2), {"n_layers": 2}),
          ("qwen3-1.7b", DECODE, (2, 4), {"n_layers": 2})]


def _count(arch, spec, dims, cut):
    mesh = dryrun.fake_mesh("single", "cpu", dims=dims)
    got = dryrun.count_cell(arch, spec, mesh, CPU,
                            cfg=get_config(arch).reduced(**cut),
                            microbatches=1)
    mi = got.pop("mi")
    got["mi"] = (mi.dp, mi.tp, mi.fsdp_over, tuple(mi.mesh.shape))
    return got


def test_counts_do_not_depend_on_what_ran_before():
    if dist.is_initialized():
        dist.destroy_process_group()
    try:
        first = _count(*CELL)
        again = _count(*CELL)
        for cell in OTHERS:
            _count(*cell)
        last = _count(*CELL)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert first["flops_total"] > 0
    for got in (again, last):
        assert set(got) == set(first)
        for key in first:
            assert got[key] == first[key], key
