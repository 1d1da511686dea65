"""Meshes: the port of ``repro.launch.mesh``.

Single pod: (16, 16) = 256 devices, axes (data, model).
Multi-pod:  (2, 16, 16) = 512 devices, axes (pod, data, model) — the pod
axis carries cross-pod data parallelism; `model` stays intra-pod.

``make_production_mesh`` returns those layouts as shape-only meshes (no
process of 256 ranks exists to build a ``DeviceMesh`` over); the rules
read only their sizes.  ``make_host_mesh`` builds a real ``DeviceMesh``
over the ranks of the current process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..sharding.partition import MeshInfo


class ShapeMesh:
    """A mesh layout without devices: ``.shape`` (axis name -> size) and
    ``.axis_names``, as the reference's production meshes expose them."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ShapeMesh(dict(zip(axes, shape)))


def make_mesh_info(mesh) -> MeshInfo:
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    dp = tuple(a for a in names if a in ("pod", "data"))
    return MeshInfo(mesh=mesh, dp=dp, tp="model")


def make_host_mesh(n_model: int = 1) -> DeviceMesh:
    """A (world // n_model, n_model) mesh, axes ("data", "model"), over
    the ranks of the current process group; without a group the world is
    one rank (the reference's assertion that n_model divides it comes
    first), and a mesh needs one.  The mesh's devices are the cards when
    the group's backend is NCCL (rank r on card r mod the count), else
    the CPU."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    assert n % n_model == 0
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs a process group "
                           "(torch.distributed.init_process_group)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, (n // n_model, n_model),
                            mesh_dim_names=("data", "model"))
