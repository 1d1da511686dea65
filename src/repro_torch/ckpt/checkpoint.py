"""Atomic checkpoints with keep-N garbage collection.

The port of ``repro.ckpt.checkpoint``, with its layout and guarantees.
One directory a step:

    <dir>/step_000000042/
        manifest.json      step, n_leaves, extras, leaves (shape, dtype),
                           paths
        arr_00000.npy ...  one file a leaf
    <dir>/step_000000042.done  the commit marker

A save writes into a temporary directory, renames it into place and only
then writes the marker, so a crash mid-save leaves no committed step;
steps without a marker are ignored.  The tree is a nested dict of tensors
(the train state), flattened in sorted-key order as the reference's
pytrees are; bfloat16 leaves are stored as their uint16 bits (numpy has
no bfloat16), recorded as "bfloat16" in the manifest and restored bit for
bit.

A tree of DTensors (a model-parallel train state) is saved whole: every
rank takes part in gathering each leaf, rank 0 alone writes, and the
ranks meet at a barrier before :func:`save` returns, so the layout on disk
does not depend on the mesh.  :func:`restore` returns plain tensors on
``device`` (the CPU by default), or with ``shardings`` (a tree of
``NamedSharding``s like the target, as ``train.step.shard_state`` gives)
each leaf laid out on its mesh: a checkpoint saved on one mesh restores
onto another, or onto none (elastic restore).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..sharding.partition import place


def _flatten(tree, prefix: str = "") -> list:
    """(path, leaf) pairs in sorted-key order; paths as the reference's
    ``keystr`` writes them (``['opt']['m']['embed']``)."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten(tree[key], f"{prefix}[{key!r}]")
        return out
    return [(prefix, tree)]


def _unflatten(like, leaves: list):
    """``like``'s structure (and key order) with the leaves of
    :func:`_flatten`'s order."""
    by_path = dict(zip((p for p, _ in _flatten(like)), leaves))

    def build(t, prefix: str = ""):
        if isinstance(t, dict):
            return {k: build(v, f"{prefix}[{k!r}]") for k, v in t.items()}
        return by_path[prefix]

    return build(like)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(dir_: str, step: int, tree, *, extras: dict | None = None,
         keep: int = 3) -> str:
    """Atomically write a checkpoint; prune to the newest ``keep`` steps.
    With DTensor leaves every rank must call it (rank 0 writes)."""
    flat = _flatten(tree)
    paths = [p for p, _ in flat]
    if not any(isinstance(leaf, DTensor) for _, leaf in flat):
        return _save(dir_, step, paths, (leaf for _, leaf in flat), extras,
                     keep)
    # Each leaf gathered whole on every rank (a collective, in the one
    # order every rank flattens the tree in); rank 0 writes them one by
    # one, the others only take part; then a barrier.
    whole = (leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
             for _, leaf in flat)
    if dist.get_rank() == 0:
        final = _save(dir_, step, paths, whole, extras, keep)
    else:
        for _ in whole:
            pass
        final = os.path.join(dir_, f"step_{step:09d}")
    dist.barrier()
    return final


def _save(dir_: str, step: int, paths: list, leaves, extras, keep: int
          ) -> str:
    os.makedirs(dir_, exist_ok=True)
    name = f"step_{step:09d}"
    final = os.path.join(dir_, name)
    tmp = tempfile.mkdtemp(dir=dir_, prefix=".tmp_" + name)
    try:
        manifest = {"step": step, "n_leaves": len(paths),
                    "extras": extras or {}, "leaves": []}
        for i, leaf in enumerate(leaves):
            arr, dtype = _to_numpy(leaf)
            np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), arr)
            manifest["leaves"].append({"shape": list(arr.shape),
                                       "dtype": dtype})
        manifest["paths"] = paths
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        # The commit marker, written only after the rename.
        with open(final + ".done", "w") as f:
            f.write(str(step))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(dir_, keep)
    return final


def _gc(dir_: str, keep: int):
    steps = committed_steps(dir_)
    for s in steps[:-keep] if keep else []:
        name = os.path.join(dir_, f"step_{s:09d}")
        shutil.rmtree(name, ignore_errors=True)
        try:
            os.remove(name + ".done")
        except OSError:
            pass


def committed_steps(dir_: str) -> list[int]:
    if not os.path.isdir(dir_):
        return []
    out = []
    for f in os.listdir(dir_):
        if f.endswith(".done") and f.startswith("step_"):
            out.append(int(f[len("step_"):-len(".done")]))
    return sorted(out)


def latest_step(dir_: str) -> int | None:
    steps = committed_steps(dir_)
    return steps[-1] if steps else None


def restore(dir_: str, like, *, step: int | None = None, device=None,
            shardings=None):
    """Restore into the structure of ``like`` (a nested dict of tensors or
    of anything with a ``shape``).  Returns (tree, step, extras), the
    leaves on ``device`` (default: the CPU) in the checkpoint's dtypes,
    or, with ``shardings`` (a tree like ``like`` of ``NamedSharding``s),
    each leaf laid out on its mesh (on the mesh's device).  Raises on a
    different leaf count or a shape mismatch."""
    step = latest_step(dir_) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {dir_}")
    path = os.path.join(dir_, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like = [leaf for _, leaf in _flatten(like)]
    if len(leaves_like) != manifest["n_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves; "
            f"restore target has {len(leaves_like)}")
    leaves = []
    for i, spec in enumerate(manifest["leaves"]):
        arr = np.load(os.path.join(path, f"arr_{i:05d}.npy"))
        if list(arr.shape) != list(leaves_like[i].shape):
            raise ValueError(
                f"leaf {i}: checkpoint shape {arr.shape} != target "
                f"{tuple(leaves_like[i].shape)}")
        if spec["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        leaves.append(t if device is None else t.to(device))
    tree = _unflatten(like, leaves)
    if shardings is not None:
        tree = place(tree, shardings)
    return tree, step, manifest.get("extras", {})
