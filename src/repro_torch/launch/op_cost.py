"""Count one device's executed program: FLOPs, bytes, collectives and peak
memory.  The port's counterpart of ``repro.launch.hlo_cost``.

The reference parses the compiled XLA module of a step; torch has no
compiled module, so the port executes the step, on fake tensors
(``launch.dryrun``) or real ones, under :class:`OpCost`, a
``TorchDispatchMode`` that sees every ATen op and custom op the device
runs.  DTensor ops are passed on (``NotImplemented``) and counted where
they land: the local ops on this rank's shards and the ``_c10d_functional``
collectives.  DTensor's sharding propagation, which runs each op once on
fake tensors of the global shapes to learn the output's layout, and its
host arithmetic of strided shards (:func:`host_placement_math`) are not
counted.

- **flops**: products only, as ``analyze_hlo`` counts them (2 M N K a
  product; elementwise work is left out): ``mm``, ``bmm``, ``addmm``,
  ``baddbmm`` (einsum's products reach these) and convolutions, by
  ``torch.utils.flop_counter``'s formulas, and the hand-written kernels'
  custom ops by their own (``kernels.custom_ops``).
- **bytes**: operands read plus outputs written, op by op.  Views,
  aliases, ``detach``, empty allocations and a collective's wait (and
  the wrapper of its result) move no bytes and are skipped (the
  reference's ``_SKIP_BYTES_OPS``); a gather or an index reads only
  output-sized data, and an ``index_put`` writes only its values.  The
  bytes of dtype conversions (``_to_copy`` or ``copy_`` to another
  dtype) are also summed apart, as ``convert_bytes_total``.
- **collectives**: each ``_c10d_functional`` op (and DTensor's
  ``_dtensor.shard_dim_alltoall``) with its group's size and ranks, by
  the reference's ring formulas for the wire bytes a device (R the
  result's bytes, g the group: all-gather R (g - 1) / g,
  all-reduce 2 R (g - 1) / g, reduce-scatter R (g - 1), all-to-all
  R (g - 1) / g; an all-to-all that sends one block to one rank and
  takes one from one rank is a collective-permute, R), crossing pods
  where the group holds ranks of two pods of ``pod_size`` (a permute:
  where its other rank lies in another pod); a schedule of the
  largest, each with the line of the model or train step that ran it
  (the innermost frame of the port's ``models``, ``train`` or
  ``kernels`` packages), and each such line's count and wire bytes by
  kind (``collective_sites``).
- **arguments**: the bytes of the registered inputs that the program
  reads, as a compiled program's inputs are those it uses (XLA prunes
  the rest: an encoder-decoder's decode step takes no encoder weights).
- **peak memory**: the bytes of the storages that the program makes, and
  frees, above the arguments' (finalizers on the storages); the
  arguments' own storages count as freed when the program drops them
  (AdamW's donated moments).  ``peak_tensors`` names the largest
  storages live at the peak (64 MiB and up): the tensor that made each,
  its op and the line of the port's code that ran it.

There is no while-loop trip logic: the port runs its layers and
microbatches eagerly, so every op it executes is counted.  The kernel
wrappers call their custom ops for fake tensors only; a real CPU tensor
runs the plain version, whose ops are counted as they run, and on the
card the wrappers launch the kernels outside the dispatcher, which no
mode sees: count the card's program on fake tensors (``launch.dryrun``).
"""
from __future__ import annotations

import collections
import contextlib
import os
import sys
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.distributed.tensor.placement_types import _StridedShard
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import custom_ops

aten = torch.ops.aten
# The products analyze_hlo counts (a dot or a convolution).
PRODUCTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.convolution,
            aten._convolution, aten.convolution_backward}
KERNELS = {getattr(torch.ops.repro_torch, name): name
           for name in custom_ops.OPS}
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               # DTensor's own all-to-all (a split moved to another dim).
               "shard_dim_alltoall": "all-to-all"}
# Ops that move no bytes (beyond the views, which ``is_view`` marks).
NO_BYTES = {aten.detach, aten._unsafe_view, aten.empty, aten.empty_strided,
            aten.new_empty, aten.new_empty_strided, aten.empty_like,
            aten.lift_fresh, torch.ops.prim.device, aten.item,
            aten._local_scalar_dense}
# Ops that read only output-sized data (XLA's gather model).
GATHERS = {aten.index, aten.gather, aten.index_select, aten.embedding}
POD_SIZE = 256
# The storages the peak's record names: 64 MiB and up.
PEAK_TENSOR_MIN = 1 << 26
# The packages whose frames name a collective's place in the schedule.
_SITES = tuple(os.sep + os.path.join("repro_torch", p) + os.sep
               for p in ("models", "train", "kernels"))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensor_bytes(tree) -> int:
    """The bytes of every tensor of a nested structure (a DTensor's local
    shard)."""
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def _storages(tree):
    """The distinct storages of the tensors of ``tree`` (DTensors' local
    shards), by their C pointer."""
    out = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            out[s._cdata] = s
    return out


def crosses_pods(ranks, pod_size: int) -> bool:
    """Whether a collective over ``ranks`` (a permute: its sender and its
    receiver) crosses pods of ``pod_size`` ranks."""
    return len({r // pod_size for r in ranks}) > 1


def ring_wire(kind: str, R: float, g: int) -> float:
    """Wire bytes a device of a ring collective whose result holds R
    bytes, over a group of g devices (``hlo_cost._collective_wire``)."""
    g = max(g, 1)
    if kind == "all-gather":
        return R * (g - 1) / g
    if kind == "all-reduce":
        return 2 * R * (g - 1) / g
    if kind == "reduce-scatter":
        return R * (g - 1)
    if kind == "all-to-all":
        return R * (g - 1) / g
    return R                  # a collective-permute


@contextlib.contextmanager
def host_placement_math():
    """DTensor computes a strided shard's size and offset with tensors
    (``torch.arange`` and a split); that host arithmetic runs outside
    every dispatch mode: it is not the device's program, and under a
    fake-tensor mode its values would be unreadable."""
    owner, name = _StridedShard, "local_shard_size_and_offset"
    raw = owner.__dict__.get(name)
    if raw is None:
        yield
        return
    fn = raw.__func__ if isinstance(raw, staticmethod) else raw

    def host(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)

    setattr(owner, name, staticmethod(host) if isinstance(raw, staticmethod)
            else host)
    try:
        yield
    finally:
        setattr(owner, name, raw)


class OpCost(TorchDispatchMode):
    """Counts what runs while it is entered; see the module docstring.

    ``arguments(tree)`` first registers the program's inputs (their bytes
    are ``argument_size_in_bytes``); ``result(outputs)`` then gives the
    totals in the reference's artifact fields."""

    def __init__(self, pod_size: int = POD_SIZE):
        super().__init__()
        self.pod_size = pod_size
        self.flops = 0.0
        self.bytes = 0.0
        self.convert_bytes = 0.0
        self.flops_by_op: collections.Counter = collections.Counter()
        self.kernel_calls: collections.Counter = collections.Counter()
        self.coll: dict = {}            # kind -> [count, wire]
        self.schedule: list = []        # (path, kind, wire, shape)
        self.live = 0                   # bytes above the arguments
        self.peak = 0
        self._arg_sizes: dict = {}      # storage -> the arguments' bytes
        self._read: set = set()         # the argument storages read
        self._arg_storages: dict = {}
        self._tracked: set = set()
        self._groups: dict = {}
        self._suspended = 0
        self._large: dict = {}          # live storages of PEAK_TENSOR_MIN+
        self._peak_large: dict = {}     # ... as they stood at the peak

    # -- inputs and outputs --------------------------------------------------

    def arguments(self, tree) -> None:
        """Register ``tree``'s tensors as the program's arguments: the
        bytes of those that the program reads (each local shard once) are
        the argument size, as a compiled program's inputs are the
        arguments it uses (XLA prunes the others: the encoder's weights
        in an encoder-decoder's decode step), and their storages count as
        freed when the program drops them."""
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                t = t.to_local() if isinstance(t, DTensor) else t
                key = t.untyped_storage()._cdata
                self._arg_sizes[key] = self._arg_sizes.get(key, 0) \
                    + _nbytes(t)
        for key, s in _storages(tree).items():
            if key not in self._tracked:
                self._arg_storages[key] = s.nbytes()
                self._track(s, key, s.nbytes(), counted=False)

    def memory_analysis(self, outputs) -> dict:
        """The reference's ``memory_analysis`` fields: argument, output
        and alias (outputs held in the arguments' storages: the state
        AdamW updates in place, the caches decode writes in place) bytes,
        and temp, the peak above the arguments less what the outputs add,
        so that argument + temp + output - alias is the device's peak."""
        out_b = tensor_bytes(outputs)
        alias = sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
                    for t in tree_flatten(outputs)[0]
                    if isinstance(t, torch.Tensor)
                    and (t.to_local() if isinstance(t, DTensor) else t
                         ).untyped_storage()._cdata in self._arg_storages)
        args = sum(self._arg_sizes[k] for k in self._read)
        return {"argument_size_in_bytes": int(args),
                "output_size_in_bytes": int(out_b),
                "alias_size_in_bytes": int(alias),
                "temp_size_in_bytes": int(max(0, self.peak
                                              - (out_b - alias)))}

    def result(self, outputs) -> dict:
        """The counts in the reference's artifact fields."""
        wire = sum(w for _, w in self.coll.values())
        cross = sum(w for k, (_, w) in self.coll.items()
                    if k.endswith("/cross-pod"))
        return {
            "flops_total": float(self.flops),
            "bytes_accessed_total": float(self.bytes),
            "convert_bytes_total": float(self.convert_bytes),
            "memory_analysis": self.memory_analysis(outputs),
            "collectives": {
                "ops": {k: {"count": c, "wire_bytes_per_chip": w}
                        for k, (c, w) in sorted(self.coll.items())},
                "wire_bytes_per_chip": float(wire),
                "cross_pod_bytes_per_chip": float(cross)},
            "n_collective_lines": sum(c for c, _ in self.coll.values()),
            "top_collectives": [
                {"path": p[-60:], "kind": k, "wire_bytes": round(w, 1),
                 "shape": sh}
                for p, k, w, sh in sorted(self.schedule,
                                          key=lambda e: -e[2])[:12]],
            "collective_sites": self.sites(),
            "peak_tensors": self.peak_tensors(),
            "kernel_calls": dict(sorted(self.kernel_calls.items())),
            "flops_by_op": {k: float(v) for k, v in
                            sorted(self.flops_by_op.items())},
        }

    def sites(self) -> dict:
        """Each line of the port's code that ran collectives: {kind:
        [count, wire bytes a chip]}."""
        out: dict = {}
        for path, kind, wire, _ in self.schedule:
            e = out.setdefault(path, {}).setdefault(kind, [0, 0.0])
            e[0] += 1
            e[1] += wire
        return out

    def peak_tensors(self, n: int = 8) -> list:
        """The largest storages live at the peak (of ``PEAK_TENSOR_MIN``
        bytes or more): their bytes, the dtype and shape of the tensor
        that made them, and the op and line of the port's code that
        made them."""
        return [{"bytes": b, "shape": shape, "op": op, "path": path}
                for b, (shape, op, path) in sorted(
                    self._peak_large.values(), key=lambda e: -e[0])[:n]]

    # -- the mode ------------------------------------------------------------

    def __enter__(self):
        # DTensor's sharding propagation is host work, not this device's
        # program: it runs each op on fake tensors of the global shapes to
        # learn the output's layout, and an op without a sharding rule
        # through its decomposition on meta tensors.  It runs once a layout
        # (DTensor caches the result), so counting it would make a count
        # depend on what the process ran before.
        prop = DTensor._op_dispatcher.sharding_propagator
        self._patches = contextlib.ExitStack()
        for owner, name in (
                (ShardingPropagator, "_propagate_tensor_meta_non_cached"),
                (ShardingPropagator, "propagate_op_sharding_non_cached"),
                (prop, "propagate_op_sharding")):
            if hasattr(owner, name):
                self._patches.enter_context(self._uncounted(owner, name))
        self._patches.enter_context(host_placement_math())
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._patches.close()
        return out

    @contextlib.contextmanager
    def _uncounted(self, owner, name):
        """``owner.name`` (a method, or an instance's cached callable)
        replaced while the mode is entered by one that counts nothing."""
        raw = getattr(owner, name)

        def call(*args, **kwargs):
            self._suspended += 1
            try:
                return raw(*args, **kwargs)
            finally:
                self._suspended -= 1

        setattr(owner, name, call)
        try:
            yield
        finally:
            setattr(owner, name, raw)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._suspended:
            self._count(func, args, kwargs, out)
        return out

    # -- counting ------------------------------------------------------------

    def _track(self, s, key, nbytes: int, counted: bool = True,
               made=None) -> None:
        self._tracked.add(key)
        if counted:
            self.live += nbytes
            if nbytes >= PEAK_TENSOR_MIN:
                self._large[key] = (nbytes, made)
            if self.live > self.peak:
                self.peak = self.live
                self._peak_large = dict(self._large)
        weakref.finalize(s, self._free, key, nbytes)

    def _free(self, key, nbytes: int) -> None:
        self._tracked.discard(key)
        self._large.pop(key, None)
        self._arg_storages.pop(key, None)
        if key not in self._read:     # its key may name a new storage
            self._arg_sizes.pop(key, None)
        self.live -= nbytes

    @staticmethod
    def _path() -> str:
        """``file:line function`` of the innermost frame in the port's
        model, train or kernel code."""
        f = sys._getframe(1)
        while f is not None:
            name = f.f_code.co_filename
            if any(site in name for site in _SITES):
                return (f"{os.path.basename(name)}:{f.f_lineno} "
                        f"{f.f_code.co_name}")
            f = f.f_back
        return ""

    def _group(self, name):
        if name not in self._groups:
            pg = (name if isinstance(name, dist.ProcessGroup)
                  else dist.distributed_c10d._resolve_process_group(name))
            self._groups[name] = dist.get_process_group_ranks(pg)
        return self._groups[name]

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        if packet in PRODUCTS or packet in KERNELS:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            self.flops_by_op[str(packet).split(".", 1)[-1]] += f
        if packet in KERNELS:
            self.kernel_calls[KERNELS[packet]] += 1
        functional = func.namespace.startswith(("_c10d_functional",
                                                 "_dtensor"))
        if not func.is_view and packet not in NO_BYTES:
            self._read.update(k for k in (t.untyped_storage()._cdata
                                          for t in ins)
                              if k in self._arg_sizes)
        if functional and packet.__name__ in COLLECTIVES:
            self._collective(func, args, kwargs, outs)
        elif functional:
            return   # waits and wrappers of a collective's result
        if not func.is_view and packet not in NO_BYTES:
            self._bytes(func, packet, ins, outs, args)
        if not func.is_view:
            # New storages: an in-place op's output is its input's.
            held = {t.untyped_storage()._cdata for t in ins}
            for t in outs:
                s = t.untyped_storage()
                key = s._cdata
                if key not in held and key not in self._tracked:
                    made = None
                    if s.nbytes() >= PEAK_TENSOR_MIN:
                        made = (f"{t.dtype}{list(t.shape)}"[:48],
                                str(packet).split(".", 1)[-1], self._path())
                    self._track(s, key, s.nbytes(), made=made)

    def _bytes(self, func, packet, ins, outs, args) -> None:
        out_b = sum(map(_nbytes, outs))
        if packet in GATHERS:
            b = 2 * out_b
        elif packet in (aten.index_put, aten.index_put_):
            vals = args[2]
            b = 2 * _nbytes(vals) + sum(_nbytes(i) for i in args[1]
                                        if i is not None)
        else:
            b = sum(map(_nbytes, ins)) + out_b
        self.bytes += b
        if packet is aten._to_copy and ins and outs \
                and ins[0].dtype != outs[0].dtype:
            self.convert_bytes += b
        elif packet is aten.copy_ and len(ins) > 1 \
                and ins[0].dtype != ins[1].dtype:
            self.convert_bytes += b

    def _collective(self, func, args, kwargs, outs) -> None:
        kind = COLLECTIVES[func._overloadpacket.__name__]
        names = [a.name for a in func._schema.arguments]
        bound = dict(zip(names, args), **kwargs)
        ranks = self._group(bound["group_name"])
        R = sum(map(_nbytes, outs))
        cross = crosses_pods(ranks, self.pod_size)
        to = [r for r, n in zip(ranks, bound.get("input_split_sizes", ()))
              if n]
        if kind == "all-to-all" and len(to) == 1 and sum(
                1 for n in bound["output_split_sizes"] if n) == 1:
            # One block to one rank and one from one: a permute.
            kind = "collective-permute"
            cross = crosses_pods((dist.get_rank(), to[0]), self.pod_size)
        wire = ring_wire(kind, R, len(ranks))
        key = kind + ("/cross-pod" if cross else "")
        e = self.coll.setdefault(key, [0, 0.0])
        e[0] += 1
        e[1] += wire
        shape = f"{outs[0].dtype}{list(outs[0].shape)}" if outs else ""
        self.schedule.append((self._path(), key, wire, shape[:48]))
