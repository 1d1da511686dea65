"""Multi-pod dry run: count one device's program of every (arch x shape x
mesh) cell.  The port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell's sharded step for 512
placeholder devices and reads the compiled module.  Torch has no
compiled module, so the port *executes* the step, on fake tensors: a
fake process group (``torch.testing._internal.distributed.fake_pg``,
backend ``"fake"``) of 256 or 512 ranks backs the production meshes,
(16, 16) single-pod and (2, 16, 16) multi-pod, this process is rank 0,
and the model, its state, the batch and the caches are fake tensors
(``FakeTensorMode``: shapes without data, nothing allocated).  Per cell
it

  1. builds the model and lays it out by the sharding rules as the
     reference does (``OVERRIDES``, ``prod_config``, ``mesh_info_for``;
     training through ``train.step.build_sharded_train_step`` with the
     optimizer state split over every data axis; serving with the
     weights split over the model axis alone where they fit
     ``SERVING_TP_ONLY_LIMIT``),
  2. runs rank 0's program of the train step, the prefill or the decode
     step under ``launch.op_cost.OpCost``, where each hand-written kernel
     is a custom op with its flop formula (``kernels.custom_ops``),
  3. writes the counts (FLOPs, bytes, collectives, peak memory) to a JSON
     artifact in the reference's schema, in ``artifacts/dryrun_torch/``
     (resumable: existing cells skip), with the card whose rates the
     roofline applies.

What differs from the reference's artifact: the counts are of the
executed ops, not of a compiled module (no fusion: every eager op reads
and writes its operands), and the bytes of dtype conversions stay in
``bytes_accessed_total`` (``launch.roofline``).  ``scan_layers`` and
``--unrolled`` have no counterpart: every layer and microbatch runs.
What agrees with it, cell for cell (``tests/test_torch_dryrun_reference*
.py`` on a (2, 4) mesh and on a (2, 2, 2) mesh with a "pod" axis,
``chip_smoke.py`` on the single pod and the multi-pod mesh against
``tests/data/dryrun_reference_single.json`` and ``_multi.json``): rank
0's product FLOPs are one device's of the reference's compiled step (the
products run on each rank's shards, ``sharding.partition.matmul``; the
log-softmax on the vocabulary's shards), the argument bytes are those
the program reads (the train step reads its shard of the batch), and
the collectives move no more bytes than the reference's, nor across
pods more than an exact recount of the reference's compiled groups.
The artifact also names the largest tensors live at the peak
(``peak_tensors``).

The fake tensors are the card's (``"cuda"``) unless ``--device cpu`` is
given, and then the artifact names ``DEFAULT_CARD`` as the card whose
rates apply; without a card and without ``--device`` the run raises.  A cell
that fails records its error and the run goes on.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \\
      --mesh single [--device cpu] [--layers 8]
  python -m repro_torch.launch.dryrun --all [--mesh both] [--force] \
      [--jobs 6]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor import placement_types
from torch.distributed.tensor.experimental import implicit_replication

from ..configs import SHAPES, all_cells, get_config
from ..configs.registry import make_inputs
from ..core.bridge import DEVICE_RATES
from ..core.proxies import resolve_device
from ..models.model import LM
from ..sharding import rules
from ..sharding.partition import (MeshInfo, P, axis_names, axis_size,
                                  from_local, place, shard_module,
                                  use_sharding)
from ..train.optimizer import OptConfig
from ..train.step import build_sharded_train_step, init_state
from .op_cost import POD_SIZE, OpCost, host_placement_math

ARTIFACT_DIR = os.path.join("artifacts", "dryrun_torch")

# Per-(arch, shape) execution overrides for the production step:
# microbatch count (activation memory) and q-chunk (attention logits), plus
# head padding for TP-unfriendly head counts (llava 56 -> 64; zero-padded,
# function-exact).  The reference's table, entry for entry.
OVERRIDES: dict[str, dict] = {
    "grok-1-314b": dict(microbatches={"train_4k": 16}, opt_int8=True,
                        accum_dtype="bfloat16",
                        q_chunk={"train_4k": 2048, "prefill_32k": 2048}),
    "llava-next-34b": dict(pad_heads_to=64,
                           microbatches={"train_4k": 16},
                           q_chunk={"train_4k": 512, "prefill_32k": 512}),
    "recurrentgemma-9b": dict(microbatches={"train_4k": 8},
                              q_chunk={"prefill_32k": 2048}),
    "falcon-mamba-7b": dict(microbatches={"train_4k": 8}),
    "moonshot-v1-16b-a3b": dict(microbatches={"train_4k": 8},
                                q_chunk={"prefill_32k": 2048}),
    "qwen2.5-3b": dict(microbatches={"train_4k": 4},
                       q_chunk={"train_4k": 2048, "prefill_32k": 2048}),
    "qwen3-1.7b": dict(microbatches={"train_4k": 2},
                       q_chunk={"train_4k": 2048, "prefill_32k": 2048}),
    "tinyllama-1.1b": dict(microbatches={"train_4k": 2},
                           q_chunk={"train_4k": 2048,
                                    "prefill_32k": 2048}),
    # 360M parameters: replicated weights, the whole mesh data/sequence
    # parallel, the gradients reduced once.
    "smollm-360m": dict(microbatches={}, q_chunk={"prefill_32k": 512},
                        replicate_params=True, seq_parallel=True),
    "seamless-m4t-medium": dict(microbatches={"train_4k": 4},
                                q_chunk={"train_4k": 2048,
                                         "prefill_32k": 2048}),
}

# The card a run on fake CPU tensors counts for (``--device cpu``).
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def prod_config(arch: str, shape: str, *, scan_layers: bool = False):
    """The exact arch config with production knobs applied, and the
    microbatch count."""
    cfg = get_config(arch)
    ov = OVERRIDES.get(arch, {})
    rep: dict = dict(dtype="bfloat16", scan_layers=scan_layers,
                     attn_impl="ref", remat=True)
    if "pad_heads_to" in ov:
        rep["pad_heads_to"] = ov["pad_heads_to"]
    qc = ov.get("q_chunk", {}).get(shape)
    if qc:
        rep["q_chunk"] = qc
    return dataclasses.replace(cfg, **rep), ov.get(
        "microbatches", {}).get(shape, 1)


def mesh_info_for(mesh, global_batch: int) -> MeshInfo:
    """Batch-aware axis roles: B == 1 cells move the data axes into TP."""
    names = axis_names(mesh)
    dp = tuple(a for a in names if a in ("pod", "data"))
    dp_size = 1
    for a in dp:
        dp_size *= axis_size(mesh, a)
    # Multi-pod policy: FSDP stays intra-pod (weight gathers inside the
    # pod); the pod axis carries plain DP (one cross-pod grad reduce).
    fsdp = tuple(a for a in dp if a != "pod") or None
    if global_batch == 1:
        return MeshInfo(mesh=mesh, dp=(), tp=tuple(names))
    if global_batch % dp_size != 0:
        # shed pod axis from dp if that fixes divisibility
        dp2 = tuple(a for a in dp if a != "pod")
        dp_size2 = 1
        for a in dp2:
            dp_size2 *= axis_size(mesh, a)
        if global_batch % dp_size2 == 0:
            return MeshInfo(mesh=mesh, dp=dp2, tp="model", fsdp_over=dp2)
        raise ValueError(f"batch {global_batch} unshardable on {names}")
    return MeshInfo(mesh=mesh, dp=dp, tp="model", fsdp_over=fsdp)


SERVING_TP_ONLY_LIMIT = 3e9   # per-device param bytes under TP-only sharding


def _serving_param_specs(cfg, params: dict, mi: MeshInfo, fsdp_specs):
    """Inference parameter layout: split over the model axis alone when
    the per-device footprint allows (no per-step FSDP weight gathers);
    FSDP otherwise (grok-1-314b).  REPRO_SERVING_FSDP=1 forces FSDP."""
    if os.environ.get("REPRO_SERVING_FSDP") == "1":
        return fsdp_specs
    per_chip = sum(p.numel() * p.element_size()
                   for p in params.values()) / max(mi.tp_size, 1)
    if per_chip > SERVING_TP_ONLY_LIMIT:
        return fsdp_specs
    mi_tp = MeshInfo(mesh=mi.mesh, dp=(), tp=mi.tp)
    return rules.param_pspecs(cfg, params, mi_tp)


def _named(specs, mi: MeshInfo):
    if isinstance(specs, dict):
        return {k: _named(v, mi) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_named(v, mi) for v in specs]
    return mi.named(specs)


def own(tree):
    """Each DTensor's local shard copied into a storage of its own: what a
    device holds (a shard cut from a whole tensor may be a view of it)."""
    if isinstance(tree, dict):
        return {k: own(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [own(v) for v in tree]
    if isinstance(tree, DTensor):
        return from_local(tree.to_local().clone(), tree.device_mesh,
                          tree.placements, tree.shape)
    return tree.clone()


def _place(tree, shardings):
    if isinstance(tree, list):
        return [place(t, s) for t, s in zip(tree, shardings)]
    return place(tree, shardings)


def _own_params(model: LM) -> None:
    for name, p in list(model.named_parameters()):
        owner, _, attr = name.rpartition(".")
        setattr(model.get_submodule(owner), attr,
                torch.nn.Parameter(own(p.detach()), requires_grad=False))


def build_cell(arch: str, shape, mesh, device, *, cfg=None,
               microbatches: int | None = None):
    """One device's program of the cell on ``mesh`` (a ``DeviceMesh``
    with the production axis names): (run, arguments, cfg, mi,
    microbatches), ``run()`` returning the step's outputs and
    ``arguments`` the device's inputs (the local shards of the state, the
    batch and the caches).  Tensors are made on ``device``, under a
    ``FakeTensorMode`` fake ones.  ``shape`` is a name of ``SHAPES`` or a
    ``ShapeSpec``; ``cfg`` and ``microbatches`` replace the production
    config's and count (reduced configs in the tests)."""
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    pcfg, mb = prod_config(arch, sh.name)
    cfg = pcfg if cfg is None else cfg
    mb = mb if microbatches is None else microbatches
    mi = mesh_info_for(mesh, sh.global_batch)
    # The global microbatch must not drop below the dp shard count.
    mb = max(1, min(mb, sh.global_batch // max(mi.dp_size, 1)))
    ov = OVERRIDES.get(arch, {})
    cache_len = sh.seq_len
    ctx = rules.make_ctx(cfg, mi, cache_len=cache_len,
                         seq_shard_attn=(sh.kind != "decode"))
    if ov.get("seq_parallel") and sh.kind != "decode":
        dp_ax = tuple(mi.dp) or None
        ctx.act_specs["act"] = P(dp_ax, mi.tp, None)
        ctx.act_specs["act_heads"] = P(dp_ax, mi.tp, None, None)
        ctx.act_specs["act_ff"] = P(dp_ax, mi.tp, None)
        ctx.act_specs["logits"] = P(dp_ax, mi.tp, None)
    model = LM(cfg, device)
    params = dict(model.named_parameters())
    if ov.get("replicate_params"):
        p_specs = {n: P() for n in params}
    else:
        p_specs = rules.param_pspecs(cfg, params, mi)
    batch = make_inputs(cfg, sh.kind, sh.global_batch, sh.seq_len, device)
    b_named = {k: mi.named(v) for k, v in
               rules.batch_pspecs(batch, mi).items()}

    if sh.kind == "train":
        opt_cfg = OptConfig(state_int8=ov.get("opt_int8", False))
        shard_module(model, _named(p_specs, mi))
        _own_params(model)
        state = init_state(model, opt_cfg)
        # Optimizer state over every data axis (hierarchical ZeRO): never
        # gathered, so the pod axis costs one cross-pod reduce-scatter and
        # gather a step instead of doubling the resident state.
        mi_opt = dataclasses.replace(mi, fsdp_over=tuple(mi.dp))
        o_specs = rules.param_pspecs(cfg, state["opt"], mi_opt)
        o_specs["step"] = P()
        shardings = {"params": _named(p_specs, mi),
                     "opt": _named(o_specs, mi_opt)}
        state["opt"] = own(place(state["opt"], shardings["opt"]))
        step = build_sharded_train_step(
            model, opt_cfg, ctx, shardings, microbatches=mb,
            accum_dtype=ov.get("accum_dtype", "float32"))
        # The device's argument is its shard of the batch; the step takes
        # each microbatch's rows of the global batch from the shards (the
        # reference's program moves them likewise).
        db = place(batch, b_named)
        return (lambda: step(state, db)), (state, db), cfg, mi, mb

    shard_module(model, _named(_serving_param_specs(cfg, params, mi,
                                                    p_specs), mi))
    _own_params(model)
    mem_len = sh.seq_len if cfg.family == "encdec" else 0
    caches = model.init_cache(sh.global_batch, cache_len, mem_len)
    c_named = _named(rules.cache_pspecs(cfg, caches, mi,
                                        cache_len=cache_len), mi)
    db = own(place(batch, b_named))
    if sh.kind == "prefill":
        del caches

        def run():
            with use_sharding(ctx), implicit_replication():
                logits, out = model.prefill(db, cache_len)
                return logits, _place(out, c_named)
        return run, (dict(model.named_parameters()), db), cfg, mi, mb

    caches = own(_place(caches, c_named))

    def run():
        with use_sharding(ctx), implicit_replication():
            return model.decode_step(db, caches), caches
    return run, (dict(model.named_parameters()), db, caches), cfg, mi, mb


def count_cell(arch: str, shape, mesh, device, *, pod_size: int = POD_SIZE,
               **kw) -> dict:
    """Build the cell (:func:`build_cell`) on fake tensors of ``device``
    and count rank 0's program (a collective crossing pods of
    ``pod_size`` ranks, ``hlo_cost.analyze_hlo``'s parameter): the
    artifact's counts, plus ``cfg``, ``mi`` and ``microbatches``."""
    with fake_execution():
        run, args, cfg, mi, mb = build_cell(arch, shape, mesh, device, **kw)
        return count(run, args, pod_size) | {"cfg": cfg, "mi": mi,
                                              "microbatches": mb}


@contextlib.contextmanager
def fake_execution():
    """A ``FakeTensorMode`` for DTensor programs, their strided shards'
    host arithmetic outside it (``op_cost.host_placement_math``)."""
    with host_placement_math(), FakeTensorMode(allow_non_fake_inputs=True):
        yield


@contextlib.contextmanager
def card_all_to_all():
    """DTensor's all-to-all (a split moved to another dim) taken on every
    mesh, as on the card's.  On a CPU mesh DTensor replaces it by an
    all-gather and a chunk, for process groups without an all-to-all;
    the fake group and gloo both run it, so a count with ``--device cpu``
    counts the card's program."""
    raw = getattr(placement_types, "shard_dim_alltoall", None)

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu":
            return raw(input, gather_dim, shard_dim, mesh, mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    if raw is None:
        yield
        return
    placement_types.shard_dim_alltoall = all_to_all
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = raw


def count(run, args, pod_size: int = POD_SIZE) -> dict:
    """``run()`` under :class:`~.op_cost.OpCost` (DTensor's all-to-all
    taken on every mesh: :func:`card_all_to_all`), ``args`` its
    arguments: the counts in the artifact's fields."""
    cost = OpCost(pod_size)
    cost.arguments(args)
    with card_all_to_all(), cost:
        out = run()
    return cost.result(out)


# ---------------------------------------------------------------------------
# Meshes over a fake process group
# ---------------------------------------------------------------------------

def _mesh_dims(mesh_kind: str) -> tuple[tuple, tuple]:
    """The production mesh's (shape, axis names), or a reduced test mesh
    by REPRO_TEST_MESH=RxC (or PxRxC)."""
    tm = os.environ.get("REPRO_TEST_MESH")
    if tm:
        dims = tuple(int(x) for x in tm.split("x"))
    else:
        dims = (2, 16, 16) if mesh_kind == "multi" else (16, 16)
    axes = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
    return dims, axes


def fake_mesh(mesh_kind: str, device_type: str, dims: tuple | None = None):
    """A ``DeviceMesh`` of the mesh kind (or of ``dims``, axes ("data",
    "model") or ("pod", "data", "model")) over a fake process group of as
    many ranks, this process rank 0 (a group of another size is
    replaced)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dims is None:
        dims, axes = _mesh_dims(mesh_kind)
    else:
        axes = ("pod", "data", "model")[-len(dims):]
    n = 1
    for d in dims:
        n *= d
    if dist.is_initialized() and (dist.get_backend() != "fake"
                                  or dist.get_world_size() != n):
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs its own fake process "
                               "group; another group is initialized")
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        clear_sharding_caches()
    return init_device_mesh(device_type, dims, mesh_dim_names=axes)


def clear_sharding_caches() -> None:
    """Empty DTensor's caches of sharding propagation (the Python one of
    this thread and, where the release has one, the C++ one), whose
    entries hold the meshes, and so the process groups, of the layouts
    they saw: a group made anew starts from none of a destroyed one's."""
    prop = DTensor._op_dispatcher.sharding_propagator
    for cache in (prop.propagate_op_sharding,
                  getattr(prop, "_propagate_tensor_meta_cached", None)):
        if cache is not None:
            cache.cache_clear()
    fast = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                   None)
    if fast is not None:
        fast()


def card_for(device) -> str:
    """The card whose rates the artifact's counts are for: the card's own
    name on the card, else ``DEFAULT_CARD``; raises for a card the rate
    table does not hold."""
    card = DEFAULT_CARD
    if torch.device(device).type == "cuda":
        card = torch.cuda.get_device_name(torch.device(device))
    if card not in DEVICE_RATES:
        raise KeyError(f"no rates for {card!r}; the table holds "
                       f"{sorted(DEVICE_RATES)}")
    return card


def run_cell(arch: str, shape: str, mesh_kind: str, *,
             out_dir=ARTIFACT_DIR, force=False, device=None,
             layers: int | None = None) -> dict:
    """Count one cell and write its artifact (``layers`` cuts the depth:
    the config's ``n_layers``, recorded as ``layers`` and in the file's
    name)."""
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape}__{mesh_kind}" + (f"__{layers}l" if layers
                                              else "")
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    dev = resolve_device(device)
    mesh = fake_mesh(mesh_kind, dev.type)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "n_chips": mesh.size(), "ok": False,
           "card": card_for(dev), "device": dev.type}
    cut = None
    if layers:
        rec["layers"] = layers
        cut = dataclasses.replace(prod_config(arch, shape)[0],
                                  n_layers=layers)
    t0 = time.time()
    try:
        got = count_cell(arch, shape, mesh, dev, cfg=cut)
        mi = got.pop("mi")
        cfg = got.pop("cfg")
        rec.update(got)
        rec.update(ok=True, microbatches=got["microbatches"],
                   dp=list(mi.dp),
                   tp=list(mi.tp) if isinstance(mi.tp, tuple) else [mi.tp],
                   n_params=sum(p.numel() for p in LM(
                       cfg, "meta").parameters()))
    except Exception as e:  # noqa: BLE001 -- record the failure, keep going
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["seconds"] = round(time.time() - t0, 1)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu for fake CPU tensors (default: the card)")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted side by side, each in a process of "
                         "its own (its own fake group)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut each cell's depth to this many layers")
    args = ap.parse_args(argv)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    todo = [(arch, shape, mk) for arch, shape in cells for mk in meshes]
    if args.jobs > 1:
        _run_jobs(todo, args)
    recs = []
    for arch, shape, mk in todo:
        rec = run_cell(arch, shape, mk, out_dir=args.out,
                       force=args.force and args.jobs == 1,
                       device=args.device, layers=args.layers)
        recs.append(rec)
        status = "OK " if rec.get("ok") else "FAIL"
        mem = rec.get("memory_analysis", {})
        per_dev = (mem.get("argument_size_in_bytes", 0)
                   + mem.get("temp_size_in_bytes", 0)) / 1e9
        print(f"[{status}] {arch:22s} {shape:12s} {mk:6s} "
              f"flops={rec.get('flops_total', 0):.3e} "
              f"mem/dev={per_dev:.2f}GB "
              f"coll={rec.get('n_collective_lines', '-')} "
              f"{rec.get('seconds', 0):.1f}s"
              + ("" if rec.get("ok") else "  " + rec.get("error", "")[:120]),
              flush=True)
    return recs


def _run_jobs(todo: list, args) -> None:
    """Each cell by ``python -m repro_torch.launch.dryrun`` in a process of
    its own, ``args.jobs`` at a time, one torch thread each; the caller
    then reads the artifacts."""
    import concurrent.futures
    import subprocess
    import sys

    env = dict(os.environ, OMP_NUM_THREADS="1")
    flags = ["--out", args.out] + (["--force"] if args.force else [])
    if args.device:
        flags += ["--device", args.device]
    if args.layers:
        flags += ["--layers", str(args.layers)]

    def one(cell):
        arch, shape, mk = cell
        subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", arch, "--shape", shape, "--mesh", mk,
                        *flags], env=env, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL, check=False)

    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        list(pool.map(one, todo))


if __name__ == "__main__":
    main()
