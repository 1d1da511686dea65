"""Run a function on several CPU ranks (gloo) for the port's tests.

:func:`run_ranks` spawns ``world`` processes once, each joining a gloo
process group through a ``FileStore`` under the test's temporary
directory (no port to collide on between xdist workers), with one torch
thread a rank, and returns each rank's result.  The functions run here
import torch and ``repro_torch`` only: the children never load JAX, and
the tests compare their results with the reference in the parent.
"""
import contextlib
import math
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _main(rank: int, world: int, tmp: str, fn, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world)
    try:
        out = fn(rank, tmp, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"result_{rank}.pt"))


def run_ranks(fn, world: int, tmp, *args) -> list:
    """``fn(rank, tmp, *args)`` on ``world`` gloo ranks; the ranks'
    results (anything ``torch.save`` takes), in rank order."""
    return start_ranks(fn, world, tmp, *args)()


def start_ranks(fn, world: int, tmp, *args):
    """:func:`run_ranks` started, not waited for: returns the function
    that waits for the ranks and returns their results."""
    tmp = str(tmp)
    ctx = mp.start_processes(_main, args=(world, tmp, fn, args),
                             nprocs=world, start_method="spawn", join=False)

    def results() -> list:
        while not ctx.join():
            pass
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"),
                           weights_only=False) for r in range(world)]

    return results


# ---------------------------------------------------------------------------
# The ranks' work
# ---------------------------------------------------------------------------

def psum_rank(rank, tmp, xs, blocks, lin):
    """``compressed_psum`` of ``xs[rank]`` over a 2-rank axis for each
    block size (the mesh passed, and the installed context's); and of
    ``lin`` over an axis of one rank."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding.partition import (MeshInfo, ShardingCtx,
                                                use_sharding)
    from repro_torch.train.optimizer import compressed_psum

    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("d",))
    x = torch.from_numpy(xs[rank])
    out = {b: compressed_psum(x, "d", b, mesh=mesh).numpy() for b in blocks}
    with use_sharding(ShardingCtx(MeshInfo(mesh=mesh, dp=("d",)))):
        out["ctx"] = compressed_psum(x, "d").numpy()
    one = init_device_mesh("cpu", (2, 1), mesh_dim_names=("x", "d"))
    out["one"] = compressed_psum(torch.from_numpy(lin), "d",
                                 mesh=one).numpy()
    return out


def lm_batch(cfg, B: int, S: int, seed: int) -> dict:
    """A training batch from ``seed``: tokens, their next tokens as labels
    (the last few masked with -1), and an encoder-decoder model's
    ``src_embeds``."""
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(3, cfg.vocab, (B, S), generator=g)
    labels = toks.roll(-1, 1)
    labels[:, -3:] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.randn(B, S // 2 + 1, cfg.d_model,
                                          generator=g)
    return batch


def _grads(model, batch, names):
    loss, _ = model.loss_fn(batch)
    return loss.detach(), torch.autograd.grad(
        loss, [dict(model.named_parameters())[n] for n in names])


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


@contextlib.contextmanager
def _counting_state_moves():
    """Counts the leaves that the AdamW update moves to their state's
    layout by hand (``train.optimizer``'s ``to_state_layout``: a mesh of
    pods) while entered."""
    from repro_torch.train import optimizer

    raw = optimizer.to_state_layout
    n = [0]

    def to_state_layout(x, plan):
        n[0] += 1
        return raw(x, plan)

    optimizer.to_state_layout = to_state_layout
    try:
        yield n
    finally:
        optimizer.to_state_layout = raw


@contextlib.contextmanager
def _counting_row_blocks():
    """Counts the weight gradients computed a block of rows a rank
    (``sharding.partition._RowBlockGrad``'s backward) while entered."""
    from repro_torch.sharding import partition

    fn, raw = partition._RowBlockGrad, partition._RowBlockGrad.backward
    n = [0]

    def backward(ctx, dy):
        n[0] += 1
        return raw(ctx, dy)

    fn.backward = staticmethod(backward)
    try:
        yield n
    finally:
        fn.backward = staticmethod(raw)


def step_pair(cfg, mesh, opt_cfg, microbatches: int = 1, steps: int = 2,
              B: int = 4, S: int = 16) -> dict:
    """The plain step and the DTensor step on ``mesh`` from one state:
    the loss and the gradients of the first batch (the largest gradient
    error over the parameters, relative to each one's largest entry), and
    ``steps`` train steps of each (losses, gradient norms, the largest
    parameter difference after them; ``bitwise`` if every loss, norm and
    parameter is equal bit for bit)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.train import sharded_training
    from repro_torch.models.model import LM
    from repro_torch.sharding import rules
    from repro_torch.sharding.partition import MeshInfo, use_sharding
    from repro_torch.sharding.partition import place
    from repro_torch.train.step import build_train_step, init_state

    plain = LM(cfg, "cpu", torch.Generator().manual_seed(0))
    model = LM(cfg, "cpu", torch.Generator().manual_seed(0))
    s1 = init_state(plain, opt_cfg)
    st1 = build_train_step(plain, opt_cfg, microbatches=microbatches)
    s2, st2, shardings = sharded_training(model, opt_cfg, mesh,
                                          microbatches=microbatches)
    names = list(s1["params"])
    batch = lm_batch(cfg, B, S, 100)
    l1, g1 = _grads(plain, batch, names)
    mi = MeshInfo(mesh=mesh, dp=tuple(a for a in ("pod", "data")
                                      if a in mesh.mesh_dim_names),
                  tp="model")
    with use_sharding(rules.make_ctx(cfg, mi)), implicit_replication(), \
            _counting_row_blocks() as row_blocks:
        db = place(batch, {k: mi.named(v) for k, v in
                           rules.batch_pspecs(batch, mi).items()})
        l2, g2 = _grads(model, db, names)
    out = {"loss": (float(l1), float(_whole(l2))),
           "row_block_grads": row_blocks[0],
           "grad_err": max(float((_whole(b) - a).abs().max()
                                 / a.abs().max().clamp(min=1e-30))
                           for a, b in zip(g1, g2)),
           "losses": [], "norms": [], "bitwise": True}
    with _counting_state_moves() as moves:
        for i in range(steps):
            batch = lm_batch(cfg, B, S, i)
            s1, m1 = st1(s1, batch)
            s2, m2 = st2(s2, batch)
            out["losses"].append((float(m1["loss"]), float(m2["loss"])))
            out["norms"].append((float(m1["grad_norm"]),
                                 float(m2["grad_norm"])))
            out["bitwise"] &= bool(torch.equal(m1["loss"], m2["loss"])
                                   and torch.equal(m1["grad_norm"],
                                                   m2["grad_norm"]))
    out["state_moves"] = moves[0]
    errs = [(s1["params"][n] - _whole(s2["params"][n])).abs().max()
            for n in names]
    out["param_err"] = float(max(errs))
    out["bitwise"] &= all(float(e) == 0 for e in errs)
    out["placements"] = {n: tuple(str(p) for p in s2["params"][n].placements)
                         for n in names}
    out["shardings"] = {n: tuple(str(p) for p in shardings["params"][n][1])
                        for n in names}
    out["opt_misplaced"] = [
        (str(t.placements), str(sh.placements))
        for t, sh in zip(_leaves(s2["opt"]), _leaves(shardings["opt"]))
        if t.placements != sh.placements]
    return out


def model_parallel_rank(rank, tmp, cases, one_by_one, launcher):
    """Each case ``(name, cfg, (dp, tp), opt_cfg, microbatches)``:
    :func:`step_pair` on a (dp, tp) mesh of the ranks.  Each
    ``one_by_one`` config: :func:`step_pair` on a (1, 1) mesh of this rank
    alone (two ranks).  Then, given a ``launcher``, ``launch.train.main(
    launcher)`` on both ranks (its losses), and an elastic restore: a
    state saved from a (1, 2) mesh restored onto (2, 1) and onto no
    mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    out = {"cases": {}, "one": {}}
    for name, cfg, shape, opt_cfg, mb in cases:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=(
            "pod", "data", "model")[-len(shape):])
        out["cases"][name] = step_pair(cfg, mesh, opt_cfg, mb)
    if launcher is None:
        return out
    own = init_device_mesh("cpu", (2, 1, 1),
                           mesh_dim_names=("rank", "data", "model"))
    for name, cfg, opt_cfg in one_by_one:
        out["one"][name] = step_pair(cfg, own["data", "model"], opt_cfg)
    from repro_torch.launch import train as launch_train
    _, ls = launch_train.main(launcher + ["--ckpt-dir",
                                          os.path.join(tmp, "launch")],
                              log=lambda *_: None)
    out["launcher"] = [loss for _, loss, _ in ls.history]
    out["elastic"] = _elastic(tmp, one_by_one[0][1], one_by_one[0][2])
    return out


def state_layout_rank(rank, tmp, cases):
    """Each case ``(dims, shape, param spec, state spec)``: a tensor
    (``arange``, the same on every rank) laid out on a ("pod", "data",
    "model") mesh of ``dims`` by the parameter's spec, moved to the
    state's layout and back by hand (``partition.to_state_layout``,
    ``to_param_layout``): whether a plan was made, and whether each move
    gives the shard that DTensor's own layout holds."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding import partition as pt

    out = []
    for dims, shape, p_spec, s_spec in cases:
        mesh = init_device_mesh("cpu", dims,
                                mesh_dim_names=("pod", "data", "model"))
        t = torch.arange(math.prod(shape), dtype=torch.float32
                         ).reshape(shape)
        x = pt.cut(t, mesh, pt.placements(mesh, p_spec))
        want = pt.cut(t, mesh, pt.placements(mesh, s_spec))
        plan = pt.state_plan(x, want.placements)
        if plan is None:
            out.append({"plan": False})
            continue
        y = pt.to_state_layout(x, plan)
        back = pt.to_param_layout(y, plan)
        out.append({"plan": True,
                    "to_state": torch.equal(y.to_local(), want.to_local())
                    and y.placements == want.placements,
                    "to_param": torch.equal(back.to_local(), x.to_local())
                    and back.placements == x.placements})
    return out


def pod_rank(rank, tmp, cases, layout_cases):
    """:func:`model_parallel_rank`'s cases (on meshes with a "pod" axis)
    and :func:`state_layout_rank`'s."""
    return {**model_parallel_rank(rank, tmp, cases, [], None),
            "layouts": state_layout_rank(rank, tmp, layout_cases)}


def _elastic(tmp, cfg, opt_cfg) -> dict:
    """A state after one step on a (1, 2) mesh, saved, then restored onto
    a (2, 1) mesh's shardings and onto no mesh: whether every leaf equals
    the saved state's bit for bit, and whether the restored leaves lie as
    the (2, 1) shardings say."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch.train import sharded_training
    from repro_torch.models.model import LM
    from repro_torch.train.loop import _load_into

    d = os.path.join(tmp, "elastic")
    m12 = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    m21 = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    state, step, _ = sharded_training(
        LM(cfg, "cpu", torch.Generator().manual_seed(0)), opt_cfg, m12)
    state, _ = step(state, lm_batch(cfg, 4, 16, 7))
    ckpt.save(d, 1, state)
    saved = _flat({k: state[k] for k in state})
    target, _, sh21 = sharded_training(
        LM(cfg, "cpu", torch.Generator().manual_seed(1)), opt_cfg, m21)
    onto, _, _ = ckpt.restore(d, target, shardings=sh21)
    _load_into(target, onto)
    plain, _, _ = ckpt.restore(d, target)
    got21, gotp = _flat(target), _flat(plain)
    return {"n": len(saved),
            "onto_21": all(torch.equal(saved[k], got21[k]) for k in saved),
            "onto_none": all(torch.equal(saved[k], gotp[k]) for k in saved),
            "plain": not any(isinstance(t, DTensor) for t in _leaves(plain)),
            "misplaced": [(str(t.placements), str(s.placements))
                          for t, s in zip(_leaves(target), _leaves(sh21))
                          if t.placements != s.placements
                          or t.device_mesh != m21]}


def _leaves(tree) -> list:
    """The leaves of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix: _whole(tree).detach().clone()}


# ---------------------------------------------------------------------------
# The dry run's counts and sharded serving (tests/test_torch_dryrun.py)
# ---------------------------------------------------------------------------

def _named_tree(specs, mi):
    if isinstance(specs, dict):
        return {k: _named_tree(v, mi) for k, v in specs.items()}
    return mi.named(specs)


def _cache_leaves(tree) -> list:
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _cache_leaves(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _cache_leaves(tree[k])]
    return [tree]


def serve_pair(cfg, shape, B: int, S: int, cache_len: int, lengths) -> dict:
    """Prefill and decode on a (dp, tp) ``shape`` mesh of the ranks,
    parameters laid out by the rules, against the plain model from the
    same seed: the largest differences of the prefill's logits and caches,
    and of a decode step's logits and written caches (from random caches,
    the rows' ``lengths`` so far), and each decode cache's placements."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.model import LM
    from repro_torch.models.tree import tree_map
    from repro_torch.sharding import rules
    from repro_torch.sharding.partition import (MeshInfo, place,
                                                shard_module, use_sharding)

    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    mi = MeshInfo(mesh=mesh, dp=("data",), tp="model")
    plain = LM(cfg, "cpu", torch.Generator().manual_seed(0))
    model = LM(cfg, "cpu", torch.Generator().manual_seed(0))
    specs = rules.param_pspecs(cfg, dict(model.named_parameters()), mi)
    shard_module(model, _named_tree(specs, mi))
    g = torch.Generator().manual_seed(1)
    mem = S + 3 if cfg.family == "encdec" else 0
    batch = {"tokens": torch.randint(3, cfg.vocab, (B, S), generator=g)}
    if mem:
        batch["src_embeds"] = torch.randn(B, mem, cfg.d_model, generator=g)

    def placed(b):
        return place(b, {k: mi.named(v) for k, v in
                         rules.batch_pspecs(b, mi).items()})

    def err(a, b):
        return max(float((_whole(y) - x).abs().max())
                   for x, y in zip(_cache_leaves(a), _cache_leaves(b)))

    l1, c1 = plain.prefill(batch, cache_len)
    with use_sharding(rules.make_ctx(cfg, mi, cache_len=cache_len,
                                     seq_shard_attn=True)), \
            implicit_replication():
        l2, c2 = model.prefill(placed(batch), cache_len)
    out = {"prefill_logits": err(l1, l2), "prefill_caches": err(c1, c2)}
    dec = {"tokens": torch.randint(3, cfg.vocab, (B, 1), generator=g),
           "lengths": torch.tensor(lengths, dtype=torch.int32)}
    if mem:
        dec["mem_len"] = torch.tensor([mem - i for i in range(B)],
                                      dtype=torch.int32)
    gc = torch.Generator().manual_seed(5)
    c1 = [tree_map(lambda t: torch.randn(t.shape, generator=gc).to(t.dtype),
                   c) for c in plain.init_cache(B, cache_len, mem)]
    c2 = [tree_map(torch.clone, c) for c in c1]
    d1 = plain.decode_step(dec, c1)
    cs = rules.cache_pspecs(cfg, c2, mi, cache_len=cache_len)
    with use_sharding(rules.make_ctx(cfg, mi, cache_len=cache_len)), \
            implicit_replication():
        dc = [place(c, _named_tree(s, mi)) for c, s in zip(c2, cs)]
        d2 = model.decode_step(placed(dec), dc)
    out.update(decode_logits=err(d1, d2), decode_caches=err(c1, dc),
               placements=[str(t.placements) for t in _cache_leaves(dc)])
    return out


def dryrun_rank(rank, tmp, count_cases, serve_cases):
    """Each count case ``(name, arch, cfg, shape_spec, mesh, mb)``: the
    dry run's cell (``launch.dryrun.build_cell``) on real CPU tensors on
    a (dp, tp) mesh of the ranks, counted (``launch.dryrun.count``).
    Each serve case ``(name, cfg, mesh, B, S, cache_len, lengths)``:
    :func:`serve_pair`."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun

    from repro_torch.kernels import custom_ops

    out = {"counts": {}, "serve": {}}
    # The wrappers send only fake tensors to the kernels' custom ops; the
    # count cases send these ranks' real ones there too, so that they run
    # the program the fake group counts (each op's body is the plain
    # version with the kernel's outputs).
    is_fake, custom_ops.is_fake = custom_ops.is_fake, lambda t: True
    try:
        for name, arch, cfg, spec, shape, mb in count_cases:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            run, args, _, _, _ = dryrun.build_cell(
                arch, spec, mesh, torch.device("cpu"), cfg=cfg,
                microbatches=mb)
            out["counts"][name] = dryrun.count(run, args)
    finally:
        custom_ops.is_fake = is_fake
    for name, cfg, shape, B, S, cache_len, lengths in serve_cases:
        out["serve"][name] = serve_pair(cfg, shape, B, S, cache_len, lengths)
    return out
