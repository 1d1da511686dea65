"""The train step: gradients (with microbatch accumulation) and the AdamW
update.  The port of ``repro.train.step``.

The state is ``{"params": {name: parameter}, "opt": adamw state}``, where
the parameters are the model's own (``LM.named_parameters``): a step
differentiates ``model.loss_fn`` with autograd, computes the update
functionally (``optimizer.adamw_update``) and copies the new values into
the model's parameters in place, so that the model always holds the
state's parameters.  A step consumes its input state: the update takes
each leaf's old moments out of it as it makes the new ones (``donate``),
as the reference's launcher donates the state to its jitted step, so
that two AdamW states never live whole at once (moonshot-v1-16b-a3b at 4
layers: 23.6 GB of float32 moments each).  The batch is split on its leading axis into
``microbatches``; their gradients are accumulated in ``accum_dtype``
(float32 by default, whatever the parameters' dtype), then divided by the
count, as the reference does.

Model parallelism (:func:`build_sharded_train_step`) runs the same step on
DTensors: :func:`shard_state` lays the model's parameters and the AdamW
state out over a ``DeviceMesh`` by the sharding rules
(``sharding.rules.param_pspecs``, the step count replicated; on a mesh of
pods the state over ("pod", "data"), the parameters over "data"), each
batch is split by ``batch_pspecs``, and the step runs under the rules'
activation constraints (``sharding.partition.use_sharding``).  On a mesh
of one rank it computes the plain step's numbers bit for bit.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..models.model import LM
from ..sharding import rules
from ..sharding.partition import (P, NamedSharding, ShardingCtx,
                                  param_grad, place, placements,
                                  shard_module, use_sharding)
from .optimizer import OptConfig, adamw_init, adamw_update


def init_state(model: LM, opt_cfg: OptConfig) -> dict:
    """The model's parameters (already drawn: ``LM(cfg, device,
    generator)`` takes the reference's key's place), unfrozen, and a fresh
    AdamW state."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return {"params": params, "opt": adamw_init(opt_cfg, params)}


def build_train_step(model: LM, opt_cfg: OptConfig, *, microbatches: int = 1,
                     accum_dtype: str = "float32", place=None):
    """``train_step(state, batch) -> (state, metrics)``; metrics ``loss``,
    ``grad_norm`` and ``lr`` (plus ``ce``, ``aux`` and ``ntok`` with one
    microbatch, as in the reference), as tensors on the model's device.
    ``accum_dtype='bfloat16'`` halves the accumulator's memory.
    ``place`` (a batch -> batch function) lays out each microbatch after
    the split (:func:`build_sharded_train_step` splits it over the mesh)."""
    acc_dt = getattr(torch, accum_dtype)
    names = [n for n, _ in model.named_parameters()]

    def grads_of(params, batch):
        if place is not None:
            batch = place(batch)
        loss, metrics = model.loss_fn(batch)
        ps = [params[n] for n in names]
        grads = torch.autograd.grad(loss, ps)
        grads = [param_grad(g, p) if isinstance(g, DTensor) else g
                 for g, p in zip(grads, ps)]
        return loss.detach(), metrics, dict(zip(names, grads))

    def split(batch, i):
        return {k: x[i * (x.shape[0] // microbatches):
                     (i + 1) * (x.shape[0] // microbatches)]
                for k, x in batch.items()}

    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            # The accumulator starts as the first microbatch's gradients,
            # so that it keeps their layout (a partial sum stays one).
            loss = torch.zeros((), dtype=torch.float32,
                               device=params[names[0]].device)
            for i in range(microbatches):
                l, _, g = grads_of(params, split(batch, i))
                grads = ({n: x.to(acc_dt) for n, x in g.items()} if i == 0
                         else {n: grads[n] + g[n].to(acc_dt) for n in names})
                loss = loss + l
            grads = {n: g / microbatches for n, g in grads.items()}
            loss = loss / microbatches
            metrics = {}
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, grads, state["opt"], params, donate=True)
        with torch.no_grad():
            for n in names:
                params[n].copy_(new_params[n])
        out = {"loss": loss, **opt_metrics,
               **{k: v.detach() for k, v in metrics.items()}}
        return {"params": params, "opt": new_opt}, out

    return train_step


# ---------------------------------------------------------------------------
# Model parallelism: the same step on DTensors over a DeviceMesh
# ---------------------------------------------------------------------------

def _named(specs, mi):
    if isinstance(specs, dict):
        return {k: _named(v, mi) for k, v in specs.items()}
    return mi.named(specs)


def shard_state(model: LM, opt_cfg: OptConfig, mi,
                opt_mi) -> tuple[dict, dict]:
    """The model's parameters laid out over ``mi.mesh`` by the rules
    (replaced in the model by DTensor parameters cut from the tensors it
    holds, which every rank drew from the same seed), and a fresh AdamW
    state laid out by ``opt_mi``'s rules (its FSDP axes: on a mesh of pods
    the state is split over ("pod", "data"), elsewhere as the
    parameters), the step count replicated.  Returns (state, shardings),
    the shardings a tree of ``NamedSharding``s like the state (what
    ``train.loop.run`` and ``ckpt.restore`` take)."""
    cfg = model.cfg
    specs = rules.param_pspecs(cfg, dict(model.named_parameters()), mi)
    shard_module(model, _named(specs, mi))
    state = init_state(model, opt_cfg)
    o_specs = rules.param_pspecs(cfg, state["opt"], opt_mi)
    o_specs["step"] = P()
    shardings = {"params": _named(specs, mi),
                 "opt": _named(o_specs, opt_mi)}
    state["opt"] = place(state["opt"], shardings["opt"])
    return state, shardings


def build_sharded_train_step(model: LM, opt_cfg: OptConfig,
                             ctx: ShardingCtx, shardings: dict, *,
                             microbatches: int = 1,
                             accum_dtype: str = "float32"):
    """The train step on :func:`shard_state`'s state: each microbatch (a
    plain batch, the same on every rank) split by ``batch_pspecs``, the
    step run under ``use_sharding(ctx)`` (plain tensors it makes, as
    positions and masks, taken as replicated), the new AdamW state laid
    out as ``shardings`` says, and the metrics returned as plain tensors,
    the same on every rank."""
    mi = ctx.mi

    def place_batch(batch):
        specs = rules.batch_pspecs(batch, mi)
        return place(batch, {k: NamedSharding(mi.mesh, placements(
            mi.mesh, specs[k], x.shape)) for k, x in batch.items()})

    raw = build_train_step(model, opt_cfg, microbatches=microbatches,
                           accum_dtype=accum_dtype, place=place_batch)

    def train_step(state, batch):
        with use_sharding(ctx), implicit_replication():
            state, metrics = raw(state, batch)
            # The update leaves each moment in its state layout (on a mesh
            # of pods too: ``optimizer.adamw_update``), so this moves
            # nothing but a leaf whose layout DTensor's arithmetic changed.
            state["opt"] = place(state["opt"], shardings["opt"])
        return state, {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}

    return train_step
