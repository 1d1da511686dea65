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
"""
from __future__ import annotations

import torch

from ..models.model import LM
from .optimizer import OptConfig, adamw_init, adamw_update


def init_state(model: LM, opt_cfg: OptConfig) -> dict:
    """The model's parameters (already drawn: ``LM(cfg, device,
    generator)`` takes the reference's key's place), unfrozen, and a fresh
    AdamW state."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return {"params": params, "opt": adamw_init(opt_cfg, params)}


def build_train_step(model: LM, opt_cfg: OptConfig, *, microbatches: int = 1,
                     accum_dtype: str = "float32"):
    """``train_step(state, batch) -> (state, metrics)``; metrics ``loss``,
    ``grad_norm`` and ``lr`` (plus ``ce``, ``aux`` and ``ntok`` with one
    microbatch, as in the reference), as tensors on the model's device.
    ``accum_dtype='bfloat16'`` halves the accumulator's memory."""
    acc_dt = getattr(torch, accum_dtype)
    names = [n for n, _ in model.named_parameters()]

    def grads_of(params, batch):
        loss, metrics = model.loss_fn(batch)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
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
            grads = {n: torch.zeros(params[n].shape, dtype=acc_dt,
                                    device=params[n].device) for n in names}
            loss = torch.zeros((), dtype=torch.float32,
                               device=params[names[0]].device)
            for i in range(microbatches):
                l, _, g = grads_of(params, split(batch, i))
                grads = {n: grads[n] + g[n].to(acc_dt) for n in names}
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
