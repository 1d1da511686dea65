"""AdamW with float32 states, global-norm clipping, LR schedules, and
optional int8 gradient compression with error feedback.

The port of ``repro.train.optimizer``.  Parameters, gradients and states
are dicts keyed by the model's parameter names (``LM.named_parameters``);
a state entry is a float32 tensor, or ``{"q": int8, "s": float32}`` with
8-bit states.  :func:`adamw_update` is functional, as the reference's: it
returns new parameters and a new state (``train.step`` copies the
parameters back into the model).  Not ``torch.optim.AdamW``: the update
follows the reference's order of operations, which that class does not
(it decays the weights before the step and updates bfloat16 parameters in
their own dtype):

- the gradients are clipped by their global norm, then (``compress_int8``)
  quantized with error feedback, in blocks laid over the reference's
  leaves (a group's layers stacked);
- bias correction with a float32 step count;
- the weight decay is added to the Adam direction, ``delta = m^ /
  (sqrt(v^) + eps) + wd p``;
- a parameter is updated in float32 and cast to its dtype once.

The reference stacks each group's layers on a leading axis, so a group
parameter (a ``groups.`` or ``enc_groups.`` name) has one axis more
there: the 8-bit state rule, which keeps leaves of fewer than two axes in
float32, counts that axis, so that a state carried across
(``interop.adamw_state_from_jax``) keeps its form.

Under model parallelism (``train.step.build_sharded_train_step``) the
parameters, gradients and states are DTensors laid out by the sharding
rules, and the update runs on them as it is: the global norm sums every
shard, and ``compress_int8``'s blocks, which span the shards of a leaf,
are laid over the whole leaves, so that they give the unsharded result.
On a mesh of pods the state is split over ("pod", "data") and the
parameters over "data" alone (hierarchical ZeRO); there each such leaf's
gradient and parameter are moved to the state's layout, updated on the
state's shard, and the new parameter gathered back over the pod axis, by
collectives that the port chooses (``sharding.partition.state_plan``),
not DTensor's planner.  :func:`compressed_psum` is the int8-quantized
all-reduce over a mesh axis.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models.model import GROUP_KEYS
from ..sharding.partition import (amax_rows, current_ctx, cut,
                                  pod_partial_over, state_plan,
                                  to_param_layout, to_state_layout)


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine | linear | const
    compress_int8: bool = False       # int8 grad quantization + err feedback
    compress_block: int = 256
    state_int8: bool = False          # 8-bit Adam m/v (row-wise scales)


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (float32): linear warm-up, then the
    schedule's decay over the remaining steps."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "linear":
        decay = 1.0 - t
    else:
        decay = 1.0
    return cfg.lr * warm * decay


# ---------------------------------------------------------------------------
# int8 block quantization + error feedback
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor, block: int = 256):
    """Block-wise symmetric int8 quantization: returns (q, scales)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blk = flat.reshape(nb, block).float()
    scale = blk.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blk / torch.where(scale == 0, 1.0, scale)).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale, shape, block: int = 256):
    blk = q.float() * scale
    n = math.prod(shape)
    return blk.reshape(-1)[:n].reshape(shape)


def compressed_psum(x: torch.Tensor, axis_name: str, block: int = 256,
                    mesh=None) -> torch.Tensor:
    """Int8-quantized all-reduce over a mesh axis: each rank quantizes its
    contribution (``quantize_int8``), dequantizes it, and the dequantized
    values are summed over the ranks of ``axis_name`` (the reference sums
    the dequantized values too).  ``x`` is this rank's local tensor; the
    mesh is ``mesh``, by default the installed sharding context's."""
    if mesh is None:
        ctx = current_ctx()
        if ctx is None:
            raise ValueError("compressed_psum needs a mesh (or an installed "
                             "sharding context)")
        mesh = ctx.mi.mesh
    q, s = quantize_int8(x, block)
    deq = dequantize_int8(q, s, x.shape, block)
    dist.all_reduce(deq, op=dist.ReduceOp.SUM,
                    group=mesh.get_group(axis_name))
    return deq


def stacks(names) -> list[list[str]]:
    """The parameter names as the reference's leaves: the layers of a
    group that share a path (``groups.<g>.<i>.<path>``, i = 0, 1, ...;
    likewise ``enc_groups``) form one stacked leaf, every other name a
    leaf of its own."""
    out, at = [], {}
    for name in names:
        parts = name.split(".", 3)
        if parts[0] in GROUP_KEYS and len(parts) == 4:
            key = (parts[0], parts[1], parts[3])
            if key not in at:
                at[key] = len(out)
                out.append([])
            out[at[key]].append(name)
        else:
            out.append([name])
    return out


def compress_grads(grads: dict, err: dict, block: int = 256):
    """Quantize grads + err to int8 and return (dequantized, new_err).
    The blocks run over each reference leaf, a group's layers stacked
    (:func:`stacks`), so that they fall where the reference's do.  DTensor
    leaves are gathered whole for it, and the results cut back to their
    layouts."""
    if any(isinstance(g, DTensor) for g in grads.values()):
        deq, new_err = compress_grads(
            {n: _whole(g) for n, g in grads.items()},
            {n: _whole(e) for n, e in err.items()}, block)
        return ({n: _cut_like(t, grads[n]) for n, t in deq.items()},
                {n: _cut_like(t, err[n]) for n, t in new_err.items()})
    deq, new_err = {}, {}
    for names in stacks(grads):
        tot = torch.cat([(grads[n].float() + err[n]).reshape(-1)
                         for n in names])
        q, s = quantize_int8(tot, block)
        d = dequantize_int8(q, s, tot.shape, block)
        at = 0
        for n in names:
            g, e = grads[n], err[n]
            dn = d[at:at + g.numel()].reshape(g.shape).to(g.dtype)
            deq[n] = dn
            new_err[n] = (tot[at:at + g.numel()].reshape(g.shape)
                          - dn.float()).to(e.dtype)
            at += g.numel()
    return deq, new_err


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _cut_like(t: torch.Tensor, like):
    """``t`` (the same on every rank) laid out as ``like`` is."""
    if not isinstance(like, DTensor):
        return t
    return cut(t, like.device_mesh, like.placements)


# ---------------------------------------------------------------------------
# 8-bit Adam state (row-wise int8 + a float32 scale a row)
# ---------------------------------------------------------------------------

def _q8(x: torch.Tensor) -> dict:
    """Quadratic-map int8: code c -> sign(c) * (|c|/127)^2 * rowmax.

    Quantizing in sqrt-space concentrates resolution near zero (linear
    int8 zeroes small second moments and Adam's 1/sqrt(v) explodes)."""
    s = amax_rows(x.abs())
    xn = x / torch.where(s == 0, 1.0, s)
    q = (torch.round(torch.sqrt(xn.abs()) * 127.0) * torch.sign(xn)
         ).to(torch.int8)
    return {"q": q, "s": s[..., 0]}


def _dq8(t) -> torch.Tensor:
    if isinstance(t, dict):
        c = t["q"].float() / 127.0
        return torch.sign(c) * c * c * t["s"][..., None]
    return t


def stacked_ndim(name: str, x: torch.Tensor) -> int:
    """The number of axes the leaf has in the reference, whose groups
    stack their layers on a leading axis."""
    return x.dim() + (1 if name.split(".", 1)[0] in GROUP_KEYS else 0)


def _maybe_q8(name: str, x: torch.Tensor, use: bool):
    # tiny leaves (norms, biases outside the groups) stay float32
    return _q8(x) if use and stacked_ndim(name, x) >= 2 else x


def _plan(p, m):
    """The leaf's move between its parameter's layout and its state's
    (``partition.state_plan``), or None where the two are one."""
    m = m["q"] if isinstance(m, dict) else m
    if not (isinstance(p, DTensor) and isinstance(m, DTensor)):
        return None
    return state_plan(p, m.placements)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(cfg: OptConfig, params: dict) -> dict:
    """Zero moments (and error feedback with ``compress_int8``) on each
    parameter's device, a step count of 0 (int32)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    first = next(iter(params.values()))
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "m": {n: _maybe_q8(n, zeros(p), cfg.state_int8)
              for n, p in params.items()},
        "v": {n: _maybe_q8(n, zeros(p), cfg.state_int8)
              for n, p in params.items()},
    }
    if cfg.compress_int8:
        state["err"] = {n: zeros(p) for n, p in params.items()}
    return state


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def _reduce_over_pods(grads: dict, params: dict, state: dict,
                      donate: bool) -> tuple[dict, set]:
    """The gradients that are partial sums over the pods (the train step
    on a mesh of pods) reduced, once a step, before the global norm reads
    them: a leaf whose state splits over the pods is moved to its state's
    shard by a reduce-scatter over the pod axis (``to_state_layout``),
    any other reduced to its parameter's layout.  Returns the gradients
    (``grads`` itself when ``donate``) and the names of those moved."""
    out = grads if donate else dict(grads)
    moved = set()
    for name in list(out):
        if not pod_partial_over(out[name]):
            continue
        plan = _plan(params[name], state["m"][name])
        if plan is not None:
            out[name] = to_state_layout(out[name], plan)
            moved.add(name)
        else:
            p = params[name]
            out[name] = out[name].redistribute(p.device_mesh, p.placements)
    return out, moved


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads: dict, state: dict, params: dict,
                 donate: bool = False):
    """Returns (new_params, new_state, metrics): new tensors, the inputs
    untouched, unless ``donate``: then each leaf's gradient and old
    moments are taken out of ``grads`` and ``state`` as its new moments
    are made, so that the old and the new state never live whole at once
    (the caller passes a state it will not read again, as the reference's
    launcher donates its state to the jitted step).  Metrics:
    ``grad_norm`` (before clipping) and ``lr``.

    Each leaf's float32 gradient is made when its update runs, and the
    update's intermediates are computed in place on tensors the update
    made itself (each operation rounds as its out-of-place form does), so
    at most a few float32 copies of the largest leaf live at once: with
    recurrentgemma-9b's 1.05 B-entry embedding the out-of-place update held
    about seven (29 GB) beside a float32 copy of every gradient.

    A leaf whose state splits over a mesh dim more than its parameter (a
    mesh of pods) is updated on the state's shard: its gradient and
    parameter moved there first, its new parameter gathered back after
    (``partition.to_state_layout``, ``to_param_layout``); the arithmetic
    is the same.  Every other leaf is updated in the layouts it has."""
    step = state["step"] + 1
    grads, moved = _reduce_over_pods(grads, params, state, donate)
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                         max=1.0)
             if cfg.clip_norm else 1.0)
    new_err = None
    if cfg.compress_int8:
        grads, new_err = compress_grads(
            {n: g.float() * scale for n, g in grads.items()}, state["err"],
            cfg.compress_block)
        scale = None
    b1, b2 = cfg.betas
    lr = lr_at(cfg, step)
    stepf = step.float()
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    new_params, new_m, new_v = {}, {}, {}
    take = dict.pop if donate else dict.__getitem__
    for name, p in params.items():
        plan = _plan(p, state["m"][name])
        g = take(grads, name)
        if plan is not None:
            if name not in moved:
                g = to_state_layout(g, plan)
            p = to_state_layout(p, plan)
        g = g.float()
        if scale is not None:
            g = g * scale
        m = b1 * _dq8(take(state["m"], name)) + (1 - b1) * g
        v = b2 * _dq8(take(state["v"], name)) + (1 - b2) * g * g
        del g
        delta = m / bc1                                    # mh
        den = v / bc2                                      # vh
        delta.div_(den.sqrt_().add_(cfg.eps))
        del den
        if cfg.weight_decay:
            delta.add_(cfg.weight_decay * p.float())
        new_p = p.to(torch.float32, copy=True)
        new_p = new_p.sub_(delta.mul_(lr)).to(p.dtype)
        new_params[name] = (new_p if plan is None
                            else to_param_layout(new_p, plan))
        del delta, new_p
        new_m[name] = _maybe_q8(name, m, cfg.state_int8)
        new_v[name] = _maybe_q8(name, v, cfg.state_int8)
    new_state = {"step": step, "m": new_m, "v": new_v}
    if new_err is not None:
        new_state["err"] = new_err
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
