"""Carry state across from the JAX package (``repro``) into the port.

PlaceIT itself has no learned weights; its state is the experiment
configuration and objective (JSON), the normalizer vector ``[NORM_DIM]``
and weight vector ``[W_FIXED + n_terms]``, placements (``Sol`` = ``(types,
rot)`` or ``(order, rots)`` int8 arrays) and stacked ``ScoreGraph`` arrays (``W``, ``edges``,
``edge_mask``, ``area``, ``edge_len``). The functions here take that state
as plain numpy arrays, dicts or JSON — the form ``repro`` writes it in —
and return the port's objects and tensors on a given device. The LM
substrate's parameters (``repro.models.model.init_params``, a nested dict
of arrays) become the port's state dict with :func:`lm_params_from_jax`,
and its AdamW state the port's with :func:`adamw_state_from_jax`, so that
both packages can start a train step from one state.
Nothing here imports ``repro``: the caller converts its arrays with
``np.asarray``.
"""
from __future__ import annotations

import json
from typing import Mapping

import numpy as np
import torch

from .core.api import ExperimentConfig
from .core.chiplets import TRAFFIC_TYPES
from .core.cost import CostNormalizers
from .core.objective import NORM_DIM, Objective, weight_dim
from .models.model import GROUP_KEYS

GRAPH_KEYS = {"W": torch.float32, "edges": torch.long,
              "edge_mask": torch.bool, "area": torch.float32,
              "edge_len": torch.float32}


def config_from_json(s: str | Mapping) -> ExperimentConfig:
    """An ``ExperimentConfig`` from the reference's JSON (or dict) form;
    its kernel backend ``"fw-pallas"`` reads as ``"fw-cuda"``."""
    d = json.loads(s) if isinstance(s, str) else s
    return ExperimentConfig.from_dict(d)


def objective_from_json(s: str | Mapping) -> Objective:
    d = json.loads(s) if isinstance(s, str) else s
    return Objective.from_dict(d)


def norms_tensor(vec, device="cpu") -> torch.Tensor:
    """The reference's normalizer vector as a float32 tensor."""
    v = np.asarray(vec, np.float32)
    if v.shape[-1] != NORM_DIM:
        raise ValueError(f"normalizer vector needs {NORM_DIM} entries, got "
                         f"shape {v.shape}")
    return torch.as_tensor(v, device=device)


def normalizers_from_vec(vec) -> CostNormalizers:
    """``CostNormalizers`` from a ``[NORM_DIM]`` vector (``norms_vec``'s
    inverse), e.g. to give a port Evaluator the reference's draw."""
    v = np.asarray(vec, np.float64)
    if v.shape != (NORM_DIM,):
        raise ValueError(f"normalizer vector needs shape ({NORM_DIM},), got "
                         f"{v.shape}")
    return CostNormalizers(
        lat={t: float(v[i]) for i, t in enumerate(TRAFFIC_TYPES)},
        inv_thr={t: float(v[4 + i]) for i, t in enumerate(TRAFFIC_TYPES)},
        area=float(v[8]))


def weights_tensor(vec, objective: Objective, device="cpu") -> torch.Tensor:
    """The reference's weight vector for ``objective`` as a tensor."""
    v = np.asarray(vec, np.float32)
    if v.shape[-1] != weight_dim(objective):
        raise ValueError(f"weight vector needs {weight_dim(objective)} "
                         f"entries, got shape {v.shape}")
    return torch.as_tensor(v, device=device)


def sol_from_arrays(a, b) -> tuple[np.ndarray, np.ndarray]:
    """A placement as the port's int8 Sol, as the reference's reps write
    it: homogeneous ``(types, rot)`` [R, C], 3D ``(types, rot)`` [R, C, Z]
    or heterogeneous ``(order, rots)`` [N]."""
    t = np.array(a, dtype=np.int8)
    r = np.array(b, dtype=np.int8)
    if t.shape != r.shape or t.ndim not in (1, 2, 3):
        raise ValueError(f"Sol needs two equal [R, C], [R, C, Z] or [N] "
                         f"arrays, got {t.shape} and {r.shape}")
    return t, r


def graph_batch(batch: Mapping, device="cpu") -> dict:
    """Stacked ScoreGraph arrays as tensors on ``device``, in the dtypes
    the port's scorer uses (edges as long)."""
    missing = {"W", "edges", "edge_mask", "area"} - set(batch)
    if missing:
        raise ValueError(f"graph batch lacks {sorted(missing)}")
    return {k: torch.as_tensor(np.asarray(batch[k]), device=device).to(dt)
            for k, dt in GRAPH_KEYS.items() if k in batch}


def _lm_tensor(a) -> torch.Tensor:
    """float32 and int8 as they are; bfloat16 arrives viewed as uint16
    (numpy has no bfloat16 of its own) and is viewed back, bit for bit."""
    a = np.array(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype in (np.float32, np.int8):
        return torch.from_numpy(a)
    raise TypeError(f"LM parameters come as float32, or bfloat16 viewed as "
                    f"uint16 (8-bit optimizer states as int8); got "
                    f"{a.dtype}")


def _is_q8(t) -> bool:
    """An 8-bit optimizer state: ``{"q": int8 codes, "s": scales}``."""
    return isinstance(t, Mapping) and set(t) == {"q", "s"}


def _flatten(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, Mapping) and not _is_q8(val):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def _leaf(val, i: int | None = None):
    """A leaf (or an 8-bit state's pair) as tensors, its layer ``i`` of a
    stacked group where ``i`` is given."""
    if _is_q8(val):
        return {k: _leaf(v, i) for k, v in val.items()}
    t = _lm_tensor(val)
    return t if i is None else t[i]


def _unstack(tree: Mapping) -> dict:
    """A tree shaped as ``init_params``' output (its leaves arrays, or
    8-bit states) as the port's flat dict keyed by parameter name: each
    group of ``tree["groups"]`` (and of an encoder-decoder model's
    ``tree["enc_groups"]``), whose arrays stack the group's layers on a
    leading axis, becomes ``groups.<g>.<i>.<path>`` (``enc_groups.<g>.<i>.
    <path>``) entries, ``<path>`` the dotted keys inside the layer (an MoE
    layer's ``moe.we1``, a decoder layer's ``xattn.wq``)."""
    out = {}
    for key, val in tree.items():
        if key in GROUP_KEYS:
            for g, group in enumerate(val):
                for path, arr in _flatten(group):
                    n = np.shape(arr["q"] if _is_q8(arr) else arr)[0]
                    for i in range(n):
                        out[f"{key}.{g}.{i}.{path}"] = _leaf(arr, i)
        elif isinstance(val, Mapping) and not _is_q8(val):
            raise ValueError(f"LM parameters: unexpected subtree {key!r}")
        else:
            out[key] = _leaf(val)
    return out


def lm_params_from_jax(params: Mapping) -> dict:
    """The reference's LM parameters as the port's state dict (for
    ``repro_torch.models.model.LM.load_state_dict``).

    ``params`` is ``init_params``'s nested dict with numpy leaves: float32
    arrays, or bfloat16 arrays viewed as ``uint16``.  Each group of
    ``params["groups"]`` and ``params["enc_groups"]``, whose arrays stack
    the group's layers on a leading axis, is unstacked into
    ``groups.<g>.<i>.<path>`` (``enc_groups...``) entries; the rest keeps
    its key.  The tensors lie on the CPU; ``load_state_dict``
    copies them to the model's device and dtype."""
    return _unstack(params)


def adamw_state_from_jax(opt: Mapping, device="cpu") -> dict:
    """The reference's AdamW state (``repro.train.optimizer.adamw_init`` /
    ``adamw_update``: ``step``, ``m``, ``v`` and, with ``compress_int8``,
    ``err``) as the port's (``repro_torch.train.optimizer``), on
    ``device``.  The moment trees are unstacked exactly as
    :func:`lm_params_from_jax` unstacks the parameters, so that each entry
    is keyed by the parameter's name; 8-bit states (``{"q": int8, "s":
    float32}``) keep their codes and scales, a stacked state's row i
    being layer i's.  Leaves come as numpy arrays (float32, int8, the
    step int32)."""
    def on(t):
        if isinstance(t, dict):
            return {k: on(v) for k, v in t.items()}
        return t.to(device)

    out = {"step": torch.tensor(int(np.asarray(opt["step"])),
                                dtype=torch.int32, device=device)}
    for key in ("m", "v", "err"):
        if key in opt:
            out[key] = {n: on(t) for n, t in _unstack(opt[key]).items()}
    return out


def lm_cache_from_jax(caches, device="cpu") -> list:
    """The reference's decode caches (``init_cache``'s list, one nested
    dict a group, each leaf the group's layers stacked on a leading axis:
    float32 arrays, or bfloat16 viewed as ``uint16``) as the port's
    (``LM.init_cache``'s: the same nesting and shapes), on ``device``, bit
    for bit."""
    def on(tree):
        if isinstance(tree, Mapping):
            return {k: on(v) for k, v in tree.items()}
        return _lm_tensor(tree).to(device)

    return [on(c) for c in caches]
