"""Named registries for the experiment API (optimizers, scorer backends,
objective terms, schedule ramps, grid augmentations).

The PlaceIT pipeline is pluggable at five seams:

* **optimizers** — search algorithms over a placement representation, all
  with the uniform signature ``(evaluator, rng, budget, params) -> OptResult``
  plus a typed params dataclass (``api.BRParams`` etc.).
* **scorer backends** — the Floyd-Warshall ``W -> (D, Ncnt)`` implementation
  that dominates evaluation time (paper Table V): the plain PyTorch version
  or the hand-written CUDA kernel, selected by name (``"fw-ref"``,
  ``"fw-cuda"``).
* **objective terms** — the summands of the placement cost function
  (paper §IV-B): the built-in ``lat`` / ``inv-thr`` / ``area`` terms plus
  penalty terms, composed into an ``objective.Objective`` and lowered into
  the scorer by ``objective.compile_objective``.
* **schedule ramps** — the shapes of constraint-hardening weight ramps
  (``objective.Schedule``): built-in ``linear`` / ``cosine`` / ``step``,
  with the uniform signature ``(t, start, end, params) -> scale`` over the
  run's progress fraction ``t`` in [0, 1].
* **augmentations** — alternatives to the paper's greedy augmentation for
  grid families: extra static candidate adjacencies (wraparound, express
  skip links) with the uniform signature
  ``(R, C, Z, sz_mm, params) -> list[AdjRecord]``
  (``repro_torch.arch3d.topology`` registers ``torus`` and ``express``).

Entries are registered with decorators::

    @register_optimizer("tabu", params_cls=TabuParams)
    def tabu(evaluator, rng, budget, params): ...

    @register_scorer_backend("fw-mine")
    def _build():            # zero-arg factory -> fw_impl callable
        return my_fw_impl

    @register_objective_term("power", host_fn=power_host)
    def power(sample, norms, objective, params): ...   # [P] tensor

Backends are registered as zero-arg *factories* so optional dependencies
(e.g. the CUDA build) are only touched when the backend is selected.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


class Registry:
    """A named, typo-friendly mapping used for all pluggable seams."""

    def __init__(self, kind: str):
        self.kind = kind
        self._items: dict[str, Any] = {}

    def add(self, name: str, obj: Any) -> Any:
        if name in self._items:
            raise ValueError(f"duplicate {self.kind} {name!r}")
        self._items[name] = obj
        return obj

    def get(self, name: str) -> Any:
        try:
            return self._items[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: "
                f"{', '.join(sorted(self._items)) or '(none)'}") from None

    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._items))

    def __contains__(self, name: str) -> bool:
        return name in self._items


@dataclass(frozen=True)
class OptimizerEntry:
    name: str
    fn: Callable            # (evaluator, rng, budget, params) -> OptResult
    params_cls: type        # typed hyper-parameter dataclass


@dataclass(frozen=True)
class ObjectiveTermEntry:
    """One cost-function summand (see ``repro_torch.core.objective``).

    ``fn(sample, norms, objective, params) -> [P]`` is the batched device
    implementation (torch tensors with a leading placement dimension,
    evaluated inside the scorer).
    ``host_fn(metrics, batch, norms, objective, params) -> [B]
    float64`` is the optional batched host-numpy implementation used for
    reporting and for the legacy ``cost.total_cost`` equivalence; when
    omitted, the device ``fn`` runs on CPU tensors instead (float32).
    """

    name: str
    fn: Callable
    host_fn: Callable | None = None


OPTIMIZERS = Registry("optimizer")
SCORER_BACKENDS = Registry("scorer backend")
OBJECTIVE_TERMS = Registry("objective term")
SCHEDULE_RAMPS = Registry("schedule ramp")
AUGMENTATIONS = Registry("augmentation")


def register_optimizer(name: str, *, params_cls: type):
    """Decorator: register ``fn(evaluator, rng, budget, params)`` under
    ``name`` with its typed params dataclass."""
    def deco(fn):
        OPTIMIZERS.add(name, OptimizerEntry(name, fn, params_cls))
        return fn
    return deco


def register_scorer_backend(name: str):
    """Decorator: register a zero-arg factory returning the fw_impl
    callable ``W -> (D, Ncnt)`` under ``name``."""
    def deco(factory):
        SCORER_BACKENDS.add(name, factory)
        return factory
    return deco


def register_objective_term(name: str, *, host_fn: Callable | None = None):
    """Decorator: register a per-placement cost term
    ``fn(sample, norms, objective, params) -> [P]`` (torch; evaluated in
    the scorer) under ``name``, with an optional float64 batched
    ``host_fn`` for host-side reporting/equivalence paths."""
    def deco(fn):
        OBJECTIVE_TERMS.add(name, ObjectiveTermEntry(name, fn, host_fn))
        return fn
    return deco


def register_schedule_ramp(name: str):
    """Decorator: register a weight-ramp shape
    ``fn(t, start, end, params) -> scale`` under ``name`` (``t`` is the
    run's progress fraction in [0, 1]; see ``objective.Schedule``)."""
    def deco(fn):
        SCHEDULE_RAMPS.add(name, fn)
        return fn
    return deco


def register_augmentation(name: str):
    """Decorator: register a grid augmentation
    ``fn(R, C, Z, sz_mm, params) -> list[AdjRecord]`` under ``name`` —
    extra static candidate adjacencies (masked like the base grid's) that
    replace the paper's greedy leftover-PHY augmentation on grid families
    (the 3D families of ``repro_torch.arch3d``)."""
    def deco(fn):
        AUGMENTATIONS.add(name, fn)
        return fn
    return deco


def resolve_backend(backend) -> Callable:
    """Resolve a backend name (or pass through a raw callable) to the
    fw_impl function.  Raw callables are allowed for the legacy
    ``Experiment.fw_impl`` shim and for experimentation."""
    if callable(backend):
        return backend
    return SCORER_BACKENDS.get(backend)()
