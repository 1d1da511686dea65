"""Registry-driven experiment API (config-first, pluggable), in PyTorch.

The port of the single-experiment part of ``repro.core.api``:

* :class:`ExperimentConfig` — one experiment (arch x chiplet config x
  algorithms x budget x seeds); its dict/JSON form is the reference's, so
  one JSON loads and runs in both packages (the reference's backend
  ``"fw-pallas"`` reads as its counterpart ``"fw-cuda"``, which is written
  back as ``"fw-pallas"``).
* :class:`Budget` and the typed per-algorithm hyper-parameters
  (:class:`BRParams`, :class:`GAParams`, :class:`SAParams`) with the
  paper's Table III/IV defaults, for the host loops ``"br"``, ``"ga"``,
  ``"sa"`` and their device-resident forms ``"br-batched"``,
  ``"ga-batched"``, ``"sa-batched"`` (``optimize.DevicePipeline``).
* Named scorer backends: ``"fw-tiled"`` (the default: a size dispatch
  between the two hand-written CUDA FW kernels, ``ops.fw_impl_tiled``),
  ``"fw-cuda"`` (the cluster-resident CUDA FW kernel for every V) and
  ``"fw-ref"`` (the plain PyTorch version).
* :func:`run_experiment` and :func:`baseline_cost`, which run on the card
  unless the caller passes ``device="cpu"``; without a card and without
  ``device`` they raise (see ``proxies.resolve_device``).
* :func:`run_sweep` — many configs at once, sharing one ``Evaluator``
  (normalizer draw) per (arch, seed, ...) and one scorer per (layout,
  chunk, backend, objective structure, device) across the whole sweep,
  folding SA repetitions into extra chains of one batched call and
  running every stackable optimizer in lockstep with its scoring requests
  concatenated into single scorer calls (``optimize.drive_stacked``).  A
  :class:`SweepConfig` with a ``pareto_grid`` runs a Pareto sweep
  (``repro_torch.core.pareto``).
* ``workload:`` — a traffic :class:`repro_torch.netsim.workload.Workload`
  backing a ``trace-lat`` / ``trace-thr`` objective term; its JSON form is
  the reference's.
* ``archive_k:`` — a top-K population archive per Evaluator
  (``optimize.PopArchive``) that thickens Pareto fronts; ``shard`` splits
  every stacked scoring call's population axis across devices
  (``repro_torch.sharding.population``).
* :class:`DesignRequest` / :class:`DesignUpdate` / :class:`DesignResponse`
  — the design service's request schema (engine:
  ``repro_torch.serve.design``), with the reference's dict form.
* The 3D / hierarchical families (``ARCH3D``: ``repro_torch.arch3d``)
  dispatch through :func:`make_rep` like any other arch name.

Per-algorithm RNG streams are derived with :func:`algo_seed` from a stable
CRC32 digest of the algorithm name, as in the reference, so a seed gives
the same placements in both packages.
"""
from __future__ import annotations

import dataclasses
import json
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

import numpy as np

from ..kernels import ops
from .baseline import MeshBaseline
from .cache import LRUCache
from .chiplets import ARCH3D, LARGE_HOMOG, ArchSpec, resolve_arch
from .objective import Objective, Schedule
from .optimize import (Evaluator, OptResult, best_random,
                       best_random_batched, best_random_batched_steps,
                       best_random_steps, drive_stacked, genetic_algorithm,
                       genetic_algorithm_batched,
                       genetic_algorithm_batched_steps,
                       genetic_algorithm_steps, simulated_annealing,
                       simulated_annealing_batched,
                       simulated_annealing_batched_steps,
                       simulated_annealing_steps)
from .placement_hetero import HeteroRep
from .placement_homog import HomogRep, hex_mask
from .proxies import make_scorer, resolve_device
from .registries import (OPTIMIZERS, OptimizerEntry, register_optimizer,
                         register_scorer_backend, resolve_backend)

# Paper §V-B grid sizes: R*C >= N with one spare row of slack.
GRID_DIMS = {32 + 4 + 4: (8, 5), 64 + 8 + 8: (10, 8)}

# 100+-chiplet (HexaMesh-regime) grids: (R, C, hex side or None).  hex127
# places 127 chiplets on the centered-hexagonal mask of side 7 (13x13
# grid, 127 allowed cells).
LARGE_GRIDS = {
    "homog100": (10, 10, None),
    "homog144": (12, 12, None),
    "homog256": (16, 16, None),
    "hex127": (13, 13, 7),
}


# ---------------------------------------------------------------------------
# Budget + typed per-algorithm hyper-parameters.
# ---------------------------------------------------------------------------

_DEFAULT_EVALS = object()          # sentinel: "300 unless seconds is given"


@dataclass(frozen=True)
class Budget:
    """Evaluation and/or wall-clock budget; at least one must be set.

    ``evals`` is per repetition; ``seconds`` matches the paper's 3600 s
    wall budget.  When both are set the first one to expire stops the run.
    ``Budget()`` means 300 evals; ``Budget(seconds=3600.0)`` means one hour
    with *no* eval cap.
    """

    evals: int | None = _DEFAULT_EVALS  # type: ignore[assignment]
    seconds: float | None = None

    def __post_init__(self):
        if self.evals is _DEFAULT_EVALS:
            object.__setattr__(
                self, "evals", None if self.seconds is not None else 300)
        if self.evals is None and self.seconds is None:
            raise ValueError("Budget needs evals and/or seconds")

    def scaled(self, k: int) -> "Budget":
        """Budget for ``k`` repetitions folded into one batched call."""
        return dataclasses.replace(
            self, evals=None if self.evals is None else self.evals * k)

    def to_dict(self) -> dict:
        return {"evals": self.evals, "seconds": self.seconds}

    @classmethod
    def from_dict(cls, d: Mapping) -> "Budget":
        return cls(evals=d.get("evals"), seconds=d.get("seconds"))


@dataclass(frozen=True)
class BRParams:
    """Best Random (§II-B1)."""

    batch: int = 32            # placements per batched scoring call


@dataclass(frozen=True)
class GAParams:
    """Genetic Algorithm (§II-B2; Table III/IV)."""

    population: int = 50
    elitism: int = 8
    tournament: int = 8
    p_mutation: float = 0.5


@dataclass(frozen=True)
class SAParams:
    """Simulated Annealing (§II-B3; Table III/IV + adaptive cooling).

    ``chains`` > 1 runs independent chains scored as one batch per step;
    optimizers whose params carry a ``chains`` field are eligible for
    repetition-folding in :func:`run_sweep`.
    """

    t0_temp: float = 35.0
    block_len: int = 50
    alpha: float = 1.0
    beta: float = 5.0
    chains: int = 1


# ---------------------------------------------------------------------------
# Optimizer registry entries: uniform (evaluator, rng, budget, params).
# ---------------------------------------------------------------------------

# Budget -> driver-kwargs mappings, shared by the registered entry points
# and the run_sweep step-generator factories below, so the stacked and
# unstacked paths can never diverge.

def _br_kwargs(budget: Budget, params: BRParams) -> dict:
    return dict(max_evals=budget.evals, time_budget_s=budget.seconds,
                batch=params.batch)


def _ga_kwargs(budget: Budget, params: GAParams) -> dict:
    max_gen = (None if budget.evals is None
               else max(1, budget.evals // params.population))
    return dict(population=params.population, elitism=params.elitism,
                tournament=params.tournament, p_mutation=params.p_mutation,
                time_budget_s=budget.seconds, max_generations=max_gen)


def _sa_kwargs(budget: Budget, params: SAParams) -> dict:
    max_it = (None if budget.evals is None
              else max(1, budget.evals // params.chains))
    return dict(t0_temp=params.t0_temp, block_len=params.block_len,
                alpha=params.alpha, beta=params.beta, chains=params.chains,
                time_budget_s=budget.seconds, max_iters=max_it)


@register_optimizer("br", params_cls=BRParams)
def _run_br(evaluator: Evaluator, rng: np.random.Generator, budget: Budget,
            params: BRParams) -> OptResult:
    return best_random(evaluator, rng, **_br_kwargs(budget, params))


@register_optimizer("ga", params_cls=GAParams)
def _run_ga(evaluator: Evaluator, rng: np.random.Generator, budget: Budget,
            params: GAParams) -> OptResult:
    return genetic_algorithm(evaluator, rng, **_ga_kwargs(budget, params))


@register_optimizer("sa", params_cls=SAParams)
def _run_sa(evaluator: Evaluator, rng: np.random.Generator, budget: Budget,
            params: SAParams) -> OptResult:
    return simulated_annealing(evaluator, rng, **_sa_kwargs(budget, params))


# Device-resident variants: whole generations / chain-blocks are produced
# as batched generate→graph→score requests via optimize.DevicePipeline,
# with invalid individuals masked-and-resampled in batch.  Same typed
# params as their host-loop counterparts; paper defaults apply through the
# "-batched" suffix stripping in _base_params.

@register_optimizer("br-batched", params_cls=BRParams)
def _run_br_batched(evaluator: Evaluator, rng: np.random.Generator,
                    budget: Budget, params: BRParams) -> OptResult:
    return best_random_batched(evaluator, rng, **_br_kwargs(budget, params))


def _ga_batched_kwargs(budget: Budget, params: GAParams) -> dict:
    # ga-batched scores elites once (population up front, then only the
    # population - elitism children per generation), so the evals->
    # generations conversion differs from the host GA's evals//population.
    per_gen = max(params.population - params.elitism, 1)
    max_gen = (None if budget.evals is None
               else max(1, (budget.evals - params.population) // per_gen))
    return dict(population=params.population, elitism=params.elitism,
                tournament=params.tournament, p_mutation=params.p_mutation,
                time_budget_s=budget.seconds, max_generations=max_gen)


@register_optimizer("ga-batched", params_cls=GAParams)
def _run_ga_batched(evaluator: Evaluator, rng: np.random.Generator,
                    budget: Budget, params: GAParams) -> OptResult:
    return genetic_algorithm_batched(evaluator, rng,
                                     **_ga_batched_kwargs(budget, params))


@register_optimizer("sa-batched", params_cls=SAParams)
def _run_sa_batched(evaluator: Evaluator, rng: np.random.Generator,
                    budget: Budget, params: SAParams) -> OptResult:
    return simulated_annealing_batched(evaluator, rng,
                                       **_sa_kwargs(budget, params))


# ---------------------------------------------------------------------------
# Scorer backends (the fw_impl seam; paper Table V hot spot).
# ---------------------------------------------------------------------------

@register_scorer_backend("fw-cuda")
def _backend_fw_cuda() -> Callable:
    """The cluster-resident CUDA FW kernel for CUDA tensors, every V (the
    plain version for CPU tensors); the counterpart of the reference's
    "fw-pallas"."""
    return ops.fw_impl_cuda


@register_scorer_backend("fw-ref")
def _backend_fw_ref() -> Callable:
    """The plain PyTorch Floyd-Warshall + path counts, on any device."""
    return ops.fw_impl_ref


@register_scorer_backend("fw-tiled")
def _backend_fw_tiled() -> Callable:
    """The default: size dispatch between the cluster-resident CUDA kernel
    and the blocked CUDA kernel, each where it was measured faster
    (``ops.fw_takes_tiled``); the plain versions for CPU tensors.  The
    reference's "fw-tiled" is its own size dispatch."""
    return ops.fw_impl_tiled


# The reference's kernel backend name, read as its counterpart here, and
# each port backend's name in the reference (a port JSON runs there).
_BACKEND_ALIASES = {"fw-pallas": "fw-cuda"}
_REFERENCE_NAMES = {"fw-cuda": "fw-pallas"}
DEFAULT_BACKEND = "fw-tiled"


# ---------------------------------------------------------------------------
# Paper Table III/IV defaults, typed.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ArchDefaults:
    ga: GAParams
    sa: SAParams
    mutation_mode: str


PAPER_DEFAULTS: dict[tuple[str, int], ArchDefaults] = {
    ("homog", 32): ArchDefaults(
        ga=GAParams(population=200, elitism=30, tournament=30),
        sa=SAParams(t0_temp=40.0, block_len=250),
        mutation_mode="neighbor-one"),
    ("homog", 64): ArchDefaults(
        ga=GAParams(population=50, elitism=8, tournament=8),
        sa=SAParams(t0_temp=35.0, block_len=50),
        mutation_mode="neighbor-one"),
    ("hetero", 32): ArchDefaults(
        ga=GAParams(population=30, elitism=6, tournament=6),
        sa=SAParams(t0_temp=33.0, block_len=50),
        mutation_mode="any-one"),
    ("hetero", 64): ArchDefaults(
        ga=GAParams(population=20, elitism=5, tournament=5),
        sa=SAParams(t0_temp=28.0, block_len=45),
        mutation_mode="any-one"),
}

# Defaults for the 100+-chiplet families: GA/SA shapes from the paper's
# homog64 row (the closest calibrated point).
LARGE_DEFAULTS = ArchDefaults(
    ga=GAParams(population=50, elitism=8, tournament=8),
    sa=SAParams(t0_temp=35.0, block_len=50),
    mutation_mode="neighbor-one")

# Defaults for the 3D / hierarchical families (repro_torch.arch3d): the
# homog64 row's GA/SA shapes with a slightly smaller population — the
# stacked grids are denser (every cell occupied).
ARCH3D_DEFAULTS = ArchDefaults(
    ga=GAParams(population=32, elitism=6, tournament=6),
    sa=SAParams(t0_temp=35.0, block_len=50),
    mutation_mode="neighbor-one")


def arch_family(arch_name: str) -> tuple[str, int]:
    if arch_name in LARGE_GRIDS:
        # "hex127" has no "homog" prefix and no 32/64 substring.
        return "homog", sum(LARGE_HOMOG[arch_name])
    if arch_name in ARCH3D:
        return "arch3d", sum(ARCH3D[arch_name])
    fam = "homog" if arch_name.startswith("homog") else "hetero"
    size = 32 if "32" in arch_name else 64
    return fam, size


def paper_defaults(arch_name: str) -> ArchDefaults:
    if arch_name in LARGE_GRIDS:
        return LARGE_DEFAULTS
    if arch_name in ARCH3D:
        return ARCH3D_DEFAULTS
    return PAPER_DEFAULTS[arch_family(arch_name)]


def algo_seed(seed: int, repetition: int, algo: str) -> int:
    """Stable per-(repetition, algorithm) RNG stream — CRC32, not hash(),
    so the stream survives PYTHONHASHSEED / process changes."""
    return seed + 1000 * repetition + zlib.crc32(algo.encode()) % 997


def make_rep(arch: ArchSpec, arch_name: str,
             mutation_mode: str | None = None):
    """Placement representation for a named architecture (§V-A / §VI-A,
    plus the LARGE_GRIDS 100+-chiplet families and the ARCH3D families)."""
    fam, _ = arch_family(arch_name)
    mode = mutation_mode or paper_defaults(arch_name).mutation_mode
    if fam == "arch3d":
        # Lazy import: the arch3d package imports core modules.
        from ..arch3d.families import make_rep3d
        return make_rep3d(arch, arch_name, mutation_mode=mode)
    if fam == "hetero":
        return HeteroRep(arch, mutation_mode=mode)
    if arch_name in LARGE_GRIDS:
        R, C, hex_side = LARGE_GRIDS[arch_name]
        allowed = None if hex_side is None else hex_mask(hex_side)
        return HomogRep(arch, R=R, C=C, mutation_mode=mode, allowed=allowed)
    n = len(arch.chiplets)
    R, C = GRID_DIMS.get(n, (int(np.ceil(np.sqrt(n))),) * 2)
    return HomogRep(arch, R=R, C=C, mutation_mode=mode)


# ---------------------------------------------------------------------------
# Scorer cache: one scorer per (layout, chunk, backend, objective
# *structure*, shape key, device) — a bounded LRU, so a long-lived process
# cannot leak scorers.  Hits, misses and evictions are counted and
# surfaced through scorer_cache_stats() / SweepStats.
# ---------------------------------------------------------------------------

SCORER_CACHE_CAPACITY = 64

_SCORER_CACHE: LRUCache = LRUCache(SCORER_CACHE_CAPACITY)
_SCORER_STATS = {"hits": 0, "misses": 0}


def get_scorer(layout, *, chunk: int, backend: str,
               objective: Objective | None = None,
               shape_key=None, device=None) -> Callable:
    """Cached batched scorer (with the compiled objective in it).  Two
    Evaluators over the same layout and device share one scorer, with its
    index tensors already on the device; normalizers and objective
    *weights* are runtime arguments, so only the term structure
    (:meth:`Objective.structure_key`) forces a new scorer.

    ``shape_key`` splits the cache for representations whose graph-array
    shapes the layout alone does not fix: 3D families over the same
    chiplet set (``repro_torch.arch3d``, e.g. stack3d32 vs torus3d32)
    share a ``Layout`` but emit different edge-slot counts, and
    ``run_sweep`` and the design engine group stacked runs by scorer
    identity — a shared scorer would concatenate unlike batches."""
    objective = objective if objective is not None else Objective()
    dev = resolve_device(device)
    key = (layout, chunk, backend, objective.structure_key(), shape_key,
           str(dev))
    hit = key in _SCORER_CACHE
    _SCORER_STATS["hits" if hit else "misses"] += 1
    if not hit:
        _SCORER_CACHE[key] = make_scorer(
            layout, chunk=chunk, fw_impl=resolve_backend(backend),
            objective=objective, device=dev)
    return _SCORER_CACHE[key]


def scorer_cache_stats() -> dict:
    return dict(_SCORER_STATS, evictions=_SCORER_CACHE.evictions,
                size=len(_SCORER_CACHE),
                capacity=_SCORER_CACHE.capacity)


def set_scorer_cache_capacity(n: int) -> None:
    """Bound the scorer LRU (evicting down if needed)."""
    _SCORER_CACHE.set_capacity(n)


def clear_scorer_cache() -> None:
    _SCORER_CACHE.clear()
    _SCORER_CACHE.evictions = 0
    _SCORER_STATS.update(hits=0, misses=0)


def clear_pipeline_cache() -> None:
    """Drop the device pipeline's cached produce→graph stages (per-arch
    static W matrices included); the scorer cache is separate."""
    from .optimize import DevicePipeline
    DevicePipeline.clear_stage_cache()


def make_evaluator(rep, arch: ArchSpec, *, rng: np.random.Generator,
                   norm_samples: int, chunk: int = 16,
                   backend: str = DEFAULT_BACKEND, fw_impl=None,
                   objective: Objective | None = None,
                   schedule: Schedule | None = None,
                   norm=None, archive_k: int = 0,
                   workload=None, device=None) -> Evaluator:
    """Evaluator wired to a named backend on ``device`` (default: the
    card); raw ``fw_impl`` callables bypass the cache.  ``objective``
    defaults to the one built from the arch's (deprecated) ``w_*`` weights
    — the paper formula for paper archs.  ``workload`` (a
    :class:`repro_torch.netsim.workload.Workload`) backs a ``trace-lat`` /
    ``trace-thr`` objective term — a runtime scorer operand, so it does
    not enter the scorer cache key.  ``archive_k`` > 0 attaches a top-K
    population archive on the device
    (:class:`repro_torch.core.optimize.PopArchive`)."""
    dev = resolve_device(device)
    objective = (objective if objective is not None
                 else Objective.from_arch(arch))
    if fw_impl is not None:
        return Evaluator(rep, arch, rng=rng, norm_samples=norm_samples,
                         chunk=chunk, fw_impl=fw_impl, objective=objective,
                         schedule=schedule, norm=norm, archive_k=archive_k,
                         workload=workload, device=dev)
    scorer = get_scorer(rep.layout, chunk=chunk, backend=backend,
                        objective=objective,
                        shape_key=getattr(rep, "scorer_shape_key", None),
                        device=dev)
    return Evaluator(rep, arch, rng=rng, norm_samples=norm_samples,
                     chunk=chunk, scorer=scorer, objective=objective,
                     schedule=schedule, norm=norm, archive_k=archive_k,
                     workload=workload)


# ---------------------------------------------------------------------------
# ExperimentConfig: declarative, serializable.
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=True)
class ExperimentConfig:
    """One experiment: architecture x chiplet config x algorithms.

    ``params`` holds per-algorithm overrides (typed dataclasses or plain
    dicts); anything unspecified falls back to the paper's Table III/IV
    defaults for the architecture.  Round-trips via to/from_dict/json with
    the reference's keys.  The device is not a field (a new key would break
    JSON parity): it is the ``device`` argument of the entry points.
    """

    arch: str                              # homog32|homog64|hetero32|hetero64
    config: str = "baseline"               # baseline | placeit (§VII)
    algorithms: tuple[str, ...] = ("br", "ga", "sa")
    repetitions: int = 1
    budget: Budget = field(default_factory=Budget)
    norm_samples: int = 100                # paper: 500
    seed: int = 0
    backend: str = DEFAULT_BACKEND
    chunk: int = 16
    mutation_mode: str | None = None       # None -> paper default
    params: dict = field(default_factory=dict)
    # Cost function (repro_torch.core.objective); the default reproduces
    # the paper formula.
    objective: Objective = field(default_factory=Objective)
    # Constraint-hardening weight ramps over each run's progress; None =
    # static weights.
    schedule: Schedule | None = None
    # > 0 keeps a device-resident top-K archive of every evaluated
    # placement (optimize.PopArchive); Pareto sweeps re-score it as extra
    # front candidates.
    archive_k: int = 0
    # Traffic workload (repro_torch.netsim.workload.Workload, or its dict
    # form) backing a `trace-lat` objective term; None for proxy-only
    # search.
    workload: object | None = None

    def __post_init__(self):
        object.__setattr__(self, "algorithms", tuple(self.algorithms))
        if not isinstance(self.objective, Objective):
            object.__setattr__(self, "objective",
                               Objective.from_dict(self.objective))
        if self.workload is not None and isinstance(self.workload, Mapping):
            # Lazy import: the netsim package imports core modules.
            from ..netsim.workload import Workload
            object.__setattr__(self, "workload",
                               Workload.from_dict(self.workload))
        if self.schedule is not None and \
                not isinstance(self.schedule, Schedule):
            object.__setattr__(self, "schedule",
                               Schedule.from_dict(self.schedule))
        # Normalize overrides to typed params (validates algo names too).
        norm = {}
        for algo, ov in self.params.items():
            entry: OptimizerEntry = OPTIMIZERS.get(algo)
            if isinstance(ov, entry.params_cls):
                norm[algo] = ov
            else:
                norm[algo] = dataclasses.replace(
                    self._base_params(algo, entry), **dict(ov))
        object.__setattr__(self, "params", norm)

    def _base_params(self, algo: str, entry: OptimizerEntry):
        try:
            d = paper_defaults(self.arch)
        except KeyError:
            d = None
        # "-batched" variants inherit their host-loop counterpart's paper
        # defaults (same search hyper-parameters, different execution).
        base = algo[:-len("-batched")] if algo.endswith("-batched") else algo
        if d is not None and isinstance(getattr(d, base, None),
                                        entry.params_cls):
            return getattr(d, base)
        return entry.params_cls()

    def resolved_params(self, algo: str):
        """Paper defaults for this arch, overridden by ``self.params``."""
        if algo in self.params:
            return self.params[algo]
        return self._base_params(algo, OPTIMIZERS.get(algo))

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "config": self.config,
            "algorithms": list(self.algorithms),
            "repetitions": self.repetitions,
            "budget": self.budget.to_dict(),
            "norm_samples": self.norm_samples, "seed": self.seed,
            "backend": _REFERENCE_NAMES.get(self.backend, self.backend),
            "chunk": self.chunk,
            "mutation_mode": self.mutation_mode,
            "params": {a: dataclasses.asdict(p)
                       for a, p in self.params.items()},
            "objective": self.objective.to_dict(),
            "schedule": (None if self.schedule is None
                         else self.schedule.to_dict()),
            "archive_k": self.archive_k,
            "workload": (None if self.workload is None
                         else self.workload.to_dict()),
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "ExperimentConfig":
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown ExperimentConfig keys: "
                             f"{sorted(unknown)}")
        if isinstance(d.get("budget"), Mapping):
            d["budget"] = Budget.from_dict(d["budget"])
        if "algorithms" in d:
            d["algorithms"] = tuple(d["algorithms"])
        if "backend" in d:
            d["backend"] = _BACKEND_ALIASES.get(d["backend"], d["backend"])
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return cls.from_dict(json.loads(s))

    def __eq__(self, other):
        if not isinstance(other, ExperimentConfig):
            return NotImplemented
        return self.to_dict() == other.to_dict()

    def __hash__(self):
        # The generated field-tuple hash would choke on the params dict;
        # hash the canonical serialized form instead.  Workloads hash by
        # content digest instead of their full [K, n, n] rate payload.
        d = self.to_dict()
        if d.get("workload") is not None:
            d["workload"] = self.workload.digest()
        return hash(json.dumps(d, sort_keys=True))


# ---------------------------------------------------------------------------
# run_experiment / baseline_cost.
# ---------------------------------------------------------------------------

@dataclass
class RunRecord:
    arch: str
    config: str
    algorithm: str
    repetition: int
    result: OptResult
    seconds: float
    # Traffic types whose cost normalizer fell back to 1.0 because every
    # norm sample was disconnected (see cost.CostNormalizers.degenerate).
    degenerate_norms: tuple = ()


def run_experiment(config: ExperimentConfig, *, fw_impl=None, device=None
                   ) -> list[RunRecord]:
    """Run every (repetition x algorithm) of one config on ``device``
    (default: the card).

    The reference's loop: one fresh Evaluator (and normalizer draw) per
    repetition, one RNG stream per algorithm (:func:`algo_seed`).
    ``fw_impl`` is the raw-callable hook; prefer ``config.backend``.
    """
    dev = resolve_device(device)
    arch = resolve_arch(config.arch, config.config)
    entries = [OPTIMIZERS.get(a) for a in config.algorithms]   # fail fast
    records: list[RunRecord] = []
    for rep_i in range(config.repetitions):
        rng = np.random.default_rng(config.seed + 1000 * rep_i)
        rep = make_rep(arch, config.arch, config.mutation_mode)
        ev = make_evaluator(rep, arch, rng=rng,
                            norm_samples=config.norm_samples,
                            chunk=config.chunk, backend=config.backend,
                            fw_impl=fw_impl, objective=config.objective,
                            schedule=config.schedule,
                            archive_k=config.archive_k,
                            workload=config.workload, device=dev)
        for entry in entries:
            t0 = time.monotonic()
            rng_a = np.random.default_rng(
                algo_seed(config.seed, rep_i, entry.name))
            res = entry.fn(ev, rng_a, config.budget,
                           config.resolved_params(entry.name))
            records.append(RunRecord(config.arch, config.config, entry.name,
                                     rep_i, res, time.monotonic() - t0,
                                     degenerate_norms=ev.degenerate_norms))
    return records


def baseline_cost(config: ExperimentConfig, *, fw_impl=None, device=None
                  ) -> tuple[float, dict]:
    """2D-mesh baseline scored with the same normalizers (§VII), on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    arch = resolve_arch(config.arch, config.config)
    rng = np.random.default_rng(config.seed)
    rep = make_rep(arch, config.arch, config.mutation_mode)
    ev = make_evaluator(rep, arch, rng=rng,
                        norm_samples=config.norm_samples,
                        chunk=config.chunk, backend=config.backend,
                        fw_impl=fw_impl, objective=config.objective,
                        workload=config.workload, device=dev)
    g = MeshBaseline(arch).build()[0]
    metrics = ev.score([g])
    cost = float(np.asarray(ev.costs_from(metrics))[0])
    return cost, {k: float(v[0]) for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# run_sweep: batched multi-config execution.
# ---------------------------------------------------------------------------

@dataclass
class SweepRun:
    config: ExperimentConfig
    records: list[RunRecord]


@dataclass
class SweepStats:
    scorers_built: int         # scorers built by this sweep (cache misses)
    evaluators_built: int      # normalizer draws (shared across reps)
    n_evaluated: int
    seconds: float
    score_calls: int = 0       # scorer calls across the whole sweep
    stacked_groups: int = 0    # lockstep groups with >= 2 runs
    scorer_evictions: int = 0  # scorers dropped by the LRU
    shard_devices: int = 1     # devices the population axis was split over


@dataclass
class SweepResult:
    runs: list[SweepRun]
    stats: SweepStats
    # Per base-config Pareto fronts (repro_torch.core.pareto.ParetoFront)
    # when the sweep was launched from a SweepConfig with a pareto_grid.
    fronts: list | None = None

    @property
    def records(self) -> list[RunRecord]:
        return [r for run in self.runs for r in run.records]


@dataclass(frozen=True)
class SweepConfig:
    """A whole sweep as one serializable value (the reference's JSON form).

    ``configs`` are the base experiments.  With a ``pareto_grid``
    (:class:`repro_torch.core.pareto.ParetoGridSpec`), each base config is
    expanded into one config per grid scalarization (same term structure,
    different runtime weights — they share one scorer and stack in
    lockstep), and ``run_sweep`` attaches one
    :class:`repro_torch.core.pareto.ParetoFront` per base config to
    ``SweepResult.fronts``.  ``shard`` splits the population axis of
    every stacked scoring call across devices (see :func:`run_sweep`).
    """

    configs: tuple = ()
    pareto_grid: object | None = None      # pareto.ParetoGridSpec
    fold_repetitions: bool = True
    stack_scoring: bool = True
    shard: bool = False

    def __post_init__(self):
        object.__setattr__(self, "configs", tuple(
            c if isinstance(c, ExperimentConfig)
            else ExperimentConfig.from_dict(c) for c in self.configs))
        if self.pareto_grid is not None:
            from .pareto import ParetoGridSpec
            if not isinstance(self.pareto_grid, ParetoGridSpec):
                object.__setattr__(self, "pareto_grid",
                                   ParetoGridSpec.from_dict(self.pareto_grid))

    def to_dict(self) -> dict:
        return {"configs": [c.to_dict() for c in self.configs],
                "pareto_grid": (None if self.pareto_grid is None
                                else self.pareto_grid.to_dict()),
                "fold_repetitions": self.fold_repetitions,
                "stack_scoring": self.stack_scoring,
                "shard": self.shard}

    @classmethod
    def from_dict(cls, d: Mapping) -> "SweepConfig":
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown SweepConfig keys: {sorted(unknown)}")
        return cls(**dict(d))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1)

    @classmethod
    def from_json(cls, s: str) -> "SweepConfig":
        return cls.from_dict(json.loads(s))


# Step-generator factories for optimizers that support lockstep stacked
# scoring in run_sweep: same Budget -> kwargs mapping as the registered
# entry points (shared helpers above), different executor.

def _br_steps(ev, rng, budget: Budget, params: BRParams):
    return best_random_steps(ev, rng, **_br_kwargs(budget, params))


def _ga_steps(ev, rng, budget: Budget, params: GAParams):
    return genetic_algorithm_steps(ev, rng, **_ga_kwargs(budget, params))


def _sa_steps(ev, rng, budget: Budget, params: SAParams):
    return simulated_annealing_steps(ev, rng, **_sa_kwargs(budget, params))


def _br_batched_steps(ev, rng, budget: Budget, params: BRParams):
    return best_random_batched_steps(ev, rng, **_br_kwargs(budget, params))


def _ga_batched_steps(ev, rng, budget: Budget, params: GAParams):
    return genetic_algorithm_batched_steps(
        ev, rng, **_ga_batched_kwargs(budget, params))


def _sa_batched_steps(ev, rng, budget: Budget, params: SAParams):
    return simulated_annealing_batched_steps(
        ev, rng, **_sa_kwargs(budget, params))


# Every optimizer is a step generator, so the whole family stacks —
# including SA (host chains) and the device-resident *-batched drivers
# (their requests are pre-stacked device batches).
_SWEEP_STACKABLE = {
    "br": _br_steps, "ga": _ga_steps, "sa": _sa_steps,
    "br-batched": _br_batched_steps, "ga-batched": _ga_batched_steps,
    "sa-batched": _sa_batched_steps,
}


def stackable_steps(algo: str):
    """Step-generator factory ``(ev, rng, budget, params) -> generator``
    for a lockstep-stackable optimizer, or ``None`` if ``algo`` only runs
    synchronously.  Public seam for the design service (serve.design)."""
    return _SWEEP_STACKABLE.get(algo)


# ---------------------------------------------------------------------------
# Design-service request/response schema (engine: repro_torch.serve.design).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DesignRequest:
    """One tenant's placement-design request.

    ``config`` is a normal :class:`ExperimentConfig`; with a
    ``pareto_grid`` (:class:`repro_torch.core.pareto.ParetoGridSpec`) it is
    expanded into one run per grid scalarization and the streamed/final
    results carry a Pareto front.  ``timeout_s`` is wall time measured
    from submission; the engine resolves the request as ``"timeout"``
    when it expires.  Round-trips via to/from_dict in the reference's
    form.
    """

    config: ExperimentConfig
    request_id: str = ""
    pareto_grid: object | None = None      # pareto.ParetoGridSpec
    timeout_s: float | None = None

    def __post_init__(self):
        if not isinstance(self.config, ExperimentConfig):
            object.__setattr__(self, "config",
                               ExperimentConfig.from_dict(self.config))
        if self.pareto_grid is not None:
            from .pareto import ParetoGridSpec
            if not isinstance(self.pareto_grid, ParetoGridSpec):
                object.__setattr__(self, "pareto_grid",
                                   ParetoGridSpec.from_dict(self.pareto_grid))

    def to_dict(self) -> dict:
        return {"config": self.config.to_dict(),
                "request_id": self.request_id,
                "pareto_grid": (None if self.pareto_grid is None
                                else self.pareto_grid.to_dict()),
                "timeout_s": self.timeout_s}

    @classmethod
    def from_dict(cls, d: Mapping) -> "DesignRequest":
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown DesignRequest keys: "
                             f"{sorted(unknown)}")
        return cls(**dict(d))


@dataclass
class DesignUpdate:
    """One streamed increment for a request.

    ``kind`` is ``"progress"`` (a scoring round completed; carries the
    best-so-far cost), ``"front"`` (the request's Pareto front), or a
    terminal ``"done"`` / ``"cancelled"`` / ``"timeout"`` / ``"error"``.
    """

    request_id: str
    kind: str
    tick: int = 0                 # engine tick the update was emitted on
    generation: int = 0           # scoring rounds completed for the request
    best_cost: float | None = None
    front: object | None = None   # pareto.ParetoFront (kind="front")
    error: str | None = None

    def to_dict(self) -> dict:
        return {"request_id": self.request_id, "kind": self.kind,
                "tick": self.tick, "generation": self.generation,
                "best_cost": self.best_cost,
                "front_size": (None if self.front is None
                               else len(self.front.points)),
                "error": self.error}


@dataclass
class DesignResponse:
    """Terminal result for a request: the per-run records (same shape as
    :func:`run_experiment` output), the final Pareto front when a grid or
    archive produced one, and the stream of updates that led here."""

    request_id: str
    status: str                   # done | cancelled | timeout | error
    records: list = field(default_factory=list)    # list[RunRecord]
    front: object | None = None   # pareto.ParetoFront
    updates: list = field(default_factory=list)    # list[DesignUpdate]
    seconds: float = 0.0
    error: str | None = None

    @property
    def best_cost(self) -> float | None:
        costs = [r.result.best_cost for r in self.records
                 if r.result is not None]
        return min(costs) if costs else None

    def to_dict(self) -> dict:
        return {"request_id": self.request_id, "status": self.status,
                "records": summarize(self.records),
                "front_size": (None if self.front is None
                               else len(self.front.points)),
                "updates": [u.to_dict() for u in self.updates],
                "seconds": self.seconds, "error": self.error}


@dataclass
class _SweepUnit:
    """One (config, algorithm, repetition) run inside a sweep."""

    cfg_i: int
    cfg: ExperimentConfig
    algo: str
    rep_i: int                 # -1 for a folded batch record
    ev: Evaluator
    entry: OptimizerEntry
    params: Any
    budget: Budget
    result: OptResult | None = None
    seconds: float = 0.0


def run_sweep(configs, *, fold_repetitions: bool = True,
              stack_scoring: bool = True, shard=False,
              device=None) -> SweepResult:
    """Run many configs on ``device`` (default: the card), amortizing
    scorer construction and normalization.

    ``configs`` may also be a :class:`SweepConfig`; with a ``pareto_grid``
    the base configs are expanded per grid scalarization and per-config
    Pareto fronts are attached to ``SweepResult.fronts``
    (``repro_torch.core.pareto``).

    Unlike per-config :func:`run_experiment` (which re-draws normalizers
    per repetition), a sweep shares one Evaluator per (arch, config, seed,
    norm_samples, chunk, backend, mutation_mode, objective, schedule,
    workload) — and one normalizer draw across objectives that differ only
    in terms or weights — and one scorer per (layout, chunk, backend,
    objective structure, device) across *all* configs.  With
    ``fold_repetitions`` (default), repetitions of chain-style optimizers
    (params with a ``chains`` field, e.g. SA) are folded into extra
    independent chains of a single batched call.  Folding only applies to
    pure evaluation budgets: a wall-clock budget covers one sequential
    run, so such configs run repetition by repetition instead.

    With ``stack_scoring`` (default), runs of every registered-stackable
    optimizer — BR/GA/SA host loops and the device-resident ``*-batched``
    drivers — from configs that share a scorer execute in lockstep with
    their per-round scoring requests concatenated into a single scorer
    call (:func:`repro_torch.core.optimize.drive_stacked`); per-row
    normalizer, weight and demand rows keep each run's costs exact.
    Results are bit for bit those of unstacked execution; only the number
    of scorer calls changes (``stats.score_calls``).  Runs with a
    wall-clock budget never stack (interleaving would consume their time
    budget with the group's work).  A stacked record's ``seconds`` is its
    *attributed* wall time — its own generator resumes plus its
    proportional share of each stacked scoring call — so
    :func:`summarize`'s per-record evals/s stays meaningful.

    Because the Evaluator is shared, each record's ``n_generated`` is the
    number of placements generated *by that run* (a per-call delta).

    With ``shard`` every stackable run (stacked groups *and* singletons)
    routes its scoring through
    :func:`repro_torch.sharding.population.shard_scorer`, which splits the
    population axis into one contiguous slice per device.  ``shard=True``
    takes every CUDA device when ``device`` is one (the sweep's own device
    when it is the CPU); a list of devices names them.  The scorer's rows
    do not depend on the slice they fall in, so the records are bit for
    bit those of the unsharded path; ``stats.shard_devices`` records the
    device count.
    """
    if isinstance(configs, SweepConfig):
        sc = configs
        if sc.pareto_grid is not None:
            from .pareto import run_pareto_sweep
            return run_pareto_sweep(
                sc.configs, sc.pareto_grid,
                fold_repetitions=sc.fold_repetitions,
                stack_scoring=sc.stack_scoring, shard=sc.shard,
                device=device)
        return run_sweep(sc.configs, fold_repetitions=sc.fold_repetitions,
                         stack_scoring=sc.stack_scoring, shard=sc.shard,
                         device=device)
    dev = resolve_device(device)
    t0 = time.monotonic()
    miss0 = _SCORER_STATS["misses"]
    evict0 = _SCORER_CACHE.evictions
    # Normalizer draws depend only on (arch, config, seed, samples, chunk,
    # backend, mutation_mode, policy) — never on the objective's terms or
    # weights — so evaluators for different scalarizations of one base
    # config (e.g. a Pareto grid) share one draw.
    norm_cache: dict[tuple, Evaluator] = {}
    ev_cache: dict[tuple, Evaluator] = {}
    units: list[_SweepUnit] = []
    for cfg_i, cfg in enumerate(configs):
        arch = resolve_arch(cfg.arch, cfg.config)
        nkey = (cfg.arch, cfg.config, cfg.seed, cfg.norm_samples, cfg.chunk,
                cfg.backend, cfg.mutation_mode, cfg.objective.normalizer)
        key = nkey + (cfg.objective, cfg.schedule, cfg.archive_k,
                      cfg.workload)
        if key not in ev_cache:
            rng = np.random.default_rng(cfg.seed)
            rep = make_rep(arch, cfg.arch, cfg.mutation_mode)
            base = norm_cache.get(nkey)
            ev_cache[key] = make_evaluator(
                rep, arch, rng=rng, norm_samples=cfg.norm_samples,
                chunk=cfg.chunk, backend=cfg.backend,
                objective=cfg.objective, schedule=cfg.schedule,
                norm=None if base is None else base.norm,
                archive_k=cfg.archive_k, workload=cfg.workload, device=dev)
            if base is None:
                norm_cache[nkey] = ev_cache[key]
        ev = ev_cache[key]
        for algo in cfg.algorithms:
            entry = OPTIMIZERS.get(algo)
            params = cfg.resolved_params(algo)
            foldable = (fold_repetitions and cfg.repetitions > 1
                        and hasattr(params, "chains")
                        and cfg.budget.seconds is None)
            if foldable:
                p = dataclasses.replace(
                    params, chains=params.chains * cfg.repetitions)
                units.append(_SweepUnit(
                    cfg_i, cfg, algo, -1, ev, entry, p,
                    cfg.budget.scaled(cfg.repetitions)))
            else:
                for rep_i in range(cfg.repetitions):
                    units.append(_SweepUnit(cfg_i, cfg, algo, rep_i, ev,
                                            entry, params, cfg.budget))

    # Lockstep groups: stackable units sharing one scorer.  Wall-clock-
    # budgeted runs never stack: interleaving would consume each run's
    # time budget with the whole group's work.
    groups: dict[int, list[_SweepUnit]] = {}
    shard_on = shard is not None and shard is not False
    if stack_scoring or shard_on:
        for u in units:
            if u.algo in _SWEEP_STACKABLE and u.budget.seconds is None:
                groups.setdefault(id(u.ev.scorer), []).append(u)
        if not stack_scoring:       # shard-only: each run on its own
            groups = {id(u): [u] for us in groups.values() for u in us}
        elif not shard_on:          # stacking alone only pays off for > 1
            groups = {k: v for k, v in groups.items() if len(v) > 1}
    stacked = {id(u) for us in groups.values() for u in us}
    stacked_groups = sum(1 for us in groups.values() if len(us) > 1)

    shard_devs = None
    if shard_on:
        from ..sharding.population import population_devices, shard_scorer
        shard_devs = population_devices(shard_device_list(shard, dev))

    for us in groups.values():
        items = []
        for u in us:
            rng_a = np.random.default_rng(
                algo_seed(u.cfg.seed, max(u.rep_i, 0), u.algo))
            items.append((_SWEEP_STACKABLE[u.algo](u.ev, rng_a, u.budget,
                                                   u.params), u.ev))
        score_fn = (None if shard_devs is None
                    else shard_scorer(us[0].ev.scorer, shard_devs))
        results, gen_counts, run_secs = drive_stacked(items,
                                                      score_fn=score_fn)
        for u, res, g, s in zip(us, results, gen_counts, run_secs):
            res.n_generated = g
            u.result, u.seconds = res, s
    for u in units:
        if id(u) in stacked:
            continue
        ta = time.monotonic()
        g0 = u.ev.n_generated
        rng_a = np.random.default_rng(
            algo_seed(u.cfg.seed, max(u.rep_i, 0), u.algo))
        res = u.entry.fn(u.ev, rng_a, u.budget, u.params)
        res.n_generated = u.ev.n_generated - g0
        u.result, u.seconds = res, time.monotonic() - ta

    runs = [SweepRun(cfg, []) for cfg in configs]
    for u in units:          # units were built in config order
        runs[u.cfg_i].records.append(
            RunRecord(u.cfg.arch, u.cfg.config, u.algo, u.rep_i, u.result,
                      u.seconds, degenerate_norms=u.ev.degenerate_norms))
    stats = SweepStats(
        scorers_built=_SCORER_STATS["misses"] - miss0,
        evaluators_built=len(norm_cache),
        n_evaluated=sum(r.result.n_evaluated
                        for run in runs for r in run.records),
        seconds=time.monotonic() - t0,
        score_calls=sum(ev.n_score_calls for ev in ev_cache.values()),
        stacked_groups=stacked_groups,
        scorer_evictions=_SCORER_CACHE.evictions - evict0,
        shard_devices=1 if shard_devs is None else len(shard_devs))
    return SweepResult(runs, stats)


def shard_device_list(shard, device):
    """The explicit device list a ``shard`` argument names, or ``None``
    for every CUDA device: ``True`` on a CUDA ``device`` means all cards,
    ``True`` on the CPU means that one device, a sequence names them."""
    if shard is True:
        dev = resolve_device(device)
        return None if dev.type == "cuda" else [dev]
    return list(shard)


# ---------------------------------------------------------------------------
# Reporting helpers.
# ---------------------------------------------------------------------------

def summarize(records: list[RunRecord]) -> list[dict]:
    rows = []
    for r in records:
        rows.append(dict(
            arch=r.arch, config=r.config, algorithm=r.algorithm,
            repetition=r.repetition, best_cost=r.result.best_cost,
            n_evaluated=r.result.n_evaluated,
            n_generated=r.result.n_generated, seconds=round(r.seconds, 2),
            evals_per_s=round(r.result.n_evaluated / max(r.seconds, 1e-9),
                              1),
        ))
    return rows


def best_by_algorithm(records: list[RunRecord]) -> dict[str, RunRecord]:
    out: dict[str, RunRecord] = {}
    for r in records:
        if r.algorithm not in out \
                or r.result.best_cost < out[r.algorithm].result.best_cost:
            out[r.algorithm] = r
    return out
