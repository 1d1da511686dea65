# The PlaceIT system in PyTorch: placement search, topology inference,
# proxy scoring on the card.
#
# Public entry point: the registry-driven experiment API.
from .api import (Budget, ExperimentConfig, RunRecord,  # noqa: F401
                  SweepConfig, SweepResult, baseline_cost, best_by_algorithm,
                  run_experiment, run_sweep, summarize)
from .objective import (Objective, Ramp, Schedule, TermSpec,  # noqa: F401
                        TrafficMix, compile_objective, compile_schedule,
                        objective_cost_host, weights_vec)
from .pareto import (ParetoFront, ParetoGridSpec, ParetoPoint,  # noqa: F401
                     hypervolume, nondominated_mask, run_pareto,
                     run_pareto_sweep)
from .registries import (OBJECTIVE_TERMS, OPTIMIZERS,  # noqa: F401
                         SCHEDULE_RAMPS, SCORER_BACKENDS,
                         register_objective_term, register_optimizer,
                         register_schedule_ramp, register_scorer_backend)
