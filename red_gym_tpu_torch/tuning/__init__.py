"""Vehicle and controller parameter search (CMA-ES) on batched rollouts."""

from red_gym_tpu_torch.tuning.param_search import (CMAES, DEFAULT_BOUNDS, SEARCH_FIELDS,
                                                   make_laptime_evaluator, search)

__all__ = ["CMAES", "DEFAULT_BOUNDS", "SEARCH_FIELDS", "make_laptime_evaluator", "search"]
