"""Calibrated policy search on the port: SLO-constrained differentiable
optimisation.

Counterpart: ``repro.search``. This package inverts the what-if
simulator. Where ``core.whatif.run_grid`` enumerates (twin x traffic)
scenarios and leaves a person to scan Table II for the cheapest row that
still meets the SLO, ``repro_torch.search`` descends a differentiable
annual-cost objective (a smooth softplus SLO hinge, run through the
checkpointed gradient scans calibration uses, with the registry's smooth
surrogates for hard-gated policy extras) and returns that configuration
directly — every reported number re-checked through the bit-exact
aggregate grid (the CUDA aggregate kernels on the card).

* ``space`` — declarative search spaces over policy parameters;
* ``objective`` — the smooth annual-cost + SLO-hinge lane objective;
* ``optimize`` — multi-start projected AdamW (K restarts x S scenarios
  as lanes of one gradient loop), the ``search_policies`` tournament;
* ``frontier`` — the cost-vs-SLO Pareto sweep (all targets as lanes of
  the same loop; monotone by construction).

``search(faults=schedule, quantile=q)`` makes the search
chance-constrained over sampled fault futures (``repro_torch.faults``).
Entry points take ``device=`` (default ``"cuda"``): ``search``,
``search_policies``, ``pareto_frontier`` here, and
``repro_torch.core.whatif.optimize_scenario``.
"""
from repro_torch.search.frontier import (Frontier, FrontierPoint,
                                         pareto_frontier)
from repro_torch.search.objective import lane_objective, smooth_met_fraction
from repro_torch.search.optimize import (SearchInfeasibleWarning,
                                         SearchResult, TournamentResult,
                                         achieved_quantile, evaluate_exact,
                                         search, search_policies)
from repro_torch.search.space import (SearchSpace, default_space,
                                      search_space)

__all__ = [
    "Frontier", "FrontierPoint", "pareto_frontier",
    "lane_objective", "smooth_met_fraction",
    "SearchInfeasibleWarning", "SearchResult", "TournamentResult",
    "achieved_quantile", "evaluate_exact", "search", "search_policies",
    "SearchSpace", "default_space", "search_space",
]
