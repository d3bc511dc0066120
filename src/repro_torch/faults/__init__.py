"""Fault & outage scenario library (ROADMAP: chaos suites) on the port.

Counterpart: ``repro.faults``, with the same exports.

Declarative fault specs -> seeded deterministic futures -> grid rows:

    from repro_torch import faults
    schedule = faults.FaultSchedule(
        specs=(faults.outage(rate_per_year=6),
               faults.disconnect(disconnect_frac=(0.2, 0.5))),
        n_futures=8, seed=0)
    summaries = run_grid(twins, traffics, slo, faults=schedule)

The chance-constrained search over the same futures comes with the
search slice of the port.
"""
from .spec import (FAULT_KINDS, FaultSchedule, FaultSpec, brownout, burst,
                   disconnect, outage)
from .sampler import (ReplayTerm, SampledFaults, sample_futures,
                      validate_sampled)
from .grid import FaultGrid, benign_futures, expand_grid

__all__ = [
    "FAULT_KINDS", "FaultSpec", "FaultSchedule",
    "outage", "brownout", "disconnect", "burst",
    "SampledFaults", "ReplayTerm", "sample_futures", "validate_sampled",
    "FaultGrid", "expand_grid", "benign_futures",
]
