"""Differentiable twin calibration on the port: fit digital twins to
measured traces.

Counterpart: ``repro.calibrate``. Closes the paper's measure -> model ->
simulate loop (Secs. V-F/V-G): ``ObservedTrace`` packages what a
wind-tunnel experiment measured, ``fit`` recovers any registered
TwinPolicy's parameter vector from it by differentiating through the
simulation scan (all restarts as lanes of one scan), and
``calibrated_twin`` hands the result to the what-if grids
(``core.whatif.calibrated_grid``). Entry points take ``device=``
(default ``"cuda"``).
"""
from repro_torch.calibrate.fit import (DEFAULT_FIT_OPT, FitResult,
                                       calibrated_twin, evaluate, fit,
                                       fit_with_holdout)
from repro_torch.calibrate.objective import (DEFAULT_WEIGHTS, FitSpec,
                                             fit_spec, lane_series_loss,
                                             lane_trace_loss, params_from_z,
                                             series_loss, trace_loss,
                                             twin_from_z, z_from_params)
from repro_torch.calibrate.trace import (SERIES_KEYS, ObservedTrace,
                                         bin_loadpattern)

__all__ = [
    "DEFAULT_FIT_OPT", "DEFAULT_WEIGHTS", "FitResult", "FitSpec",
    "ObservedTrace", "SERIES_KEYS", "bin_loadpattern", "calibrated_twin",
    "evaluate", "fit", "fit_spec", "fit_with_holdout", "lane_series_loss",
    "lane_trace_loss", "params_from_z", "series_loss", "trace_loss",
    "twin_from_z", "z_from_params",
]
