"""The port's batch_window fit on the CPU, at the reference test's size
(``tests/test_calibrate.py::test_recover_batch_window_identifiable_params``):
a 24 h ramp in 600 s bins, 16 restarts x 800 steps. A file of its own, as
the autoscale fit has (``--dist loadfile`` spreads files over the
workers)."""
from repro_torch import calibrate as pc
from repro_torch.core import loadpattern as plp
from repro_torch.core import twin as pt

from test_torch_calibrate_fit import relerrs, replay
from torch_port_ref import one_torch_thread  # noqa: F401


def test_recover_batch_window_identifiable_params():
    """batch_window recovers its identifiable parameters; base_latency_s
    is additively degenerate with the half-window term (0.25 s against
    hours of batching latency) and is excluded by construction."""
    truth = pt.make_twin("b", "batch_window", max_rps=3.0, usd_per_hour=0.04,
                         base_latency_s=0.25, window_hours=4.0,
                         idle_cost_fraction=0.15)
    pat = plp.LoadPattern("ramp24", (plp.Segment(24 * 3600, 0.5, 4.0),))
    res = pc.fit(replay(pat, truth, bin_s=600.0), "batch_window",
                 restarts=16, steps=800, seed=0, device="cpu")
    errs = relerrs(res, truth)
    errs.pop("base_latency_s")
    assert max(errs.values()) < 0.05, errs
