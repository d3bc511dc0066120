"""The port's autoscale fit on the CPU, at the reference test's size
(``tests/test_calibrate.py::test_recover_autoscale_params``): four
drainable burst cycles (36 h in 300 s bins, 432 bins), 16 restarts x 800
steps, the instance bounds frozen; every free parameter within 5%. The
slowest fit of the slice, so a file of its own (``--dist loadfile``
spreads files over the workers)."""
from repro_torch import calibrate as pc
from repro_torch.core import loadpattern as plp
from repro_torch.core import twin as pt

from test_torch_calibrate_fit import relerrs
from torch_port_ref import one_torch_thread  # noqa: F401


def test_recover_autoscale_params():
    truth = pt.make_twin("t", "autoscale", max_rps=0.8, usd_per_hour=0.02,
                         base_latency_s=0.3, min_instances=1,
                         max_instances=4, scale_up_hours=2.0)
    segs = []
    for _ in range(4):       # drainable burst cycles: the boot-delay signal
        segs += [plp.Segment(3 * 3600, 2.0, 2.0),
                 plp.Segment(6 * 3600, 0.1, 0.1)]
    tr = pc.ObservedTrace.from_loadpattern(
        plp.LoadPattern("cycles", tuple(segs)), truth, bin_s=300.0,
        device="cpu")
    res = pc.fit(tr, "autoscale", restarts=16, steps=800, seed=0,
                 fixed_values={"min_instances": 1.0, "max_instances": 4.0},
                 device="cpu")
    errs = relerrs(res, truth)
    assert max(errs.values()) < 0.05, errs
    # instance bounds were frozen, not fit
    assert "min_instances" not in errs and "max_instances" not in errs
    assert res.params[3] == 1.0 and res.params[4] == 4.0
