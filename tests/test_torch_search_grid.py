"""The port's search against an exhaustive grid and against the
reference's search: ``tests/test_search.py``'s
``test_search_beats_256_point_grid`` for fifo, quickscale, autoscale and
shed (batch_window: ``test_torch_search_grid_batch.py``), on the CPU at
the reference test's size (a 336-hour load, 6 restarts x 80 steps, SLO
4 h / 95%).

On each problem both searches pass the bar (feasible, and no dearer
than the best feasible point of the 256-point ``SearchSpace.grid`` to
the z-clip resolution, 1e-3), and the port's exact annual cost is
within 1% of the reference's. The two searches are not bitwise the same
walk: the port maps z in float64 (the reference in float32) and its
sigmoid, exp and log round otherwise, and 80 AdamW steps carry those
ulps to different restarts' end points.
"""
import numpy as np
import pytest

from repro_torch.core import twin as pt
from repro_torch.core.slo import SLO
from repro_torch.core.traffic import HOURS_PER_YEAR
from repro_torch.search import evaluate_exact, search

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import reference

USD, LAT = 0.01, 0.2
#: the search's bar against the grid (the reference test's)
GRID_RTOL = 1e-3
#: the port's exact winner against the reference's
WINNER_RTOL = 0.01


@pytest.fixture(scope="module")
def jref():
    with reference() as r:
        yield r


def weekly_load(seed=0, mean=4000.0, t_bins=336):
    rng = np.random.default_rng(seed)
    t = np.arange(t_bins)
    load = (mean + 0.75 * mean * np.sin(2 * np.pi * t / 24.0)
            + rng.uniform(0, 0.2 * mean, t_bins))
    return np.maximum(load, 50.0).astype(np.float32)[None]


def base_for(tw, policy):
    extras = {"autoscale": {"max_instances": 8.0, "scale_up_hours": 2.0},
              "shed": {"queue_cap_hours": 4.0},
              "batch_window": {"window_hours": 2.0}}
    return tw.make_twin(policy, policy, max_rps=2.5, usd_per_hour=USD,
                        base_latency_s=LAT, **extras.get(policy, {}))


def search_both(jref, policy):
    """The port's and the reference's search of one 256-grid problem, and
    the grid's best feasible exact cost."""
    loads = weekly_load(seed=3, mean=4000.0)
    kw = dict(loads=loads, bin_hours=1.0, restarts=6, steps=80, seed=0)
    res = search(base_for(pt, policy),
                 slo=SLO(limit_s=4 * 3600, met_fraction=0.95),
                 device="cpu", **kw)
    want = jref.search.search(
        base_for(jref.twin, policy),
        slo=jref.slo.SLO(limit_s=4 * 3600, met_fraction=0.95), **kw)
    gcost, gfeas, _, _ = evaluate_exact(
        res.space.grid(256), loads, 1.0, res.slo, np.array([1.0]),
        HOURS_PER_YEAR / loads.shape[1], device="cpu")
    return res, want, np.where(gfeas, gcost, np.inf).min()


@pytest.mark.parametrize("policy", ["fifo", "quickscale", "autoscale",
                                    "shed"])
def test_search_beats_256_point_grid_and_matches_reference(jref, policy):
    res, want, grid_best = search_both(jref, policy)
    assert np.isfinite(grid_best), f"{policy}: no feasible grid point"
    for who, r in (("port", res), ("reference", want)):
        assert r.feasible, f"{policy}: the {who} found no feasible config"
        # beats, or matches to the z-clip resolution at a box-edge optimum
        assert r.cost_usd <= grid_best * (1.0 + GRID_RTOL), \
            (policy, who, r.cost_usd, grid_best, r.config())
    assert abs(res.cost_usd - want.cost_usd) <= WINNER_RTOL * want.cost_usd, \
        (policy, res.cost_usd, want.cost_usd, res.config(), want.config())
    assert res.space.free_names == want.space.free_names
