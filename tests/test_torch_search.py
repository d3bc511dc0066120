"""Policy search on the port: the search bars of ``tests/test_search.py``
and ``tests/test_faults.py``, and the shape of its gradient loop.

All on the CPU (``device="cpu"``), at the reference tests' sizes:

* a registered toy policy with a closed-form convex optimum is recovered
  to ~1% (on the CPU: the CUDA kernels refuse a registered policy);
* the Pareto frontier's cost is non-increasing as the SLO loosens, from
  one gradient loop (one ``search.kernel`` span) for all targets;
* an infeasible search warns with the policy and the pinned parameters,
  and counts ``warn.search_infeasible``;
* p95/p99 ride the aggregate histogram and match the series path to one
  quarter-octave bucket, and search reports them as evidence;
* one gradient loop: one ``search.kernel`` span a search and one a
  policy in a tournament, one objective evaluation a step over all K x
  S x F lanes, and the last step's diagnostics ride out of the loop
  (``per_restart == history[-1]``). These stand in for the reference's
  jit-cache counts, which have no PyTorch counterpart.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import simulate
from repro_torch.core import twin as twin_mod
from repro_torch.core.slo import SLO
from repro_torch.core.traffic import HOURS_PER_YEAR, TrafficModel
from repro_torch.core.twin import (AGG_SLO_LATENCY, SimpleTwin, make_twin,
                                   policy_spec, register_policy)
from repro_torch.core.whatif import table2_rows
from repro_torch.search import (SearchInfeasibleWarning, pareto_frontier,
                                search, search_policies, search_space)
from repro_torch.search import optimize as popt
from repro_torch.search.objective import annual_scale

from torch_port_ref import one_torch_thread  # noqa: F401

RPS, USD, LAT = 1.2, 0.01, 0.2
CPU = dict(device="cpu")


def weekly_load(seed=0, mean=4000.0, t_bins=336):
    """``tests/test_search.py``'s ``weekly_load``."""
    rng = np.random.default_rng(seed)
    t = np.arange(t_bins)
    load = (mean + 0.75 * mean * np.sin(2 * np.pi * t / 24.0)
            + rng.uniform(0, 0.2 * mean, t_bins))
    return np.maximum(load, 50.0).astype(np.float32)[None]


def base_for(policy):
    extras = {"autoscale": {"max_instances": 8.0, "scale_up_hours": 2.0},
              "shed": {"queue_cap_hours": 4.0},
              "batch_window": {"window_hours": 2.0}}
    return make_twin(policy, policy, max_rps=2.5, usd_per_hour=USD,
                     base_latency_s=LAT, **extras.get(policy, {}))


# ---------------------------------------------------------------------------
# analytic sanity: closed-form convex optimum
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def toy_policy():
    """cost/bin = usd * (1 + (knob - 3)^2) * dt: optimum knob* = 3, annual
    cost* = usd * 8736, whatever the traffic. Registered for this module
    only (the registry is the process's)."""
    @register_policy("toyquad",
                     ("max_rps", "usd_per_hour", "base_latency_s", "knob"),
                     defaults={"knob": 1.0},
                     bounds={"knob": (0.5, 10.0)})
    def _toy_lane(carry, arrive, p, dt):
        cost = p[:, 1] * (1.0 + (p[:, 3] - 3.0) ** 2) * dt
        zero = torch.zeros_like(arrive)
        return carry, (arrive, zero, p[:, 2], cost, zero)

    yield policy_spec("toyquad")
    del twin_mod._REGISTRY["toyquad"]


def test_toy_convex_optimum_recovered_closed_form(toy_policy):
    base = make_twin("toy", "toyquad", max_rps=RPS, usd_per_hour=USD,
                     base_latency_s=LAT, knob=1.0)
    res = search(base, loads=weekly_load(), bin_hours=1.0, slo=None,
                 restarts=4, steps=80, seed=0, **CPU)
    assert res.feasible
    knob = res.twin.param("knob")
    assert abs(knob - 3.0) < 0.05, knob
    assert res.cost_usd == pytest.approx(USD * HOURS_PER_YEAR, rel=5e-3)


# ---------------------------------------------------------------------------
# Pareto frontier: one gradient loop, monotone by construction
# ---------------------------------------------------------------------------

def test_pareto_frontier_monotone_and_one_loop():
    limits = [1800.0, 3600.0, 4 * 3600.0, 12 * 3600.0]
    with obs.capture() as rec:
        fr = pareto_frontier(base_for("autoscale"), loads=weekly_load(seed=5),
                             bin_hours=1.0, slo_limits=limits, restarts=4,
                             steps=30, seed=0, **CPU)
    (kernel,) = rec.find(name="search.kernel")      # all targets, one loop
    assert kernel.attrs["restarts"] == 4 * len(limits)
    assert [p.limit_s for p in fr.points] == sorted(limits)
    feasible_costs = [p.cost_usd for p in fr.points if p.feasible]
    assert len(feasible_costs) >= 2
    for tighter, looser in zip(feasible_costs, feasible_costs[1:]):
        assert looser <= tighter + 1e-9
    rows = fr.rows()
    assert len(rows) == len(limits)
    assert "tightening_premium_usd" in rows[0]


# ---------------------------------------------------------------------------
# actionable diagnostics, and their telemetry
# ---------------------------------------------------------------------------

def test_infeasible_search_warns_and_counts():
    """``test_infeasible_search_warns_with_policy_and_bounds`` and
    ``tests/test_obs.py``'s
    ``test_search_emits_kernel_span_and_infeasible_event``."""
    base = make_twin("tiny", "shed", max_rps=0.5, usd_per_hour=USD,
                     base_latency_s=0.9, queue_cap_hours=1.0)
    sp = search_space(base, ("queue_cap_hours",))
    slo = SLO(limit_s=1.0, met_fraction=0.99)
    with obs.capture() as rec:
        with pytest.warns(SearchInfeasibleWarning) as warned:
            res = search(sp, loads=weekly_load(), bin_hours=1.0, slo=slo,
                         restarts=4, steps=30, seed=0, **CPU)
    assert not res.feasible
    msg = str(warned[0].message)
    assert "shed" in msg
    assert "NO feasible configuration" in msg
    assert "compliance" in msg
    assert ("bound" in msg) or ("cannot meet the SLO" in msg)
    (kernel,) = rec.find(name="search.kernel")
    assert kernel.attrs["restarts"] == 4 and kernel.attrs["policy"] == "shed"
    assert rec.counter_total("warn.search_infeasible") == 1
    assert rec.counter_total("search.restarts") >= 4
    assert rec.counter_total("search.restarts.feasible") == 0
    flat = obs.counters()
    assert flat["search.objective_choice{policy=shed,stream=False}"] >= 1


# ---------------------------------------------------------------------------
# p95/p99 evidence
# ---------------------------------------------------------------------------

def test_p95_p99_series_vs_aggregate_and_table_columns():
    loads = np.tile(weekly_load(seed=11), (2, 1))
    twins = [SimpleTwin("f", 1.0, USD, LAT),
             make_twin("s", "shed", max_rps=1.0, usd_per_hour=USD,
                       base_latency_s=LAT, queue_cap_hours=3.0)]
    slo = SLO(limit_s=4 * 3600, met_fraction=0.95)
    series = simulate.simulate_grid(twins, loads, slo=slo, bin_hours=1.0,
                                    **CPU)
    agg = simulate.simulate_grid(twins, loads, slo=slo, bin_hours=1.0,
                                 return_series=False, **CPU)
    for s, a in zip(series, agg):
        assert s.median_latency_s <= s.p95_latency_s <= s.p99_latency_s
        assert a.median_latency_s <= a.p95_latency_s <= a.p99_latency_s
        for key in ("p95_latency_s", "p99_latency_s"):
            exact, hist = getattr(s, key), getattr(a, key)
            # the histogram CDF is exact to one quarter-octave bucket
            assert abs(np.log2(hist / exact)) <= 0.26, (key, exact, hist)
    rows = table2_rows(agg)
    assert "latency_p95_s" in rows[0] and "latency_p99_s" in rows[0]
    assert rows[0]["latency_p95_s"] == pytest.approx(
        agg[0].p95_latency_s, rel=0.02, abs=0.01)


def test_search_result_reports_p_latency_evidence():
    slo = SLO(limit_s=4 * 3600, met_fraction=0.95)
    res = search(base_for("autoscale"), loads=weekly_load(), bin_hours=1.0,
                 slo=slo, restarts=4, steps=30, seed=0, **CPU)
    assert res.feasible
    assert all(r.slo_met for r in res.scenario_rows)
    assert res.p95_latency_s <= slo.limit_s * (2 ** 0.25)
    assert "latency_p95_s" in res.leaderboard_row()
    assert len(res.restart_table()) == 4


# ---------------------------------------------------------------------------
# one gradient loop, one objective evaluation a step
# ---------------------------------------------------------------------------

def test_tournament_one_loop_per_policy(monkeypatch):
    """One ``search.kernel`` span a policy, and one objective evaluation
    a step over all K x S lanes (no Python loop over restarts or
    scenarios)."""
    calls = []
    orig = popt.lane_objective_vectorized

    def spy(params_block, loads_block, *a, **k):
        calls.append((tuple(params_block.shape), tuple(loads_block.shape)))
        return orig(params_block, loads_block, *a, **k)

    monkeypatch.setattr(popt, "lane_objective_vectorized", spy)
    loads = np.concatenate([weekly_load(seed=3), weekly_load(seed=4)])
    slo = SLO(limit_s=4 * 3600, met_fraction=0.95)
    with obs.capture() as rec:
        tour = search_policies([base_for("fifo"), base_for("autoscale"),
                                base_for("shed")], loads=loads,
                               bin_hours=1.0, slo=slo, restarts=4, steps=5,
                               seed=0, **CPU)
    spans = rec.find(name="search.kernel")
    assert [s.attrs["policy"] for s in spans] == ["fifo", "autoscale",
                                                  "shed"]
    assert all(s.attrs["scenarios"] == 2 and s.attrs["steps"] == 5
               and s.attrs["futures"] == 1 and not s.attrs["stream"]
               for s in spans)
    assert calls == [((8, 6), (8, 336))] * 15
    ranked = tour.leaderboard_rows()
    assert len(ranked) == 3
    costs = [r["cost_usd"] for r in ranked if r["feasible"]]
    assert costs == sorted(costs)
    assert {"policy", "cost_usd", "config"} <= set(ranked[0])


def test_search_loop_aux_rides_the_loop():
    """The last step's per-restart objective is ``history[-1]`` (the aux
    of the last gradient evaluation, not a forward on the final z), on
    the streamed objective."""
    base = make_twin("auto", "autoscale", max_rps=1.9512,
                     usd_per_hour=0.0082, base_latency_s=0.15,
                     max_instances=8, scale_up_hours=2)
    space = search_space(base, ("max_instances", "scale_up_hours"))
    loads = TrafficModel.honda_default("nom").hourly_loads()[:97][None]
    steps, k = 6, 3
    ocfg = dataclasses.replace(popt.DEFAULT_SEARCH_OPT, total_steps=steps)

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)

    box = tuple(torch.as_tensor(a) for a in (
        space.lo, space.hi, space.log_mask, space.free_mask, space.fixed))
    out = popt._search_loop(
        steps, 1, 1, 1.0, AGG_SLO_LATENCY, space.needs_surrogate, ocfg,
        True, f32(space.z0(k, seed=0)), f32(loads.T), f32([1.0]), box,
        (torch.as_tensor(space.tie_src), torch.as_tensor(space.tie_coeff)),
        space.policy_index, f32(np.full(k, 2 * 3600.0)), 0.95, 100.0, 50.0,
        annual_scale(97, 1.0))
    z_fin, p_fin, per_restart, cost, frac, history = out
    assert history.shape == (steps, k) and cost.shape == (k, 1)
    assert torch.equal(per_restart, history[-1])
    assert torch.equal(p_fin, space.params_of_z(z_fin))
    assert bool((z_fin.abs() <= 10.0).all())


def test_registered_policy_is_refused_on_the_card(toy_policy):
    """The exact re-check on the card raises the CUDA kernels' refusal of
    a registered policy instead of moving to the CPU (here there is no
    card: the request itself raises)."""
    base = make_twin("toy", "toyquad", max_rps=RPS, usd_per_hour=USD,
                     base_latency_s=LAT, knob=1.0)
    err = NotImplementedError if torch.cuda.is_available() else RuntimeError
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(err):
            search(base, loads=weekly_load(), bin_hours=1.0, slo=None,
                   restarts=2, steps=2)
