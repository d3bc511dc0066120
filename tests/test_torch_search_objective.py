"""The search objective, spaces and exact re-check against the reference.

Counterparts of ``tests/test_stream_objectives.py``'s objective cases,
of ``SearchSpace``'s construction in ``repro.search.space`` and of
``repro.search.optimize.evaluate_exact``:

* every form of ``lane_objective`` (streamed, materialised, vectorised;
  latency and drop-rate SLOs; with fault caps) matches the reference's
  value and ``jax.grad`` within 1e-5 relative (gradients: denominator
  floored at 1e-6 of the largest entry);
* the port's streamed and materialised forms agree bit for bit;
* a ``SearchSpace``'s arrays, its starts and its grid equal the
  reference's, its parameters within 1e-6 relative (the port maps z in
  float64 and rounds once, the reference in float32), and its errors are
  the reference's;
* ``evaluate_exact``'s rows equal the reference's bit for bit;
* ``optimize_scenario`` is ``search(search_space(base, ...))``, and the
  restart mesh (``devices`` > 1) raises.
"""
import numpy as np
import pytest
import torch

from repro_torch import faults
from repro_torch.core import twin as pt
from repro_torch.core.slo import SLO
from repro_torch.core.traffic import TrafficModel
from repro_torch.core.twin import AGG_SLO_DROP_RATE, AGG_SLO_LATENCY
from repro_torch.core.whatif import optimize_scenario
from repro_torch.search import (achieved_quantile, evaluate_exact, search,
                                search_space)
from repro_torch.search import objective as pobj
from repro_torch.search.space import default_space

from torch_port_ref import (assert_bitwise, assert_same_results,  # noqa
                            one_torch_thread, reference)

RTOL = 1e-5


@pytest.fixture(scope="module")
def jref():
    with reference() as r:
        yield r


def all_twins(tw):
    return [tw.SimpleTwin("fifo", 1.9512, 0.0082, 0.15),
            tw.QuickscalingTwin("quick", 1.9512, 0.0082, 0.15),
            tw.make_twin("auto", "autoscale", max_rps=0.5,
                         usd_per_hour=0.002, base_latency_s=0.1,
                         max_instances=32, scale_up_hours=3),
            tw.make_twin("shed", "shed", max_rps=1.0, usd_per_hour=0.0082,
                         base_latency_s=0.15, queue_cap_hours=2),
            tw.make_twin("batch", "batch_window", max_rps=6.15,
                         usd_per_hour=0.0703, base_latency_s=0.06,
                         window_hours=6)]


def lanes(twin, n=3, t_bins=97, seed=0):
    """``tests/test_stream_objectives.py``'s ``_lanes``."""
    rng = np.random.default_rng(seed)
    hl = TrafficModel.honda_default("nom").hourly_loads()[:t_bins]
    loads = np.stack([hl * (1.0 + 0.2 * i) for i in range(n)]) \
        .astype(np.float32)
    params = (np.tile(twin.padded_params().astype(np.float32), (n, 1))
              * rng.uniform(0.9, 1.1, (n, 6)).astype(np.float32))
    return params, loads


def obj_args(slo_mode, n=3):
    limit = 2 * 3600.0 if slo_mode == AGG_SLO_LATENCY else 0.05
    return np.full((n,), limit, np.float32), (slo_mode, 0.95, 100.0, 50.0,
                                              1.2)


def assert_grads_close(a, b, rtol=RTOL, floor=1e-6, what=""):
    """The reference's guarded 1e-5 contract for the objective's
    gradients (``tests/test_stream_objectives.py``'s
    ``_assert_grads_close``): relative to the larger of |b| and ``floor``
    of the gradient scale, or within ``floor`` of that scale absolutely
    (a slot whose gradient is ~0 behind a saturated hinge gate carries
    float32 accumulation noise, not disagreement)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1.0)
    rel = np.abs(a - b) / np.maximum(np.abs(b), floor * scale)
    ok = (rel <= rtol) | (np.abs(a - b) <= floor * scale)
    assert ok.all(), (what, rel[~ok].max())


def same(a, b, what):
    """Bitwise for floats; equal values and dtype otherwise."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        assert_bitwise(a, b, what)
    else:
        assert a.dtype == b.dtype and np.array_equal(a, b), what


def t(a, grad=False):
    return torch.tensor(np.array(a), requires_grad=grad)


def port_objective(form, params, loads, pidx, slo_lane, rest, caps=None):
    """(objective, cost, frac) and d sum(objective) / d params."""
    p = t(params, True)
    fn = (pobj.lane_objective_vectorized if form == "vectorized"
          else pobj.lane_objective)
    kw = {} if form == "vectorized" else {"stream": form == "stream"}
    o, (c, f) = fn(p, t(loads), 1.0, pidx, t(slo_lane), *rest,
                   caps_block=None if caps is None else t(caps), **kw)
    o.sum().backward()
    return [x.detach().numpy() for x in (o, c, f)], p.grad.numpy()


_REF_FNS = {}


def ref_objective(jref, form, params, loads, pidx, slo_lane, rest,
                  caps=None):
    """The reference's objective and ``jax.grad``, jitted once per form
    and SLO mode (the policy index is a traced operand, as in its search
    kernel)."""
    jax, jnp = jref.jax, jref.jax.numpy
    key = (id(jref), form, rest, caps is None)
    if key not in _REF_FNS:
        ro = jref.search.objective
        fn = (ro.lane_objective_vectorized if form == "vectorized"
              else ro.lane_objective)
        kw = {} if form == "vectorized" else {"stream": form == "stream"}

        def f(p, loads, pidx, slo_lane, caps):
            o, aux = fn(p, loads, 1.0, pidx, slo_lane, *rest,
                        caps_block=caps, **kw)
            return o.sum(), (o, aux)

        _REF_FNS[key] = jax.jit(jax.value_and_grad(f, has_aux=True))
    (_, (o, (c, fr))), g = _REF_FNS[key](
        jnp.asarray(params), jnp.asarray(loads), jnp.int32(pidx),
        jnp.asarray(slo_lane), None if caps is None else jnp.asarray(caps))
    return [np.asarray(x) for x in (o, c, fr)], np.asarray(g)


@pytest.mark.parametrize("slo_mode", [AGG_SLO_LATENCY, AGG_SLO_DROP_RATE])
@pytest.mark.parametrize("j", range(5), ids=lambda j: pt.policy_names()[j])
def test_lane_objective_matches_reference(jref, j, slo_mode):
    twin = all_twins(pt)[j]
    params, loads = lanes(twin)
    slo_lane, rest = obj_args(slo_mode)
    vals, want = {}, {}
    for form in ("materialised", "vectorized"):
        want[form] = ref_objective(jref, form, params, loads, j, slo_lane,
                                   rest)
    want["stream"] = want["materialised"]   # the reference's are bitwise
    for form in ("stream", "materialised", "vectorized"):
        got, g_got = port_objective(form, params, loads, j, slo_lane, rest)
        want_v, g_want = want[form]
        for name, a, b in zip(("objective", "cost", "frac"), got, want_v):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0,
                                       err_msg=f"{form} {name}")
        assert_grads_close(g_got, g_want, what=form)
        vals[form] = got
    for a, b in zip(vals["stream"], vals["materialised"]):
        assert_bitwise(a, b, "streamed vs materialised")


def test_fault_lanes_match_reference(jref):
    """Chance-constrained lanes (``test_fault_lanes_stream_bitwise_and_
    grads``): autoscale through outages and disconnects, 4 futures."""
    twin = all_twins(pt)[2]
    t_bins, n_fut = 97, 4
    sched = jref.faults.FaultSchedule(
        specs=(jref.faults.outage(rate_per_year=40),
               jref.faults.disconnect(disconnect_frac=(0.2, 0.5))),
        n_futures=n_fut, seed=3)
    caps = np.asarray(jref.faults.sample_futures(sched, t_bins, 1.0).cap,
                      np.float32)
    params, loads = lanes(twin, n=n_fut)
    loads = np.broadcast_to(loads[:1], (n_fut, t_bins)).copy()
    slo_lane, rest = obj_args(AGG_SLO_LATENCY, n=n_fut)
    vals, want = {}, {}
    for form in ("materialised", "vectorized"):
        want[form] = ref_objective(jref, form, params, loads, 2, slo_lane,
                                   rest, caps)
    want["stream"] = want["materialised"]
    for form in ("stream", "materialised", "vectorized"):
        got, g_got = port_objective(form, params, loads, 2, slo_lane, rest,
                                    caps)
        want_v, g_want = want[form]
        for name, a, b in zip(("objective", "cost", "frac"), got, want_v):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0,
                                       err_msg=f"{form} {name}")
        # the reference's floor for fault lanes: a reconnect flood drives
        # slots to ~1e8 and puts float32 carry noise under them
        assert_grads_close(g_got, g_want, floor=1e-5, what=form)
        vals[form] = got
    for a, b in zip(vals["stream"], vals["materialised"]):
        assert_bitwise(a, b, "streamed vs materialised (faults)")


def test_smooth_met_fraction_matches_reference(jref):
    rng = np.random.default_rng(1)
    v = rng.uniform(0, 2e4, (3, 50)).astype(np.float32)
    w = rng.uniform(0, 5e3, (3, 50)).astype(np.float32)
    lim = np.array([7200.0, 3600.0, 1e4], np.float32)
    got = pobj.smooth_met_fraction(t(v), t(w), t(lim), 144.0).numpy()
    want = np.asarray(jref.search.smooth_met_fraction(v, w, lim, 144.0))
    np.testing.assert_allclose(got, want, rtol=RTOL)


# ---------------------------------------------------------------------------
# search spaces
# ---------------------------------------------------------------------------

SPACE_CASES = [
    ("autoscale", dict(max_rps=1.9512, usd_per_hour=0.0082,
                       base_latency_s=0.15, max_instances=8,
                       scale_up_hours=2),
     ("max_instances", "scale_up_hours"), {}, None),
    ("shed", dict(max_rps=1.9512, usd_per_hour=0.0082, base_latency_s=0.15,
                  queue_cap_hours=4.0),
     ("queue_cap_hours", "max_rps"), {},
     {"usd_per_hour": ("max_rps", 0.0082 / 1.9512)}),
    ("fifo", dict(max_rps=1.0, usd_per_hour=4.0, base_latency_s=0.05),
     ("max_rps",), {"max_rps": (0.05, 1.5)},
     {"usd_per_hour": ("max_rps", 4.0)}),
    ("batch_window", dict(max_rps=2.5, usd_per_hour=0.01,
                          base_latency_s=0.2, window_hours=2.0),
     None, {}, None),
    ("quickscale", dict(max_rps=2.5, usd_per_hour=0.01,
                        base_latency_s=0.2), None, {}, None),
]
SPACE_FIELDS = ("lo", "hi", "log_mask", "free_mask", "fixed", "tie_src",
                "tie_coeff")


@pytest.mark.parametrize("case", SPACE_CASES, ids=lambda c: c[0])
def test_search_space_equals_reference(jref, case):
    policy, kw, free, bounds, tie = case
    sp = search_space(pt.make_twin("b", policy, **kw), free,
                      bounds=bounds or None, tie=tie)
    rs = jref.search.search_space(jref.twin.make_twin("b", policy, **kw),
                                  free, bounds=bounds or None, tie=tie)
    for f in SPACE_FIELDS:
        same(getattr(sp, f), getattr(rs, f), f)
    assert (sp.free_names, sp.num_free, sp.policy_index,
            sp.needs_surrogate) == (rs.free_names, rs.num_free,
                                    rs.policy_index, rs.needs_surrogate)
    z0 = sp.z0(6, seed=3)
    assert_bitwise(z0, rs.z0(6, seed=3), "z0")
    got = sp.params_of_z(torch.from_numpy(z0)).numpy()
    want = np.asarray(jref.jax.vmap(rs.params_of_z)(z0))
    # the reference maps in float32 (its exp of a log-space sum is a few
    # ulps off; measured 7.7e-7), the port in float64 rounded once
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    grid, rgrid = sp.grid(64), rs.grid(64)
    assert [g.params for g in grid] == [g.params for g in rgrid]
    assert [g.name for g in grid] == [g.name for g in rgrid]


def test_default_space_prices_capacity(jref):
    for policy in ("fifo", "quickscale"):
        base = pt.make_twin("b", policy, max_rps=2.0, usd_per_hour=0.05,
                            base_latency_s=0.2)
        sp = default_space(base)
        assert sp.free_names == ("max_rps",)
        assert sp.tie_src[1] == 0
        assert sp.tie_coeff[1] == np.float32(0.025)
        assert sp.needs_surrogate == (policy == "quickscale")


def _space_errors(mod, tw):
    shed = tw.make_twin("b", "shed", max_rps=1.2, usd_per_hour=0.01,
                        base_latency_s=0.2, queue_cap_hours=4.0)
    return [
        lambda: mod.search_space(shed, ("queue_cap_hours",),
                                 bounds={"queue_cap_hours": (8.0, 16.0)}),
        lambda: mod.search_space(shed, ("nope",)),
        lambda: mod.search_space(shed, ("queue_cap_hours",),
                                 tie={"max_rps": ("nope", 1.0)}),
        lambda: mod.search_space(shed, ("max_rps",),
                                 tie={"max_rps": ("usd_per_hour", 1.0)}),
        lambda: mod.search_space(shed, ("queue_cap_hours",),
                                 tie={"max_rps": ("usd_per_hour", 1.0),
                                      "usd_per_hour": ("base_latency_s",
                                                       2.0)}),
        lambda: mod.search_space(shed, ("queue_cap_hours",),
                                 bounds={"queue_cap_hours": (2.0, 2.0)}),
        lambda: mod.search_space(shed, ("queue_cap_hours",),
                                 bounds={"queue_cap_hours": (1.0, np.inf)}),
    ]


def test_space_errors_are_the_references(jref):
    """``test_space_rejects_base_outside_box_naming_param_and_policy`` and
    every other error of the space, with the reference's type and
    message."""
    from repro_torch import search as psearch
    got = _space_errors(psearch, pt)
    want = _space_errors(jref.search, jref.twin)
    for g, w in zip(got, want):
        with pytest.raises((KeyError, ValueError)) as ew:
            w()
        with pytest.raises(type(ew.value)) as eg:
            g()
        assert str(eg.value) == str(ew.value)
    with pytest.raises(ValueError, match=r"shed\.queue_cap_hours"):
        got[0]()


# ---------------------------------------------------------------------------
# the exact re-check
# ---------------------------------------------------------------------------

def test_evaluate_exact_rows_equal_reference(jref):
    base_kw = dict(max_rps=1.9512, usd_per_hour=0.0082, base_latency_s=0.15,
                   max_instances=8, scale_up_hours=2)
    free = ("max_instances", "scale_up_hours")
    sp = search_space(pt.make_twin("b", "autoscale", **base_kw), free)
    rs = jref.search.search_space(
        jref.twin.make_twin("b", "autoscale", **base_kw), free)
    hl = TrafficModel.honda_default("nom").hourly_loads()[:336]
    loads = np.stack([hl, 1.4 * hl]).astype(np.float32)
    w = np.array([0.25, 0.75], np.float32)
    slo = (SLO(limit_s=2 * 3600, met_fraction=0.95),
           jref.slo.SLO(limit_s=2 * 3600, met_fraction=0.95))
    got = evaluate_exact(sp.grid(16), loads, 1.0, slo[0], w, 26.0,
                         device="cpu")
    want = jref.search.evaluate_exact(rs.grid(16), loads, 1.0, slo[1], w,
                                      26.0)
    for name, a, b in zip(("cost", "feasible", "pct"), got[:3], want[:3]):
        same(a, b, name)
    for a, b in zip(got[3], want[3]):
        assert_same_results(a, b)


def test_achieved_quantile_shape():
    rows = [type("R", (), {"slo_met": m})()
            for m in (True, True, False, True,   # scen 0: 3/4
                      True, True, True, True)]   # scen 1: 4/4
    assert achieved_quantile(rows, 2, 4) == pytest.approx(0.75)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _small(tw):
    base = tw.make_twin("auto", "autoscale", max_rps=1.9512,
                        usd_per_hour=0.0082, base_latency_s=0.15,
                        max_instances=8, scale_up_hours=2)
    loads = TrafficModel.honda_default("w").hourly_loads()[:96][None]
    return base, loads, SLO(limit_s=2 * 3600, met_fraction=0.95)


def test_optimize_scenario_is_search_of_the_space():
    base, loads, slo = _small(pt)
    kw = dict(loads=loads, bin_hours=1.0, restarts=3, steps=6, seed=0,
              device="cpu")
    free = ("max_instances", "scale_up_hours")
    a = optimize_scenario(base, None, slo, search=free, **kw)
    b = search(search_space(base, free), None, slo, **kw)
    assert_bitwise(a.restart_params, b.restart_params, "restart params")
    assert_bitwise(a.history, b.history, "history")
    assert (a.cost_usd, a.twin, a.feasible) == (b.cost_usd, b.twin,
                                                b.feasible)


def test_restart_mesh_raises():
    base, loads, slo = _small(pt)
    kw = dict(loads=loads, bin_hours=1.0, restarts=2, steps=1,
              device="cpu")
    # the restart mesh needs torch.distributed ranks
    # (tests/test_torch_restart_mesh.py); without a group it raises
    with pytest.raises(ValueError, match="torchrun"):
        search(base, None, slo, devices=2, **kw)
    for bad in (0, -2):
        with pytest.raises(ValueError, match="positive"):
            search(base, None, slo, devices=bad, **kw)
    assert search(base, None, slo, devices=1, **kw).restart_costs.shape \
        == (2,)


def test_faults_operand_is_checked():
    base, loads, slo = _small(pt)
    with pytest.raises(TypeError, match="FaultSchedule or SampledFaults"):
        search(base, None, slo, loads=loads, bin_hours=1.0, faults=[1],
               device="cpu")
    sched = faults.FaultSchedule(specs=(faults.outage(),), n_futures=2)
    with pytest.raises(ValueError, match="quantile"):
        search(base, None, slo, loads=loads, bin_hours=1.0, faults=sched,
               quantile=0.0, device="cpu")
