"""The port's what-if layer against ``repro.core.whatif`` / ``simulate``.

Full-year ``run_grid`` on the CPU (the plain versions of the kernels), in
both result modes, field for field and bit for bit against the JAX
package: the paper's Table II grid and a grid with one twin of every
policy. Also the blocked aggregate dispatch, ``_dedup_rows`` and
``_agg_block_plan``, the Table IV retention comparison and
``monthly_table``, and ``convert.py`` carrying the reference's grid state
across. Chaos suites (``faults=``) are in ``test_torch_faults.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import cost as pcost
from repro_torch.core import simulate as psim
from repro_torch.core import slo as pslo
from repro_torch.core import traffic as ptraffic
from repro_torch.core import twin as ptwin
from repro_torch.core import whatif as pwhatif

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import assert_bitwise, assert_same_results, reference


@pytest.fixture(scope="module")
def jref():
    with reference() as r:
        yield r


def paper_twins(tw):
    return [tw.SimpleTwin("blocking-write", 1.9512, 0.0082, 0.15),
            tw.SimpleTwin("no-blocking-write", 6.15, 0.0703, 0.06),
            tw.SimpleTwin("cpu-limited", 0.6612, 0.0027, 0.29)]


def policy_twins(tw):
    """One twin of every registered policy, tuned so queues build, the
    autoscaler ramps, shed drops and batch_window flushes."""
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


def traffics(tr):
    return [tr.TrafficModel.honda_default("nominal", R=3.5, G=1.0),
            tr.TrafficModel.honda_default("high(+50%)", R=3.5, G=1.5)]


@functools.lru_cache(maxsize=None)
def port_run_grid(twins, series):
    return pwhatif.run_grid(twins(ptwin), traffics(ptraffic),
                            slo=pslo.SLO(), return_series=series,
                            device="cpu")


@pytest.mark.parametrize("twins", [paper_twins, policy_twins])
@pytest.mark.parametrize("series", [False, True])
def test_run_grid_matches_reference(jref, twins, series):
    want = jref.whatif.run_grid(twins(jref.twin), traffics(jref.traffic),
                                slo=jref.slo.SLO(), return_series=series)
    got = port_run_grid(twins, series)
    assert pwhatif.table2_rows(got) == jref.whatif.table2_rows(want)
    assert_same_results(got, want)
    if twins is paper_twins:
        rows = {r["run"]: r for r in pwhatif.table2_rows(got)}
        assert rows["nominal no-blocking-write"]["cost_usd"] == 614.14
        assert rows["high(+50%) blocking-write"]["latency_backlog_s"] == \
            218920.44
        assert {run for run, r in rows.items() if r["slo_met"]} == {
            "nominal blocking-write", "nominal no-blocking-write",
            "high(+50%) no-blocking-write"}


def test_aggregate_mode_equals_series_mode():
    series = port_run_grid(policy_twins, True)
    aggs = port_run_grid(policy_twins, False)
    for s, a in zip(series, aggs):
        for x, y in ((a.total_cost_usd, s.total_cost_usd),
                     (a.max_throughput_rph, s.max_throughput_rph),
                     (a.mean_throughput_rph, s.mean_throughput_rph),
                     (a.dropped_records, s.dropped_records),
                     (a.processed_records, s.processed.sum()),
                     (a.arrived_records, s.load.sum()),
                     (a.queue_end, s.queue[-1]),
                     (a.pct_latency_met, s.pct_latency_met),
                     (a.pct_hours_met, s.pct_hours_met)):
            assert x == y, s.name
        assert a.slo_met == s.slo_met


def _mixed_grid(tw, n=40, t=336, seed=0):
    rng = np.random.default_rng(seed)
    names = ["fifo", "quickscale", "autoscale", "shed", "batch_window"]
    twins = []
    for i in range(n):
        policy = names[int(rng.integers(0, 5))]
        extra = {"autoscale": dict(max_instances=8.0, scale_up_hours=2.0),
                 "shed": dict(queue_cap_hours=1.5),
                 "batch_window": dict(window_hours=4.0)}.get(policy, {})
        twins.append(tw.make_twin(f"t{i}", policy,
                                  max_rps=float(rng.uniform(0.5, 3.0)),
                                  usd_per_hour=0.01, base_latency_s=0.1,
                                  **extra))
    matrix = rng.uniform(0.0, 9000.0, (5, t)).astype(np.float32)
    index = rng.integers(0, 5, n).astype(np.int32)
    return twins, matrix, index


def test_blocked_grid_equals_unblocked(jref):
    twins, matrix, index = _mixed_grid(ptwin)
    kw = dict(load_matrix=matrix, load_index=index, bin_hours=1.0,
              slo=pslo.SLO(limit_s=3600.0), return_series=False,
              device="cpu")
    whole = psim.simulate_grid(twins, **kw)
    blocked = psim.simulate_grid(twins, scenario_block=8, **kw)
    assert_same_results(blocked, whole)
    j_twins, _, _ = _mixed_grid(jref.twin)
    want = jref.simulate.simulate_grid(
        j_twins, load_matrix=matrix, load_index=index, bin_hours=1.0,
        slo=jref.slo.SLO(limit_s=3600.0), return_series=False,
        scenario_block=8)
    assert_same_results(blocked, want)


def test_dedup_rows_and_block_plan_match_reference(jref):
    rng = np.random.default_rng(7)
    n = 60
    index = rng.integers(0, 3, n).astype(np.int32)
    params = rng.uniform(0, 4, (6, ptwin.PARAM_DIM)).astype(np.float32)[
        rng.integers(0, 6, n)]
    pol = rng.integers(0, 5, n).astype(np.int32)
    keep, inv, fidx = psim._dedup_rows(index, params, pol)
    j_keep, j_inv, j_fidx = jref.simulate._dedup_rows(index, params, pol)
    np.testing.assert_array_equal(keep, j_keep)
    np.testing.assert_array_equal(inv, j_inv)
    assert fidx is None and j_fidx is None
    assert psim._dedup_rows(np.arange(4), params[:4], pol[:4]) is None
    for block in (1, 7, 16, 64):
        got = psim._agg_block_plan(pol, block)
        want = jref.simulate._agg_block_plan(pol, block)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_duplicate_scenarios_run_once_with_identical_rows():
    twins, matrix, index = _mixed_grid(ptwin, n=6)
    kw = dict(bin_hours=1.0, return_series=False, device="cpu")
    rows = psim.simulate_grid(twins * 3, load_matrix=matrix,
                              load_index=np.tile(index, 3), **kw)
    for i in range(6):
        assert_same_results([rows[i + 6], rows[i + 12]], [rows[i]] * 2)


def test_retention_whatif_and_monthly_table_match(jref):
    got = pwhatif.retention_whatif(
        paper_twins(ptwin)[1], traffics(ptraffic)[0], record_mb=0.0141,
        retentions_days=(91, 182), cost_model=pcost.CostModel(),
        device="cpu")
    want = jref.whatif.retention_whatif(
        paper_twins(jref.twin)[1], traffics(jref.traffic)[0],
        record_mb=0.0141, retentions_days=(91, 182),
        cost_model=jref.cost.CostModel())
    assert got == want
    assert sum(r["storage_usd"] for r in got[182]) > \
        sum(r["storage_usd"] for r in got[91])


def test_convert_carries_reference_grid_state(jref):
    j_twins = policy_twins(jref.twin)
    params = np.stack([t.padded_params() for t in j_twins])
    idx = np.asarray([t.policy_index for t in j_twins])
    names = [t.name for t in j_twins]
    order = jref.twin.policy_names()
    twins = convert.twins_from_arrays(params, idx, names, order)
    assert [t.policy for t in twins] == [t.policy for t in j_twins]
    for t, j in zip(twins, j_twins):
        assert_bitwise(t.padded_params(), j.padded_params(), t.name)
    matrix = np.stack([tr.hourly_loads() for tr in traffics(jref.traffic)])
    index = np.array([0, 1, 1, 0, 1], np.int32)
    ops = convert.grid_tensors(matrix, index, params, idx, order,
                               device="cpu")
    assert ops["loads_t"].shape == (matrix.shape[1], 2)
    assert ops["loads_t"].dtype == torch.float32
    assert ops["load_index"].dtype == torch.int32
    assert_bitwise(ops["onehot"].numpy(), jref.twin.policy_onehot(idx))
    with pytest.raises(ValueError, match="policy order"):
        convert.check_policy_order(list(reversed(order)))
    with pytest.raises(ValueError, match="pads"):
        bad = params.copy()
        bad[0, 5] = 1.0                  # fifo takes three parameters
        convert.twins_from_arrays(bad, idx, names, order)


def test_unported_options_raise():
    twins, matrix, index = _mixed_grid(ptwin, n=4)
    kw = dict(load_matrix=matrix, load_index=index, bin_hours=1.0,
              return_series=False, device="cpu")
    with pytest.raises(NotImplementedError, match="devices"):
        psim.simulate_grid(twins, devices=2, **kw)
    assert dataclasses.replace(pcost.CostModel()).chip_usd_per_hour is None
