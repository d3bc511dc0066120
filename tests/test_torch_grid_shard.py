"""The scenario mesh (``simulate_grid(devices=D)``) over gloo ranks on the
CPU, against the port's and the reference's unsharded grids.

The reference's cases of ``tests/test_grid_shard.py`` (which need four
JAX host devices and skip here): n = 23 in blocks of 5 over every rank
(per-policy pads and an all-pad block both run), three policy blocks
over two ranks, the auto block, ``simulate_grid`` end to end,
``run_grid``'s pass-through and a fault grid. Worlds of 2 and 4 ranks,
each spawned once for all its cases (``torch_mesh_workers.grid_worker``).
Scenarios are independent, so the rows are held **bitwise** to the
port's ``devices=None`` run and to the reference's unsharded one; every
rank gets the same rows. Also each round's ``grid.round`` span with the
reference's attrs, the ``grid.blocks`` counter, and the errors: no
process group, and more devices than ranks.
"""
import numpy as np
import pytest
import torch

from repro_torch import faults as pf
from repro_torch.core import simulate as psim
from repro_torch.core import slo as pslo
from repro_torch.core import traffic as ptr
from repro_torch.core import twin as ptw
from repro_torch.core import whatif as pwhatif

import torch_mesh_workers as w
from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import assert_same_results, reference

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jref():
    with reference() as r:
        yield r


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: every rank's results}, each world spawned once."""
    root = tmp_path_factory.mktemp("grid")
    return {d: w.spawn(w.grid_worker, d, root) for d in (2, 4)}


@pytest.fixture(params=[2, 4])
def world(request, worlds):
    return request.param, worlds[request.param]


def slo():
    return pslo.SLO(limit_s=w.SLO_LIMIT, met_fraction=0.95)


@pytest.fixture(scope="module")
def run_grid_base():
    """``run_grid``'s unsharded full-year rows (one run for both
    worlds)."""
    return pwhatif.run_grid(w.policy_twins(ptw), w.traffics(ptr), slo=slo(),
                            device="cpu")


@pytest.mark.parametrize("case", w.DISPATCH_CASES, ids=lambda c: c[0])
def test_sharded_dispatch_is_bitwise_unsharded(world, jref, case):
    name, n, _, _ = case
    _, ranks = world
    _, matrix, index, params, idx = w.grid_arrays(ptw, ptr, n)
    base_c, base_a = psim._grid_agg_dispatch(matrix, index, params, idx, 1.0,
                                             w.SLO_LIMIT, 0, None, CPU)
    ref_c, ref_a = jref.simulate._grid_agg_dispatch(
        matrix, index, params, idx, 1.0, w.SLO_LIMIT, 0, None)
    for r in ranks:
        c, a = r[name]
        assert c.shape == (n, psim.CARRY_DIM) and a.shape == (n, psim.AGG_DIM)
        np.testing.assert_array_equal(c, base_c)
        np.testing.assert_array_equal(a, base_a)
        np.testing.assert_array_equal(c, np.asarray(ref_c))
        np.testing.assert_array_equal(a, np.asarray(ref_a))


def test_simulate_grid_devices_end_to_end(world, jref):
    _, ranks = world
    twins, matrix, index, _, _ = w.grid_arrays(ptw, ptr, 10)
    base = psim.simulate_grid(twins, load_matrix=matrix, load_index=index,
                              bin_hours=1.0, slo=slo(), return_series=False,
                              device="cpu")
    jtwins, *_ = w.grid_arrays(jref.twin, jref.traffic, 10)
    want = jref.simulate.simulate_grid(
        jtwins, load_matrix=matrix, load_index=index, bin_hours=1.0,
        slo=jref.slo.SLO(limit_s=w.SLO_LIMIT, met_fraction=0.95),
        return_series=False)
    for r in ranks:
        assert_same_results(r["end_to_end"], base)
        assert_same_results(r["end_to_end"], want)


def test_fault_grid_devices_is_bitwise_unsharded(world, jref):
    _, ranks = world
    twins, matrix, index, _, _ = w.grid_arrays(ptw, ptr, 10)
    kw = dict(load_matrix=matrix, load_index=index[:5], bin_hours=1.0,
              return_series=False)
    base = psim.simulate_grid(twins[:5], slo=slo(),
                              faults=w.chaos_schedule(pf), device="cpu",
                              **kw)
    jtwins, *_ = w.grid_arrays(jref.twin, jref.traffic, 10)
    want = jref.simulate.simulate_grid(
        jtwins[:5], slo=jref.slo.SLO(limit_s=w.SLO_LIMIT, met_fraction=0.95),
        faults=w.chaos_schedule(jref.faults), **kw)
    assert len(base) == 15
    for r in ranks:
        assert_same_results(r["fault"], base)
    # the reference's XLA fault path fuses batch_window's cost product,
    # its Pallas kernel and the port do not (ROADMAP C5: 2^-23 relative
    # on the annual cost); every other row is bitwise
    exact = [i for i, row in enumerate(want)
             if row.twin.policy != "batch_window"]
    assert_same_results([base[i] for i in exact], [want[i] for i in exact])
    for b, j in zip(base, want):
        if b.twin.policy == "batch_window":
            assert abs(b.total_cost_usd - j.total_cost_usd) \
                <= 2.0 ** -23 * abs(j.total_cost_usd)


def test_run_grid_devices_passthrough(worlds, run_grid_base):
    """Full-year rows through ``run_grid(devices=2)`` (the world of 2)."""
    base = run_grid_base
    for r in worlds[2]:
        assert [x.name for x in r["run_grid"]] == [x.name for x in base]
        assert_same_results(r["run_grid"], base)


def test_grid_round_spans_carry_the_reference_attrs(world):
    d, ranks = world
    # 10 scenarios of five policies in blocks of 4: five policy blocks
    n_blocks = 5
    for r in ranks:
        rounds = r["rounds"]
        assert len(rounds) == -(-n_blocks // d)
        for i, attrs in enumerate(rounds):
            assert attrs == {"round": i, "devices": d, "block": 4,
                             "backend": "plain", "scenarios": d * 4}
        assert r["blocks_counter"] == {
            ("grid.blocks", (("backend", "plain"), ("devices", str(d)))):
            float(n_blocks)}


def test_more_devices_than_ranks_raise(world):
    d, ranks = world
    for r in ranks:
        assert f"devices={d + 1}" in r["too_many"]
        assert f"only {d} rank(s)" in r["too_many"]
        assert "torchrun --nproc-per-node" in r["too_many"]


def test_devices_without_a_process_group_raise():
    twins, matrix, index, _, _ = w.grid_arrays(ptw, ptr, 4)
    kw = dict(load_matrix=matrix, load_index=index, bin_hours=1.0,
              device="cpu")
    with pytest.raises(ValueError, match="no torch.distributed process "
                                         "group.*torchrun"):
        psim.simulate_grid(twins, return_series=False, devices=2, **kw)
    with pytest.raises(ValueError, match="streaming-aggregate"):
        psim.simulate_grid(twins, return_series=True, devices=2, **kw)
    with pytest.raises(ValueError, match="positive"):
        psim.simulate_grid(twins, return_series=False, devices=0, **kw)
    # devices=1 is the one-device grid
    got = psim.simulate_grid(twins, return_series=False, devices=1, **kw)
    assert_same_results(got, psim.simulate_grid(
        twins, return_series=False, **kw))
