"""The restart meshes of ``fit`` and ``search`` (``devices=2``) over gloo
ranks on the CPU, against ``devices=None``.

One spawn of two ranks (``torch_mesh_workers.restart_worker``) runs a
shed fit (4 restarts x 30 steps on a 2 h ramp in 300 s bins) and an
autoscale search (4 restarts x 12 steps over a week) with ``devices=2``;
this process runs the same calls unsharded. Restarts are independent
lanes, the backward's schedule is planned for all of them
(``policy_vjp.whole_lanes``) and the search's objective path is decided
from the global size, so both are held **bitwise** (the reference pins
its search bitwise and its fit within rtol 2e-6, XLA's SPMD
contraction). A restart count the mesh does not divide runs unsharded
with the warn-once ``RuntimeWarning``.
"""
import numpy as np
import pytest

import torch_mesh_workers as w
from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import assert_bitwise

FIELDS = ("fit_z", "fit_losses", "fit_history", "search_params",
          "search_history")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return w.spawn(w.restart_worker, 2, tmp_path_factory.mktemp("restart"))


@pytest.fixture(scope="module")
def unsharded():
    return w.restart_summary(*w.restart_runs(None))


@pytest.mark.parametrize("field", FIELDS)
def test_restart_mesh_is_bitwise_unsharded(ranks, unsharded, field):
    want = np.asarray(unsharded[field])
    for r in ranks:
        got = np.asarray(r["mesh"][field])
        assert got.shape == want.shape
        assert_bitwise(got, want, field)


def test_restart_mesh_picks_the_same_winners(ranks, unsharded):
    for r in ranks:
        assert r["mesh"]["fit_best"] == unsharded["fit_best"]
        assert r["mesh"]["search_best"] == unsharded["search_best"]
        assert r["mesh"]["search_cost"] == unsharded["search_cost"]
    assert unsharded["fit_history"].shape == (w.FIT_STEPS, w.RESTARTS)
    assert unsharded["search_history"].shape == (w.SEARCH_STEPS, w.RESTARTS)


def test_indivisible_restarts_fall_back_with_a_warning(ranks):
    for r in ranks:
        (msg,) = r["fallback_warnings"]
        assert "restart mesh" in msg and "mesh axis 'restart' (size 2)" \
            in msg
