"""Chance-constrained policy search on the port: ``tests/test_faults.py``'s
closed-form toy, on the CPU at the reference test's size.

Five handcrafted fault futures over a flat load (benign, three short
outages, one long one); a latency SLO allowing 15% violating hours. The
long outage needs ~4x the capacity, so the 80%-of-futures configuration
(quantile 0.8) is strictly cheaper than the worst case (quantile 1.0),
and its exact ``achieved_quantile`` (the bit-exact aggregate re-check
across the futures) sits in [0.8, 1).
"""
import numpy as np
import pytest

from repro_torch.core.slo import SLO
from repro_torch.core.twin import make_twin
from repro_torch.faults import SampledFaults
from repro_torch.search import search, search_space

from torch_port_ref import one_torch_thread  # noqa: F401

CPU = dict(device="cpu")


def _toy_faults(t_bins=336):
    """5 futures over a flat load: benign, 3 short outages, 1 long one.
    At an SLO allowing 15% violating hours the long outage needs ~4x the
    capacity, so quantile 0.8 (4 of 5 futures) is strictly cheaper than
    the worst case."""
    n_fut = 5
    cap = np.ones((n_fut, t_bins), np.float32)
    mask = np.zeros((n_fut, t_bins), np.float32)
    for f, (start, dur) in enumerate([(60, 10), (140, 10), (230, 10)],
                                     start=1):
        cap[f, start:start + dur] = 0.0
        mask[f, start:start + dur] = 1.0
    cap[4, 100:140] = 0.0
    mask[4, 100:140] = 1.0
    windows = [(), ((60, 70),), ((140, 150),), ((230, 240),),
               ((100, 140),)]
    events = tuple(
        tuple({"spec": "toy-outage", "kind": "outage", "start": a,
               "end": b} for a, b in wins)
        for wins in windows)
    return SampledFaults(
        cap=cap, mask=mask, load_mult=np.ones((n_fut, t_bins), np.float64),
        replay=((),) * n_fut, events=events, n_futures=n_fut, t_bins=t_bins,
        bin_hours=1.0, seed=0)


def test_chance_constrained_beats_worst_case():
    t_bins = 336
    loads = np.full((1, t_bins), 300.0, np.float32)
    slo = SLO(limit_s=5.0, met_fraction=0.85)
    base = make_twin("base", "fifo", max_rps=1.0, usd_per_hour=4.0,
                     base_latency_s=0.05)
    space = search_space(base, ("max_rps",),
                         bounds={"max_rps": (0.05, 1.5)},
                         tie={"usd_per_hour": ("max_rps", 4.0)})
    toy = _toy_faults(t_bins)
    kw = dict(loads=loads, bin_hours=1.0, slo=slo, faults=toy, restarts=6,
              steps=80, seed=0, **CPU)
    worst = search(space, quantile=1.0, **kw)
    chance = search(space, quantile=0.8, **kw)
    assert worst.feasible and chance.feasible
    assert worst.achieved_quantile == pytest.approx(1.0)
    assert chance.achieved_quantile >= 0.8 - 1e-9
    assert chance.cost_usd < worst.cost_usd, (chance.cost_usd,
                                              worst.cost_usd)
    assert chance.quantile == 0.8 and chance.n_futures == 5
    assert chance.achieved_quantile < 1.0
    assert len(chance.scenario_rows) == 5
