"""The port's ground rules.

* ``repro_torch`` imports ``torch`` and numpy, never ``jax`` and nothing
  of the JAX package ``repro``, not even ``repro.faults`` or ``repro.obs``
  (checked in a fresh interpreter, and in the source text of the package,
  its ``faults`` copy included, and of ``chip_smoke.py``);
* its entry points (the what-if grid's, and the serving slice's
  ``ServeEngine``, ``models.model.init_params`` and ``init_cache``)
  default to the card and raise without one;
* ``chip_smoke.py`` fails, printing no result, where there is no card.
"""
import dataclasses
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import faults
from repro_torch.configs import get_smoke_config
from repro_torch.core import simulate, slo, traffic, twin, whatif
from repro_torch.models import model as M
from repro_torch.serve.engine import ServeEngine

from torch_port_ref import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))",
                       re.MULTILINE)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert {"repro_torch.kernels.policy_scan", "repro_torch.faults.grid",
            "repro_torch.faults.sampler", "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.ssm_scan", "repro_torch.models.model",
            "repro_torch.models.transformer", "repro_torch.serve.engine",
            "repro_torch.core.spans", "repro_torch.core.pipeline",
            "repro_torch.configs.jamba15_large_398b"} <= set(_modules())


def test_port_sources_do_not_import_jax_or_the_reference():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 30
    for f in files:
        hit = FORBIDDEN.search(f.read_text())
        assert hit is None, f"{f}: {hit.group(0).strip()}"
    # the pattern tells the port's own package apart from the reference
    assert FORBIDDEN.search("from repro_torch.core import twin") is None
    assert FORBIDDEN.search("from repro.core import twin") is not None
    assert FORBIDDEN.search("import repro") is not None


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible; this checks the card-less "
                    "behaviour")


def test_entry_points_default_to_the_card_and_raise_without_one():
    _no_card()
    tw = [twin.SimpleTwin("a", 1.0, 0.01, 0.1)]
    tr = [traffic.TrafficModel.honda_default("n")]
    loads = tr[0].hourly_loads()
    schedule = faults.FaultSchedule(specs=(faults.outage(),), n_futures=2)
    cfg = dataclasses.replace(get_smoke_config("jamba-1.5-large-398b"),
                              moe=None)
    cpu_params = M.init_params(cfg, device="cpu")
    calls = [
        lambda: whatif.run_grid(tw, tr, slo=slo.SLO()),
        lambda: whatif.run_grid(tw, tr, return_series=True),
        lambda: whatif.run_grid(tw, tr, faults=schedule),
        lambda: simulate.simulate_grid(tw, loads[None], faults=schedule,
                                       return_series=False),
        lambda: whatif.run_scenarios([whatif.Scenario("s", tw[0], tr[0])]),
        lambda: simulate.simulate_grid(tw, loads[None]),
        lambda: simulate.simulate_year(tw[0], loads),
        lambda: whatif.retention_whatif(tw[0], tr[0], record_mb=0.01),
        lambda: M.init_params(cfg),
        lambda: M.init_cache(cfg, 2, 16),
        lambda: ServeEngine(cfg, cpu_params),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        repro_torch.resolve_device("mps")


def test_chip_smoke_fails_without_a_card():
    _no_card()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no CUDA device" in out.stderr


def test_plain_cpu_run_needs_asking_for():
    # the same call runs once the CPU is named explicitly
    loads = np.full((1, 24), 3600.0, np.float32)
    rows = simulate.simulate_grid([twin.SimpleTwin("a", 1.0, 0.01, 0.1)],
                                  loads, bin_hours=1.0, device="cpu")
    assert rows[0].processed.sum() == 24 * 3600.0
