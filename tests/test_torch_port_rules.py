"""The port's ground rules.

* ``repro_torch`` imports ``torch`` and numpy, never ``jax`` and nothing
  of the JAX package ``repro``, not even ``repro.faults``, ``repro.obs``
  or ``repro.pipelines`` (checked in a fresh interpreter, and in the
  source text of the package, its ``faults``, ``obs`` and ``pipelines``
  copies, wind-tunnel, ``calibrate`` and ``optim`` modules included, and
  of ``chip_smoke.py``);
* no accelerator has a price by default: ``CostModel`` and
  ``roofline_twin`` take the chip's price from the caller;
* run telemetry is off unless asked for;
* its entry points (the what-if grid's, the serving slice's
  ``ServeEngine``, ``models.model.init_params`` and ``init_cache`` and
  the ``launch.serve`` CLI, and
  the calibration slice's ``fit``, ``fit_with_holdout``, ``evaluate``,
  ``calibrated_twin``, ``calibrated_grid`` and the trace replay, and the
  search slice's ``search``, ``search_policies``, ``pareto_frontier`` and
  ``optimize_scenario``, and the training side's ``make_train_step``,
  ``train``, ``elastic_restore``, ``state_like`` and the ``launch.train``
  CLI) default to the card and raise without one;
* ``chip_smoke.py`` fails, printing no result, where there is no card;
* the model runs every config, MLA (minicpm3), the encoder-decoder
  (whisper) and the vision frontend with its M-RoPE positions (qwen2-vl)
  among them, and refuses, with ``NotImplementedError``, an attention
  kind, block kind or frontend it does not know;
* no CUDA source keeps a kernel's shared-memory opt-in once per process
  (the attribute belongs to one device's context, ROADMAP C11): every
  opt-in goes through ``csrc/smem_opt_in.cuh``, which sets it per device;
* the policy scans, the series loop's included, divide through float64
  reciprocals, never the IEEE float32 division.
"""
import dataclasses
import inspect
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
from repro_torch import calibrate, faults
from repro_torch.configs import get_smoke_config
from repro_torch.core import cost, simulate, slo, traffic, twin, whatif
from repro_torch.core.pipeline import Resources
from repro_torch.models import model as M
from repro_torch.serve.engine import ServeEngine

from torch_port_ref import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
CSRC = SRC / "repro_torch" / "kernels" / "csrc"
#: a cudaFuncSetAttribute result kept in a static: set once per process
OPT_IN_CACHED = re.compile(r"\bstatic\b[^;{}]*\bcudaFuncSetAttribute\b")
# a product cast to 32 bits, as in `4 * ((unsigned)bucket * (unsigned)n)`:
# an offset into a buffer of more than 2^32 elements wraps without a fault
OFFSET_32 = re.compile(r"\((?:unsigned|uint32_t|int)\)\s*\w+\s*\*\s*"
                       r"\((?:unsigned|uint32_t|int)\)")
# a call of the policy step, its division chosen by the second argument
BIN_STEP_CALL = re.compile(r"\bbin_step<\s*[^,<>]+,\s*(\w+)\s*>\s*\(")
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
            "repro_torch.configs.jamba15_large_398b",
            "repro_torch.core.schema", "repro_torch.core.datagen",
            "repro_torch.core.loadpattern", "repro_torch.core.metrics",
            "repro_torch.core.experiment", "repro_torch.pipelines.telemetry",
            "repro_torch.obs.record", "repro_torch.obs.export",
            "repro_torch.obs.report", "repro_torch.obs.profile",
            "repro_torch.obs.__main__", "repro_torch.calibrate",
            "repro_torch.calibrate.fit", "repro_torch.calibrate.objective",
            "repro_torch.calibrate.trace", "repro_torch.optim",
            "repro_torch.optim.adamw",
            "repro_torch.kernels.policy_vjp", "repro_torch.search",
            "repro_torch.search.space", "repro_torch.search.objective",
            "repro_torch.search.optimize",
            "repro_torch.search.frontier", "repro_torch.launch.specs",
            "repro_torch.launch.serve", "repro_torch.optim.compression",
            "repro_torch.data.loader", "repro_torch.checkpoint.ckpt",
            "repro_torch.distributed.fault",
            "repro_torch.distributed.elastic", "repro_torch.train.steps",
            "repro_torch.train.loop", "repro_torch.launch.train",
            "repro_torch.kernels.lane_codegen",
            "repro_torch.distributed.sharding",
            "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
            "repro_torch.launch.roofline"} <= set(_modules())


def test_port_sources_do_not_import_jax_or_the_reference():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_mesh_workers.py"]
    assert len(files) > 50
    names = {f.relative_to(SRC / "repro_torch").as_posix() for f in files
             if f.is_relative_to(SRC / "repro_torch")}
    assert {"obs/record.py", "obs/export.py", "obs/report.py",
            "obs/profile.py", "obs/__init__.py", "obs/__main__.py",
            "pipelines/telemetry.py", "pipelines/__init__.py",
            "core/experiment.py", "core/datagen.py", "core/schema.py",
            "core/loadpattern.py", "core/metrics.py",
            "calibrate/__init__.py", "calibrate/fit.py",
            "calibrate/objective.py", "calibrate/trace.py",
            "optim/__init__.py", "optim/adamw.py",
            "kernels/policy_vjp.py", "search/__init__.py",
            "search/space.py", "search/objective.py",
            "search/optimize.py", "search/frontier.py",
            "launch/specs.py", "launch/serve.py", "optim/compression.py",
            "data/__init__.py", "data/loader.py", "checkpoint/__init__.py",
            "checkpoint/ckpt.py", "distributed/__init__.py",
            "distributed/fault.py", "distributed/elastic.py",
            "train/__init__.py", "train/steps.py", "train/loop.py",
            "launch/train.py", "kernels/lane_codegen.py",
            "distributed/sharding.py", "launch/mesh.py",
            "launch/dryrun.py", "launch/roofline.py"} <= names
    for f in files:
        hit = FORBIDDEN.search(f.read_text())
        assert hit is None, f"{f}: {hit.group(0).strip()}"
    # the pattern tells the port's own package apart from the reference
    assert FORBIDDEN.search("from repro_torch.core import twin") is None
    assert FORBIDDEN.search("from repro.core import twin") is not None
    assert FORBIDDEN.search("import repro") is not None


def test_no_accelerator_price_by_default():
    price = inspect.signature(twin.roofline_twin).parameters[
        "chip_usd_per_hour"]
    assert price.default is inspect.Parameter.empty
    assert price.kind is inspect.Parameter.KEYWORD_ONLY
    assert cost.CostModel().chip_usd_per_hour is None
    with pytest.raises(ValueError, match="chip_usd_per_hour"):
        cost.CostModel().pipeline_usd_per_hour(Resources(chips=1))
    assert cost.CostModel().pipeline_usd_per_hour(Resources()) > 0
    assert not hasattr(cost, "TPU_V5E_USD_PER_CHIP_HOUR")


def test_run_telemetry_is_off_unless_asked_for():
    code = ("from repro_torch import obs\n"
            "print(obs.enabled())\n")
    env = _env()
    env.pop("REPRO_OBS", None)
    for value, want in ((None, "False"), ("1", "True"), ("0", "False")):
        if value is not None:
            env["REPRO_OBS"] = value
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == want, value


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
    trace = calibrate.ObservedTrace.from_simulation(tw[0], loads[:6], 1.0,
                                                    device="cpu")
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
        lambda: calibrate.fit(trace, "fifo", restarts=2, steps=1),
        lambda: calibrate.fit_with_holdout(trace, trace, "fifo",
                                           restarts=2, steps=1),
        lambda: calibrate.evaluate(tw[0], trace),
        lambda: calibrate.calibrated_twin(trace, "fifo", restarts=2,
                                          steps=1),
        lambda: whatif.calibrated_grid(trace, ["fifo"], tr, restarts=2,
                                       steps=1),
        lambda: calibrate.ObservedTrace.from_simulation(tw[0], loads[:4],
                                                        1.0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        repro_torch.resolve_device("mps")


def test_search_entry_points_default_to_the_card_and_raise_without_one():
    from repro_torch import search
    _no_card()
    base = twin.make_twin("a", "autoscale", max_rps=1.9512,
                          usd_per_hour=0.0082, base_latency_s=0.15,
                          max_instances=8, scale_up_hours=2)
    tr = [traffic.TrafficModel.honda_default("n")]
    target = slo.SLO(limit_s=2 * 3600, met_fraction=0.95)
    free = ("max_instances", "scale_up_hours")
    calls = [
        lambda: search.search(base, tr, target, restarts=2, steps=1),
        lambda: search.search(search.search_space(base, free), tr, target,
                              restarts=2, steps=1),
        lambda: search.search_policies([base], tr, target, restarts=2,
                                       steps=1),
        lambda: search.pareto_frontier(base, tr, [3600.0, 7200.0],
                                       restarts=2, steps=1),
        lambda: whatif.optimize_scenario(base, tr, target, search=free,
                                         restarts=2, steps=1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for entry in (search.search, search.pareto_frontier,
                  whatif.optimize_scenario):
        params = inspect.signature(entry).parameters
        assert "device" not in params or \
            params["device"].default == "cuda", entry
    assert inspect.signature(search.search).parameters[
        "device"].default == "cuda"
    assert inspect.signature(search.pareto_frontier).parameters[
        "device"].default == "cuda"


def test_training_entry_points_default_to_the_card_and_raise_without_one():
    from repro_torch.config import (OptimizerConfig, ParallelConfig,
                                    TrainConfig)
    from repro_torch.distributed.elastic import elastic_restore, state_like
    from repro_torch.launch import train as launch_train
    from repro_torch.train.loop import train
    from repro_torch.train.steps import make_train_step
    _no_card()
    cfg = get_smoke_config("llama3.2-1b")
    ocfg, par = OptimizerConfig(), ParallelConfig()
    calls = [
        lambda: make_train_step(cfg, ocfg, par),
        lambda: train(cfg, TrainConfig(steps=1, checkpoint_dir="unused"),
                      ocfg, par),
        lambda: elastic_restore("unused", cfg, ocfg, par),
        lambda: state_like(cfg, ocfg),
        lambda: launch_train.main(["--smoke", "--steps", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert launch_train.parse_args([]).device == "cuda"
    for entry in (make_train_step, train, elastic_restore, state_like):
        assert inspect.signature(entry).parameters[
            "device"].default == "cuda", entry


def test_mesh_entry_points_default_to_the_card_and_need_ranks():
    """The multi-GPU layer: the meshes are built on the card by default,
    and every ``devices=`` > 1 and every mesh needs a process group,
    naming how to start one (no quiet one-process fall-back)."""
    from repro_torch.distributed.elastic import elastic_restore
    from repro_torch.launch import mesh
    from repro_torch.launch import train as launch_train
    for entry in (mesh.make_host_mesh, mesh.make_production_mesh):
        assert inspect.signature(entry).parameters[
            "device"].default == "cuda", entry
    with pytest.raises(ValueError, match="torchrun"):
        mesh.make_host_mesh(2, 1)
    with pytest.raises(ValueError, match=r"\(16, 16\).*torchrun"):
        mesh.make_production_mesh()
    with pytest.raises(ValueError, match=r"\(2, 16, 16\).*torchrun"):
        mesh.make_production_mesh(multi_pod=True)
    cfg = get_smoke_config("llama3.2-1b")
    from repro_torch.config import OptimizerConfig, ParallelConfig
    with pytest.raises(ValueError, match="torchrun"):
        elastic_restore("unused", cfg, OptimizerConfig(), ParallelConfig(),
                        devices=2, device="cpu")
    args = launch_train.parse_args(["--data", "2", "--model", "1"])
    assert (args.data, args.model, args.device) == (2, 1, "cuda")
    assert launch_train.mesh_of(launch_train.parse_args([])) is None


def test_collectives_are_called_in_sharding_alone():
    """Every ``torch.distributed`` collective of the port, serving's row
    sums, vocabulary gathers and expert exchange among them, is called in
    ``distributed/sharding.py`` and nowhere else."""
    call = re.compile(r"\bdist\.(all_\w+|reduce\w*|broadcast\w*|barrier|"
                      r"gather\w*|scatter\w*|send|recv)\(")
    sites = {f.relative_to(SRC / "repro_torch").as_posix()
             for f in (SRC / "repro_torch").rglob("*.py")
             if call.search(f.read_text())}
    assert sites == {"distributed/sharding.py"}
    text = (SRC / "repro_torch" / "distributed" / "sharding.py").read_text()
    for name in ("all_to_all_single", "all_reduce", "all_gather"):
        assert f"dist.{name}(" in text, name


def test_serve_launcher_defaults_to_the_card_and_raises_without_one():
    from repro_torch.launch import serve as launch_serve
    _no_card()
    assert launch_serve.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--requests", "1"])
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--requests", "1"], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "served" not in out.stdout


@pytest.mark.parametrize("arch, what", [
    ("minicpm3-4b", "mla attention"),
    ("whisper-small", "encoder-decoder"),
    ("qwen2-vl-7b", "the vision frontend")])
def test_model_refuses_what_is_not_ported(arch, what):
    """The three features were refused until ported; the configs that
    need them now run, and the model still refuses what it does not
    know in their place."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    for cfg in (get_config(arch), get_smoke_config(arch)):
        tf.check_supported(cfg)
        if what == "mla attention":
            unknown = dataclasses.replace(cfg, attention=dataclasses.replace(
                cfg.attention, kind="linear"))
            refusal = "linear attention not supported"
        elif what == "encoder-decoder":
            unknown = dataclasses.replace(cfg, block_pattern=("hyena",))
            refusal = "'hyena' blocks not supported"
        else:
            unknown = dataclasses.replace(cfg, frontend="video")
            refusal = "the video frontend not supported"
        with pytest.raises(NotImplementedError, match=refusal):
            tf.check_supported(unknown)
        with pytest.raises(NotImplementedError, match=refusal):
            M.init_params(unknown, device="cpu")
    assert M.param_count(get_smoke_config(arch)) == sum(
        w.numel() for w in M.init_params(get_smoke_config(arch),
                                         device="cpu").values())


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


def test_shared_memory_opt_in_is_set_per_device():
    sources = sorted(CSRC.glob("*.cu"))
    assert len(sources) >= 4
    for f in sources + sorted(CSRC.glob("*.cuh")):
        hit = OPT_IN_CACHED.search(f.read_text())
        assert hit is None, (f"{f.name} caches an opt-in per process: "
                             f"{hit.group(0)!r}")
    # the kernels call the per-device helper, never the attribute itself
    for f in sources:
        assert "cudaFuncSetAttribute" not in f.read_text(), f.name
    helper = (CSRC / "smem_opt_in.cuh").read_text()
    assert "cudaGetDevice" in helper and "cudaFuncSetAttribute" in helper
    # the pattern catches the per-process form, on one line or two
    assert OPT_IN_CACHED.search(
        "static const cudaError_t attr = cudaFuncSetAttribute(\n"
        "    kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);")
    assert OPT_IN_CACHED.search("const cudaError_t attr = smem_opt_in("
                                "kernel, bytes);") is None


def test_kernel_offsets_are_not_multiplied_in_32_bits():
    """No kernel source multiplies two values cast to 32 bits, the form
    in which a histogram offset once wrapped past 2^32 elements; offsets
    are products in size_t."""
    for f in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        hit = OFFSET_32.search(f.read_text())
        assert hit is None, f"{f.name}: a 32-bit product {hit.group(0)!r}"
    assert OFFSET_32.search("hp = hcol + 4 * ((unsigned)bucket * "
                            "(unsigned)n);")
    assert OFFSET_32.search("hp = hcol + 4 * ((size_t)bucket * n);") is None


def test_policy_scans_divide_through_reciprocals():
    """Every call of the policy step in ``csrc/policy_scan.cu`` divides
    through the float64 reciprocals (``bin_step<.., true>``), and the
    series loop runs the scenario scan's step, which is such a call: the
    IEEE float32 division, whose slow path a zero dividend takes (the
    fault backlog's wait, most bins), does not come back."""
    text = (CSRC / "policy_scan.cu").read_text()
    calls = BIN_STEP_CALL.findall(text)
    assert calls and set(calls) == {"true"}, calls
    start = text.index("struct ScenarioScan")
    step = text[start:text.index("\n};\n", start)]
    assert BIN_STEP_CALL.findall(step) == ["true"]
    series = text[text.index("void series_scan("):
                  text.index("policy_scan_kernel(")]
    assert re.search(r"\bsc\.(?:template\s+)?step\b", series)
    assert "bin_step<" not in series
    assert BIN_STEP_CALL.findall(
        "bin_step<kFault, false>(branch, c0, c1") == ["false"]
