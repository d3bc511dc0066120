"""The port's dry run and roofline (ROADMAP A8.3) against the reference's.

``python -m repro_torch.launch.dryrun`` runs in subprocesses (each a
fresh process: it owns its fake process group of 256 ranks) for four
cells: llama3.2-1b ``train_4k`` (``probe1_exact``) and ``decode_32k``
(every mode: memfit and the four probes), jamba-1.5-large
``long_500k`` and whisper-small ``decode_32k`` (``probe1_exact``; its
12 heads over a ``model`` axis of 16 fall back, ROADMAP C19), on the
single-pod mesh. Beside them,
one subprocess compiles the reference's ``build_lowered`` for the same
one-group probes on a (16, 16) mesh of 512 host devices with Auto axes
(``jax.make_mesh(..., axis_types=(AxisType.Auto,) * 2)``: its own
Explicit-axis production mesh does not compile on jax 0.9, ROADMAP C3).
Checked:

* argument bytes equal the reference's ``argument_size_in_bytes`` but
  for one named difference: where ``model`` splits the query heads and
  exceeds the KV heads the port's ``wk`` / ``wv`` shard holds the one
  whole head its query heads read (and in training its AdamW moments
  likewise), where the reference's holds a ``kv_heads * head_dim /
  model`` column slice of it; whisper-small's, whose heads fall back,
  equal the reference's exactly;
* the port's FLOPs (``FlopCounterMode``: products and attention, no
  elementwise work) within ``[FLOP_LO, 1]`` of the HLO's, and within a
  stated band of the model flops (6 N T to train, 2 N T to decode, per
  rank);
* memfit's direct count of the whole stack equals the probes'
  extrapolation ``B + (n_groups - 1)(C - B)``, flops and collective
  bytes alike;
* ``launch.roofline.analytic_bytes`` equals the reference's for all 10
  archs x 4 shapes, and ``analyze_cell`` on the same synthetic records
  gives the reference's fields, each time scaled by the ratio of the
  constants;
* the roofline's command line prints its table from the records.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.config import SHAPES, get_shape
from repro_torch.configs import all_archs, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.models import model as M

from torch_port_ref import model_ref as jref  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (arch, shape, modes) of the port's runs
CELLS = (("llama3.2-1b", "train_4k", ("probe1_exact",)),
         ("llama3.2-1b", "decode_32k", D.MODES),
         ("jamba-1.5-large-398b", "long_500k", ("probe1_exact",)),
         ("whisper-small", "decode_32k", ("probe1_exact",)))
#: the cells whose KV shards hold C23's whole head
C23_CELLS = (("llama3.2-1b", "train_4k"), ("llama3.2-1b", "decode_32k"),
             ("jamba-1.5-large-398b", "long_500k"))
#: the port's flops against the HLO's: a lower bound (no elementwise
#: work); measured 0.987 (train), 0.822 (decode), 0.659 (long_500k)
FLOP_LO = 0.6
#: the port's flops over the model flops per rank (6 N T / 256 to train
#: with full remat, 2 N T / 256 to decode; N counts the embedding table,
#: which a lookup reads without products): measured 1.12 (train_4k: the
#: forward twice), 1.42 (decode_32k: attention over the 32k context),
#: 12.6 (long_500k: the 16 data ranks repeat the one row)
MODEL_FLOP_BANDS = {"train_4k": (1.0, 2.0), "decode_32k": (1.0, 4.0),
                    "long_500k": (1.0, 64.0)}
#: a cell whose widths fall back (C19) repeats their work on every rank:
#: whisper-small's decode runs its 12 heads' attention (self and cross,
#: over the 32k cache and 1,500 frames) and its whole 51,865-wide
#: unembedding on all 16 model ranks; measured 4.21
FALLBACK_FLOP_BANDS = {("whisper-small", "decode_32k"): (1.0, 8.0)}

REF_SCRIPT = r'''
import dataclasses, json, sys
import jax
import jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
from repro.launch import dryrun as D   # sets XLA_FLAGS before jax runs
from jax.sharding import AxisType
from repro.config import OptimizerConfig, get_shape
from repro.configs import get_config
from repro.kernels import ops
from repro.models import transformer as tf
out = {}
for arch, shape_name in json.loads(sys.argv[1]):
    shape = get_shape(shape_name)
    cfg = D.reduced_cfg(get_config(arch), 1)
    if shape.kind != "train":
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    par = dataclasses.replace(D.default_parallel(shape), microbatches=1)
    mesh = jax.make_mesh((16, 16), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    tf.set_scan_unroll(1)
    ops.set_attn_chunk(0)
    with mesh:
        compiled = D.build_lowered(cfg, shape, par, mesh,
                                   OptimizerConfig()).compile()
    ca = compiled.cost_analysis() or {}
    out[arch + "/" + shape_name] = {
        "flops": float(ca.get("flops", 0.0)),
        "memory": D.memory_dict(compiled),
        "collectives": D.parse_collectives(compiled.as_text())}
print(json.dumps(out))
'''


def _env():
    env = dict(os.environ)
    src = os.path.join(ROOT, "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({(arch, shape, mode): the port's record}, {arch/shape: the
    reference's compiled numbers}), all subprocesses run at once."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", str(out)]
        + (["--mode", modes[0]] if len(modes) == 1 else []),
        cwd=str(out), env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for arch, shape, modes in CELLS]
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT,
         json.dumps([[a, s] for a, s, _ in CELLS])],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    logs = [p.communicate(timeout=300)[0] for p in procs]
    ref_out, ref_err = ref.communicate(timeout=300)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    assert ref.returncode == 0, ref_err[-3000:]
    port = {}
    for arch, shape, modes in CELLS:
        for mode in modes:
            with open(D.cell_path(str(out), arch, shape, "single",
                                  mode)) as f:
                port[(arch, shape, mode)] = json.load(f)
    return port, json.loads(ref_out.strip().splitlines()[-1]), str(out)


def _local_numel(shape, spec, mesh, kind=None):
    n = 1
    cuts = {d: len(idx) for d, _, idx in sh.cut_indices(
        shape, spec, mesh, {a: 0 for a in mesh}, kind)}
    for d, size in enumerate(shape):
        n *= cuts.get(d, size)
    return n


def kv_head_bytes(arch, shape_name):
    """The bytes the port's KV-projection shards hold beyond the
    reference's: the whole head against its column slice."""
    shape = get_shape(shape_name)
    cfg = D.reduced_cfg(get_config(arch), 1)
    mesh = {"data": 16, "model": 16}
    par = dataclasses.replace(D.default_parallel(shape), microbatches=1)
    if shape.kind == "train":
        layout = M.train_layout(cfg, par, mesh)
        itemsize, copies = 4, 3            # the parameter, m and v
    else:
        layout = M.serve_layout(cfg, par, mesh, shape.global_batch,
                                shape.seq_len)[0]
        itemsize, copies = 2, 1
    rules = sh.build_rules(par, mesh)
    if shape.kind != "train":
        rules = dict(rules, embed=None)
    specs = M.partition_specs(cfg, rules, mesh)
    extra = 0
    for name, (spec, whole, kind) in layout.items():
        if name.endswith((".attn.wk", ".attn.wv")):
            extra += (_local_numel(whole, spec, mesh, kind)
                      - _local_numel(whole, specs[name], mesh)) * itemsize
    return extra * copies


@pytest.mark.parametrize("arch, shape", [(a, s) for a, s, _ in CELLS])
def test_argument_bytes_are_the_references(runs, arch, shape):
    port, ref, _ = runs
    got = port[(arch, shape, "probe1_exact")]
    assert got["status"] == "ok", got.get("error")
    want = ref[f"{arch}/{shape}"]["memory"]["argument_size_in_bytes"]
    diff = kv_head_bytes(arch, shape)
    assert (diff > 0) == ((arch, shape) in C23_CELLS), diff
    assert got["memory"]["argument_size_in_bytes"] == want + diff


@pytest.mark.parametrize("arch, shape", [(a, s) for a, s, _ in CELLS])
def test_flops_within_their_bounds(runs, arch, shape):
    port, ref, _ = runs
    flops = port[(arch, shape, "probe1_exact")]["cost"]["flops"]
    ratio = flops / ref[f"{arch}/{shape}"]["flops"]
    assert FLOP_LO <= ratio <= 1.0, ratio
    s = get_shape(shape)
    cfg = D.reduced_cfg(get_config(arch), 1)
    n = M.active_param_count(cfg) if cfg.moe else M.param_count(cfg)
    if s.kind == "train":
        model = 6.0 * n * s.global_batch * s.seq_len / 256
    else:
        model = 2.0 * n * s.global_batch / 256
    lo, hi = FALLBACK_FLOP_BANDS.get((arch, shape), MODEL_FLOP_BANDS[shape])
    assert lo <= flops / model <= hi, flops / model


def test_memfit_direct_count_is_the_extrapolation(runs):
    port, _, _ = runs
    memfit = port[("llama3.2-1b", "decode_32k", "memfit")]
    assert memfit["hlo_has_while"] is False
    assert memfit["direct"] == memfit["extrapolated"]
    assert memfit["direct"]["flops"] == memfit["cost"]["flops"] > 0
    assert memfit["n_groups_full"] == 16
    for mode in D.MODES:
        assert port[("llama3.2-1b", "decode_32k", mode)]["status"] == "ok"


def test_decode_collectives_are_the_split_caches(runs):
    """A decode step over the sequence split: the max, sum and output
    all-reduces of each attention layer, the query and K/V gathers over
    model, and the logits gathered whole."""
    port, _, _ = runs
    coll = port[("llama3.2-1b", "decode_32k", "probe1_exact")]["collectives"]
    assert coll["all-reduce"]["count"] >= 3
    assert coll["all-gather"]["count"] >= 2
    assert coll["reduce-scatter"]["count"] == 0


def test_roofline_command_line_reads_the_records(runs, tmp_path):
    _, _, out = runs
    csv = tmp_path / "roofline.csv"
    got = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--out", out,
         "--csv", str(csv)], env=_env(), capture_output=True, text=True,
        timeout=120)
    assert got.returncode == 0, got.stderr
    assert "989 TFLOP/s" in got.stdout and "llama3.2-1b" in got.stdout
    assert csv.exists()


def _memfits():
    """A synthetic memfit record per (arch, shape), as the dry run
    writes them."""
    out = {}
    for arch in all_archs():
        for shape in SHAPES:
            par = D.default_parallel(shape)
            cfg = get_config(arch)
            out[(arch, shape.name)] = {
                "microbatches": par.microbatches, "remat": par.remat,
                "fsdp": par.fsdp_axis,
                "param_dtype": (cfg.param_dtype if shape.kind == "train"
                                else "bfloat16"),
                "n_groups_full": cfg.num_layers // len(cfg.block_pattern)}
    return out


def test_analytic_bytes_are_the_references(jref):
    from repro.launch import roofline as jroof
    for (arch, shape), memfit in _memfits().items():
        assert R.analytic_bytes(arch, shape, memfit) == \
            jroof.analytic_bytes(arch, shape, memfit), (arch, shape)


def _write_cell(out, arch, shape, memfit, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(out, exist_ok=True)
    recs = {"memfit": dict(memfit, status="ok", memory={
        "argument_size_in_bytes": int(rng.integers(1e9, 4e10)),
        "temp_size_in_bytes": int(rng.integers(1e8, 9e10))})}
    for i, mode in enumerate(D.MODES[1:]):
        recs[mode] = {"status": "ok", "n_groups_full":
                      memfit["n_groups_full"],
                      "cost": {"flops": float(rng.uniform(1e9, 1e13)) * (
                          1 + i % 2),
                          "bytes": float(rng.uniform(1e8, 1e11))},
                      "collectives": {k: {"bytes": float(
                          rng.uniform(0, 1e9)), "count": 1}
                          for k in D.COLLECTIVES}}
    for mode, rec in recs.items():
        with open(D.cell_path(out, arch, shape, "single", mode), "w") as f:
            json.dump(rec, f)


def test_analyze_cell_is_the_references_with_the_h100_constants(
        jref, tmp_path):
    from repro.launch import roofline as jroof
    out = str(tmp_path)
    for i, ((arch, shape), memfit) in enumerate(_memfits().items()):
        if D.skip_reason(arch, get_shape(shape)):
            continue
        _write_cell(out, arch, shape, memfit, i)
        got = R.analyze_cell(out, arch, shape)
        want = jroof.analyze_cell(out, arch, shape)
        assert got.status == want.status == "ok"
        for field in ("flops_dev", "bytes_dev", "hlo_bytes_dev",
                      "coll_bytes_dev", "model_flops_dev", "useful_ratio",
                      "mem_gb_dev"):
            assert getattr(got, field) == pytest.approx(
                getattr(want, field), rel=1e-12), field
        assert got.compute_s == pytest.approx(
            want.compute_s * jroof.PEAK_BF16 / R.PEAK_BF16, rel=1e-12)
        assert got.memory_s == pytest.approx(
            want.memory_s * jroof.HBM_BW / R.HBM_BW, rel=1e-12)
        assert got.collective_s == pytest.approx(
            want.collective_s * jroof.ICI_BW / R.LINK_BW, rel=1e-12)
        terms = {"compute": got.compute_s, "memory": got.memory_s,
                 "collective": got.collective_s}
        assert got.bound == max(terms, key=terms.get)
        assert got.fits_hbm == (got.mem_gb_dev * 1e9 <= R.HBM_BYTES)
    rows = R.rows(R.analyze_all(out))
    assert len(rows) == 40
