"""The multi-GPU layer's pure functions against the reference's
(``repro.distributed.sharding``, ``models.model.partition_specs``,
``optim.adamw.opt_state_specs``, ``train.steps.train_shardings``), with
no ranks: a mesh here is its ``{axis: size}`` shape, and the
reference's a device-free stand-in with ``axis_names`` and a
``devices`` array of that shape (its functions read no more).

A port spec is a tuple equal to ``tuple(spec)`` of the reference's
``PartitionSpec`` (one axis by its name, several as a tuple). Also
``resolve_mesh_axis``'s validation and its warn-once, and
``batch_rows`` against the reference's microbatch-then-shard layout.
"""
import dataclasses
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch import obs
from repro_torch.config import OptimizerConfig, ParallelConfig
from repro_torch.configs import all_archs, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.models import model as M
from repro_torch.optim.adamw import opt_state_specs
from repro_torch.train.steps import train_shardings

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import reference

MESHES = {"data2": {"data": 2, "model": 1},
          "data4_model2": {"data": 4, "model": 2},
          "prod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16},
          "pod2_data2": {"pod": 2, "data": 2, "model": 1}}
PARALLEL = {"default": {},
            "data_batch": {"batch_axes": ("data",)},
            "no_fsdp": {"fsdp_axis": None},
            "no_tp": {"tp_axis": None},
            "expert_model": {"expert_axis": "model"},
            "seq_tuple": {"seq_axis": ("pod", "data"),
                          "shard_cache_seq": True}}


@pytest.fixture(scope="module")
def jref():
    with reference() as r:
        yield r


def jmesh(shape):
    return SimpleNamespace(axis_names=tuple(shape),
                           devices=np.empty(tuple(shape.values())))


def jparallel(jref, kw):
    from repro.config import ParallelConfig as JParallelConfig
    return JParallelConfig(**kw)


def spec_tree(tree):
    return {k: tuple(v) for k, v in tree.items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("par", sorted(PARALLEL))
def test_rules_and_batch_specs_match_the_reference(jref, mesh, par):
    shape = MESHES[mesh]
    p, jp = ParallelConfig(**PARALLEL[par]), jparallel(jref, PARALLEL[par])
    assert sh.build_rules(p, shape) == jref.sharding.build_rules(
        jp, jmesh(shape))
    assert sh.mesh_shape_dict(shape) == jref.sharding.mesh_shape_dict(
        jmesh(shape))
    assert sh.batch_partition(p, shape) == jref.sharding.batch_partition(
        jp, jmesh(shape))
    # a divisible batch, an indivisible one, M-RoPE positions, a scalar
    batch = {"tokens": np.zeros((64, 8)), "loss_mask": np.zeros((64, 8)),
             "odd": np.zeros((3, 5)), "positions": np.zeros((3, 64, 8)),
             "scale": np.zeros(())}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = sh.input_batch_specs(batch, p, shape)
        want = jref.sharding.input_batch_specs(batch, jp, jmesh(shape))
    assert got == spec_tree(want)


@pytest.mark.parametrize("mesh", ["data2", "data4_model2", "prod",
                                  "multipod"])
@pytest.mark.parametrize("arch", all_archs())
def test_partition_specs_match_the_reference(jref, arch, mesh):
    shape = MESHES[mesh]
    cfg, jcfg = get_config(arch), jref.configs.get_config(arch)
    rules = sh.build_rules(ParallelConfig(), shape)
    got = M.partition_specs(cfg, rules, shape)
    want = jref.model.partition_specs(jcfg, jref.sharding.build_rules(
        jparallel(jref, {}), jmesh(shape)), shape)
    assert got == spec_tree(want)
    abstract = M.abstract_params(cfg)
    assert {k: tuple(v.shape) for k, v in abstract.items()} == {
        k: tuple(v.shape) for k, v in
        jref.model.abstract_params(jcfg).items()}
    assert all(v.device.type == "meta" for v in abstract.values())


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mesh", ["data2", "prod", "multipod"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "phi3.5-moe-42b-a6.6b",
                                  "rwkv6-7b"])
def test_opt_state_specs_match_the_reference(jref, arch, mesh, state_dtype):
    from repro.config import OptimizerConfig as JOptimizerConfig
    shape = MESHES[mesh]
    cfg, jcfg = get_config(arch), jref.configs.get_config(arch)
    ocfg = OptimizerConfig(state_dtype=state_dtype)
    jocfg = JOptimizerConfig(state_dtype=state_dtype)
    pspecs = M.partition_specs(cfg, sh.build_rules(ParallelConfig(), shape),
                               shape)
    jpspecs = jref.model.partition_specs(jcfg, jref.sharding.build_rules(
        jparallel(jref, {}), jmesh(shape)), shape)
    got = opt_state_specs(pspecs, ocfg, M.abstract_params(cfg), "data",
                          shape)
    want = jref.adamw.opt_state_specs(jpspecs, jocfg,
                                      jref.model.abstract_params(jcfg),
                                      "data", shape)
    assert got.step == tuple(want.step)
    for field in ("m", "v", "m_scale", "v_scale"):
        assert getattr(got, field) == spec_tree(getattr(want, field)), field


def test_train_shardings_match_the_reference(jref):
    from repro.config import OptimizerConfig as JOptimizerConfig
    shape = MESHES["pod2_data2"]
    cfg = get_config("llama3.2-1b")
    jcfg = jref.configs.get_config("llama3.2-1b")
    batch = {"tokens": np.zeros((8, 16)), "loss_mask": np.zeros((8, 16))}
    kw = {"grad_compression": "int8"}
    got = train_shardings(cfg, OptimizerConfig(state_dtype="int8"),
                          ParallelConfig(**kw), shape, batch)
    want_p = jref.model.partition_specs(jcfg, jref.sharding.build_rules(
        jparallel(jref, kw), jmesh(shape)), shape)
    want_o = jref.adamw.opt_state_specs(
        want_p, JOptimizerConfig(state_dtype="int8"),
        jref.model.abstract_params(jcfg), "data", shape)
    want_b = jref.sharding.input_batch_specs(batch, jparallel(jref, kw),
                                             jmesh(shape))
    assert got[0] == spec_tree(want_p)
    assert got[1].m == spec_tree(want_o.m)
    assert got[2] == spec_tree(want_b) == {
        "tokens": (("pod", "data"), None),
        "loss_mask": (("pod", "data"), None)}


@pytest.mark.parametrize("batch, size, k", [(8, 2, 1), (8, 2, 2), (12, 3, 2),
                                            (16, 4, 4), (6, 1, 3)])
def test_batch_rows_follow_the_reference_layout(batch, size, k):
    """The reference splits the global batch into k microbatches
    ([k, b / k, ...]) and shards each over the data axes."""
    layout = np.arange(batch).reshape(k, size, batch // (k * size))
    for index in range(size):
        np.testing.assert_array_equal(sh.batch_rows(batch, index, size, k),
                                      layout[:, index].reshape(-1))
    with pytest.raises(ValueError, match="does not split"):
        sh.batch_rows(batch + 1, 0, size, k)


def test_resolve_mesh_axis_validates_and_warns_once():
    assert sh.resolve_mesh_axis(None, 8, "t") is None
    assert sh.resolve_mesh_axis(1, 8, "t") is None
    with pytest.raises(ValueError, match="positive"):
        sh.resolve_mesh_axis(0, 8, "t")
    with pytest.raises(ValueError, match="positive"):
        sh.resolve_mesh_axis(-2, 8, "t")
    with pytest.raises(ValueError, match="t: devices=2 but no torch."
                                         "distributed process group.*"
                                         "torchrun --nproc-per-node=2"):
        sh.resolve_mesh_axis(2, 8, "t")
    sh._REPLICATION_WARNED.clear()
    with obs.capture() as rec:
        with pytest.warns(RuntimeWarning, match="replication"):
            sh._warn_replicated("test(x)", "restart", 5, 2)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sh._warn_replicated("test(x)", "restart", 5, 2)
        assert not caught                  # the same fall-back: silent
        with pytest.warns(RuntimeWarning, match="mesh axis 'restart'"):
            sh._warn_replicated("test(x)", "restart", 7, 2)
    assert rec.counter_total("warn.replication_fallback") == 3.0


def test_indivisible_batch_specs_warn_and_replicate():
    sh._REPLICATION_WARNED.clear()
    with pytest.warns(RuntimeWarning, match="NO parallelism"):
        got = sh.input_batch_specs({"tokens": np.zeros((6, 4))},
                                   ParallelConfig(), {"data": 4, "model": 1})
    assert got == {"tokens": ()}


def test_mesh_of_no_kind_is_refused():
    with pytest.raises(TypeError, match="DeviceMesh"):
        sh.mesh_shape_dict(object())
    cfg = dataclasses.replace(get_config("llama3.2-1b"))
    assert M.partition_specs(cfg, sh.build_rules(ParallelConfig(), {
        "data": 1, "model": 1}), {"data": 1, "model": 1})[
        "embed.table"] == (None, None)
