"""Training over a mesh of ranks (ROADMAP A8.1), gloo on the CPU.

One spawn of two ``gloo`` ranks (``torch_mesh_workers.train_worker``)
runs every case; this process holds their results to the port's
one-device step and to the reference's:

* FSDP over ``data=2`` (smoke llama3.2, float32): each rank holds its
  shards, gathers before the forward, reduce-scatters the gradients; the
  first step's loss and gradients against the port's one-device step and
  the reference's single-device ``make_train_step``, two steps' whole
  parameters against the one-device step's. The ranks' mask counts
  differ (row 0 has a masked tail), so a mean of per-rank means would
  miss: the loss is the whole batch's nll over its whole mask count.
  Float32 bounds (the gradient sum's order): ``LOSS_RTOL`` on the loss,
  ``GRAD_RTOL`` of each leaf's largest gradient, ``PARAM_LR`` learning
  rates on the parameters;
* the same in bf16 with int8 moments (a parameter in its moments' block
  layout), and with two microbatches;
* smoke phi3.5-moe over ``data=2``: the balance loss of the whole
  batch's per-expert means, the loss and gradients (with and without
  remat) against the reference's single-device step (measured: aux
  9.0e-8, gradients 1.5e-6; a mean of the ranks' own balance losses
  misses by 1.1e-2);
* ``pod=2`` with ``grad_compression="int8"``: the compressed gradients
  bitwise a numpy emulation built from the reference's
  ``repro.optim.compression`` over the pods' own gradients;
* checkpoints 2 -> 2, 2 -> 1 and 1 -> 2 ranks through
  ``elastic_restore`` / ``reshard_tree``, bitwise;
* ``train(mesh=)`` with a transient fault and a node loss bitwise its
  uninterrupted run, and near the one-device loop;
* ``python -m repro_torch.launch.train --data 2``;
* a ``model`` axis that does not divide a width the blocks split (3
  query heads over model=2) falls back as the reference's specs do
  (C19): the step builds, warns naming the axis, and each leaf holds its
  spec's shard (the model axis itself trains:
  ``tests/test_torch_train_tp*.py``; the fall-back's steps:
  ``tests/test_torch_serve_fallback.py``).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.config import OptimizerConfig, ParallelConfig
from repro_torch.distributed.elastic import elastic_restore
from repro_torch.optim.adamw import init_opt_state
from repro_torch.train.steps import make_train_step

import torch_mesh_workers as w
from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import model_ref as jref  # noqa: F401
from torch_port_ref import bits

#: float32 over data=2 against one device: the loss (relative), each
#: gradient leaf (of its largest |value|), the parameters after two
#: steps (in learning rates). Measured on this CPU: 8.9e-8, 3.8e-7 and
#: 6.1e-4 lr (1.6e-3 lr with two microbatches)
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
PARAM_LR = 1e-2
#: bf16 compute with int8 moments: the loss, and the parameters in
#: learning rates (a first step's sign flips near eps; as
#: tests/test_torch_train.py's STEP_PARAM_LR). Measured: 6.1e-5 and
#: 1.43 lr
BF16_LOSS_RTOL = 2e-3
BF16_PARAM_LR = 2.5
WORLD = 2


@pytest.fixture(scope="module")
def params_np(jref):
    """The reference's smoke llama3.2 parameters, as numpy."""
    jcfg = jref.configs.get_smoke_config("llama3.2-1b")
    jp = jref.model.init_params(jcfg, jref.jax.random.PRNGKey(1))
    return {k: np.asarray(v) for k, v in jp.items()}


@pytest.fixture(scope="module")
def moe_params_np(jref):
    """The reference's smoke phi3.5-moe parameters, as numpy."""
    jcfg = jref.configs.get_smoke_config(w.MOE_ARCH)
    jp = jref.model.init_params(jcfg, jref.jax.random.PRNGKey(2))
    return {k: np.asarray(v) for k, v in jp.items()}


@pytest.fixture(scope="module")
def ranks(params_np, moe_params_np, tmp_path_factory):
    root = tmp_path_factory.mktemp("train_mesh")
    return w.spawn(w.train_worker, WORLD, root, params_np, moe_params_np,
                   str(root))


def one_device(dtype, state_dtype="float32", microbatches=1, steps=2,
               params_np=None):
    """The port's one-device step on the whole batch: (metrics of each
    step, the params after each step, the first step's gradients)."""
    cfg = w.smoke(dtype)
    ocfg = OptimizerConfig(state_dtype=state_dtype, **w.OPT)
    step = make_train_step(cfg, ocfg, ParallelConfig(
        batch_axes=("data",), microbatches=microbatches), device="cpu")
    params = {k: torch.tensor(v) for k, v in params_np.items()}
    batch = {k: torch.from_numpy(v)
             for k, v in w.train_batch(cfg.vocab_size).items()}
    grads, _ = step.grads(params, batch)
    state = (params, init_opt_state(params, ocfg))
    metrics, whole = [], []
    for _ in range(steps):
        p, o, m = step(state[0], state[1], batch)
        state = (p, o)
        metrics.append({k: float(v) for k, v in m.items()})
        whole.append({k: v.float().numpy() for k, v in p.items()})
    return metrics, whole, {k: g.float().numpy() for k, g in grads.items()}


def rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


def leaf_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def params_of(whole):
    return {k[len("[0]['"):-2]: v for k, v in whole.items()
            if k.startswith("[0]")}


def test_ranks_agree(ranks):
    a, b = ranks
    for name in ("float32", "bf16_int8", "microbatches"):
        assert a[name]["metrics"] == b[name]["metrics"]
        for k in a[name]["whole"][-1]:
            np.testing.assert_array_equal(a[name]["whole"][-1][k],
                                          b[name]["whole"][-1][k])


def test_fsdp_step_matches_one_device(ranks, params_np):
    got = ranks[0]["float32"]
    metrics, whole, grads = one_device("float32", params_np=params_np)
    for g, m in zip(got["metrics"], metrics):
        assert rel(g["loss"], m["loss"]) <= LOSS_RTOL, (g, m)
        assert g["tokens"] == m["tokens"] == w.BATCH * (w.SEQ - 1) \
            - w.SEQ // 2
    for k in grads:
        assert leaf_err(got["grads"][f"['{k}']"], grads[k]) <= GRAD_RTOL, k
    for g, m in zip(got["whole"], whole):
        p = params_of(g)
        for k in m:
            err = float(np.abs(p[k] - m[k]).max())
            assert err <= PARAM_LR * w.OPT["lr"], (k, err)


def reference_step(jref, arch, key, seq=w.SEQ):
    """The reference's single-device step on the whole batch: (its first
    step's metrics, its gradients)."""
    from repro.config import OptimizerConfig as JOptimizerConfig
    from repro.config import ParallelConfig as JParallelConfig
    jnp = jref.jax.numpy
    jcfg = dataclasses.replace(jref.configs.get_smoke_config(arch),
                               dtype="float32")
    jparams = jref.model.init_params(jcfg, jref.jax.random.PRNGKey(key))
    jb = {k: jnp.asarray(v)
          for k, v in w.train_batch(jcfg.vocab_size, s=seq).items()}
    act = dict(jref.sharding._ACT)
    try:
        jstep, _ = jref.train_steps.make_train_step(
            jcfg, JOptimizerConfig(**w.OPT),
            JParallelConfig(batch_axes=("data",)),
            jref.mesh.make_host_mesh(1, 1),
            {k: jref.jax.ShapeDtypeStruct(v.shape, v.dtype)
             for k, v in jb.items()}, donate=False)
        _, _, jm = jstep(jparams, jref.adamw.init_opt_state(
            jparams, JOptimizerConfig(**w.OPT)), jb)
        jgrads = jref.jax.jit(jref.jax.grad(
            lambda p: jref.model.loss_fn(p, jcfg, jb)[0]))(jparams)
    finally:
        jref.sharding.set_activation_mesh(act["mesh"], act["rules"])
    return ({k: float(v) for k, v in jm.items()},
            {k: np.asarray(g) for k, g in jgrads.items()})


def test_fsdp_step_matches_the_reference(ranks, jref):
    jm, jgrads = reference_step(jref, "llama3.2-1b", 1)
    got = ranks[0]["float32"]
    assert rel(got["metrics"][0]["loss"], jm["loss"]) <= LOSS_RTOL
    for k, g in jgrads.items():
        assert leaf_err(got["grads"][f"['{k}']"], g) <= GRAD_RTOL, k


def test_fsdp_moe_balance_loss_is_the_whole_batchs(ranks, jref):
    """Smoke phi3.5-moe over data=2: the balance loss is the product of
    the whole batch's per-expert means, as the reference's single-device
    step computes it, not the mean of the ranks' products (which the
    ranks' own ``aux`` shows is far outside the bound)."""
    jm, jgrads = reference_step(jref, w.MOE_ARCH, 2, seq=w.MOE_SEQ)
    for r in ranks:
        got = r["moe"]
        for m in ("loss", "nll", "aux"):
            assert rel(got["metrics"][0][m], jm[m]) <= LOSS_RTOL, (m, got)
        for k, g in jgrads.items():
            assert leaf_err(got["grads"][f"['{k}']"], g) <= GRAD_RTOL, k
            assert leaf_err(got["remat_grads"][f"['{k}']"], g) \
                <= GRAD_RTOL, k
        assert rel(got["remat_metrics"][0]["aux"], jm["aux"]) <= LOSS_RTOL
    ranks_mean = sum(r["moe"]["own_aux"] for r in ranks) / len(ranks)
    assert rel(ranks_mean, jm["aux"]) > 10 * LOSS_RTOL
    assert "whole dispatch groups of 256" in ranks[0]["moe"]["groups"]


def test_fsdp_bf16_int8_matches_one_device(ranks, params_np):
    got = ranks[0]["bf16_int8"]
    metrics, whole, _ = one_device("bfloat16", "int8", params_np=params_np)
    for g, m in zip(got["metrics"], metrics):
        assert rel(g["loss"], m["loss"]) <= BF16_LOSS_RTOL, (g, m)
    p = params_of(got["whole"][-1])
    for k, v in whole[-1].items():
        assert float(np.abs(p[k] - v).max()) <= BF16_PARAM_LR * w.OPT["lr"]


def test_fsdp_microbatches_match_one_device(ranks, params_np):
    got = ranks[0]["microbatches"]
    metrics, whole, grads = one_device("float32", microbatches=2,
                                       params_np=params_np)
    for g, m in zip(got["metrics"], metrics):
        assert rel(g["loss"], m["loss"]) <= LOSS_RTOL, (g, m)
        assert g["tokens"] == m["tokens"]
    for k in grads:
        assert leaf_err(got["grads"][f"['{k}']"], grads[k]) <= GRAD_RTOL, k


def test_pod_int8_compression_matches_its_emulation(ranks, jref):
    """Each pod's own gradient (data=1 a pod: the one-device gradient of
    its rows' mean loss), compressed as the reference's
    ``_pod_compressed_grads`` does, with ``repro.optim.compression``."""
    comp = jref.compression
    jnp = jref.jax.numpy
    own = [r["pod"]["own_grads"] for r in ranks]
    for k in own[0]:
        gs = [jnp.asarray(o[k], jnp.float32) for o in own]
        scale = jnp.maximum(*[comp.block_absmax(g, 256) for g in gs]) / 127.0
        qsum = sum(np.asarray(comp.quantize_int8_with_scale(g, scale, 256),
                              np.int32) for g in gs)
        deq = (qsum.astype(np.float32) * np.asarray(scale)[:, None]
               ).reshape(-1)[: gs[0].size].reshape(gs[0].shape)
        want = deq / np.float32(len(gs))
        for r in ranks:
            np.testing.assert_array_equal(bits(r["pod"]["grads"][k]),
                                          bits(want), err_msg=k)
    for m in ("loss", "nll", "tokens"):
        mean = np.float32(sum(np.float32(r["pod"]["own_metrics"][m])
                              for r in ranks)) / np.float32(len(ranks))
        assert ranks[0]["pod"]["metrics"][0][m] == pytest.approx(
            float(mean), rel=1e-7)


def test_checkpoints_move_between_mesh_sizes(ranks):
    ck = ranks[0]["ckpt"]
    assert ck["step"] == w.TRAIN_STEPS
    assert ck["two_to_two_bitwise"] and ck["one_to_two_bitwise"]
    assert ck["one_to_two_gathers_back"]
    assert all(r["ckpt"]["one_to_two_bitwise"] for r in ranks)
    # 2 -> 1: the two ranks' checkpoint onto one device
    cfg = w.smoke("bfloat16")
    ocfg = OptimizerConfig(state_dtype="int8", **w.OPT)
    p, o, step, extra = elastic_restore(
        ck["two_dir"], cfg, ocfg, ParallelConfig(batch_axes=("data",)),
        device="cpu")
    assert step == w.TRAIN_STEPS and extra == {"ranks": WORLD}
    one = w.np_tree((p, o))
    assert sorted(one) == sorted(ck["two_whole"])
    for k, v in one.items():
        np.testing.assert_array_equal(v, ck["two_whole"][k], err_msg=k)


def test_loop_restarts_alike_on_every_rank(ranks):
    for r in ranks:
        lp = r["loop"]
        assert lp["faults"]["fired"] == ["transient@2", "node_loss@5"]
        assert lp["faults"]["restarts"] == 1 and lp["clean"]["restarts"] == 0
        a, b = np.array(lp["faults"]["losses"]), np.array(
            lp["clean"]["losses"])
        np.testing.assert_array_equal(bits(a.astype(np.float32)),
                                      bits(b.astype(np.float32)))
    assert ranks[0]["loop"]["clean"]["losses"] == \
        ranks[1]["loop"]["clean"]["losses"]


def test_loop_matches_one_device(ranks, tmp_path):
    from repro_torch.train.loop import train
    cfg, tcfg, ocfg, par = w.loop_config(str(tmp_path), "one")
    res = train(cfg, tcfg, ocfg, par, device="cpu", verbose=False)
    got = ranks[0]["loop"]["clean"]["losses"]
    assert len(got) == len(res.losses) == w.LOOP_STEPS
    for g, m in zip(got, res.losses):
        assert rel(g, m) <= LOSS_RTOL, (got, res.losses)


def test_launcher_trains_over_data_2(ranks, tmp_path):
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    from repro_torch.distributed.elastic import state_like
    from repro_torch.launch import train as launch_train
    assert ranks[0]["launch_rc"] == 0 and ranks[1]["launch_rc"] == 0
    one = str(tmp_path / "launch_one")
    assert launch_train.main(
        ["--smoke", "--device", "cpu", "--steps", "3", "--seq-len", "32",
         "--batch", "4", "--ckpt-dir", one, "--ckpt-every", "3"]) == 0
    args = launch_train.parse_args(["--smoke", "--steps", "3"])
    cfg, _, ocfg, _ = launch_train.configs(args)
    (p2, _), s2, _ = restore_checkpoint(ranks[0]["launch_dir"], None,
                                        state_like(cfg, ocfg, "cpu"))
    (p1, _), s1, _ = restore_checkpoint(one, None,
                                        state_like(cfg, ocfg, "cpu"))
    assert s1 == s2 == 3
    for k in p1:
        err = float((p2[k] - p1[k]).abs().max())
        assert err <= BF16_PARAM_LR * ocfg.lr, (k, err)


def test_model_axis_that_does_not_divide_raises_c19(ranks):
    """No raise now (C19): 3 query heads of 16 over model=2 keep the
    reference's column shards (1.5 heads a rank), half of the one KV head
    a rank, the MLP split as before, and the warning names the axis."""
    for r in ranks:
        rec = r["model_axis"]
        warned = [m for m in rec["warnings"] if "'heads_act'" in m]
        assert warned and "dim 3" in warned[0], rec["warnings"]
        assert "mesh axis 'model' (size 2)" in warned[0]
        shapes = rec["shapes"]
        assert shapes["stack.blk0.attn.wq"] == (2, 64, 24)
        assert shapes["stack.blk0.attn.wk"] == (2, 64, 8)
        assert shapes["stack.blk0.attn.wo"] == (2, 24, 64)
        assert shapes["stack.blk0.mlp.w_down"] == (2, 64, 64)
    assert os.path.isdir(ranks[0]["launch_dir"])
