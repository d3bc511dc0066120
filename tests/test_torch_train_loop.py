"""The port's training pipeline on the CPU (ROADMAP A9): the loader, the
checkpoints, fault tolerance, the loop and its launcher.

* ``data.loader.TokenBatchLoader``: its batches bitwise the reference's
  loader's, and a resumed stream (``state_dict`` / ``load_state_dict``)
  the uninterrupted one; ``close`` ends its thread;
* ``checkpoint.ckpt``: round trip (bf16 restored by the manifest's
  dtype), atomic publish, ``AsyncCheckpointer``'s ``keep`` collection,
  and a checkpoint of (parameters, optimizer state) written by either
  package restored by the other, bit for bit, in bf16 and int8 moments;
* ``distributed.fault``: ``retry_step`` and ``StragglerWatchdog``, and
  ``distributed.elastic.elastic_restore`` onto one device;
* ``train.loop.train``: the reference's ``tests/test_checkpoint_and_ft.py``
  cases (a transient fault and a node loss survived, a resumed run
  continuing from its checkpoint) and, beyond them, the losses after a
  restart or a resume bitwise an uninterrupted run's (the same
  operations on the same restored state, one torch thread);
* ``launch.train`` on the CPU.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                                         restore_checkpoint, save_checkpoint)
from repro_torch.config import OptimizerConfig, ParallelConfig, TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import model_params_from_arrays
from repro_torch.core.spans import Span, SpanCollector
from repro_torch.data.loader import TokenBatchLoader
from repro_torch.distributed.elastic import elastic_restore, state_like
from repro_torch.distributed.fault import (FaultInjector, StragglerWatchdog,
                                           TransientFault, retry_step)
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.optim.adamw import adamw_update, init_opt_state
from repro_torch.train.loop import train

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import model_ref as jref  # noqa: F401
from torch_port_ref import bits

ARCH = "llama3.2-1b"
PAR = ParallelConfig(batch_axes=("data",))


def host(x) -> np.ndarray:
    """A tensor or array as numpy, bf16 widened to float32 (exact)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if str(x.dtype) == "bfloat16" else x


def same(got, want, what=""):
    got, want = host(got), host(want)
    assert got.shape == want.shape, what
    if got.dtype.itemsize in (4, 8):
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

def test_loader_is_the_reference_and_resumes_exactly(jref):
    kw = dict(vocab_size=300, seq_len=16, batch=3, seed=7)
    mine = TokenBatchLoader(**kw)
    theirs = jref.loader.TokenBatchLoader(**kw)
    try:
        got = [mine.next() for _ in range(5)]
        for b in got:
            want = theirs.next()
            assert set(b) == set(want) == {"tokens", "loss_mask"}
            for k in b:
                assert b[k].dtype == want[k].dtype
                same(b[k], want[k], k)
        state = mine.state_dict()
        assert state == {"step": 5, "seed": 7}
        ahead = [mine.next() for _ in range(3)]
        mine.load_state_dict({"step": 2, "seed": 7})   # rewind mid-flight
        for b in got[2:] + ahead:
            same(mine.next()["tokens"], b["tokens"])
    finally:
        mine.close()
        theirs.close()
    assert not mine._thread.is_alive()
    again = TokenBatchLoader(**kw)
    again.load_state_dict(state)
    try:
        same(again.next()["tokens"], ahead[0]["tokens"])
    finally:
        again.close()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}


def test_checkpoint_roundtrip(tmp_ckpt_dir):
    t = _tree()
    save_checkpoint(tmp_ckpt_dir, 3, t, extra={"k": 1})
    assert latest_step(tmp_ckpt_dir) == 3
    like = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(
        4, dtype=torch.bfloat16)}}
    got, step, extra = restore_checkpoint(tmp_ckpt_dir, None, like)
    assert step == 3 and extra == {"k": 1}
    assert torch.equal(got["a"], t["a"])
    assert got["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["c"], t["b"]["c"])
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_ckpt_dir, 3, {"a": torch.zeros(3, 2),
                                             "b": like["b"]})


def test_checkpoint_atomic_no_tmp_visible(tmp_ckpt_dir):
    save_checkpoint(tmp_ckpt_dir, 1, _tree())
    os.makedirs(os.path.join(tmp_ckpt_dir, "step_00000002.tmp"))
    assert latest_step(tmp_ckpt_dir) == 1          # a crashed write
    save_checkpoint(tmp_ckpt_dir, 2, _tree())
    names = os.listdir(tmp_ckpt_dir)
    assert all(not n.endswith(".tmp") for n in names)
    assert latest_step(tmp_ckpt_dir) == 2


def test_async_checkpointer_gc(tmp_ckpt_dir):
    ck = AsyncCheckpointer(tmp_ckpt_dir, keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        ck.save(s, t)
    t["a"].add_(100.0)          # the snapshot was taken at save()
    ck.close()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_ckpt_dir))
    assert steps == [3, 4]
    assert not ck.errors
    assert not ck._worker.is_alive()
    got, _, _ = restore_checkpoint(tmp_ckpt_dir, 4, _tree())
    assert torch.equal(got["a"], _tree()["a"])


def test_restore_missing_raises(tmp_ckpt_dir):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_ckpt_dir, None, _tree())


def _state(jref, state_dtype):
    """Two AdamW steps of smoke llama3.2 in both packages, from the
    reference's parameters: ((params, opt_state), (jparams, jopt))."""
    from repro.config import OptimizerConfig as JOptimizerConfig
    jnp = jref.jax.numpy
    kw = dict(state_dtype=state_dtype, state_block=64, warmup_steps=1)
    ocfg, jocfg = OptimizerConfig(**kw), JOptimizerConfig(**kw)
    cfg = get_smoke_config(ARCH)
    jparams = jref.model.init_params(jref.configs.get_smoke_config(ARCH),
                                     jref.jax.random.PRNGKey(0))
    params = model_params_from_arrays(
        {k: np.asarray(v) for k, v in jparams.items()}, cfg, device="cpu")
    rng = np.random.default_rng(0)
    opt, jopt = init_opt_state(params, ocfg), jref.adamw.init_opt_state(
        jparams, jocfg)
    for _ in range(2):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
        params, opt = adamw_update(params, {k: torch.from_numpy(v)
                                            for k, v in g.items()}, opt,
                                   ocfg)
        jparams, jopt = jref.adamw.adamw_update(
            jparams, {k: jnp.asarray(v) for k, v in g.items()}, jopt, jocfg)
    return cfg, ocfg, (params, opt), (jparams, jopt)


def _assert_state_equal(got, want):
    (gp, go), (wp, wo) = got, want
    assert set(gp) == set(wp)
    for k in wp:
        same(gp[k], wp[k], k)
    same(go.step, wo.step, "step")
    for field in ("m", "v", "m_scale", "v_scale"):
        g, w = getattr(go, field), getattr(wo, field)
        assert set(g) == set(w), field
        for k in w:
            same(g[k], w[k], f"{field} {k}")


@pytest.mark.parametrize("state_dtype", ["bfloat16", "int8"])
def test_checkpoints_cross_between_packages(jref, tmp_path, state_dtype):
    cfg, ocfg, state, jstate = _state(jref, state_dtype)
    # the reference's checkpoint, restored by the port
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jref.ckpt.save_checkpoint(jdir, 2, jstate, extra={"loader": {
        "step": 2, "seed": 0}})
    got, step, extra = restore_checkpoint(jdir, None,
                                          state_like(cfg, ocfg, "cpu"))
    assert step == 2 and extra["loader"]["step"] == 2
    _assert_state_equal(got, jstate)
    # the port's, restored by the reference, over the port's own state
    save_checkpoint(pdir, 2, state)
    back, step, _ = jref.ckpt.restore_checkpoint(pdir, None, jstate)
    assert step == 2
    _assert_state_equal(state, back)
    # and restored by the port itself through elastic_restore
    p2, o2, step, _ = elastic_restore(pdir, cfg, ocfg, PAR, device="cpu")
    _assert_state_equal((p2, o2), (state[0], state[1]))


def test_elastic_restore_onto_more_devices_raises(tmp_ckpt_dir):
    cfg = get_smoke_config(ARCH)
    # onto a mesh it needs torch.distributed ranks
    # (tests/test_torch_train_mesh.py); without a group it raises
    with pytest.raises(ValueError, match="torchrun"):
        elastic_restore(tmp_ckpt_dir, cfg, OptimizerConfig(), PAR,
                        devices=2, device="cpu")
    with pytest.raises(FileNotFoundError):
        elastic_restore(tmp_ckpt_dir, cfg, OptimizerConfig(), PAR,
                        device="cpu")


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_retry_step_recovers_transient():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TransientFault("flaky")
        return "ok"

    assert retry_step(flaky, retries=5, backoff_s=0.001) == "ok"
    assert calls["n"] == 3


def test_retry_step_exhausts():
    def always():
        raise TransientFault("nope")

    with pytest.raises(TransientFault):
        retry_step(always, retries=2, backoff_s=0.001)


def test_straggler_watchdog():
    col = SpanCollector()
    t = 0.0
    for _ in range(12):
        col.add(Span("stage", t, 0.01))
        t += 0.02
    col.add(Span("stage", t, 0.5))        # 50x the median
    flagged = StragglerWatchdog(col, factor=3.0).stragglers()
    assert "stage" in flagged
    assert flagged["stage"]["ratio"] > 10


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def _train(ckpt_dir, steps, every, injector=None, async_checkpoint=True):
    cfg = get_smoke_config(ARCH)
    tcfg = TrainConfig(steps=steps, seq_len=32, global_batch=4,
                       checkpoint_every=every, checkpoint_dir=ckpt_dir,
                       log_every=100, async_checkpoint=async_checkpoint)
    ocfg = OptimizerConfig(total_steps=10, warmup_steps=2)
    return train(cfg, tcfg, ocfg, PAR, device="cpu", injector=injector,
                 verbose=False)


def test_train_loop_survives_faults(tmp_path):
    inj = FaultInjector(transient_at=(2,), node_loss_at=(6,))
    res = _train(str(tmp_path / "a"), 10, 3, injector=inj)
    assert res.steps_done == 10
    assert res.restarts == 1
    assert "transient@2" in inj.fired and "node_loss@6" in inj.fired
    assert res.final_loss < res.losses[0]          # still learning
    assert latest_step(str(tmp_path / "a")) == 10
    # the restart resumed from step 3's checkpoint (state, optimizer and
    # data position): every loss after it is the uninterrupted run's
    clean = _train(str(tmp_path / "b"), 10, 3)
    assert res.losses[:5] == clean.losses[:5]
    assert res.losses[5:] == clean.losses[3:]
    assert set(res.collector.stage_names()) >= {
        "datagen", "datagen+next", "h2d", "train_step", "checkpoint"}


def test_train_loop_resume_from_checkpoint(tmp_path):
    d = str(tmp_path / "ckpt")
    r1 = _train(d, 4, 2, async_checkpoint=False)
    r2 = _train(d, 8, 2, async_checkpoint=False)
    # resumed run continues from step 4, not from scratch
    assert r2.steps_done == 8
    assert len(r2.losses) == 4
    whole = _train(str(tmp_path / "whole"), 8, 2)
    assert r1.losses + r2.losses == whole.losses


def test_launch_train_on_cpu(tmp_path, capsys):
    assert launch_train.main([
        "--smoke", "--device", "cpu", "--steps", "3", "--seq-len", "16",
        "--batch", "2", "--ckpt-dir", str(tmp_path / "c"), "--ckpt-every",
        "2", "--remat", "full"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("done: 3 steps, loss ")
    assert "restarts=0" in out and "train_step" in out
    assert latest_step(str(tmp_path / "c")) == 3
    args = launch_train.parse_args(["--smoke", "--microbatches", "2"])
    cfg, tcfg, ocfg, par = launch_train.configs(args)
    assert cfg.name == get_smoke_config(ARCH).name
    assert par.microbatches == 2 and ocfg.warmup_steps == 10
    assert tcfg.checkpoint_dir == "checkpoints/train"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if not torch.cuda.is_available():
            launch_train.main(["--smoke", "--steps", "1",
                               "--ckpt-dir", str(tmp_path / "d")])
        else:
            raise RuntimeError("no CUDA device (a card is present)")


def test_fresh_state_is_drawn_from_the_seed():
    cfg = get_smoke_config(ARCH)
    a = M.init_params(cfg, seed=0, device="cpu")
    like, opt = state_like(cfg, OptimizerConfig(state_dtype="int8"), "cpu")
    assert set(like) == set(a)
    assert all(like[k].shape == a[k].shape and like[k].dtype == a[k].dtype
               for k in a)
    assert opt.m_scale and int(opt.step) == 0
