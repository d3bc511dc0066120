"""The port's training math on the CPU against the reference (ROADMAP A9).

* ``optim.compression``: the block int8 quantizer, its scales, absmax and
  shared-scale form, bit for bit (both round half to even);
* ``optim.adamw`` in its three moment types over six steps against the
  reference's jitted ``adamw_update`` (the form its train step runs):
  parameters and int8 scales within 1e-6 of the leaf's largest |value|,
  float32 moments 1e-6, bf16 moments one bf16 step (2^-8), int8 moments
  one quantization step. Not bitwise: the global norm's sums reduce in
  another order, and under jit XLA contracts ``p - lr * upd`` into an FMA
  (measured: parameters <= 7.3e-8, float32 moments <= 2.1e-7, scales
  <= 1.1e-7, bf16 and int8 moments equal);
* ``models.model.loss_fn`` for smoke llama3.2 (GQA attention) and smoke
  rwkv6 (no attention: the WKV scan) against the reference's, in float32
  and bf16, with parameters that require grad (the training route of
  ``kernels/ops.py``: ``ref.sdpa`` / ``ref.rwkv6_scan``; the reference's
  training runs the same, Pallas off). Bounds, relative: float32 1e-5
  (C9's float32 agreement; measured <= 2.4e-7), bf16 C9's 0.15 (measured
  <= 7.6e-5);
* one ``train.steps.make_train_step`` step against the reference's
  jitted step on its 1 x 1 host mesh, smoke llama3.2: the loss, every
  gradient (the reference's through ``jax.grad`` of its ``loss_fn``, with
  ``loss_of``'s cast) and the new parameters. Float32: loss 1e-6
  relative, gradients 1e-5 of the leaf's largest |value| (measured
  1.6e-6, the embedding's); bf16 compute (float32 master weights cast as
  the reference's ``loss_of`` casts them): loss 2e-3, gradients 0.1 of
  the leaf's largest |value| (C9: activations round at other places;
  measured 1.5e-2). The new parameters are held in units of the learning
  rate: AdamW's first step moves a parameter by lr * g / (|g| + eps), a
  sign for any gradient well above eps, so a gradient within rounding of
  eps moves by a different fraction of lr, and one within rounding of 0
  (bf16) may move the other way. Float32 0.01 lr (measured 3.6e-3 lr),
  bf16 2.5 lr (measured 2.0 lr);
* microbatches: 2 against 1 within 1e-5 of the leaf's largest gradient
  (the mean of two half means is not the same sum), metrics averaged; the
  split of ``[3, b, s]`` positions;
* remat ``full`` and ``dots`` against ``none``: loss and gradients bit
  for bit (the same operations recomputed on the CPU);
* the wrappers' autograd guard and ``ops``' training route;
* ``convert.opt_state_from_arrays`` carrying the reference's int8 state.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.config import OptimizerConfig, ParallelConfig
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops, ref, rwkv6_kernel, ssm_scan
from repro_torch.models import model as M
from repro_torch.optim import compression as pc
from repro_torch.optim.adamw import adamw_update, init_opt_state
from repro_torch.train.steps import _microbatch, make_train_step

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import model_ref as jref  # noqa: F401
from torch_port_ref import bits, f32

LOSS_TOL = {"float32": 1e-5, "bfloat16": 0.15}
STEP_LOSS_TOL = {"float32": 1e-6, "bfloat16": 2e-3}
STEP_GRAD_TOL = {"float32": 1e-5, "bfloat16": 0.1}
#: the new parameters' bound, in units of the step's learning rate
STEP_PARAM_LR = {"float32": 1e-2, "bfloat16": 2.5}
MICRO_TOL = 1e-5
ADAM_TOL = 1e-6
MOMENT_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}
BATCH, SEQ = 4, 32


def same_bits(got, want, what=""):
    got, want = np.ascontiguousarray(got), np.ascontiguousarray(want)
    assert got.dtype.itemsize == want.dtype.itemsize, what
    if got.dtype.itemsize in (4, 8):
        got, want = bits(got), bits(want)
    else:
        raw = {1: np.uint8, 2: np.uint16}[got.dtype.itemsize]
        got, want = got.view(raw), want.view(raw)
    np.testing.assert_array_equal(got, want, err_msg=what)


def np_of(x):
    """A torch tensor or jax array as numpy (bf16 widened to float32)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if str(a.dtype) == "bfloat16" else a


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape, block", [((1000,), 256), ((7, 33), 32),
                                          ((64,), 64), ((5, 3, 2), 4)])
def test_compression_is_bitwise_the_reference(jref, shape, block):
    jnp = jref.jax.numpy
    rng = np.random.default_rng(sum(shape) + block)
    x = rng.normal(size=shape).astype(np.float32) * 3.0
    flat = x.reshape(-1)
    flat[:block] = 0.0                          # a block of zeros
    # exact ties: multiples of half a step of the second block's scale
    n2 = min(block, flat.size - block)
    if n2 > 0:
        flat[block:block + n2] = (np.arange(n2) - n2 // 2) * 0.5
        flat[block] = 127.0
    q, sc = pc.quantize_int8(torch.from_numpy(x), block)
    jq, jsc = jref.compression.quantize_int8(jnp.asarray(x), block)
    same_bits(q.numpy(), np.asarray(jq), "q")
    same_bits(sc.numpy(), np.asarray(jsc), "scale")
    same_bits(pc.dequantize_int8(q, sc, shape).numpy(),
              np.asarray(jref.compression.dequantize_int8(jq, jsc, shape)),
              "dequantized")
    same_bits(pc.block_absmax(torch.from_numpy(x), block).numpy(),
              np.asarray(jref.compression.block_absmax(jnp.asarray(x),
                                                       block)), "absmax")
    shared = sc * 1.5
    same_bits(pc.quantize_int8_with_scale(torch.from_numpy(x), shared,
                                          block).numpy(),
              np.asarray(jref.compression.quantize_int8_with_scale(
                  jnp.asarray(x), jnp.asarray(shared.numpy()), block)),
              "shared scale")


# ---------------------------------------------------------------------------
# AdamW, three moment types
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_states_match_the_reference(jref, state_dtype):
    from repro.config import OptimizerConfig as JOptimizerConfig
    jnp = jref.jax.numpy
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              grad_clip=1.0, state_dtype=state_dtype, state_block=32)
    ocfg, jocfg = OptimizerConfig(**kw), JOptimizerConfig(**kw)
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b": (100,), "c": (2, 3, 4)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in
          shapes.items()}
    p = {k: torch.from_numpy(v) for k, v in p0.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st, jst = init_opt_state(p, ocfg), jref.adamw.init_opt_state(jp, jocfg)
    update = jref.jax.jit(lambda a, b, c: jref.adamw.adamw_update(
        a, b, c, jocfg))
    for _ in range(6):
        g0 = {k: (rng.normal(size=s) * rng.uniform(0.1, 3.0))
              .astype(np.float32) for k, s in shapes.items()}
        p, st = adamw_update(p, {k: torch.from_numpy(v)
                                 for k, v in g0.items()}, st, ocfg)
        jp, jst = update(jp, {k: jnp.asarray(v) for k, v in g0.items()},
                         jst)
        for k in shapes:
            leaf_close(p[k], jp[k], ADAM_TOL, f"param {k}")
            for got, want in ((st.m, jst.m), (st.v, jst.v)):
                if state_dtype == "int8":       # one quantization step
                    assert np.abs(np_of(got[k]).astype(np.int32)
                                  - np_of(want[k]).astype(np.int32)
                                  ).max() <= 1, k
                else:
                    leaf_close(got[k], want[k], MOMENT_TOL[state_dtype],
                               f"moment {k}")
                assert got[k].dtype == getattr(torch, str(want[k].dtype))
            for got, want in ((st.m_scale, jst.m_scale),
                              (st.v_scale, jst.v_scale)):
                assert set(got) == set(want)
                if k in want:
                    leaf_close(got[k], want[k], ADAM_TOL, f"scale {k}")
    assert int(st.step) == int(jst.step) == 6


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def configs(jref, arch, dtype):
    return (dataclasses.replace(get_smoke_config(arch), dtype=dtype),
            dataclasses.replace(jref.configs.get_smoke_config(arch),
                                dtype=dtype))


def batch_of(cfg, seed=0, b=BATCH, s=SEQ):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[0, s // 2:] = 0.0                      # a masked tail
    return {"tokens": tokens, "loss_mask": mask}


def port_params(jref, cfg, jcfg, seed=0):
    jparams = jref.model.init_params(jcfg, jref.jax.random.PRNGKey(seed))
    return jparams, convert.model_params_from_arrays(
        {k: np.asarray(v) for k, v in jparams.items()}, cfg, device="cpu")


def rel(got, want) -> float:
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_matches_the_reference(jref, arch, dtype):
    jnp = jref.jax.numpy
    cfg, jcfg = configs(jref, arch, dtype)
    jparams, params = port_params(jref, cfg, jcfg)
    b = batch_of(cfg)
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        loss, metrics = M.loss_fn(leaves, cfg, {k: torch.from_numpy(v)
                                                for k, v in b.items()})
    loss = loss.detach()
    jloss, jmetrics = jref.jax.jit(lambda p, bb: jref.model.loss_fn(
        p, jcfg, bb))(jparams, {k: jnp.asarray(v) for k, v in b.items()})
    assert rel(loss, jloss) <= LOSS_TOL[dtype]
    for k in ("nll", "aux", "tokens"):
        assert abs(float(metrics[k]) - float(jmetrics[k])) <= \
            LOSS_TOL[dtype] * max(1.0, abs(float(jmetrics[k]))), k
    assert float(metrics["tokens"]) == BATCH * (SEQ - 1) - SEQ // 2


# ---------------------------------------------------------------------------
# one train step against the reference's
# ---------------------------------------------------------------------------

def leaf_close(got, want, tol, what):
    got, want = np_of(got).astype(np.float64), np_of(want).astype(
        np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (what, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_the_reference(jref, dtype):
    from repro.config import OptimizerConfig as JOptimizerConfig
    from repro.config import ParallelConfig as JParallelConfig
    jnp = jref.jax.numpy
    cfg, jcfg = configs(jref, "llama3.2-1b", dtype)
    jparams, params = port_params(jref, cfg, jcfg, seed=1)
    b = batch_of(cfg, seed=1)
    okw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    ocfg, jocfg = OptimizerConfig(**okw), JOptimizerConfig(**okw)
    step = make_train_step(cfg, ocfg, ParallelConfig(batch_axes=("data",)),
                           device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    grads, metrics = step.grads(params, tb)
    new_p, new_st, m = step(params, init_opt_state(params, ocfg), tb)

    mesh = jref.mesh.make_host_mesh(1, 1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jbatch_abs = {k: jref.jax.ShapeDtypeStruct(v.shape, v.dtype)
                  for k, v in jb.items()}
    act = dict(jref.sharding._ACT)
    try:
        jstep, _ = jref.train_steps.make_train_step(
            jcfg, jocfg, JParallelConfig(batch_axes=("data",)), mesh,
            jbatch_abs, donate=False)
        jnew_p, jnew_st, jm = jstep(
            jparams, jref.adamw.init_opt_state(jparams, jocfg), jb)
        cdt = jnp.dtype(jcfg.dtype)

        def jloss(p):
            p = {k: v.astype(cdt) if v.dtype == jnp.float32 else v
                 for k, v in p.items()}
            return jref.model.loss_fn(p, jcfg, jb)[0]
        jgrads = jref.jax.jit(jref.jax.grad(jloss))(jparams)
    finally:
        jref.sharding.set_activation_mesh(act["mesh"], act["rules"])

    assert rel(m["loss"], jm["loss"]) <= STEP_LOSS_TOL[dtype]
    assert rel(metrics["loss"], jm["loss"]) <= STEP_LOSS_TOL[dtype]
    assert set(grads) == set(jgrads) == set(new_p)
    for k in grads:
        leaf_close(grads[k], jgrads[k], STEP_GRAD_TOL[dtype], f"grad {k}")
        err = float(np.abs(np_of(new_p[k]) - np_of(jnew_p[k])).max())
        assert err <= STEP_PARAM_LR[dtype] * okw["lr"], (k, err)
        assert new_p[k].dtype == torch.float32
    assert int(new_st.step) == 1


def test_microbatches_average_like_one_batch(jref):
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              dtype="float32")
    params = M.init_params(cfg, seed=2, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in batch_of(cfg, seed=2).items()}
    b["loss_mask"][:] = 1.0             # equal tokens in each half
    ocfg = OptimizerConfig()
    one = make_train_step(cfg, ocfg, ParallelConfig(), device="cpu")
    two = make_train_step(cfg, ocfg, ParallelConfig(microbatches=2),
                          device="cpu")
    g1, m1 = one.grads(params, b)
    g2, m2 = two.grads(params, b)
    for k in g1:
        leaf_close(g2[k], g1[k], MICRO_TOL, k)
    for k in ("loss", "nll", "aux"):
        assert abs(float(m2[k]) - float(m1[k])) <= MICRO_TOL * max(
            1.0, abs(float(m1[k]))), k
    # averaged over the microbatches, as the reference averages them
    assert float(m2["tokens"]) == float(m1["tokens"]) / 2
    pos = torch.arange(2 * 4 * 5).reshape(2, 4, 5)
    mbs = _microbatch({"positions": torch.stack([pos[0]] * 3),
                       "tokens": pos[1]}, 2)
    assert mbs[1]["positions"].shape == (3, 2, 5)
    assert torch.equal(mbs[1]["positions"][2], pos[0][2:])
    assert torch.equal(mbs[1]["tokens"], pos[1][2:])
    with pytest.raises(ValueError, match="equal microbatches"):
        _microbatch({"tokens": pos[1]}, 3)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_gradients_of_none(jref, remat):
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              dtype="float32", num_layers=4)
    params = M.init_params(cfg, seed=3, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in batch_of(cfg, seed=3).items()}
    ocfg = OptimizerConfig()
    base = make_train_step(cfg, ocfg, ParallelConfig(remat="none"),
                           device="cpu")
    other = make_train_step(cfg, ocfg, ParallelConfig(remat=remat),
                            device="cpu")
    g0, m0 = base.grads(params, b)
    g1, m1 = other.grads(params, b)
    same_bits(m1["loss"].numpy(), m0["loss"].numpy(), "loss")
    for k in g0:
        same_bits(g1[k].numpy(), g0[k].numpy(), k)
    with pytest.raises(ValueError, match="remat"):
        make_train_step(cfg, ocfg, ParallelConfig(remat="some"),
                        device="cpu").grads(params, b)


# ---------------------------------------------------------------------------
# the autograd guard and the training route
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_grad_and_ops_routes_training():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 6, 4, 16, generator=g) for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    x, dt = torch.randn(2, 5, 8, generator=g), torch.rand(2, 5, 8,
                                                          generator=g)
    A, D = -torch.rand(8, 4, generator=g), torch.randn(8, generator=g)
    B, C = torch.randn(2, 5, 4, generator=g), torch.randn(2, 5, 4,
                                                          generator=g)
    r, kk, vv = (torch.randn(2, 5, 2, 16, generator=g) for _ in range(3))
    w = torch.rand(2, 5, 2, 16, generator=g) * 0.5 + 0.4
    u = torch.randn(2, 16, generator=g)

    q.requires_grad_()
    x.requires_grad_()
    r.requires_grad_()
    for call in (lambda: fk.flash_attention(q, k, v),
                 lambda: ssm_scan.ssm(x, dt, A, B, C, D),
                 lambda: rwkv6_kernel.rwkv6(r, kk, vv, w, u)):
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()                      # no gradient: the forward route

    # ops: the reference's training semantics, under autograd
    out = ops.sdpa(q, k, v)
    same_bits(out.detach().numpy(), ref.sdpa(q, k, v).detach().numpy())
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    with torch.no_grad():               # serving: the flash semantics
        same_bits(ops.sdpa(q, k, v).numpy(),
                  ref.flash_attention(q, k, v).numpy())
    y, _ = ops.ssm_scan(x, dt, A, B, C, D)
    y.sum().backward()
    assert x.grad is not None
    o, _ = ops.rwkv6_scan(r, kk, vv, w, u)
    o.sum().backward()
    assert r.grad is not None


def test_convert_carries_the_reference_optimizer_state(jref):
    from repro.config import OptimizerConfig as JOptimizerConfig
    jnp = jref.jax.numpy
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=5, state_dtype="int8",
              state_block=16)
    ocfg, jocfg = OptimizerConfig(**kw), JOptimizerConfig(**kw)
    rng = np.random.default_rng(4)
    p0 = {"w": rng.normal(size=(6, 9)).astype(np.float32)}
    g = [{"w": rng.normal(size=(6, 9)).astype(np.float32)} for _ in range(3)]
    jp = {"w": jnp.asarray(p0["w"])}
    jst = jref.adamw.init_opt_state(jp, jocfg)
    for gi in g[:2]:
        jp, jst = jref.adamw.adamw_update(
            jp, {"w": jnp.asarray(gi["w"])}, jst, jocfg)
    st = convert.opt_state_from_arrays(
        np.asarray(jst.step),
        *({k: np.asarray(x) for k, x in d.items()}
          for d in (jst.m, jst.v, jst.m_scale, jst.v_scale)), device="cpu")
    p = {"w": torch.from_numpy(np.asarray(jp["w"]))}
    p, st = adamw_update(p, {"w": torch.from_numpy(g[2]["w"])}, st, ocfg)
    jp, jst = jref.adamw.adamw_update(jp, {"w": jnp.asarray(g[2]["w"])},
                                      jst, jocfg)
    same_bits(p["w"].numpy(), np.asarray(jp["w"]))
    same_bits(st.v["w"].numpy(), np.asarray(jst.v["w"]))
    assert int(st.step) == 3 and st.m["w"].dtype == torch.int8
    bf = convert.opt_state_from_arrays(
        1, {"w": np.asarray(jnp.ones(3, jnp.bfloat16))},
        {"w": np.asarray(jnp.ones(3, jnp.bfloat16))}, device="cpu")
    assert bf.m["w"].dtype == torch.bfloat16 and not bf.m_scale
    assert f32(bf.v["w"]).tolist() == [1.0, 1.0, 1.0]
