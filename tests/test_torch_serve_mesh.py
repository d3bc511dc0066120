"""Serving over a (data, model) mesh (ROADMAP A8.2a), gloo on the CPU.

One spawn per world (``torch_mesh_workers.serve_worker``; worlds of 2
and 4) runs every case on each mesh of its world: ``(data=1, model=2)``
and ``(2, 1)``, then ``(2, 2)`` and ``(1, 4)``, the last the KV-head
case for the smoke configs with 2 KV heads (llama3.2, phi3.5-moe,
Jamba). The cases are every block kind in float32: llama3.2 (GQA,
RoPE, tied embeddings), minicpm3 (MLA), Jamba with and without experts
(Mamba), rwkv6, whisper with frames (cross-attention and the encoder;
its vocabulary made odd, 257, so that it stays whole), moonshot (experts
and a shared expert) and phi3.5-moe. Each rank runs a prefill of 4 x 128
tokens and 3 greedy decode steps through ``serve.steps`` on its rows
and shards (with experts the prefill's two dispatch groups are a rank's
own at data=2, through the expert exchange; a decode step's group of 4
straddles the ranks), and ``ServeEngine.serve`` of 6 requests over 4
slots (a prefill group of 256 that straddles the ranks). This process
holds them to:

* the port's one-device steps and engine on the whole batch: greedy
  tokens and engine outputs equal; logits and each gathered cache leaf
  within ``MESH_RTOL`` (max |mesh - one| / (1 + max |one|); measured
  here up to 1.6e-6 for the logits, 1.4e-6 for the caches: the
  row-parallel sums' float32 order);
* the reference's jitted single-device ``prefill`` / ``decode_step``
  with no mesh (C7), fed the same tokens: within C9's float32 bound,
  ``REF_TOL``;
* the plan: each rank's parameter and cache shapes are those of the
  reference's specs with the FSDP axis left whole and the KV-head rule
  (``torch_mesh_workers.serve_plan_shapes``), every leaf split over
  ``model`` or the expert axis smaller than whole, and the engine's
  parameters gathered back (``checkpoint.gather_tree``) bitwise the
  one-device parameters.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config import ParallelConfig
from repro_torch.convert import model_params_from_arrays

import torch_mesh_workers as w
from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import model_ref as jref  # noqa: F401

#: float32 over a mesh against one device (logits and gathered caches)
MESH_RTOL = 1e-5
#: float32 against the reference's single-device steps (C9; as
#: tests/test_torch_serve_rope_moe.py's LOGIT_TOL["float32"])
REF_TOL = 5e-5
CASES = [c[0] for c in w.SERVE_CASES]
MESH_CASES = [(world, shape, case) for world, shapes in
              w.SERVE_MESHES.items() for shape in shapes for case in CASES]
IDS = [f"{s[0]}x{s[1]}-{c}" for _, s, c in MESH_CASES]


def err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / (1.0 + float(np.abs(want).max()))


@pytest.fixture(scope="module")
def params_np(jref):
    """Each case's parameters, drawn by the reference, as numpy."""
    out = {}
    for i, (case, arch, kw) in enumerate(w.SERVE_CASES):
        jcfg = dataclasses.replace(jref.configs.get_smoke_config(arch),
                                   dtype="float32", **kw)
        jp = jref.model.init_params(jcfg, jref.jax.random.PRNGKey(10 + i))
        out[case] = {k: np.asarray(v) for k, v in jp.items()}
    return out


@pytest.fixture(scope="module")
def ranks(params_np, tmp_path_factory):
    """{world: each rank's record}."""
    root = tmp_path_factory.mktemp("serve_mesh")
    return {world: w.spawn(w.serve_worker, world, root, params_np)
            for world in w.SERVE_MESHES}


@pytest.fixture(scope="module")
def one_device(params_np):
    """{case: the port's one-device steps and engine on the whole
    batch}."""
    out = {}
    for case in CASES:
        cfg = w.serve_cfg(case)
        params = model_params_from_arrays(params_np[case], cfg,
                                          device="cpu")
        logits, toks, cache, _ = w.serve_steps(cfg, params,
                                               w.serve_inputs(cfg))
        rec = {"logits": logits, "tokens": toks,
               "cache": {k: v.numpy() for k, v in cache.items()}}
        if not cfg.encdec:
            rec["engine"], rec["spans"], _ = w.serve_engine(cfg, params)
        out[case] = rec
    return out


@pytest.fixture(scope="module")
def reference(jref, params_np, one_device):
    """{case: the reference's logits of the prefill and each decode step,
    fed the one-device tokens}."""
    jnp = jref.jax.numpy
    out = {}
    for case, arch, kw in w.SERVE_CASES:
        jcfg = dataclasses.replace(jref.configs.get_smoke_config(arch),
                                   dtype="float32", **kw)
        jparams = {k: jnp.asarray(v) for k, v in params_np[case].items()}
        batch = w.serve_inputs(jcfg)
        prefill = jref.jax.jit(
            lambda p, b, c, cfg=jcfg: jref.model.prefill(p, cfg, b, c))
        decode = jref.jax.jit(
            lambda p, c, b, cfg=jcfg: jref.model.decode_step(p, cfg, c, b))
        toks = one_device[case]["tokens"]
        with jref.ops.pallas_mode(True, interpret=True):
            cache = jref.model.init_cache(jcfg, w.SERVE_B, w.SERVE_MAX_LEN)
            logits, cache = prefill(
                jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                cache)
            got = [np.asarray(logits)]
            for step in range(w.SERVE_DECODE):
                logits, cache = decode(jparams, cache, {
                    "token": jnp.asarray(toks[:, step:step + 1]
                                         .astype(np.int32))})
                got.append(np.asarray(logits))
        out[case] = got
    return out


def records(ranks, world, shape, case):
    return [r[(shape, case)] for r in ranks[world]]


@pytest.mark.parametrize("world, shape, case", MESH_CASES, ids=IDS)
def test_tokens_and_logits_match_one_device(ranks, one_device, world,
                                            shape, case):
    one = one_device[case]
    for rec in records(ranks, world, shape, case):
        np.testing.assert_array_equal(rec["tokens"], one["tokens"])
        for step, (a, b) in enumerate(zip(rec["logits"], one["logits"])):
            assert a.shape == b.shape and np.isfinite(a).all()
            assert err(a, b) <= MESH_RTOL, (step, err(a, b))


@pytest.mark.parametrize("world, shape, case", MESH_CASES, ids=IDS)
def test_gathered_caches_match_one_device(ranks, one_device, world, shape,
                                          case):
    one = one_device[case]["cache"]
    for rec in records(ranks, world, shape, case):
        assert sorted(rec["cache"]) == sorted(one)
        for k, v in one.items():
            assert rec["cache"][k].shape == v.shape, k
            assert err(rec["cache"][k], v) <= MESH_RTOL, (k, err(
                rec["cache"][k], v))


@pytest.mark.parametrize("world, shape, case", MESH_CASES, ids=IDS)
def test_matches_the_reference(ranks, reference, world, shape, case):
    rec = records(ranks, world, shape, case)[0]
    for step, (a, b) in enumerate(zip(rec["logits"], reference[case])):
        np.testing.assert_allclose(a, b, atol=REF_TOL, rtol=REF_TOL,
                                   err_msg=f"{case} logits at step {step}")


@pytest.mark.parametrize("world, shape, case", MESH_CASES, ids=IDS)
def test_rank_holds_its_shard(ranks, world, shape, case):
    """Each rank's parameter and cache shapes are the plan's; a leaf the
    specs split over ``model`` or the expert axis is never whole; the
    parameters gather back bitwise."""
    from repro_torch.models import model as M
    cfg = w.serve_cfg(case)
    mesh_shape = {"data": shape[0], "model": shape[1]}
    pplan, cplan = w.serve_plan_shapes(cfg, mesh_shape)
    whole_p = {k: d.shape for k, d in M.full_schema(cfg).items()}
    whole_c = {k: d.shape for k, d in M.cache_schema(
        cfg, w.SERVE_B, w.SERVE_MAX_LEN).items()}
    specs = M.serve_specs(cfg, ParallelConfig(), mesh_shape, w.SERVE_B,
                          w.SERVE_MAX_LEN)
    split = [{name for name, spec in sp.items()
              if any(e is not None and mesh_shape.get(e, 1) > 1
                     for e in spec)} for sp in specs]
    for rec in records(ranks, world, shape, case):
        assert rec["param_shapes"] == pplan
        assert rec["cache_shapes"] == cplan
        for names, plan, whole in zip(split, (pplan, cplan),
                                      (whole_p, whole_c)):
            for name in names:
                assert np.prod(plan[name]) < np.prod(whole[name]), name
        assert rec["params_bitwise"]
        if not cfg.encdec:
            assert rec["engine_params_bitwise"]


@pytest.mark.parametrize("world, shape, case",
                         [c for c in MESH_CASES if c[2] != "whisper"],
                         ids=[i for i, c in zip(IDS, MESH_CASES)
                              if c[2] != "whisper"])
def test_engine_serves_the_one_device_tokens(ranks, one_device, world,
                                             shape, case):
    """``ServeEngine(mesh=)``: every rank's outputs are the one-device
    engine's, and every rank records the spans."""
    one = one_device[case]
    for rec in records(ranks, world, shape, case):
        assert rec["engine"] == one["engine"]
        assert rec["spans"] == one["spans"]


@pytest.mark.parametrize("world, shape", [(wd, s) for wd, ss in
                                          w.SERVE_MESHES.items()
                                          for s in ss])
def test_whisper_vocabulary_stays_whole_with_the_warning(ranks, world,
                                                         shape):
    for rec in records(ranks, world, shape, "whisper"):
        warned = [m for m in rec["warnings"] if "'vocab_act'" in m]
        if shape[1] > 1:
            assert warned and "dim 257" in warned[0]
            assert f"size {shape[1]}" in warned[0]
        else:
            assert not warned
        assert rec["param_shapes"]["embed.table"] == (257, 64)


@pytest.mark.parametrize("world", sorted(w.SERVE_MESHES))
def test_slots_must_split_over_the_batch_axes(ranks, world):
    assert "do not split over the batch axes" in ranks[world][0]["slots"]
