"""MLA, whisper's encoder-decoder and qwen2-vl's frontend on the CPU
against the reference.

Modules: ``layers.sinusoidal_embed`` / ``sinusoidal_positions``;
``attention.apply_mla`` (the expanded prefill through ``ops.sdpa`` at q/k
head dim 24 and v 16, then the absorbed decode over the cached latent)
and cross-attention (``apply_gqa`` with the encoder's output at prefill,
its cache at decode), each with its cache compared leaf for leaf.
Whole models: smoke minicpm3 (MLA), qwen2-vl (4 patch embeddings before
the tokens, M-RoPE positions [3, b, s] whose rows differ over the
patches) and whisper (16 frames through the encoder, sinusoidal
positions, cross-attention), in float32 and bfloat16: ``model.prefill``
and 4 greedy decode steps. The reference runs ``repro.models.model``'s
``prefill`` / ``decode_step``, jitted, with no mesh (ROADMAP C7), under
``ops.pallas_mode(True, interpret=True)``, fed the port's greedy tokens,
as ``tests/test_torch_serve_rope_moe.py`` runs it. Parameters are drawn
once by the reference and converted (``model_params_from_arrays``, which
checks every leaf of the port's schema, the encoder, ``encoder_norm``,
the ``xattn`` and the MLA leaves among them).

Tolerances (max |port - ref| / (1 + |ref|), used as atol = rtol),
measured here and set above them. Modules in float32: sinusoidal 4e-6
(measured 1.1e-6: float32 sin / cos of angles up to 59 after a float32
power, computed by two libraries), MLA and cross-attention 2e-6
(measured 3.3e-7 and 2.6e-7); in bf16 2^-7, one bf16 step (measured 0
for both). Whole models, float32: 5e-5 (measured 2.0e-6 minicpm3,
2.4e-6 qwen2-vl, 9.5e-7 whisper), and the greedy tokens are the
reference's; bfloat16: C9's 0.15 (measured 2.5e-2, 2.8e-2 and 1.8e-2).

``test_decode_consistent_with_forward`` is the reference's
``tests/test_arch_smoke.py`` test of the same name on the port for the
three archs, with its 2e-3 bounds. qwen2-vl serves text through
``ServeEngine`` (M-RoPE positions made by the model); whisper through the
engine fails for want of frames, as the reference's does. The
``launch.specs`` shapes are the reference's ``input_specs``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config import SHAPES, ShapeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import model_params_from_arrays
from repro_torch.launch import specs
from repro_torch.models import attention, layers
from repro_torch.models import model as M
from repro_torch.serve.engine import Request, ServeEngine

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import model_ref as jref  # noqa: F401
from torch_port_ref import both, f32

ARCHS = ("minicpm3-4b", "qwen2-vl-7b", "whisper-small")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_STEP = 2.0 ** -7
SINUSOID_TOL = 4e-6
MODULE_TOL = {torch.float32: 2e-6, torch.bfloat16: BF16_STEP}
LOGIT_TOL = {"float32": 5e-5, "bfloat16": 0.15}
N_PATCH, S_TEXT, N_DEC, SLOTS, MAX_LEN = 4, 16, 5, 2, 64


def close(got, want, tol, what=""):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol,
                               err_msg=what)


def schema_arrays(schema, rng):
    """Numpy values for a module's schema: normal at its init scale,
    norm scales near one."""
    out = {}
    for name, d in schema.items():
        if d.init == "ones":
            out[name] = 1 + 0.1 * rng.standard_normal(d.shape)
        else:
            out[name] = layers.init_std(d) * rng.standard_normal(d.shape)
    return {k: v.astype(np.float32) for k, v in out.items()}


# ---------------------------------------------------------------------------
# sinusoidal positions
# ---------------------------------------------------------------------------

def test_sinusoidal_embed_matches_reference(jref):
    jnp = jref.jax.numpy
    for dim in (64, 768):
        pos = np.arange(60)
        got = layers.sinusoidal_embed(torch.from_numpy(pos), dim)
        want = jref.layers.sinusoidal_embed(jnp.asarray(pos), dim)
        assert got.dtype == torch.float32 and got.shape == (60, dim)
        close(got, want, SINUSOID_TOL, f"sinusoidal_embed dim {dim}")
        lengths = np.array([3.0, 41.0], np.float32)   # decode's [b] lengths
        close(layers.sinusoidal_embed(torch.from_numpy(lengths), dim),
              jref.layers.sinusoidal_embed(jnp.asarray(lengths), dim),
              SINUSOID_TOL)
        close(layers.sinusoidal_positions(60, dim),
              jref.layers.sinusoidal_positions(60, dim), SINUSOID_TOL)


# ---------------------------------------------------------------------------
# MLA and cross-attention
# ---------------------------------------------------------------------------

def _module_cfg(arch, dtype):
    name = "float32" if dtype == torch.float32 else "bfloat16"
    return dataclasses.replace(get_smoke_config(arch), dtype=name)


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_apply_mla_prefill_and_decode(jref, dtype):
    jnp = jref.jax.numpy
    cfg = _module_cfg("minicpm3-4b", dtype)
    jcfg = dataclasses.replace(jref.configs.get_smoke_config("minicpm3-4b"),
                               dtype=cfg.dtype)
    a = cfg.attention
    rng = np.random.default_rng(7)
    arrays = schema_arrays(attention.mla_schema(cfg, "attn"), rng)
    jp = {k: jnp.asarray(v) for k, v in arrays.items()}
    tp = {k: torch.from_numpy(v) for k, v in arrays.items()}
    b, t, max_len = 2, 12, 32
    jx, x = both(jref, 0.5 * rng.standard_normal((b, t, cfg.d_model)), dtype)
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    cache_shapes = {"ckv": (b, max_len, a.kv_lora_rank),
                    "k_rope": (b, max_len, 1, a.qk_rope_head_dim)}
    jdt = jx.dtype
    jcache = {k: jnp.zeros(s, jdt) for k, s in cache_shapes.items()}
    tcache = {k: torch.zeros(s, dtype=dtype) for k, s in cache_shapes.items()}
    with jref.ops.pallas_mode(True, interpret=True):
        jy, jcache = jref.attention.apply_mla(jp, "attn", jx,
                                              jnp.asarray(pos), jcfg, jcache)
    y, tcache = attention.apply_mla(tp, "attn", x, torch.from_numpy(pos),
                                    cfg, tcache)
    tol = MODULE_TOL[dtype]
    close(y, jy, tol, "MLA prefill")
    for k in cache_shapes:
        close(tcache[k], jcache[k], tol, f"prefill cache {k}")
    np.testing.assert_array_equal(tcache["length"].numpy(), [t, t])

    # two decode steps at rows of different lengths
    jcache = dict(jcache, decode=True, length=jnp.asarray([t, t - 3]))
    tcache = dict(tcache, decode=True,
                  length=torch.tensor([t, t - 3], dtype=torch.int32))
    for step in range(2):
        jx1, x1 = both(jref, 0.5 * rng.standard_normal((b, 1, cfg.d_model)),
                       dtype)
        jpos = jcache["length"][:, None]
        jy, jcache = jref.attention.apply_mla(jp, "attn", jx1, jpos, jcfg,
                                              jcache)
        y, tcache = attention.apply_mla(
            tp, "attn", x1, tcache["length"][:, None].to(torch.int32), cfg,
            tcache)
        close(y, jy, tol, f"MLA decode step {step}")
        for k in cache_shapes:
            close(tcache[k], jcache[k], tol, f"decode cache {k}")
        np.testing.assert_array_equal(tcache["length"].numpy(),
                                      np.asarray(jcache["length"]))


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_cross_attention_matches_reference(jref, dtype):
    jnp = jref.jax.numpy
    cfg = _module_cfg("whisper-small", dtype)
    jcfg = dataclasses.replace(jref.configs.get_smoke_config("whisper-small"),
                               dtype=cfg.dtype)
    a = cfg.attention
    rng = np.random.default_rng(8)
    arrays = schema_arrays(attention.gqa_schema(cfg, "cross"), rng)
    jp = {k: jnp.asarray(v) for k, v in arrays.items()}
    tp = {k: torch.from_numpy(v) for k, v in arrays.items()}
    b, t = 2, 8
    jx, x = both(jref, rng.standard_normal((b, t, cfg.d_model)), dtype)
    jm, mem = both(jref, rng.standard_normal((b, cfg.encoder_seq,
                                              cfg.d_model)), dtype)
    shape = (b, cfg.encoder_seq, a.num_kv_heads, a.head_dim)
    jcache = {"k": jnp.zeros(shape, jx.dtype), "v": jnp.zeros(shape, jx.dtype)}
    tcache = {"k": torch.zeros(shape, dtype=dtype),
              "v": torch.zeros(shape, dtype=dtype)}
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    with jref.ops.pallas_mode(True, interpret=True):
        jy, jcache = jref.attention.apply_gqa(
            jp, "cross", jx, jnp.asarray(pos), jcfg, jcache, memory=jm,
            is_cross=True)
    y, tcache = attention.apply_gqa(tp, "cross", x, torch.from_numpy(pos),
                                    cfg, tcache, memory=mem, is_cross=True)
    tol = MODULE_TOL[dtype]
    close(y, jy, tol, "cross-attention prefill")
    for k in ("k", "v"):
        close(tcache[k], jcache[k], tol, f"cross cache {k}")
    # decode: K/V from the cache, one query a row
    jx1, x1 = both(jref, rng.standard_normal((b, 1, cfg.d_model)), dtype)
    one = np.zeros((b, 1), np.int32)
    jy, _ = jref.attention.apply_gqa(jp, "cross", jx1, jnp.asarray(one),
                                     jcfg, dict(jcache, decode=True),
                                     is_cross=True)
    y, _ = attention.apply_gqa(tp, "cross", x1, torch.from_numpy(one), cfg,
                               dict(tcache, decode=True), is_cross=True)
    close(y, jy, tol, "cross-attention decode")
    with pytest.raises(ValueError, match="encoder's output"):
        attention.apply_gqa(tp, "cross", x, torch.from_numpy(pos), cfg,
                            None, is_cross=True)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def model_batch(cfg, rng):
    """numpy prefill inputs: tokens, and the frontend's stubs."""
    batch = {"tokens": rng.integers(1, cfg.vocab_size,
                                    (SLOTS, S_TEXT)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["embeds"] = rng.standard_normal(
            (SLOTS, N_PATCH, cfg.d_model)).astype(np.float32)
        s = N_PATCH + S_TEXT
        t = np.concatenate([np.zeros(N_PATCH), np.arange(1, S_TEXT + 1)])
        hw = np.concatenate([np.arange(N_PATCH) // 2, np.arange(1, S_TEXT + 1)])
        ww = np.concatenate([np.arange(N_PATCH) % 2, np.arange(1, S_TEXT + 1)])
        batch["positions"] = np.broadcast_to(
            np.stack([t, hw, ww])[:, None], (3, SLOTS, s)).astype(np.int32)
    if cfg.encdec:
        batch["frames"] = rng.standard_normal(
            (SLOTS, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_model_matches_reference(jref, arch, dtype):
    jnp = jref.jax.numpy
    jcfg = dataclasses.replace(jref.configs.get_smoke_config(arch),
                               dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jparams = jref.model.init_params(jcfg, jref.jax.random.PRNGKey(0))
    params = M.compute_params(model_params_from_arrays(
        {k: np.asarray(v) for k, v in jparams.items()}, cfg, device="cpu"),
        cfg, "cpu")
    batch = model_batch(cfg, np.random.default_rng(1))

    port_logits, tokens = [], []
    with torch.inference_mode():
        cache = M.init_cache(cfg, SLOTS, MAX_LEN, device="cpu")
        logits, cache = M.prefill(
            params, cfg, {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in batch.items()}, cache)
        for step in range(N_DEC):
            port_logits.append(logits.float().numpy())
            tokens.append(logits[:, -1].argmax(-1).to(torch.int32))
            if step + 1 < N_DEC:
                logits, cache = M.decode_step(params, cfg, cache,
                                              {"token": tokens[-1][:, None]})
    expect_len = S_TEXT + (N_PATCH if cfg.frontend == "vision" else 0)
    assert cache["length"].tolist() == [expect_len + N_DEC - 1] * SLOTS

    prefill = jref.jax.jit(lambda p, b, c: jref.model.prefill(p, jcfg, b, c))
    decode = jref.jax.jit(
        lambda p, c, b: jref.model.decode_step(p, jcfg, c, b))
    with jref.ops.pallas_mode(True, interpret=True):
        jcache = jref.model.init_cache(jcfg, SLOTS, MAX_LEN)
        logits, jcache = prefill(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcache)
        ref_logits = [np.asarray(logits.astype(jnp.float32))]
        for step in range(1, N_DEC):
            logits, jcache = decode(
                jparams, jcache,
                {"token": jnp.asarray(tokens[step - 1].numpy()[:, None])})
            ref_logits.append(np.asarray(logits.astype(jnp.float32)))
    tol = LOGIT_TOL[dtype]
    for step, (a, b) in enumerate(zip(port_logits, ref_logits)):
        assert a.shape == b.shape == (SLOTS, 1, cfg.vocab_size)
        assert np.isfinite(a).all()
        close(a, b, tol, f"{arch} logits at step {step}")
        if dtype == "float32":
            np.testing.assert_array_equal(b[:, -1].argmax(-1),
                                          tokens[step].numpy(),
                                          err_msg=f"tokens at step {step}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_consistent_with_forward(arch):
    """Teacher-forced decode logits match the parallel forward: MLA's
    latent cache, the cross K/V cache and the decoder's sinusoidal
    positions at the cache's lengths, M-RoPE positions after the
    patches."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              param_dtype="float32")
    params = M.init_params(cfg, seed=0, device="cpu")
    b, s_pre, n_dec = 2, 8, 4
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s_pre + n_dec)).astype(np.int32))
    full = {"tokens": tokens}
    pre = {"tokens": tokens[:, :s_pre]}
    if cfg.frontend == "vision":
        full["embeds"] = torch.randn(b, 4, cfg.d_model,
                                     generator=torch.Generator().manual_seed(0))
        pos = torch.arange(s_pre + n_dec + 4, dtype=torch.int32)
        full["positions"] = pos[None, None].expand(3, b, -1)
        pre["embeds"] = full["embeds"]
        pre["positions"] = full["positions"][:, :, :s_pre + 4]
    if cfg.encdec:
        full["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        pre["frames"] = full["frames"]
    with torch.inference_mode():
        logits_full, _, _ = M.forward(params, cfg, full)
        logits_full = logits_full[:, -(s_pre + n_dec):]
        cache = M.init_cache(cfg, b, max_len=64, device="cpu")
        last, cache = M.prefill(params, cfg, pre, cache)
        np.testing.assert_allclose(last[:, 0].numpy(),
                                   logits_full[:, s_pre - 1].numpy(),
                                   atol=2e-3, rtol=2e-3)
        for i in range(n_dec - 1):
            step_logits, cache = M.decode_step(
                params, cfg, cache,
                {"token": tokens[:, s_pre + i:s_pre + i + 1]})
            np.testing.assert_allclose(
                step_logits[:, 0].numpy(),
                logits_full[:, s_pre + i].numpy(), atol=2e-3, rtol=2e-3,
                err_msg=f"{arch} decode step {i}")


def test_qwen2_vl_serves_text_through_the_engine(jref):
    """Tokens only, as the reference's engine takes them: the model makes
    the [3, b, s] M-RoPE positions, at prefill and at decode."""
    jnp = jref.jax.numpy
    arch = "qwen2-vl-7b"
    jcfg = dataclasses.replace(jref.configs.get_smoke_config(arch),
                               dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jparams = jref.model.init_params(jcfg, jref.jax.random.PRNGKey(2))
    params = model_params_from_arrays(
        {k: np.asarray(v) for k, v in jparams.items()}, cfg, device="cpu")
    eng = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                      device="cpu")
    prompts = ([5, 9, 2, 200, 17], [int(t) for t in
                                    np.random.default_rng(0).integers(
                                        1, 256, 30)])
    reqs = [Request(rid=i, prompt=list(p), max_new=4)
            for i, p in enumerate(prompts)]
    eng.process_group(reqs)
    plen = MAX_LEN // 2
    padded = np.zeros((SLOTS, plen), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    with jref.ops.pallas_mode(True, interpret=True):
        cache = jref.model.init_cache(jcfg, SLOTS, MAX_LEN)
        logits, cache = jref.model.prefill(
            jparams, jcfg, {"tokens": jnp.asarray(padded)}, cache)
        want = [np.asarray(logits[:, -1].argmax(-1))]
        for _ in range(3):
            logits, cache = jref.model.decode_step(
                jparams, jcfg, cache, {"token": jnp.asarray(want[-1])[:, None]})
            want.append(np.asarray(logits[:, -1].argmax(-1)))
    np.testing.assert_array_equal(np.array([r.output for r in reqs]),
                                  np.stack(want, axis=1))


def test_whisper_through_the_engine_needs_frames():
    cfg = get_smoke_config("whisper-small")
    eng = ServeEngine(cfg, M.init_params(cfg, seed=0, device="cpu"),
                      slots=2, max_len=64, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        eng.process_group([Request(rid=0, prompt=[1, 2, 3], max_new=2)])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(jref, arch):
    """The full configs' schemas (encoder, cross-attention and MLA leaves
    included) count the reference's parameters."""
    cfg, jcfg = get_config(arch), jref.configs.get_config(arch)
    assert M.param_count(cfg) == jref.model.param_count(jcfg)
    assert set(M.full_schema(cfg)) == set(jref.model.full_schema(jcfg))
    for name, d in M.full_schema(cfg).items():
        assert d.shape == jref.model.full_schema(jcfg)[name].shape, name


# ---------------------------------------------------------------------------
# launch/specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ("llama3.2-1b",))
def test_input_specs_match_reference(jref, arch):
    cfg, jcfg = get_config(arch), jref.configs.get_config(arch)
    for shape in SHAPES:        # the reference reads the same three fields
        got = specs.input_specs(cfg, shape)
        want = jref.launch_specs.input_specs(jcfg, shape)
        assert set(got) == set(want), shape.name
        for name, (shp, dt) in got.items():
            assert shp == tuple(want[name].shape), (shape.name, name)
            assert str(dt).replace("torch.", "") == want[name].dtype.name
        dec = specs.decode_input_specs(cfg, shape)
        jdec = jref.launch_specs.decode_input_specs(jcfg, shape)
        assert dec["token"][0] == tuple(jdec["token"].shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_concrete_batch_follows_the_specs(arch):
    cfg = get_smoke_config(arch)
    shape = ShapeConfig("smoke", 24, 2, "train")
    batch = specs.concrete_batch(
        cfg, shape, torch.Generator().manual_seed(0), device="cpu")
    want = specs.input_specs(cfg, shape)
    assert set(batch) == set(want)
    for name, t in batch.items():
        assert (tuple(t.shape), t.dtype) == want[name], name
    assert int(batch["tokens"].min()) >= 0
    assert int(batch["tokens"].max()) < cfg.vocab_size
    if "positions" in batch:
        assert torch.equal(batch["positions"][2, 1],
                           torch.arange(24, dtype=torch.int32))
    with torch.inference_mode():
        logits, _, _ = M.forward(M.init_params(cfg, seed=0, device="cpu"),
                                 cfg, batch)
    assert logits.shape == (2, 24, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all()
