"""The port's RoPE and MoE modules on the CPU against the reference.

``layers.apply_rope`` against ``repro.models.layers.apply_rope`` on
seeded inputs in float32 and bfloat16: standard RoPE at llama3.2's theta
500,000 and positions up to 4,095, partial RoPE (stablelm's
``rotary_pct`` 0.25), and M-RoPE with qwen2-vl's smoke sections on
[3, b, s] positions. Bounds: float32 within 2 ulp of the output's
magnitude, ``4 * 2^-24 * (1 + |ref|)`` (measured at most 4.8e-7
absolute on values up to ~4: the two sides' cos, sin and pow differ in
the last bit, and XLA:CPU may contract ``x1 * cos - x2 * sin`` into an
FMA); bfloat16 bitwise (measured: equal; both round cos and sin to bf16
and rotate in bf16).

``moe.apply_moe`` against ``repro.models.moe.apply_moe`` (jitted) on one
converted parameter set: moonshot's smoke config (8 experts top-2, one
shared expert), phi3.5-moe's (4 experts top-2, none shared), moonshot at
capacity factor 0.5 so that pairs overflow and drop, and decode-shaped
calls with fewer than 256 tokens (one group of 4 or 6). The top-k
choices equal the reference's (read from its ``jax.lax.top_k``); the
keep mask equals a plain count of the pairs
before each one that chose the same expert, token-major and k-minor. y
within 5e-6 (max |port - ref| / (1 + |ref|), measured at most 9.2e-7),
aux within 1e-8 absolute (measured 1.9e-9 on ~0.01), float32. Bfloat16:
y within 4e-2 (measured 2.0e-2: the expert products' silu and product
round in bf16 at other places in the two frameworks), equal choices.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import all_archs, get_config, get_smoke_config
from repro_torch.convert import model_params_from_arrays
from repro_torch.models import layers, moe
from repro_torch.models import model as M
from repro_torch.models import transformer as tf

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import model_ref as jref  # noqa: F401
from torch_port_ref import both, f32

ROPE_ULP = 4 * 2.0 ** -24
MOE_TOL = {torch.float32: 5e-6, torch.bfloat16: 4e-2}
AUX_ATOL = 1e-8
MOONSHOT, PHI = "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"
#: the RoPE / MoE / attention-free archs (the MLA, vision and
#: encoder-decoder ones: tests/test_torch_serve_mla_encdec.py)
SERVED = ("llama3.2-1b", "stablelm-3b", "gemma-7b", MOONSHOT, PHI,
          "jamba-1.5-large-398b", "rwkv6-7b")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

ROPE_CASES = {
    # case: (arch, attention overrides, M-RoPE)
    "standard": ("llama3.2-1b", {"rope_theta": 500000.0}, False),
    "partial": ("stablelm-3b", {}, False),
    "mrope": ("qwen2-vl-7b", {}, True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ROPE_CASES))
def test_rope_matches_reference(jref, case, dtype):
    arch, over, mrope = ROPE_CASES[case]
    att = dataclasses.replace(get_smoke_config(arch).attention, **over)
    jatt = dataclasses.replace(jref.configs.get_smoke_config(arch).attention,
                               **over)
    assert (att.rotary_pct, att.rope) == (jatt.rotary_pct, jatt.rope)
    rng = np.random.default_rng(11)
    b, s, h = 2, 64, 4
    x = rng.standard_normal((b, s, h, att.head_dim)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, b, s) if mrope else (b, s)).astype(
        np.int32)
    pos[..., 0] = 4095
    jx, tx = both(jref, x, dtype)
    want = np.asarray(jref.layers.apply_rope(
        jx, jref.jax.numpy.asarray(pos), jatt).astype("float32"))
    got = layers.apply_rope(tx, torch.from_numpy(pos), att)
    assert got.dtype == dtype and got.shape == tx.shape
    got = f32(got)
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ROPE_ULP,
                                   rtol=ROPE_ULP)
    rot = int(att.head_dim * att.rotary_pct) // 2 * 2
    # the pass-through tail is the input's
    np.testing.assert_array_equal(got[..., rot:], f32(tx)[..., rot:])
    if case == "partial":
        assert rot == 4 and att.head_dim == 16


def test_rope_needs_three_position_rows_for_mrope():
    att = get_smoke_config("qwen2-vl-7b").attention
    with pytest.raises(ValueError, match=r"\[3, b, s\]"):
        layers.apply_rope(torch.zeros(1, 4, 2, att.head_dim),
                          torch.zeros(1, 4, dtype=torch.int32), att)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_CASES = {
    # case: (arch, capacity factor or None for the config's, b, s)
    "moonshot": (MOONSHOT, None, 2, 256),
    "moonshot-two-groups": (MOONSHOT, None, 2, 512),
    "phi3.5": (PHI, None, 2, 256),
    "overflow": (MOONSHOT, 0.5, 2, 256),
    "decode-moonshot": (MOONSHOT, None, 4, 1),
    "decode-phi3.5": (PHI, None, 6, 1),
}


def _moe_cfgs(jref, arch, factor):
    cfgs = [jref.configs.get_smoke_config(arch), get_smoke_config(arch)]
    if factor is not None:
        cfgs = [dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=factor)) for c in cfgs]
    return cfgs


def _plain_keep(experts: np.ndarray, cap: int) -> np.ndarray:
    """[G, T, K] keep mask: a pair is kept while fewer than ``cap`` pairs
    before it in its group (token-major, k-minor) chose its expert."""
    keep = np.zeros(experts.shape, bool)
    for g in range(experts.shape[0]):
        seen = {}
        for t in range(experts.shape[1]):
            for k in range(experts.shape[2]):
                e = int(experts[g, t, k])
                keep[g, t, k] = seen.get(e, 0) < cap
                seen[e] = seen.get(e, 0) + 1
    return keep


def _reference_moe(jref, params, x, jcfg):
    """The reference's (y, aux) from its jitted ``apply_moe``, and its
    top-k experts from an eager run with ``jax.lax.top_k`` recorded."""
    jax = jref.jax
    y, aux = jax.jit(lambda p, v: jref.moe.apply_moe(p, "m", v, jcfg))(
        params, x)
    top_k, seen = jax.lax.top_k, []

    def recording(operand, k):
        out = top_k(operand, k)
        seen.append(np.asarray(out[1]))
        return out
    jax.lax.top_k = recording
    try:
        jref.moe.apply_moe(params, "m", x, jcfg)
    finally:
        jax.lax.top_k = top_k
    (experts,) = seen
    return y, aux, experts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_matches_reference(jref, case, dtype):
    arch, factor, b, s = MOE_CASES[case]
    jcfg, cfg = _moe_cfgs(jref, arch, factor)
    jnp = jref.jax.numpy
    jparams = jref.layers.init_from_schema(jref.moe.moe_schema(jcfg, "m"),
                                           jref.jax.random.PRNGKey(1),
                                           jnp.float32)
    params = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    assert set(params) == set(moe.moe_schema(cfg, "m"))
    x = np.random.default_rng(2).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    jx, tx = both(jref, x, dtype)
    jy, jaux, experts = _reference_moe(jref, jparams, jx, jcfg)
    y, aux = moe.apply_moe(params, "m", tx, cfg)
    assert y.dtype == dtype and y.shape == tx.shape
    assert aux.dtype == torch.float32 and aux.dim() == 0

    # the routing: the reference's choices, and the keep mask of a count
    m = cfg.moe
    tokens = b * s
    group = moe.group_size(tokens)
    cap = moe._capacity(group, m.num_experts, m.top_k, m.capacity_factor)
    assert cap == jref.moe._capacity(group, m.num_experts, m.top_k,
                                     m.capacity_factor)
    logits = tx.reshape(-1, group, cfg.d_model).float() @ params[
        "m.router"].float()
    tope, weight, pos, keep = moe.dispatch(torch.softmax(logits, -1),
                                           m.top_k, cap)
    np.testing.assert_array_equal(tope.numpy(), experts)
    np.testing.assert_array_equal(keep.numpy(), _plain_keep(experts, cap))
    assert bool((weight[~keep] == 0).all())
    dropped = int((~keep).sum())
    if case == "overflow":
        assert dropped > 0
    if case.startswith("decode"):
        assert group == tokens < moe.GROUP_SIZE

    want = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(f32(y), want, atol=MOE_TOL[dtype],
                               rtol=MOE_TOL[dtype])
    assert abs(float(aux) - float(jaux)) <= AUX_ATOL


def test_moe_needs_whole_groups():
    assert moe.group_size(4) == 4 and moe.group_size(512) == 256
    with pytest.raises(ValueError, match="whole groups of 256"):
        moe.group_size(300)
    cfg = get_smoke_config(MOONSHOT)
    params = M.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="whole groups"):
        M.forward(params, cfg, {"tokens": torch.zeros(3, 100,
                                                      dtype=torch.int32)})


def test_stack_sums_the_layers_aux_losses():
    cfg = dataclasses.replace(get_smoke_config(MOONSHOT), dtype="float32")
    params = M.init_params(cfg, seed=2, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    _, _, aux = M.forward(params, cfg, {"tokens": tokens})
    x = layers.embed_tokens(params, tokens, cfg)
    pos = torch.arange(16, dtype=torch.int32).expand(2, 16)
    want = torch.zeros(())
    for g in range(tf.n_groups(cfg)):
        gp = {k[len("stack."):]: v[g] for k, v in params.items()
              if k.startswith("stack.")}
        x, a = tf._apply_block(gp, cfg, 0, "attn", x, pos, None, {}, False,
                               None)
        want = want + a
    assert tf.n_groups(cfg) == 2 and float(aux) > 0
    assert float(aux) == float(want)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SERVED)
def test_active_param_count_matches_reference(jref, arch):
    cfg, jcfg = get_config(arch), jref.configs.get_config(arch)
    tf.check_supported(cfg)
    assert M.active_param_count(cfg) == jref.model.active_param_count(jcfg)
    assert M.param_count(cfg) == jref.model.param_count(jcfg)
    if cfg.moe is None:
        assert M.active_param_count(cfg) == M.param_count(cfg)
    else:
        assert M.active_param_count(cfg) < M.param_count(cfg)


def test_served_archs_are_the_unrefused_ones():
    """Every arch is served: MLA, the encoder-decoder and the vision
    frontend joined the RoPE / MoE / attention-free ones."""
    refused = []
    for arch in all_archs():
        try:
            tf.check_supported(get_config(arch))
        except NotImplementedError:
            refused.append(arch)
    assert refused == []
    assert set(SERVED) < set(all_archs()) and len(all_archs()) == 10


def test_moonshot_parameters_convert_from_the_reference(jref):
    jcfg = jref.configs.get_smoke_config(MOONSHOT)
    cfg = get_smoke_config(MOONSHOT)
    jparams = jref.model.init_params(jcfg, jref.jax.random.PRNGKey(3))
    arrays = {k: np.asarray(v) for k, v in jparams.items()}
    out = model_params_from_arrays(arrays, cfg, device="cpu")
    assert set(out) == set(M.full_schema(cfg))
    assert "stack.blk0.moe.router" in out
    assert "stack.blk0.moe.shared.w_down" in out
    for k, v in out.items():
        np.testing.assert_array_equal(v.numpy(), arrays[k], err_msg=k)
    cp = M.compute_params(out, cfg, "cpu")
    assert cp["stack.blk0.moe.router"].dtype == torch.float32
    assert cp["stack.blk0.moe.w_gate"].dtype == torch.bfloat16
    assert cp["stack.blk0.moe.shared.w_up"].dtype == torch.bfloat16


def test_init_params_in_compute_form():
    """``compute=True`` draws what ``compute_params`` holds: matrices in
    the compute dtype, ``FLOAT32_LEAVES`` (the router among them) in
    float32; a stacked leaf drawn group by group keeps each group's
    distribution."""
    cfg = dataclasses.replace(get_smoke_config(MOONSHOT), num_layers=4)
    params = M.init_params(cfg, seed=5, device="cpu", compute=True)
    schema = M.full_schema(cfg)
    assert set(params) == set(schema)
    for name, w in params.items():
        want = (torch.float32 if name.rsplit(".", 1)[-1] in M.FLOAT32_LEAVES
                else torch.bfloat16)
        assert w.dtype == want, name
        assert tuple(w.shape) == schema[name].shape
    assert M.compute_params(params, cfg, "cpu")["stack.blk0.moe.w_up"] is \
        params["stack.blk0.moe.w_up"]
    w = params["stack.blk0.moe.w_gate"].float()
    std = layers.init_std(schema["stack.blk0.moe.w_gate"])
    for g in range(w.shape[0]):
        assert abs(float(w[g].std()) / std - 1) < 0.05, g
    assert not torch.equal(w[0], w[1])
    again = M.init_params(cfg, seed=5, device="cpu", compute=True)
    assert all(torch.equal(params[k], again[k]) for k in params)
