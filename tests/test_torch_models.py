"""The port's model side on the CPU: plain kernels and blocks against the
reference.

The plain versions of ``repro_torch.kernels.ref`` are held against the
JAX package's Pallas kernels in interpret mode (``flash_attention``,
``ssm``) and its oracle ``ref.sdpa``; the GQA and Mamba blocks against
``repro.models.attention`` / ``repro.models.ssm`` under
``ops.pallas_mode(True, interpret=True)``, in prefill and in decode. All
inputs come from a numpy seed; parameters are drawn once by the
reference and converted. Bfloat16 inputs are rounded once and handed to
both sides as the same values.

Tolerances, each measured (worst case over the cases here, as
max |got - want| / (1 + |want|)) and set above it; the JAX package's own
(flash 2e-5 / 2e-2, SSM 1e-4 / 3e-2 with rtol 0.1, ``tests/test_kernels.py``)
are the ceiling. Each is used as atol = rtol:

* float32: flash 1e-6 (measured 2.8e-7: the same float32 math, a global
  softmax against an online one), sdpa 2e-6 (5.3e-7), SSM 1e-6 (3.1e-7),
  blocks 1e-6 (2.7e-7);
* bfloat16: 8e-3 = 2^-7 for all, one bf16 rounding step of the output
  (a float32 result that differs in its last bits may round to the
  neighbouring bf16 value). Measured: flash 2.2e-3, sdpa 0, SSM 9.5e-7,
  the attention block 0 (prefill, decode and K/V cache equal), the Mamba
  block 7.0e-4 (its bf16 products and sums round at other places in the
  two frameworks).

The bf16 card kernel rounds the probabilities to bf16 before its PV
product (the Pallas kernel keeps them in float32, ROADMAP C8); a
test-local float32 model of that arithmetic stays within BF16_STEP of the
Pallas kernel and of the plain version (measured 3.9e-3 causal, 1.6e-3
not, at d 64 and 128), the budget the card kernel is held to.

The last two tests hold the CUDA kernels against the plain versions and
run only where a card is visible (``python3 chip_smoke.py`` covers them at
the serving path's widths).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.convert import model_params_from_arrays
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ssm_scan as sk
from repro_torch.models import attention, layers, ssm
from repro_torch.models import model as M

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import model_ref as jref  # noqa: F401
from torch_port_ref import both, f32

BF16_STEP = 2.0 ** -7
FLASH_TOL = {torch.float32: 1e-6, torch.bfloat16: BF16_STEP}
SDPA_TOL = {torch.float32: 2e-6, torch.bfloat16: BF16_STEP}
SSM_TOL = {torch.float32: 1e-6, torch.bfloat16: BF16_STEP}
BLOCK_TOL = {torch.float32: 1e-6, torch.bfloat16: BF16_STEP}
#: the CUDA kernels against the plain versions on the card (the kernels
#: sum in another order and contract multiply-adds; bf16 outputs may take
#: the neighbouring value), as in chip_smoke.py
CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: BF16_STEP}
DTYPES = [torch.float32, torch.bfloat16]


def close(got, want, atol, rtol, what=""):
    np.testing.assert_allclose(f32(got), f32(want), atol=atol, rtol=rtol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# flash attention and sdpa
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,kh,d", [
    (2, 256, 4, 2, 64),       # GQA
    (1, 512, 8, 8, 64),       # MHA
    (2, 128, 4, 1, 32),       # MQA
    (1, 384, 6, 2, 128),      # non-pow2 blocks (384 = 3*128)
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_flash_matches_pallas_kernel(jref, b, s, h, kh, d, causal,
                                           dtype):
    rng = np.random.default_rng(1)
    jq, q = both(jref, rng.standard_normal((b, s, h, d)), dtype)
    jk, k = both(jref, rng.standard_normal((b, s, kh, d)), dtype)
    jv, v = both(jref, rng.standard_normal((b, s, kh, d)), dtype)
    want = jref.flash_attention.flash_attention(jq, jk, jv, causal=causal,
                                                interpret=True)
    got = ref.flash_attention(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == (b, s, h, d)
    tol = FLASH_TOL[dtype]
    close(got, want, tol, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["decode_kv_len", "prefill_causal",
                                  "logit_cap"])
def test_plain_sdpa_matches_reference(jref, case, dtype):
    rng = np.random.default_rng(2)
    sq = 1 if case == "decode_kv_len" else 48
    jq, q = both(jref, rng.standard_normal((2, sq, 4, 32)), dtype)
    jk, k = both(jref, rng.standard_normal((2, 64, 2, 32)), dtype)
    jv, v = both(jref, rng.standard_normal((2, 64, 2, 32)), dtype)
    kw = {"causal": case != "decode_kv_len"}
    jkw = dict(kw)
    if case == "decode_kv_len":
        kv = np.array([5, 64], np.int32)
        kw["kv_len"] = torch.from_numpy(kv)
        jkw["kv_len"] = jref.jax.numpy.asarray(kv)
    if case == "logit_cap":
        kw["logit_cap"] = jkw["logit_cap"] = 2.0
    want = jref.ref.sdpa(jq, jk, jv, **jkw)
    got = ref.sdpa(q, k, v, **kw)
    assert got.dtype == dtype
    tol = SDPA_TOL[dtype]
    close(got, want, tol, tol)


def test_flash_semantics_differ_from_sdpa_only_in_rounding():
    """``ref.flash_attention`` keeps the probabilities in float32,
    ``ref.sdpa`` casts them to bf16: equal in float32, apart in bf16."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 64, 4, 32, generator=g) for _ in range(3))
    a, b = ref.flash_attention(q, k, v), ref.sdpa(q, k, v)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    assert not torch.equal(ref.flash_attention(qb, kb, vb),
                           ref.sdpa(qb, kb, vb))


def flash_bf16_p(q, k, v, causal, tile=128):
    """The bf16 card kernel's arithmetic, written out in float32: an
    online softmax over 128-key tiles whose probabilities are rounded to
    bf16 before the PV product (the denominator sums them unrounded);
    masked scores -1e30, the denominator floored at 1e-30."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, kh, h // kh, d)
    m = torch.full((b, sq, kh, h // kh), -float("inf"))
    l = torch.zeros_like(m)                                  # noqa: E741
    acc = torch.zeros(b, sq, kh, h // kh, d)
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, sk, tile):
        kt, vt = k[:, k0:k0 + tile].float(), v[:, k0:k0 + tile].float()
        s = torch.einsum("bqkgd,bskd->bqkgs", qf, kt) * d ** -0.5
        if causal:
            keep = qpos >= torch.arange(k0, k0 + kt.shape[1])[None, :]
            s = torch.where(keep[None, :, None, None, :], s, ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)                             # noqa: E741
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgs,bskd->bqkgd", p.bfloat16().float(), vt)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, sq, h, d).to(q.dtype)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_probabilities_stay_inside_the_bf16_tolerance(jref, d,
                                                           causal):
    """The bf16 flash kernel rounds P to bf16 before the PV product; the
    Pallas kernel keeps P in float32 (ROADMAP C8). That departure, at most
    one bf16 rounding per term, stays within one bf16 step of the output
    (BF16_STEP, the kernel's card tolerance) of the plain version and of
    the Pallas kernel, sq and sk not multiples of the 128-key tile."""
    rng = np.random.default_rng(7)
    jq, q = both(jref, rng.standard_normal((1, 384, 4, d)), torch.bfloat16)
    jk, k = both(jref, rng.standard_normal((1, 384, 2, d)), torch.bfloat16)
    jv, v = both(jref, rng.standard_normal((1, 384, 2, d)), torch.bfloat16)
    got = flash_bf16_p(q, k, v, causal)
    want = jref.flash_attention.flash_attention(jq, jk, jv, causal=causal,
                                                interpret=True)
    close(got, want, BF16_STEP, BF16_STEP, "vs the Pallas kernel")
    for sq, sk_ in ((300, 300), (129, 257)):
        got = flash_bf16_p(q[:, :sq], k[:, :sk_], v[:, :sk_], causal)
        want = ref.flash_attention(q[:, :sq], k[:, :sk_], v[:, :sk_],
                                   causal=causal)
        close(got, want, CARD_TOL[torch.bfloat16], CARD_TOL[torch.bfloat16],
              f"sq {sq} sk {sk_}")


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------

def _ssm_inputs(jref, b, s, di, n, dtype, seed=4):
    rng = np.random.default_rng(seed)
    softplus = lambda a: np.log1p(np.exp(a))  # noqa: E731
    jx, x = both(jref, rng.standard_normal((b, s, di)) * 0.5, dtype)
    jdt, dt = both(jref, softplus(rng.standard_normal((b, s, di)) - 1),
                   dtype)
    jB, B = both(jref, rng.standard_normal((b, s, n)) * 0.5, dtype)
    jC, C = both(jref, rng.standard_normal((b, s, n)) * 0.5, dtype)
    A = -np.exp(rng.standard_normal((di, n)) * 0.5).astype(np.float32)
    D = rng.standard_normal(di).astype(np.float32)
    st = (rng.standard_normal((b, di, n)) * 0.1).astype(np.float32)
    jnp = jref.jax.numpy
    j = (jx, jdt, jnp.asarray(A), jB, jC, jnp.asarray(D), jnp.asarray(st))
    t = (x, dt, torch.from_numpy(A), B, C, torch.from_numpy(D),
         torch.from_numpy(st))
    return j, t


@pytest.mark.parametrize("b,s,di,n", [(2, 128, 256, 16), (1, 64, 128, 8)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_ssm_matches_pallas_kernel(jref, b, s, di, n, dtype):
    j, t = _ssm_inputs(jref, b, s, di, n, dtype)
    y_j, s_j = jref.ssm_scan.ssm(*j, chunk=32, d_block=64, interpret=True)
    y_t, s_t = ref.ssm_scan(*t)
    assert y_t.dtype == dtype and s_t.dtype == torch.float32
    tol = SSM_TOL[dtype]
    close(y_t, y_j, tol, tol, "y")
    close(s_t, s_j, tol, tol, "state")


def test_plain_ssm_zero_state_and_carry(jref):
    """``state=None`` is a zero state, and a run split in two with the
    state carried across equals the whole run (and the reference's split
    run)."""
    j, t = _ssm_inputs(jref, 1, 64, 64, 8, torch.float32, seed=5)
    x, dt, A, B, C, D, _ = t
    full, s_full = ref.ssm_scan(x, dt, A, B, C, D)
    zero, s_zero = ref.ssm_scan(x, dt, A, B, C, D, torch.zeros(1, 64, 8))
    assert torch.equal(full, zero) and torch.equal(s_full, s_zero)
    h1, s1 = ref.ssm_scan(x[:, :32], dt[:, :32], A, B[:, :32], C[:, :32], D)
    h2, s2 = ref.ssm_scan(x[:, 32:], dt[:, 32:], A, B[:, 32:], C[:, 32:], D,
                          s1)
    assert torch.equal(torch.cat([h1, h2], 1), full)
    assert torch.equal(s2, s_full)
    jx, jdt, jA, jB, jC, jD, _ = j
    _, js1 = jref.ssm_scan.ssm(jx[:, :32], jdt[:, :32], jA, jB[:, :32],
                               jC[:, :32], jD, None, chunk=16, d_block=32,
                               interpret=True)
    jh2, js2 = jref.ssm_scan.ssm(jx[:, 32:], jdt[:, 32:], jA, jB[:, 32:],
                                 jC[:, 32:], jD, js1, chunk=16, d_block=32,
                                 interpret=True)
    tol = SSM_TOL[torch.float32]
    close(h2, jh2, tol, tol, "second half")
    close(s2, js2, tol, tol, "carried state")


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """On CPU tensors ``ops`` routes as the reference does under Pallas
    (flash semantics for prefill, ``ref.sdpa`` for decode), never builds
    a kernel and counts no launch."""
    def no_build(*a, **k):
        raise AssertionError("a CPU call reached the CUDA build")
    monkeypatch.setattr(build, "load", no_build)
    fk.reset_launches()
    sk.reset_launches()
    g = torch.Generator().manual_seed(6)
    q = torch.randn(2, 16, 4, 32, generator=g).bfloat16()
    k, v = (torch.randn(2, 16, 2, 32, generator=g).bfloat16()
            for _ in range(2))
    assert torch.equal(ops.sdpa(q, k, v), ref.flash_attention(q, k, v))
    assert torch.equal(ops.sdpa(q, k, v, logit_cap=3.0),
                       ref.sdpa(q, k, v, logit_cap=3.0))
    kv_len = torch.tensor([3, 16], dtype=torch.int32)
    assert torch.equal(ops.sdpa(q[:, :1], k, v, causal=False, kv_len=kv_len),
                       ref.sdpa(q[:, :1], k, v, causal=False, kv_len=kv_len))
    x = torch.randn(2, 5, 8, generator=g)
    B = torch.randn(2, 5, 4, generator=g)
    A, D = -torch.rand(8, 4, generator=g), torch.randn(8, generator=g)
    y, st = ops.ssm_scan(x, x.abs(), A, B, B, D)
    y2, st2 = ref.ssm_scan(x, x.abs(), A, B, B, D)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    assert fk.launches == {"flash_attention": 0, "flash_attention_f32": 0}
    assert sk.launches == {"ssm_scan": 0}


def test_build_gives_each_source_its_flags():
    """The model kernels may contract; policy_scan keeps its IEEE flags
    (and so its library hash)."""
    assert set(build.SOURCES) == {"policy_scan", "flash_attention",
                                  "ssm_scan", "rwkv6"}
    assert build.FLAGS["policy_scan"] is build.NVCC_FLAGS
    for name in ("flash_attention", "ssm_scan", "rwkv6"):
        flags = " ".join(build.FLAGS[name])
        assert "arch=compute_90a,code=sm_90a" in flags
        assert "--fmad=false" not in flags and "fast_math" not in flags
        assert (build.CSRC / f"{name}.cu").is_file()
        assert build.library_path(name) != build.library_path("policy_scan")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _cfg(dtype):
    return dataclasses.replace(get_smoke_config("jamba-1.5-large-398b"),
                               moe=None, dtype=str(dtype).split(".")[-1])


def _block_params(jref, schema, seed):
    """Reference-drawn float32 parameters for ``schema`` as (jax, torch)."""
    jp = jref.layers.init_from_schema(schema, jref.jax.random.PRNGKey(seed),
                                      jref.jax.numpy.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_gqa_prefill_and_decode(jref, dtype):
    cfg = _cfg(dtype)
    jcfg = dataclasses.replace(jref.configs.get_smoke_config(
        "jamba-1.5-large-398b"), moe=None, dtype=cfg.dtype)
    jp, tp = _block_params(jref, attention.gqa_schema(cfg, "a"), 7)
    assert set(jp) == set(jref.attention.gqa_schema(jcfg, "a"))
    rng = np.random.default_rng(8)
    b, t, max_len = 2, 12, 24
    jx, x = both(jref, rng.standard_normal((b, t, cfg.d_model)), dtype)
    jx1, x1 = both(jref, rng.standard_normal((b, 1, cfg.d_model)), dtype)
    jnp = jref.jax.numpy
    a = cfg.attention
    shape = (b, max_len, a.num_kv_heads, a.head_dim)
    jcache = {"k": jnp.zeros(shape, jx.dtype), "v": jnp.zeros(shape, jx.dtype)}
    tcache = {"k": torch.zeros(shape, dtype=dtype),
              "v": torch.zeros(shape, dtype=dtype)}
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    tol = BLOCK_TOL[dtype]
    with jref.ops.pallas_mode(True, interpret=True):
        jy, jcache = jref.attention.apply_gqa(jp, "a", jx, jnp.asarray(pos),
                                              jcfg, jcache)
        ty, tcache = attention.apply_gqa(tp, "a", x, torch.from_numpy(pos),
                                         cfg, tcache)
        close(ty, jy, tol, tol, "prefill out")
        for key in ("k", "v"):
            close(tcache[key], jcache[key], tol, tol, f"prefill {key}")
        assert tcache["length"].tolist() == [t, t]
        # one decode step per row at different lengths
        lengths = np.array([t, t - 5], np.int32)
        jcache = dict(jcache, decode=True, length=jnp.asarray(lengths))
        tcache = dict(tcache, decode=True, length=torch.from_numpy(lengths))
        jy, jcache = jref.attention.apply_gqa(
            jp, "a", jx1, jnp.asarray(lengths[:, None]), jcfg, jcache)
        ty, tcache = attention.apply_gqa(
            tp, "a", x1, torch.from_numpy(lengths[:, None]), cfg, tcache)
    close(ty, jy, tol, tol, "decode out")
    for key in ("k", "v"):
        close(tcache[key], jcache[key], tol, tol, f"decode {key}")
    assert tcache["length"].tolist() == [t + 1, t - 4]


def test_write_kv_matches_dynamic_update_slice(jref):
    """Per-row writes at per-row offsets, a start past S - t clamped as
    ``lax.dynamic_update_slice`` clamps it."""
    rng = np.random.default_rng(11)
    ck = rng.standard_normal((3, 10, 2, 4)).astype(np.float32)
    cv = rng.standard_normal((3, 10, 2, 4)).astype(np.float32)
    kn = rng.standard_normal((3, 3, 2, 4)).astype(np.float32)
    vn = rng.standard_normal((3, 3, 2, 4)).astype(np.float32)
    pos = np.array([0, 4, 9], np.int32)            # the last one clamps
    jnp = jref.jax.numpy
    want = jref.attention._write_kv(*(jnp.asarray(a) for a in
                                      (ck, cv, kn, vn, pos)))
    got = attention._write_kv(*(torch.from_numpy(a.copy()) for a in
                                (ck, cv, kn, vn, pos)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_mamba_prefill_and_decode(jref, dtype):
    cfg = _cfg(dtype)
    jcfg = dataclasses.replace(jref.configs.get_smoke_config(
        "jamba-1.5-large-398b"), moe=None, dtype=cfg.dtype)
    jp, tp = _block_params(jref, ssm.mamba_schema(cfg, "m"), 9)
    # non-trivial conv bias, dt bias and skip so every leaf matters
    rng = np.random.default_rng(10)
    for leaf in ("conv_b", "dt_bias", "D"):
        v = (rng.standard_normal(tp[f"m.{leaf}"].shape) * 0.3
             ).astype(np.float32)
        tp[f"m.{leaf}"] = torch.from_numpy(v)
        jp[f"m.{leaf}"] = jref.jax.numpy.asarray(v)
    b, t = 2, 10
    jx, x = both(jref, rng.standard_normal((b, t, cfg.d_model)), dtype)
    jx1, x1 = both(jref, rng.standard_normal((b, 1, cfg.d_model)), dtype)
    jnp = jref.jax.numpy
    di, _, n = ssm._dims(cfg)
    conv_shape = (b, cfg.ssm.d_conv - 1, di)
    # a prefill ignores the state it is given (it pads with zeros)
    junk = rng.standard_normal(conv_shape).astype(np.float32)
    jstate = {"conv": jnp.asarray(junk).astype(jx.dtype),
              "ssm": jnp.ones((b, di, n), jnp.float32)}
    tstate = {"conv": torch.from_numpy(junk).to(dtype),
              "ssm": torch.ones((b, di, n))}
    tol = BLOCK_TOL[dtype]
    with jref.ops.pallas_mode(True, interpret=True):
        jy, jstate = jref.ssm.apply_mamba(jp, "m", jx, jcfg, jstate)
        ty, tstate = ssm.apply_mamba(tp, "m", x, cfg, tstate)
        close(ty, jy, tol, tol, "prefill out")
        for key in ("conv", "ssm"):
            close(tstate[key], jstate[key], tol, tol, f"prefill {key}")
        for _ in range(2):
            jstate["decode"] = tstate["decode"] = True
            jy, jstate = jref.ssm.apply_mamba(jp, "m", jx1, jcfg, jstate)
            ty, tstate = ssm.apply_mamba(tp, "m", x1, cfg, tstate)
            close(ty, jy, tol, tol, "decode out")
            for key in ("conv", "ssm"):
                close(tstate[key], jstate[key], tol, tol, f"decode {key}")
    assert tstate["ssm"].dtype == torch.float32


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_init_from_schema_follows_the_reference_distributions():
    cfg = _cfg(torch.float32)
    schema = M.full_schema(cfg)
    params = M.init_params(cfg, seed=3, device="cpu")
    assert set(params) == set(schema)
    for name, d in schema.items():
        w = params[name]
        assert tuple(w.shape) == d.shape and w.dtype == torch.float32
        if d.init == "zeros":
            assert not w.any(), name
        elif d.init == "ones":
            assert bool((w == 1).all()), name
        elif w.numel() >= 4096:
            std = layers.init_std(d)
            assert abs(float(w.std()) / std - 1) < 0.1, (name, std)
    again = M.init_params(cfg, seed=3, device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_compute_params_casts_what_the_reference_casts():
    cfg = _cfg(torch.bfloat16)
    params = M.init_params(cfg, seed=0, device="cpu")
    cp = M.compute_params(params, cfg, "cpu")
    for name, w in cp.items():
        leaf = name.rsplit(".", 1)[-1]
        want = (torch.float32 if leaf in M.FLOAT32_LEAVES
                else torch.bfloat16)
        assert w.dtype == want, name
        assert torch.equal(w, params[name].to(want))
    assert cp["stack.blk1.mixer.A_log"].dtype == torch.float32
    assert cp["stack.blk1.mixer.conv_b"].dtype == torch.bfloat16


def test_model_params_from_arrays_checks_names_and_shapes():
    cfg = _cfg(torch.float32)
    arrays = {k: v.numpy() for k, v in
              M.init_params(cfg, seed=1, device="cpu").items()}
    out = model_params_from_arrays(arrays, cfg, device="cpu")
    assert all(np.array_equal(out[k].numpy(), arrays[k]) for k in arrays)
    bad = dict(arrays)
    bad.pop("final_norm.scale")
    with pytest.raises(ValueError, match="missing"):
        model_params_from_arrays(bad, cfg, device="cpu")
    bad = dict(arrays, **{"final_norm.scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        model_params_from_arrays(bad, cfg, device="cpu")


@pytest.mark.parametrize("what", ["moe", "rope", "whisper", "mla"])
def test_unported_model_features_raise(what):
    cfg = _cfg(torch.float32)
    if what == "moe":
        cfg = get_smoke_config("jamba-1.5-large-398b")
    elif what == "rope":
        cfg = get_smoke_config("llama3.2-1b")
    elif what == "whisper":         # encoder-decoder, xattn blocks
        cfg = get_smoke_config("whisper-small")
    else:
        cfg = dataclasses.replace(get_smoke_config("minicpm3-4b"), moe=None)
    with pytest.raises(NotImplementedError, match="not ported"):
        M.init_params(cfg, device="cpu")


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain versions (on a card only)
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these at width)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_flash_kernel_matches_plain_on_card():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    for (b, sq, sk_, h, kh, d) in [(2, 200, 200, 8, 1, 64),
                                   (1, 130, 130, 4, 4, 128),
                                   (2, 64, 96, 8, 2, 32),
                                   (1, 300, 257, 8, 2, 128)]:
        for causal in (True, False):
            for dtype in DTYPES:
                q = torch.randn(b, sq, h, d, generator=g, device=dev)
                k = torch.randn(b, sk_, kh, d, generator=g, device=dev)
                v = torch.randn(b, sk_, kh, d, generator=g, device=dev)
                q, k, v = (x.to(dtype) for x in (q, k, v))
                got = fk.flash_attention(q, k, v, causal=causal)
                want = ref.flash_attention(q, k, v, causal=causal)
                tol = CARD_TOL[dtype]
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=tol, rtol=tol)


@pytest.mark.cuda
def test_ssm_kernel_matches_plain_on_card():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    for (b, s, di, n) in [(2, 37, 300, 16), (1, 1, 128, 4), (3, 70, 64, 8)]:
        for dtype in DTYPES:
            x = (torch.randn(b, s, di, generator=g, device=dev) * .5)
            dt = torch.nn.functional.softplus(
                torch.randn(b, s, di, generator=g, device=dev) - 1)
            B, C = (torch.randn(b, s, n, generator=g, device=dev) * .5
                    for _ in range(2))
            A = -torch.exp(torch.randn(di, n, generator=g, device=dev) * .5)
            D = torch.randn(di, generator=g, device=dev)
            st = torch.randn(b, di, n, generator=g, device=dev) * .1
            x, dt, B, C = (t.to(dtype) for t in (x, dt, B, C))
            got = sk.ssm(x, dt, A, B, C, D, st)
            want = ref.ssm_scan(x, dt, A, B, C, D, st)
            tol = CARD_TOL[dtype]
            for a, w in zip(got, want):
                torch.testing.assert_close(a.float(), w.float(), atol=tol,
                                           rtol=tol)
