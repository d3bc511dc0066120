"""The port's RWKV-6 slice on the CPU against the reference.

* The plain WKV recurrence (``repro_torch.kernels.ref.rwkv6_scan``)
  against the JAX package's oracle ``ref.rwkv6_scan`` and its Pallas
  kernel ``rwkv6_kernel.rwkv6`` in interpret mode, at the shapes of
  ``tests/test_kernels.py`` with a carried-in state; the state carried
  across split runs and decode steps; and the strong-decay case, where
  the Pallas kernel departs from the oracle (ROADMAP C10) and the port
  follows the oracle.
* A test-local float32 model of the chunked card kernel's form (decay
  factors all <= 1, factored around a point inside the chunk) against
  the oracle at mean log w -1, -5 and -6, and the same form with its
  matrix products from TF32 parts (3xTF32, the low 13 mantissa bits
  masked) keeping the state at float32's tolerance.
* The time-mix and channel-mix blocks and LayerNorm against
  ``repro.models.rwkv6`` / ``repro.models.layers`` under
  ``ops.pallas_mode(True, interpret=True)``, in prefill and in decode.
* ``compute_params`` and ``model_params_from_arrays`` on the rwkv6
  parameters.
* The rwkv6 smoke slice (2 and 4 layers) served by the port's
  ``ServeEngine`` against the reference's jitted ``prefill`` /
  ``decode_step`` under Pallas, with no mesh and the engine's padding
  re-created (ROADMAP C7), as ``tests/test_torch_serve.py`` does for
  Jamba.

All inputs come from numpy seeds; parameters are drawn once by the
reference and converted. Bfloat16 inputs are rounded once and handed to
both sides as the same values. Tolerances are max |got - want| /
(1 + |want|), used as atol = rtol, each measured and set above it:

* plain WKV against the oracle: float32 1e-5 (measured 8.4e-7 on the
  output, 7.0e-8 on the state: the same float32 recurrence, summed in
  another order), bfloat16 2^-7, one bf16 step of the output (measured
  3.0e-5);
* the chunked form against the oracle: float32 1e-5 on output and state
  (measured at most 3.2e-6 and 3.8e-7; with 3xTF32 products 1.7e-6 and
  1.0e-6, where one TF32 product leaves the state 5.9e-4 off);
* plain WKV against the Pallas kernel: float32 2e-5 (measured 4.3e-6:
  the kernel factors each chunk into matrix products over cumulative
  decays), bfloat16 2^-7 (measured 2.5e-3); the JAX package's own test
  allows 2e-4 / 3e-2 with rtol 0.1;
* blocks: float32 1e-5 (measured 3.1e-6, the time mix's prefill output),
  bfloat16 2e-2 (measured 1.1e-2 for the time mix, 6.3e-3 for the
  channel mix; XLA keeps float32 inside fused bf16 elementwise chains,
  PyTorch rounds after each operation, ROADMAP C9); the states agree
  within 1e-6 in both (measured 5.5e-7), LayerNorm within 1e-6 in
  float32 (measured 1.8e-7) and exactly in bf16;
* the slice's logits: float32 5e-5 with equal greedy tokens (measured
  1.2e-5 at 2 layers, 1.5e-5 at 4), bfloat16 0.15 (measured 6.7e-2 and
  9.4e-2 on logits of magnitude ~3, ROADMAP C9).

The last test holds the CUDA kernel against the plain version and runs
only where a card is visible (``python3 chip_smoke.py`` covers it at the
serving path's widths).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.convert import model_params_from_arrays
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import rwkv6_kernel as rk
from repro_torch.models import layers, rwkv6
from repro_torch.models import model as M
from repro_torch.serve.engine import Request, ServeEngine

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import model_ref as jref  # noqa: F401
from torch_port_ref import both, f32

BF16_STEP = 2.0 ** -7
ORACLE_TOL = {torch.float32: 1e-5, torch.bfloat16: BF16_STEP}
PALLAS_TOL = {torch.float32: 2e-5, torch.bfloat16: BF16_STEP}
BLOCK_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
STATE_TOL = 1e-6
NORM_TOL = {torch.float32: 1e-6, torch.bfloat16: 0.0}
LOGIT_TOL = {"float32": 5e-5, "bfloat16": 0.15}
#: the CUDA kernel against the plain version on the card, as chip_smoke.py
CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: BF16_STEP}
DTYPES = [torch.float32, torch.bfloat16]
SLOTS, MAX_LEN, MAX_NEW = 2, 32, 5
PROMPTS = ([3, 17, 5, 9, 2, 11, 7, 4, 250],
           [int(t) for t in np.random.default_rng(0).integers(1, 256, 20)])


def close(got, want, tol, what=""):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol,
                               err_msg=what)


def rel_err(got, want) -> float:
    g, w = f32(got), f32(want)
    return float(np.max(np.abs(g - w) / (1 + np.abs(w))))


def wkv_inputs(jref, b, s, h, n, dtype, seed=0, log_w=None):
    """(jax operands, torch operands) r, k, v, w, u, state. ``log_w``
    None draws the JAX test's decays (w = exp(-exp(N(-0.5, 0.5)))); a
    number draws per-step log w around that mean (spread 0.5)."""
    rng = np.random.default_rng(seed)
    jr, r = both(jref, rng.standard_normal((b, s, h, n)) * 0.5, dtype)
    jk, k = both(jref, rng.standard_normal((b, s, h, n)) * 0.5, dtype)
    jv, v = both(jref, rng.standard_normal((b, s, h, n)) * 0.5, dtype)
    z = rng.standard_normal((b, s, h, n))
    w = (np.exp(-np.exp(z * 0.5 - 0.5)) if log_w is None
         else np.exp(log_w + 0.5 * z))
    jw, w = both(jref, w, dtype)
    u = (rng.standard_normal((h, n)) * 0.3).astype(np.float32)
    st = (rng.standard_normal((b, h, n, n)) * 0.1).astype(np.float32)
    jnp = jref.jax.numpy
    return ((jr, jk, jv, jw, jnp.asarray(u), jnp.asarray(st)),
            (r, k, v, w, torch.from_numpy(u), torch.from_numpy(st)))


# ---------------------------------------------------------------------------
# the plain WKV recurrence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,n,chunk", [
    (2, 64, 2, 16, 16), (1, 128, 4, 32, 32), (2, 96, 2, 64, 16),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_wkv_matches_oracle_and_pallas(jref, b, s, h, n, chunk,
                                             dtype):
    j, t = wkv_inputs(jref, b, s, h, n, dtype)
    out, st = ref.rwkv6_scan(*t)
    assert out.dtype == dtype and out.shape == (b, s, h, n)
    assert st.dtype == torch.float32 and st.shape == (b, h, n, n)
    want, want_st = jref.ref.rwkv6_scan(*j)
    close(out, want, ORACLE_TOL[dtype], "out vs oracle")
    close(st, want_st, ORACLE_TOL[torch.float32], "state vs oracle")
    got_p, st_p = jref.rwkv6_kernel.rwkv6(*j, chunk=chunk, interpret=True)
    close(out, got_p, PALLAS_TOL[dtype], "out vs Pallas")
    close(st, st_p, PALLAS_TOL[torch.float32], "state vs Pallas")


def test_plain_wkv_state_carry(jref):
    """``state=None`` is a zero state; a run split in two with the state
    carried across equals the whole run; s = 1 steps fed their state
    equal the prefill of the same tokens; the state passed in is not
    modified."""
    j, t = wkv_inputs(jref, 2, 24, 2, 16, torch.float32, seed=3)
    r, k, v, w, u, st = t
    full, s_full = ref.rwkv6_scan(r, k, v, w, u)
    zero, s_zero = ref.rwkv6_scan(r, k, v, w, u, torch.zeros(2, 2, 16, 16))
    assert torch.equal(full, zero) and torch.equal(s_full, s_zero)
    st0 = st.clone()
    whole, s_whole = ref.rwkv6_scan(r, k, v, w, u, st)
    assert torch.equal(st, st0)
    o1, s1 = ref.rwkv6_scan(r[:, :10], k[:, :10], v[:, :10], w[:, :10], u,
                            st)
    o2, s2 = ref.rwkv6_scan(r[:, 10:], k[:, 10:], v[:, 10:], w[:, 10:], u,
                            s1)
    assert torch.equal(torch.cat([o1, o2], 1), whole)
    assert torch.equal(s2, s_whole)
    state, steps = st, []
    for i in range(24):
        o, state = ref.rwkv6_scan(r[:, i:i + 1], k[:, i:i + 1],
                                  v[:, i:i + 1], w[:, i:i + 1], u, state)
        steps.append(o)
    assert torch.equal(torch.cat(steps, 1), whole)
    assert torch.equal(state, s_whole)
    # the reference's split run lands on the same state
    jr, jk, jv, jw, ju, jst = j
    _, js1 = jref.ref.rwkv6_scan(jr[:, :10], jk[:, :10], jv[:, :10],
                                 jw[:, :10], ju, jst)
    jo2, js2 = jref.ref.rwkv6_scan(jr[:, 10:], jk[:, 10:], jv[:, 10:],
                                   jw[:, 10:], ju, js1)
    tol = ORACLE_TOL[torch.float32]
    close(o2, jo2, tol, "second half")
    close(s2, js2, tol, "carried state")


@pytest.mark.parametrize("log_w", [-1.0, -3.0, -5.0, -6.0])
def test_plain_wkv_follows_the_oracle_at_strong_decay(jref, log_w):
    """Per-step log w around -5 or -6 (w below e^-5 every step of a
    16-step chunk): the port's plain version still equals the oracle
    within its tolerance. The Pallas kernel's exponent clamp
    (``rwkv6_kernel.py``:51-56) drops pair terms there and departs from
    the oracle by far more than its own tolerance; at log w around -1 and
    -3 it agrees. The record of that departure is ROADMAP C10."""
    j, t = wkv_inputs(jref, 1, 32, 2, 16, torch.float32, seed=4,
                      log_w=log_w)
    out, st = ref.rwkv6_scan(*t)
    want, want_st = jref.ref.rwkv6_scan(*j)
    tol = ORACLE_TOL[torch.float32]
    close(out, want, tol, "out vs oracle")
    close(st, want_st, tol, "state vs oracle")
    got_p, st_p = jref.rwkv6_kernel.rwkv6(*j, chunk=16, interpret=True)
    pallas_err = rel_err(got_p, want)
    if log_w > -4:
        assert pallas_err <= PALLAS_TOL[torch.float32], pallas_err
    else:
        # the Pallas kernel's departure (ROADMAP C10), kept on record
        assert pallas_err > 100 * PALLAS_TOL[torch.float32], pallas_err
        assert rel_err(st_p, want_st) > 100 * PALLAS_TOL[torch.float32]


def tf32_split(x):
    """x as a TF32 high part and a TF32 remainder (the low 13 mantissa
    bits cleared), as the card kernel splits its operands."""
    def tf32(a):
        return (a.view(torch.int32) & ~0x1FFF).view(torch.float32)
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_3xtf32(a, b):
    """a @ b from TF32 parts: hi hi + hi lo + lo hi (lo lo dropped)."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def chunked_wkv(r, k, v, w, u, state=None, chunk=32, sub=16, mm=None):
    """The chunked card kernel's factorization, written out in float32.

    Per chunk, with c the chunk-local inclusive cumulative sum of log2 w
    (c_{-1} = 0): inter (r_t 2^c_{t-1}) S0; the intra pairs s < t with
    weight 2^(c_{t-1} - c_s), a key before the query sub-block at q0
    factored around q0 - 1 (both factors <= 1), the diagonal sub-blocks
    elementwise, the bonus on their diagonal; the state
    diag(2^c_last) S0 + (k 2^(c_last - c))^T v. ``mm`` multiplies the
    matrix products (torch.matmul, or ``mm_3xtf32``)."""
    mm = mm or torch.matmul
    b, s, h, n = r.shape
    rf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (r, k, v))
    lw = torch.log2(w.float().clamp_min(torch.finfo(torch.float32).tiny))
    lw = lw.permute(0, 2, 1, 3)                              # [b, h, s, n]
    S = (torch.zeros(b, h, n, n) if state is None else state.float())
    u4 = u.float()[None, :, None, :]
    out = torch.empty(b, h, s, n)
    for t0 in range(0, s, chunk):
        T = min(chunk, s - t0)
        rc, kc, vc = (x[:, :, t0:t0 + T] for x in (rf, kf, vf))
        c = torch.cumsum(lw[:, :, t0:t0 + T], dim=2)
        cp = torch.cat([torch.zeros_like(c[:, :, :1]), c[:, :, :-1]], 2)
        cl = c[:, :, -1:]
        o = mm(rc * torch.exp2(cp), S)
        A = torch.zeros(b, h, T, T)
        for q0 in range(0, T, sub):
            q1 = min(q0 + sub, T)
            if q0:
                ref_c = c[:, :, q0 - 1:q0]
                rq = rc[:, :, q0:q1] * torch.exp2(cp[:, :, q0:q1] - ref_c)
                kq = kc[:, :, :q0] * torch.exp2(ref_c - c[:, :, :q0])
                A[:, :, q0:q1, :q0] = mm(rq, kq.transpose(-1, -2))
            diff = cp[:, :, q0:q1, None, :] - c[:, :, None, q0:q1, :]
            below = torch.ones(q1 - q0, q1 - q0).tril(-1).bool()
            wgt = torch.where(below[..., None], torch.exp2(diff), 0.0)
            A[:, :, q0:q1, q0:q1] = torch.einsum(
                "bhti,bhsi,bhtsi->bhts", rc[:, :, q0:q1], kc[:, :, q0:q1],
                wgt)
            idx = torch.arange(q0, q1)
            A[:, :, idx, idx] = (rc[:, :, q0:q1] * u4 * kc[:, :, q0:q1]).sum(-1)
        out[:, :, t0:t0 + T] = o + mm(A, vc)
        S = (torch.exp2(cl).transpose(-1, -2) * S
             + mm((kc * torch.exp2(cl - c)).transpose(-1, -2), vc))
    return out.permute(0, 2, 1, 3).to(r.dtype), S


@pytest.mark.parametrize("chunk,sub", [(16, 16), (64, 16), (32, 8)])
@pytest.mark.parametrize("log_w", [-1.0, -5.0, -6.0])
def test_chunked_factorization_follows_the_oracle(jref, chunk, sub, log_w):
    """The card kernel's chunked form (every decay factor <= 1, factored
    around a point inside the chunk) stays within float32's 1e-5 of the
    oracle's recurrence at every decay: a carried-in state, a ragged last
    chunk (s = 100), mean log w -1, -5 and -6, chunks of 16 and 64 steps
    in sub-blocks of 16 and the kernel's own 32 in sub-blocks of 8. The
    Pallas kernel's form is off by far more at -5 and -6 (ROADMAP C10;
    the test above)."""
    j, t = wkv_inputs(jref, 1, 100, 2, 16, torch.float32, seed=4,
                      log_w=log_w)
    out, st = chunked_wkv(*t, chunk=chunk, sub=sub)
    want, want_st = jref.ref.rwkv6_scan(*j)
    tol = ORACLE_TOL[torch.float32]
    close(out, want, tol, "out vs oracle")
    close(st, want_st, tol, "state vs oracle")


@pytest.mark.parametrize("log_w", [None, -6.0])
def test_chunked_3xtf32_keeps_the_state_at_float32(jref, log_w):
    """The same form with every matrix product from TF32 parts (3xTF32,
    as on the card's tensor cores; the kernel's 32-step chunks and 8-step
    sub-blocks at its head dim 64) keeps the final state and the output
    within float32's 1e-5 of the oracle; one TF32 product (hi hi only)
    does not."""
    j, t = wkv_inputs(jref, 1, 96, 2, 64, torch.float32, seed=5,
                      log_w=log_w)
    want, want_st = jref.ref.rwkv6_scan(*j)
    out, st = chunked_wkv(*t, chunk=32, sub=8, mm=mm_3xtf32)
    tol = ORACLE_TOL[torch.float32]
    close(st, want_st, tol, "state vs oracle")
    close(out, want, tol, "out vs oracle")
    _, st1 = chunked_wkv(*t, chunk=32, sub=8,
                         mm=lambda a, b: tf32_split(a)[0] @ tf32_split(b)[0])
    assert rel_err(st1, want_st) > tol


# ---------------------------------------------------------------------------
# the wrapper and the dispatch
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """On CPU tensors ``ops.rwkv6_scan`` is the plain version, prefill
    and decode alike: it never builds the kernel and counts no launch."""
    def no_build(*a, **k):
        raise AssertionError("a CPU call reached the CUDA build")
    monkeypatch.setattr(build, "load", no_build)
    rk.reset_launches()
    g = torch.Generator().manual_seed(5)
    r, k, v = (torch.randn(2, 7, 3, 16, generator=g).bfloat16()
               for _ in range(3))
    w = torch.rand(2, 7, 3, 16, generator=g).bfloat16()
    u = torch.randn(3, 16, generator=g)
    st = torch.randn(2, 3, 16, 16, generator=g)
    for sl in (slice(0, 7), slice(3, 4)):
        got = ops.rwkv6_scan(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u, st)
        want = ref.rwkv6_scan(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u, st)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert rk.launches == {"rwkv6_chunked": 0, "rwkv6_scan": 0}


def test_wrapper_refuses_what_the_kernel_does_not_take():
    g = torch.Generator().manual_seed(6)
    r = torch.randn(1, 4, 2, 16, generator=g)
    u = torch.randn(2, 16, generator=g)
    rk._check_operands(r, r, r, r, u, None)
    rk._check_operands(r, r, r, r, u, torch.zeros(1, 2, 16, 16))
    with pytest.raises(ValueError, match="k must be"):
        rk._check_operands(r, r[:, :3], r, r, u, None)
    with pytest.raises(ValueError, match="state must be"):
        rk._check_operands(r, r, r, r, u, torch.zeros(1, 2, 16, 8))
    r8 = torch.randn(1, 4, 2, 8, generator=g)
    with pytest.raises(NotImplementedError, match="head dim 8"):
        rk._check_operands(r8, r8, r8, r8, u[:, :8], None)
    with pytest.raises(TypeError, match="share"):
        rk._check_operands(r, r, r.bfloat16(), r, u, None)
    with pytest.raises(TypeError, match="u must be float32"):
        rk._check_operands(r, r, r, r, u.bfloat16(), None)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _cfgs(jref, dtype):
    name = str(dtype).split(".")[-1]
    return (dataclasses.replace(get_smoke_config("rwkv6-7b"), dtype=name),
            dataclasses.replace(jref.configs.get_smoke_config("rwkv6-7b"),
                                dtype=name))


def _block_params(jref, schema, seed):
    """Reference-drawn float32 parameters for ``schema`` as (jax, torch),
    the leaves it initialises to zeros or ones drawn at random too, so
    that every leaf matters."""
    jnp = jref.jax.numpy
    jp = jref.layers.init_from_schema(schema, jref.jax.random.PRNGKey(seed),
                                      jnp.float32)
    jp = dict(jp)
    rng = np.random.default_rng(seed)
    for name, d in schema.items():
        if d.init in ("zeros", "ones"):
            base = 1.0 if d.init == "ones" else 0.0
            jp[name] = jnp.asarray(
                (base + 0.3 * rng.standard_normal(d.shape)).astype(
                    np.float32))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@pytest.mark.parametrize("block", ["time_mix", "channel_mix"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_blocks_prefill_and_decode(jref, block, dtype):
    """A prefill from a state it must ignore (it shifts in zeros and
    starts from a zero WKV state), then two decode steps that read it."""
    cfg, jcfg = _cfgs(jref, dtype)
    jnp = jref.jax.numpy
    if block == "time_mix":
        schema, name = rwkv6.rwkv_schema(cfg, "m"), "m"
        jfn, fn = jref.rwkv6.apply_time_mix, rwkv6.apply_time_mix
    else:
        schema, name = rwkv6.channel_mix_schema(cfg, "c"), "c"
        jfn, fn = jref.rwkv6.apply_channel_mix, rwkv6.apply_channel_mix
    assert set(schema) == set(
        (jref.rwkv6.rwkv_schema if block == "time_mix"
         else jref.rwkv6.channel_mix_schema)(jcfg, name))
    jp, tp = _block_params(jref, schema, 7)
    rng = np.random.default_rng(8)
    b, t, d = 2, 10, cfg.d_model
    H, n = d // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    jx, x = both(jref, rng.standard_normal((b, t, d)), dtype)
    junk = rng.standard_normal((b, d))
    jstate, tstate = {"wkv": jnp.ones((b, H, n, n), jnp.float32)}, {
        "wkv": torch.ones((b, H, n, n))}
    for key in ("x_att", "x_ffn"):
        jstate[key], tstate[key] = both(jref, junk, dtype)
    tol = BLOCK_TOL[dtype]
    with jref.ops.pallas_mode(True, interpret=True):
        jy, jstate = jfn(jp, name, jx, jcfg, jstate)
        ty, tstate = fn(tp, name, x, cfg, tstate)
        close(ty, jy, tol, "prefill out")
        for step in range(2):
            for key in ("x_att", "x_ffn", "wkv"):
                close(tstate[key], jstate[key], STATE_TOL,
                      f"state {key} after step {step}")
            jx1, x1 = both(jref, rng.standard_normal((b, 1, d)), dtype)
            jstate["decode"] = tstate["decode"] = True
            jy, jstate = jfn(jp, name, jx1, jcfg, jstate)
            ty, tstate = fn(tp, name, x1, cfg, tstate)
            close(ty, jy, tol, f"decode {step} out")
    for key in ("x_att", "x_ffn", "wkv"):
        close(tstate[key], jstate[key], STATE_TOL, f"final state {key}")
    assert tstate["wkv"].dtype == torch.float32
    assert tstate["x_att"].dtype == dtype


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_matches_reference(jref, dtype):
    cfg, jcfg = _cfgs(jref, dtype)
    assert cfg.norm == "layernorm"
    schema = layers.norm_schema(cfg, "n")
    assert set(schema) == {"n.scale", "n.bias"}
    jp, tp = _block_params(jref, schema, 9)
    jx, x = both(jref, np.random.default_rng(9).standard_normal(
        (2, 5, cfg.d_model)) * 3 + 1, dtype)
    got = layers.apply_norm(tp, "n", x, cfg)
    assert got.dtype == dtype
    close(got, jref.layers.apply_norm(jp, "n", jx, jcfg), NORM_TOL[dtype])


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_compute_params_keeps_the_decay_and_bonus_in_float32():
    cfg = dataclasses.replace(get_smoke_config("rwkv6-7b"), dtype="bfloat16")
    params = M.init_params(cfg, seed=0, device="cpu")
    cp = M.compute_params(params, cfg, "cpu")
    for leaf in ("decay_base", "decay_w2", "bonus", "ln_x.scale",
                 "ln_x.bias"):
        name = f"stack.blk0.mixer.{leaf}"
        assert cp[name].dtype == torch.float32, name
        assert torch.equal(cp[name], params[name])
    for leaf in ("mixer.decay_w1", "mixer.maa_w2", "mixer.wr", "cmix.wk",
                 "cmix.mix_k"):
        assert cp[f"stack.blk0.{leaf}"].dtype == torch.bfloat16, leaf
    assert cp["stack.blk0.norm1.bias"].dtype == torch.float32


def test_model_params_from_arrays_carries_the_reference_dict(jref):
    cfg = get_smoke_config("rwkv6-7b")
    jcfg = jref.configs.get_smoke_config("rwkv6-7b")
    jparams = jref.model.init_params(jcfg, jref.jax.random.PRNGKey(1))
    assert set(jparams) == set(M.full_schema(cfg))
    arrays = {k: np.asarray(v) for k, v in jparams.items()}
    out = model_params_from_arrays(arrays, cfg, device="cpu")
    for k, a in arrays.items():
        assert out[k].dtype == torch.float32
        np.testing.assert_array_equal(out[k].numpy(), a, err_msg=k)
    assert out["stack.blk0.mixer.maa_w2"].shape == (cfg.num_layers, 5, 8, 64)
    assert out["stack.blk0.mixer.bonus"].shape == (cfg.num_layers, 4, 16)
    cache = M.init_cache(cfg, 2, 16, device="cpu")
    assert cache["stack.blk0.wkv"].shape == (cfg.num_layers, 2, 4, 16, 16)
    assert cache["stack.blk0.wkv"].dtype == torch.float32
    assert set(cache) == set(jref.model.cache_schema(jcfg, 2, 16))


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

class Recorder:
    """Wraps an engine step and keeps the logits it returns."""

    def __init__(self, step):
        self.step, self.logits = step, []

    def __call__(self, *args):
        logits, cache = self.step(*args)
        self.logits.append(logits.float().numpy())
        return logits, cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_layers", [2, 4])
def test_slice_matches_reference(jref, num_layers, dtype):
    jnp = jref.jax.numpy
    jcfg = dataclasses.replace(jref.configs.get_smoke_config("rwkv6-7b"),
                               num_layers=num_layers, dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config("rwkv6-7b"),
                              num_layers=num_layers, dtype=dtype)
    jparams = jref.model.init_params(jcfg, jref.jax.random.PRNGKey(0))
    params = model_params_from_arrays(
        {k: np.asarray(v) for k, v in jparams.items()}, cfg, device="cpu")

    eng = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                      device="cpu")
    eng._prefill, eng._decode = Recorder(eng._prefill), Recorder(
        eng._decode)
    reqs = [Request(rid=i, prompt=list(p), max_new=MAX_NEW)
            for i, p in enumerate(PROMPTS)]
    eng.process_group(reqs)
    port_logits = eng._prefill.logits + eng._decode.logits
    assert len(port_logits) == MAX_NEW
    tokens = np.array([r.output for r in reqs], np.int32)
    assert tokens.shape == (SLOTS, MAX_NEW)

    # the engine's padding: prompts left-aligned in [slots, max_len // 2]
    plen = MAX_LEN // 2
    padded = np.zeros((SLOTS, plen), np.int32)
    for i, p in enumerate(PROMPTS):
        p = p[-plen:]                       # the second prompt is cut
        padded[i, :len(p)] = p
    prefill = jref.jax.jit(lambda p, b, c: jref.model.prefill(p, jcfg, b, c))
    decode = jref.jax.jit(
        lambda p, c, b: jref.model.decode_step(p, jcfg, c, b))
    with jref.ops.pallas_mode(True, interpret=True):
        cache = jref.model.init_cache(jcfg, SLOTS, MAX_LEN)
        logits, cache = prefill(jparams, {"tokens": jnp.asarray(padded)},
                                cache)
        ref_logits = [np.asarray(logits.astype(jnp.float32))]
        for step in range(1, MAX_NEW):
            tok = jnp.asarray(tokens[:, step - 1:step])
            logits, cache = decode(jparams, cache, {"token": tok})
            ref_logits.append(np.asarray(logits.astype(jnp.float32)))
    tol = LOGIT_TOL[dtype]
    for step, (a, b) in enumerate(zip(port_logits, ref_logits)):
        assert a.shape == b.shape == (SLOTS, 1, cfg.vocab_size)
        assert np.isfinite(a).all()
        close(a, b, tol, f"logits at step {step}")
        if dtype == "float32":
            np.testing.assert_array_equal(b[:, -1].argmax(-1),
                                          tokens[:, step],
                                          err_msg=f"tokens at step {step}")


# ---------------------------------------------------------------------------
# the CUDA kernel against the plain version (on a card only)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_wkv_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this at width)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for (b, s, h, n) in [(2, 37, 3, 16), (1, 1, 4, 64), (3, 70, 2, 32),
                         (2, 300, 3, 64)]:
        for dtype in DTYPES:
            r, k, v = (torch.randn(b, s, h, n, generator=g, device=dev) * .5
                       for _ in range(3))
            w = torch.exp(-torch.exp(
                torch.randn(b, s, h, n, generator=g, device=dev) * .5 - .5))
            u = torch.randn(h, n, generator=g, device=dev) * .3
            st = torch.randn(b, h, n, n, generator=g, device=dev) * .1
            r, k, v, w = (t.to(dtype) for t in (r, k, v, w))
            got = rk.rwkv6(r, k, v, w, u, st)
            want = ref.rwkv6_scan(r, k, v, w, u, st)
            for a, e, tol in zip(got, want, (CARD_TOL[dtype],
                                             CARD_TOL[torch.float32])):
                torch.testing.assert_close(a.float(), e.float(), atol=tol,
                                           rtol=tol)
