"""Registered policy steps with integer and bit-level operations
(ROADMAP C15).

The reference's ``register_policy`` takes any scalar ``jnp`` step that
``jax.vmap`` can derive: integer arithmetic, bit views, ``mod`` and
``floor_divide``, ``nextafter``, ``sin``. The port translates the same
operations into its policy kernels (``kernels/lane_codegen.py``):

* each operation, taken apart into the kernels' scalar operations and
  run as PyTorch operations (``lane_codegen.interpret``), bitwise the
  step itself, on a block of lanes that pairs edge values (NaN, +-inf,
  +-0, INT_MIN, shift counts at and past the width, negative operands of
  ``//`` and ``%``); the transcendental ones (``sin``, ``atan2``,
  ``rsqrt``, ...) land in ``Generated.transcendental``, the card holds
  them to the CPU within an ulp bound (``chip_smoke.py`` phase 11);
* an integer division by zero raises the CPU's ``RuntimeError:
  ZeroDivisionError`` in the interpretation, as in the step;
* ``diurnal`` (an int32 hour of day, ``% 24``, a daily ``sin`` curve),
  ``bw_copy`` (batch_window's own step under a new name: ``_fma``'s
  int64 bit view and ``nextafter``) and ``bits`` (a mantissa bit view,
  shifts, masks, float ``remainder`` and floor division), registered in
  the reference (scalar ``jnp`` steps) and in the port: ``run_grid`` at
  dt = 1 bitwise, ``diurnal``'s latency within ``DIURNAL_REF_RTOL``;
* what stays refused is what the reference refuses too: Python control
  flow on a value, an operation across lanes, a lane index.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import slo as pslo
from repro_torch.core import traffic as ptraffic
from repro_torch.core import twin as ptwin
from repro_torch.core import whatif as pwhatif
from repro_torch.kernels import lane_codegen as cg
from repro_torch.kernels import policy_scan as pk

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import assert_same_results, bits, reference
from test_torch_register_policy import (CAP_HOURS, LATENCY_FIELDS,
                                        lane_block, restored, traffics)

INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1
I64_MIN, I64_MAX = -2 ** 63, 2 ** 63 - 1
EDGE_F32 = [math.nan, math.inf, -math.inf, 0.0, -0.0, 1.0, -1.0, 0.5,
            -0.5, 2.5, -2.5, 3.0, -3.0, 7.0, -7.0, 24.0, 1e-45, -1e-45,
            1e-30, 3e9, -3e9, 2147483520.0, -2147483648.0, 2147483648.0,
            1e20, -1e20, 3.4028235e38, -3.4028235e38, 123.456, -0.75]
EDGE_I32 = [INT_MIN, INT_MIN + 1, INT_MAX, -1, 0, 1, 2, -2, 3, -3, 7, -7,
            24, -24, 31, 32, 33, 63, 64, 100, -100, 12345678, -12345678]
EDGE_I64 = [I64_MIN, I64_MIN + 1, I64_MAX, -1, 0, 1, 2, -2, 7, -7, 24,
            -24, 31, 32, 63, 64, 65, -64, 2 ** 40 + 3, -(2 ** 40) - 3,
            INT_MIN, INT_MAX + 1]


def _words(v: int):
    """An int64 as its (high, low) int32 words."""
    u = v & (2 ** 64 - 1)
    hi, lo = u >> 32, u & (2 ** 32 - 1)
    return [w - 2 ** 32 if w >= 2 ** 31 else w for w in (hi, lo)]


def _as_f32(ints):
    return np.asarray(ints, np.int64).astype(np.int32).view(np.float32)


def pair_block(a_f, b_f, a_i, b_i, a_l, b_l, drop=()):
    """Every pair of each edge list, one pair a lane (cycled where the
    lists differ in length): float32 a, b in ``p[0]``, ``p[1]``; int32
    a, b as the bits of ``c_0``, ``c_1``; int64 a, b as the (high, low)
    words of ``p[2]``, ``p[3]`` and ``p[4]``, ``p[5]``; ``arrive`` 0.
    Integer pairs in ``drop`` are left out."""
    pf = [(x, y) for x in a_f for y in b_f]
    pi = [(x, y) for x in a_i for y in b_i if (x, y) not in drop]
    pl = [(x, y) for x in a_l for y in b_l if (x, y) not in drop]
    lanes = max(len(pf), len(pi), len(pl))

    def cyc(pairs, k):
        return [pairs[i % len(pairs)][k] for i in range(lanes)]
    carry = np.stack([_as_f32(cyc(pi, 0)), _as_f32(cyc(pi, 1))], axis=1)
    wa = np.asarray([_words(v) for v in cyc(pl, 0)])
    wb = np.asarray([_words(v) for v in cyc(pl, 1)])
    params = np.stack([np.asarray(cyc(pf, 0), np.float32),
                       np.asarray(cyc(pf, 1), np.float32),
                       _as_f32(wa[:, 0]), _as_f32(wa[:, 1]),
                       _as_f32(wb[:, 0]), _as_f32(wb[:, 1])], axis=1)
    return (torch.from_numpy(carry), torch.zeros(lanes),
            torch.from_numpy(params))


def _i64(hi, lo):
    return (hi.view(torch.int32).to(torch.int64) << 32) | (
        lo.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)


def _encode(r):
    """A result of any lane type as two float32 slots, bit for bit."""
    if r.dtype == torch.float32:
        return r, r
    if r.dtype == torch.int32:
        return r.view(torch.float32), r.view(torch.float32)
    if r.dtype == torch.bool:
        return r.float(), r.float()
    if r.dtype == torch.float64:           # NaN canonical, as value_bits
        r = torch.where(torch.isnan(r), math.nan, r).view(torch.int64)
    w = r
    return ((w >> 32).to(torch.int32).view(torch.float32),
            w.to(torch.int32).view(torch.float32))


def op_step(kind, fn):
    """A lane step that applies ``fn`` to the block's (a, b) pair of
    ``kind`` (f32, f64: the float32 pair widened, i32, i64) and puts the
    result's bits in the carry and two outputs."""
    def step(carry, arrive, p, dt):
        if kind == "i32":
            a, b = carry[:, 0].view(torch.int32), carry[:, 1].view(
                torch.int32)
        elif kind == "i64":
            a, b = _i64(p[:, 2], p[:, 3]), _i64(p[:, 4], p[:, 5])
        elif kind == "f64":
            a, b = p[:, 0].double(), p[:, 1].double()
        else:
            a, b = p[:, 0], p[:, 1]
        hi, lo = _encode(fn(a, b))
        return (torch.stack([hi, lo], dim=1),
                (lo, hi, arrive, torch.zeros_like(arrive), arrive))
    return step


#: class 1, bitwise: (lane type, name, operation); integer division
#: ops (``DIVIDING``) are run with no zero divisor, shifts with counts at
#: and past the width
EXACT_OPS = [
    ("i32", "add", lambda a, b: a + b), ("i32", "sub", lambda a, b: a - b),
    ("i32", "mul", lambda a, b: a * b), ("i32", "neg", lambda a, b: -a),
    ("i32", "abs", lambda a, b: torch.abs(a)),
    ("i32", "min", torch.minimum), ("i32", "max", torch.maximum),
    ("i32", "lt", torch.lt), ("i32", "le", torch.le),
    ("i32", "eq", torch.eq), ("i32", "ne", torch.ne),
    ("i32", "and", lambda a, b: a & b), ("i32", "or", lambda a, b: a | b),
    ("i32", "xor", lambda a, b: a ^ b), ("i32", "not", lambda a, b: ~a),
    ("i32", "shl", lambda a, b: a << b), ("i32", "shr", lambda a, b: a >> b),
    ("i32", "shl_scalar", lambda a, b: a << 3),
    ("i32", "floordiv", lambda a, b: a // b),
    ("i32", "mod", lambda a, b: a % b),
    ("i32", "mod_scalar", lambda a, b: a % 24),
    ("i32", "fmod", torch.fmod),
    ("i32", "div_trunc", lambda a, b: torch.div(a, b, rounding_mode="trunc")),
    ("i32", "div_floor", lambda a, b: torch.div(a, b, rounding_mode="floor")),
    ("i32", "true_div", lambda a, b: a / b),
    ("i32", "sign", lambda a, b: torch.sign(a)),
    ("i32", "signbit", lambda a, b: torch.signbit(a)),
    ("i32", "isfinite", lambda a, b: torch.isfinite(a)),
    ("i32", "clamp", lambda a, b: torch.clamp(a, -5, 24)),
    ("i32", "to_f32", lambda a, b: a.float()),
    ("i32", "to_f64", lambda a, b: a.double()),
    ("i32", "to_i64", lambda a, b: a.long()),
    ("i32", "to_bool", lambda a, b: a.bool()),
    ("i32", "bool_to_int", lambda a, b: (a > b).int() + (a < 0).long()),
    ("i32", "mixed_f32", lambda a, b: a + 0.5),
    ("i32", "square", lambda a, b: a * a + a ** 2),
    ("i32", "where", lambda a, b: torch.where(a > b, a, 7)),
    ("i64", "add", lambda a, b: a + b), ("i64", "sub", lambda a, b: a - b),
    ("i64", "mul", lambda a, b: a * b), ("i64", "neg", lambda a, b: -a),
    ("i64", "abs", lambda a, b: torch.abs(a)),
    ("i64", "min", torch.minimum), ("i64", "max", torch.maximum),
    ("i64", "lt", torch.lt), ("i64", "and", lambda a, b: a & b),
    ("i64", "or", lambda a, b: a | b), ("i64", "xor", lambda a, b: a ^ b),
    ("i64", "not", lambda a, b: ~a),
    ("i64", "shl", lambda a, b: a << b), ("i64", "shr", lambda a, b: a >> b),
    ("i64", "floordiv", lambda a, b: a // b),
    ("i64", "mod", lambda a, b: a % b), ("i64", "fmod", torch.fmod),
    ("i64", "div_trunc", lambda a, b: torch.div(a, b, rounding_mode="trunc")),
    ("i64", "sign", lambda a, b: torch.sign(a)),
    ("i64", "to_i32", lambda a, b: a.int()),
    ("i64", "to_f32", lambda a, b: a.float()),
    ("i64", "to_f64", lambda a, b: a.double()),
    ("i64", "view_f64", lambda a, b: a.view(torch.float64)),
    ("f32", "remainder", torch.remainder),
    ("f32", "mod_scalar", lambda a, b: a % 7.0),
    ("f32", "fmod", torch.fmod), ("f32", "floordiv", lambda a, b: a // b),
    ("f32", "div_floor", lambda a, b: torch.div(a, b, rounding_mode="floor")),
    ("f32", "div_trunc", lambda a, b: torch.div(a, b, rounding_mode="trunc")),
    ("f32", "nextafter", torch.nextafter), ("f32", "copysign",
                                            torch.copysign),
    ("f32", "sign", lambda a, b: torch.sign(a)),
    ("f32", "signbit", lambda a, b: torch.signbit(a)),
    ("f32", "isnan", lambda a, b: torch.isnan(a)),
    ("f32", "isinf", lambda a, b: torch.isinf(a)),
    ("f32", "isfinite", lambda a, b: torch.isfinite(a)),
    ("f32", "frac", lambda a, b: torch.frac(a)),
    ("f32", "to_i32", lambda a, b: a.int()),
    ("f32", "to_i64", lambda a, b: a.long()),
    ("f32", "view_i32", lambda a, b: a.view(torch.int32)),
    ("f32", "mantissa", lambda a, b: (a.view(torch.int32) & 0x7FFFFF) >> 13),
    ("f64", "remainder", torch.remainder),
    ("f64", "floordiv", lambda a, b: a // b),
    ("f64", "nextafter", torch.nextafter),
    ("f64", "to_i32", lambda a, b: a.int()),
    ("f64", "to_i64", lambda a, b: a.long()),
    ("f64", "view_i64", lambda a, b: a.view(torch.int64)),
    ("f64", "frac_sign", lambda a, b: torch.frac(a) + torch.sign(b)),
]
#: class 2, CUDA's functions within an ulp bound on the card
TRANSCENDENTAL_OPS = [
    (kind, name, fn) for kind in ("f32", "f64") for name, fn in (
        ("sin", lambda a, b: torch.sin(a)), ("cos", lambda a, b: torch.cos(a)),
        ("tan", lambda a, b: torch.tan(a)),
        ("atan", lambda a, b: torch.atan(a)), ("atan2", torch.atan2),
        ("exp2", lambda a, b: torch.exp2(a)),
        ("log2", lambda a, b: torch.log2(a)),
        ("log10", lambda a, b: torch.log10(a)),
        ("erf", lambda a, b: torch.erf(a)), ("hypot", torch.hypot),
        ("sinh", lambda a, b: torch.sinh(a)),
        ("cosh", lambda a, b: torch.cosh(a)),
        ("rsqrt", lambda a, b: torch.rsqrt(a)))]
DIVIDING = {"floordiv", "mod", "fmod", "div_trunc", "div_floor", "mod_scalar"}


def _nonzero(values):
    return [v for v in values if v != 0]


def edge_block(kind, name, zero=False):
    """``pair_block`` of the edge values for operation ``name`` of
    ``kind``; with ``zero``, an integer division's divisors include 0."""
    shifts = name in ("shl", "shr")
    divides = kind in ("i32", "i64") and name in DIVIDING
    nonzero = divides and not zero
    b_i = ([-1, 0, 1, 13, 31, 32, 33, 64, 100, -100, INT_MIN] if shifts
           else _nonzero(EDGE_I32) if nonzero else EDGE_I32)
    b_l = ([-1, 0, 1, 31, 32, 63, 64, 65, 200, -200, I64_MIN] if shifts
           else _nonzero(EDGE_I64) if nonzero else EDGE_I64)
    # the CPU's integer division traps (SIGFPE) on the type's minimum by
    # -1, which the kernels give as neg's wrap and remainder 0
    drop = {(INT_MIN, -1), (I64_MIN, -1)} if divides else ()
    return pair_block(EDGE_F32, EDGE_F32, EDGE_I32, b_i, EDGE_I64, b_l,
                      drop)


def value_bits(x):
    """The bits of a float32 array, every NaN as the one canonical NaN: a
    NaN's payload is no value (ATen's CPU kernels give a NaN operand's
    payload through a strided loop and 0x7fc00000 through a vectorized
    one, CUDA 0x7fffffff), every other bit pattern is compared."""
    x = np.array(x, np.float32)
    x[np.isnan(x)] = np.nan
    return bits(x)


def _assert_interpretation_is_the_step(step, block, dt=1.0):
    prog = cg.translate(step)
    carry, arrive, params = block
    dtt = torch.tensor(dt, dtype=torch.float32)
    want_c, want = step(carry, arrive, params, dtt)
    got_c, got = cg.interpret(prog, carry, arrive, params, dtt)
    np.testing.assert_array_equal(value_bits(got_c.numpy()),
                                  value_bits(want_c.numpy()))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            value_bits(g.numpy()),
            value_bits(w.expand(arrive.shape[0]).numpy()))
    assert all(isinstance(cg._c_expr(i), str) for i in prog.instrs)
    return prog


@pytest.mark.parametrize("kind, name, fn", EXACT_OPS,
                         ids=[f"{k}-{n}" for k, n, _ in EXACT_OPS])
def test_exact_operation_interprets_bitwise(kind, name, fn):
    """Class 1: the translation, run as its scalar operations (ATen's
    formulas taken apart), is bitwise the step on every edge pair, and
    uses no operation of ``TRANSCENDENTAL``."""
    step = op_step(kind, fn)
    prog = _assert_interpretation_is_the_step(step, edge_block(kind, name))
    ops = {i.op for i in prog.instrs}
    assert not ops & set(cg.TRANSCENDENTAL), ops
    src = cg.emit_function(prog, "f", name)
    assert "__fmaf" not in src and "fmaf(" not in src
    if kind in ("i32", "i64") and name in DIVIDING - {"mod_scalar"}:
        assert cg.INT_DIV_FLAG in src


@pytest.mark.parametrize("kind, name, fn", TRANSCENDENTAL_OPS,
                         ids=[f"{k}-{n}" for k, n, _ in TRANSCENDENTAL_OPS])
def test_transcendental_operation_interprets_bitwise(kind, name, fn):
    """Class 2: CUDA's function of the operand's type; the interpretation
    is bitwise the step on the CPU, and the op is listed as
    transcendental."""
    step = op_step(kind, fn)
    prog = _assert_interpretation_is_the_step(step, edge_block(kind, name))
    assert name in {i.op for i in prog.instrs}
    fn_name = name + ("f" if kind == "f32" else "")
    assert f"{fn_name}(" in cg.emit_function(prog, "f", name)


@pytest.mark.parametrize("kind", ["i32", "i64"])
@pytest.mark.parametrize("name", ["floordiv", "mod", "fmod", "div_trunc"])
def test_integer_division_by_zero_raises_like_the_cpu(kind, name):
    """An integer divisor of 0: the CPU raises ``RuntimeError:
    ZeroDivisionError``; so does the interpretation, and the emitted
    division sets the kernels' flag instead of giving a value (the
    wrapper raises the same error after the launch)."""
    fn = dict((n, f) for k, n, f in EXACT_OPS if k == kind)[name]
    step = op_step(kind, fn)
    carry, arrive, params = edge_block(kind, name, zero=True)
    dtt = torch.tensor(1.0)
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        step(carry, arrive, params, dtt)
    prog = cg.translate(step)
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        cg.interpret(prog, carry, arrive, params, dtt)
    src = cg.emit_function(prog, "f", name)
    assert f"{cg.INT_DIV_FLAG} = 1" in src


def test_float_to_int_casts_give_the_x86_results():
    """NaN, +-inf and out-of-range floats become INT_MIN (int32) or
    INT64_MIN, as x86's truncating conversion gives them to PyTorch;
    the emitted cast tests the range rather than saturate as CUDA's
    intrinsics do."""
    x = torch.tensor([math.nan, math.inf, -math.inf, 3e9, -3e9, 2.5, -2.5,
                      2147483520.0, 2147483648.0, 1e19, -1e19])
    assert x.int().tolist()[:5] == [INT_MIN] * 5
    assert x.double().int().tolist()[:5] == [INT_MIN] * 5
    assert x.long().tolist()[:3] == [I64_MIN] * 3
    assert x.long().tolist()[-2:] == [I64_MIN] * 2
    prog = cg.translate(op_step("f32", lambda a, b: a.int()))
    cast = next(i for i in prog.instrs if i.op == "cast" and i.dtype == "i32")
    assert cg._c_expr(cast).endswith("(-2147483647 - 1)")


def test_xla_exp_translates_bitwise():
    """``_xla_exp`` (an int32 exponent shifted into a float32 bit view)
    is exact operations only."""
    def step(carry, arrive, p, dt):
        e = ptwin._xla_exp(p[:, 0] - 4.0)
        return carry, (e, arrive, p[:, 2], p[:, 1], arrive)
    carry, arrive, params = lane_block(seed=7)
    params[:3, 0] = torch.tensor([-200.0, 95.0, 4.0])
    prog = _assert_interpretation_is_the_step(step, (carry, arrive, params))
    assert not {i.op for i in prog.instrs} & set(cg.TRANSCENDENTAL)


# ---------------------------------------------------------------------------
# registered policies: the reference and the port
# ---------------------------------------------------------------------------

TRIPLE = ("max_rps", "usd_per_hour", "base_latency_s")
TWO_PI_24 = 2.0 * math.pi / 24.0


def diurnal_step(carry, arrive, p, dt):
    """Capacity follows the hour of the day: an int32 hour from the timer
    in the carry, ``% 24``, a ``sin`` daily curve; instances ceil(3.3 +
    2.2 sin) stay 0.1 or more from an integer at every hour, so an ulp
    of ``sin`` never moves the capacity, and only the latency's ``sin``
    term differs from the CPU within an ulp bound."""
    timer = carry[:, 1] + dt
    hour = timer.to(torch.int32) % 24
    s = torch.sin(hour.float() * TWO_PI_24)
    inst = torch.ceil(3.3 + 2.2 * s)
    cap = torch.clamp_min(p[:, 0] * inst * CAP_HOURS * dt, 1.0)
    avail = carry[:, 0] + arrive
    proc = torch.minimum(avail, cap)
    queue = avail - proc
    lat = p[:, 2] + queue / cap + (2.0 + s) * 64.0
    new = torch.stack([queue, timer], dim=1)
    return new, (proc, queue, lat, p[:, 1] * inst * dt,
                 torch.zeros_like(arrive))


def bits_step(carry, arrive, p, dt):
    """A capped queue whose latency takes a jitter from its queue's
    float32 bits (mantissa and exponent by shifts and masks, integer
    floor division and ``%`` of negative values) and a phase by float
    ``remainder``; its cost a float floor division of a signed load.
    Its constant factors are powers of two: with ``phase / 100`` the
    reference's XLA scan rounded the latency an ulp apart from ATen's at
    some bins, and an exact product rounds alike fused into an add or
    not."""
    cap = torch.clamp_min(p[:, 0] * CAP_HOURS * dt, 1.0)
    avail = carry[:, 0] + arrive
    proc = torch.minimum(avail, cap)
    queue = avail - proc
    m = queue.view(torch.int32)
    mant = (m & 0x7FFFFF) >> 13
    expo = (m >> 23) & 0xFF
    tag = ((mant << 2) ^ expo) - 2048
    jitter = ((tag // 7).float() + (tag % 7).float()) * (1.0 / 64.0)
    timer = carry[:, 1] + dt
    phase = torch.remainder(timer - 3.5, 24.0)
    shift = torch.floor_divide(arrive - 1e4, 1000.0)
    lat = p[:, 2] + queue / cap + torch.abs(jitter) + phase * 0.125
    cost = p[:, 1] * dt + torch.abs(shift) * 2.0 ** -10
    new = torch.stack([queue, timer], dim=1)
    return new, (proc, queue, lat, cost, torch.zeros_like(arrive))


def register_port():
    ptwin.register_policy("diurnal", TRIPLE)(diurnal_step)
    ptwin.register_policy("bits", TRIPLE)(bits_step)
    bw = ptwin.policy_spec("batch_window")
    ptwin.register_policy("bw_copy", bw.param_names,
                          defaults=bw.defaults)(bw.lane_step)


def register_reference(jt):
    import jax
    import jax.numpy as jnp

    @jt.register_policy("diurnal", TRIPLE)
    def _diurnal(carry, arrive, p, dt):
        timer = carry[1] + dt
        hour = timer.astype(jnp.int32) % 24
        s = jnp.sin(hour.astype(jnp.float32) * TWO_PI_24)
        inst = jnp.ceil(3.3 + 2.2 * s)
        cap = jnp.maximum(p[0] * inst * CAP_HOURS * dt, 1.0)
        avail = carry[0] + arrive
        proc = jnp.minimum(avail, cap)
        queue = avail - proc
        lat = p[2] + queue / cap + (2.0 + s) * 64.0
        return jnp.stack([queue, timer]), (proc, queue, lat,
                                           p[1] * inst * dt, jnp.zeros(()))

    @jt.register_policy("bits", TRIPLE)
    def _bits(carry, arrive, p, dt):
        cap = jnp.maximum(p[0] * CAP_HOURS * dt, 1.0)
        avail = carry[0] + arrive
        proc = jnp.minimum(avail, cap)
        queue = avail - proc
        m = jax.lax.bitcast_convert_type(queue, jnp.int32)
        mant = (m & 0x7FFFFF) >> 13
        expo = (m >> 23) & 0xFF
        tag = ((mant << 2) ^ expo) - 2048
        jitter = ((tag // 7).astype(jnp.float32)
                  + (tag % 7).astype(jnp.float32)) * (1.0 / 64.0)
        timer = carry[1] + dt
        phase = jnp.remainder(timer - 3.5, 24.0)
        shift = jnp.floor_divide(arrive - 1e4, 1000.0)
        lat = p[2] + queue / cap + jnp.abs(jitter) + phase * 0.125
        cost = p[1] * dt + jnp.abs(shift) * 2.0 ** -10
        return jnp.stack([queue, timer]), (proc, queue, lat, cost,
                                           jnp.zeros(()))

    bw = jt.policy_spec("batch_window")
    jt.register_policy("bw_copy", bw.param_names,
                       defaults=bw.defaults)(bw.step)


@pytest.fixture(scope="module")
def jref():
    with reference() as r, restored(r.twin), restored(ptwin):
        register_reference(r.twin)
        register_port()
        yield r


def new_twins(tw):
    return ([tw.make_twin(f"diurnal{i}", "diurnal", max_rps=0.5 + 0.5 * i,
                          usd_per_hour=0.0082, base_latency_s=0.15)
             for i in range(3)]
            + [tw.make_twin(f"bits{i}", "bits", max_rps=1.0 + i,
                            usd_per_hour=0.0082, base_latency_s=0.15)
               for i in range(3)]
            + [tw.make_twin(f"bw{i}", "bw_copy", max_rps=6.15,
                            usd_per_hour=0.0703, base_latency_s=0.06,
                            window_hours=2 + 2 * i) for i in range(3)])


#: ``diurnal``'s latency, the port's CPU run against the reference's: XLA's
#: and ATen's CPU ``sin`` round apart by an ulp of a value near 1, which
#: the step multiplies by 64 into a latency of 64 s or more; held to 8
#: float32 ulps relative
DIURNAL_REF_RTOL = 8 * 2.0 ** -23


def test_new_policies_translate_and_run_in_the_kernels(jref):
    """All three get a generated branch; ``diurnal`` alone is listed as
    transcendental; ``diurnal`` and ``bits`` divide integers by literals
    (24, 7) only, so no launch reads the zero-divisor flag back
    (``Generated.int_div`` is empty); nothing is refused."""
    gen = cg.generated()
    names = ptwin.policy_names()
    for name in ("diurnal", "bits", "bw_copy"):
        index = names.index(name)
        assert gen.branches[index] == cg.FIRST_GENERATED + index
    assert gen.transcendental == ("diurnal",)
    assert gen.int_div == ()
    assert not gen.refused
    assert "sinf(" in gen.header and "__float_as_int(" in gen.header
    assert "__double_as_longlong(" in gen.header      # bw_copy's _fma


@pytest.mark.parametrize("dt", [1.0, 1.0 / 60.0])
@pytest.mark.parametrize("policy", ["diurnal", "bits"])
def test_new_policies_interpret_bitwise(jref, policy, dt):
    """(bw_copy's step is batch_window's: ``TRANSLATED`` in
    ``test_torch_register_policy.py`` holds it.)"""
    step = ptwin.policy_spec(policy).lane_step
    carry, arrive, params = lane_block(seed=len(policy) + 3)
    carry[:, 1] = torch.arange(carry.shape[0], dtype=torch.float32) * 3.0
    _assert_interpretation_is_the_step(step, (carry, arrive, params), dt)


@pytest.mark.parametrize("series", [False, True])
def test_new_policies_run_the_grid_like_the_reference(jref, series):
    """``run_grid`` at dt = 1 over a full year, 9 twins x 2 traffics:
    every field of ``bits`` and ``bw_copy`` bitwise the reference's, and
    of ``diurnal`` but its latency, which is within
    ``DIURNAL_REF_RTOL``."""
    want = jref.whatif.run_grid(new_twins(jref.twin), traffics(jref.traffic),
                                slo=jref.slo.SLO(), return_series=series)
    got = pwhatif.run_grid(new_twins(ptwin), traffics(ptraffic),
                           slo=pslo.SLO(), return_series=series,
                           device="cpu")
    exact = [i for i, r in enumerate(want) if r.twin.policy != "diurnal"]
    assert_same_results([got[i] for i in exact], [want[i] for i in exact])
    for g, r in zip(got, want):
        if r.twin.policy != "diurnal":
            continue
        assert g.name == r.name
        for f in r.__dataclass_fields__:
            if f == "twin":
                continue
            u, v = getattr(g, f), getattr(r, f)
            if f in LATENCY_FIELDS:
                u, v = np.asarray(u, np.float64), np.asarray(v, np.float64)
                assert np.all(np.abs(u - v) <= DIURNAL_REF_RTOL
                              * np.abs(v)), (r.name, f)
            elif isinstance(v, np.ndarray):
                np.testing.assert_array_equal(u, v, f)
            else:
                assert u == v, (r.name, f, u, v)


def test_diurnal_instances_stay_clear_of_integers():
    """The premise of ``diurnal``'s bitwise capacity: at each hour, 3.3 +
    2.2 sin lies 0.1 or more from an integer in float32."""
    h = torch.arange(24, dtype=torch.int32)
    x = 3.3 + 2.2 * torch.sin(h.float() * TWO_PI_24)
    assert float((x - x.round()).abs().min()) >= 0.09


def zero_divisor_step(carry, arrive, p, dt):
    """``p[3]`` hours grouped by an integer divisor: (p[3] + 1) as int32,
    1 or more for every built-in's and registered twin's parameters, 0
    for a ``groups`` of -1."""
    groups = (p[:, 3] + 1.0).to(torch.int32)
    slot = (carry[:, 1] + dt).to(torch.int32) // groups
    return (torch.stack([carry[:, 0], carry[:, 1] + dt], dim=1),
            (arrive, carry[:, 0], p[:, 2] + slot.float(), p[:, 1],
             torch.zeros_like(arrive)))


def test_zero_divisor_policy_raises_on_the_cpu_grid():
    """A registered step that divides an integer by zero on one twin's
    parameters: ``run_grid`` on the CPU raises ``RuntimeError:
    ZeroDivisionError`` (the card's wrapper raises the same after the
    launch, chip_smoke.py phase 11a), and runs where no divisor is 0."""
    with restored(ptwin):
        ptwin.register_policy("zdiv", TRIPLE + ("groups",),
                              defaults={"groups": 1.0})(zero_divisor_step)
        assert cg.generated().int_div == ("zdiv",)
        ok = ptwin.make_twin("z", "zdiv", max_rps=1.0, usd_per_hour=0.01,
                             base_latency_s=0.1, groups=3.0)
        rows = pwhatif.run_grid([ok], traffics(ptraffic)[:1], slo=pslo.SLO(),
                                device="cpu")
        assert np.isfinite(rows[0].mean_latency_s)
        bad = ptwin.make_twin("z0", "zdiv", max_rps=1.0, usd_per_hour=0.01,
                              base_latency_s=0.1, groups=-1.0)
        with pytest.raises(RuntimeError, match="ZeroDivisionError"):
            pwhatif.run_grid([bad], traffics(ptraffic)[:1], slo=pslo.SLO(),
                             device="cpu")


def test_zero_divisor_check_is_read_only_where_steps_divide():
    """The wrapper reads the kernels' zero-divisor flag back after a
    launch only while a registered step divides integers."""
    with restored(ptwin):
        assert not cg.generated().int_div
        pk._zero_divisor_check(None, torch.device("cpu"), None)
        ptwin.register_policy("zdiv", TRIPLE + ("groups",),
                              defaults={"groups": 1.0})(zero_divisor_step)
        assert cg.generated().int_div == ("zdiv",)


# ---------------------------------------------------------------------------
# what stays refused, and the reference refuses too
# ---------------------------------------------------------------------------

def test_reference_refuses_control_flow_on_a_value(jref):
    """The port refuses ``_branchy_step`` (it does not trace); the
    reference cannot register its scalar form: ``jax.vmap`` cannot turn
    a traced value into a Python bool."""
    import jax

    def branchy(carry, arrive, p, dt):
        lat = p[2] if arrive > 0 else p[1]
        return carry, (arrive, carry[0], lat, p[1], arrive)
    with restored(jref.twin):
        with pytest.raises(jax.errors.TracerBoolConversionError):
            jref.twin.register_policy("branchy", TRIPLE)(branchy)
        assert "branchy" not in jref.twin.policy_names()


def _scalar_passthrough(carry, arrive, p, dt):
    return carry, (arrive, carry[0], p[2], p[1], arrive)


def test_reference_refuses_an_operation_across_lanes(jref):
    """The port refuses ``_cross_lane_step`` (``aten.cumsum``); the
    reference's lane parity check refuses a lane step that sums across
    lanes, against the scalar step it must equal."""
    import jax.numpy as jnp

    def cross_lane(carry, arrive, p, dt):
        return carry, (arrive, carry[:, 0], p[:, 2], p[:, 1],
                       jnp.cumsum(arrive))
    with restored(jref.twin):
        with pytest.raises(AssertionError, match="lane/scalar"):
            jref.twin.register_policy("cross", TRIPLE,
                                      lane_step=cross_lane)(
                _scalar_passthrough)


def test_reference_refuses_a_lane_index(jref):
    """The port refuses ``_lane_index_step`` (a select of dim 0); the
    reference's lane parity check refuses a lane step that reads lane
    0's parameter in every lane."""
    def lane_index(carry, arrive, p, dt):
        return carry, (arrive, carry[:, 0], p[0, 2] + 0.0 * arrive,
                       p[:, 1], arrive)

    def scalar(carry, arrive, p, dt):
        return carry, (arrive, carry[0], p[2], p[1], arrive)
    with restored(jref.twin):
        with pytest.raises(AssertionError, match="lane/scalar"):
            jref.twin.register_policy("indexed", TRIPLE,
                                      lane_step=lane_index)(scalar)


def test_a_step_without_parameter_gradients_registers():
    """A step whose outputs reach the parameters only through bit views
    and integers has no gradient path; the registry takes it with zero
    gradients, as the reference's ``jax.grad`` gives them, and it
    translates."""
    def mantissa_only(carry, arrive, p, dt):
        m = ((p[:, 2].view(torch.int32) & 0x7FFFFF) >> 13).float()
        return carry, (arrive, carry[:, 0], m, m, arrive)
    with restored(ptwin):
        ptwin.register_policy("mantissa", TRIPLE)(mantissa_only)
        gen = cg.generated()
        assert "mantissa" not in gen.refused
        assert "mantissa" not in gen.transcendental
        index = ptwin.policy_names().index("mantissa")
        assert gen.branches[index] == cg.FIRST_GENERATED + index
