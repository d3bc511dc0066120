"""Registered policies on the port (ROADMAP A10, C15).

A policy added with ``register_policy`` has no built-in CUDA kernel
branch, and neither has a built-in overridden by one (shed here). The
port translates its lane step into a device function of the policy
kernels (``kernels/lane_codegen.py``), as the reference traces a
registered ``jnp`` step into its Pallas kernels.

* ``run_grid`` with the reference's ``test_register_policy_extends_and_
  overrides`` policies (``null``, and ``shed`` overridden to drop
  everything) and one with real arithmetic (``capped``: + - * / min max,
  finite at any parameters, a fault's zero capacity included, as the
  registry's contract asks of a step the blend evaluates), mixed
  with the five built-ins, on the CPU against the reference's
  ``run_grid`` on XLA, both modes, bit for bit;
* the translation: each registered step (and the built-ins' exact steps
  it can take) run as its scalar operations, one PyTorch operation each,
  bitwise the step itself; the steps with no CUDA form (control flow on
  a value, an operation across lanes, a lane index) refused by name; the
  generated header and its library key;
* on a card (``cuda`` marker): the registered rows of the kernels
  bitwise the CPU run.
"""
import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import slo as pslo
from repro_torch.core import traffic as ptraffic
from repro_torch.core import twin as ptwin
from repro_torch.core import whatif as pwhatif
from repro_torch.core.twin import CARRY_DIM, PARAM_DIM
from repro_torch.kernels import build
from repro_torch.kernels import lane_codegen as cg
from repro_torch.kernels import policy_scan as pk

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import assert_same_results, bits, reference

CAP_HOURS = 3600.0
CAPPED_PARAMS = ("max_rps", "usd_per_hour", "base_latency_s", "replicas")


@contextlib.contextmanager
def restored(twin_mod):
    saved, version = dict(twin_mod._REGISTRY), twin_mod._VERSION
    try:
        yield
    finally:
        twin_mod._REGISTRY.clear()
        twin_mod._REGISTRY.update(saved)
        twin_mod._VERSION = version


def register_port():
    """The three policies in the port's registry (lane steps)."""
    triple = ("max_rps", "usd_per_hour", "base_latency_s")

    @ptwin.register_policy("null", triple)
    def _null(carry, arrive, p, dt):
        z = torch.zeros_like(arrive)
        return carry, (z, carry[:, 0], p[:, 2], z, z)

    @ptwin.register_policy("shed", triple + ("queue_cap_hours",),
                           defaults={"queue_cap_hours": 4.0})
    def _shed_v2(carry, arrive, p, dt):
        z = torch.zeros_like(arrive)
        return carry, (z, carry[:, 0], p[:, 2], p[:, 1], arrive)

    @ptwin.register_policy("capped", CAPPED_PARAMS,
                           defaults={"replicas": 1.0},
                           bounds={"replicas": (0.5, 16.0)})
    def _capped(carry, arrive, p, dt):
        cap = torch.clamp_min(p[:, 0] * p[:, 3] * CAP_HOURS, 1.0)
        avail = carry[:, 0] + arrive
        proc = torch.minimum(avail, cap)
        queue = avail - proc
        lat = p[:, 2] + queue / cap
        new = torch.stack([queue, carry[:, 1]], dim=1)
        return new, (proc, queue, lat, p[:, 1] * p[:, 3],
                     torch.zeros_like(arrive))


def register_reference(jt):
    """The same three in the reference's registry (its scalar steps)."""
    import jax.numpy as jnp
    triple = ("max_rps", "usd_per_hour", "base_latency_s")

    @jt.register_policy("null", triple)
    def _null(carry, arrive, p):
        z = jnp.zeros(())
        return carry, (z, carry[0], p[2], z, z)

    @jt.register_policy("shed", triple + ("queue_cap_hours",),
                        defaults={"queue_cap_hours": 4.0})
    def _shed_v2(carry, arrive, p):
        z = jnp.zeros(())
        return carry, (z, carry[0], p[2], p[1], arrive)

    @jt.register_policy("capped", CAPPED_PARAMS,
                        defaults={"replicas": 1.0},
                        bounds={"replicas": (0.5, 16.0)})
    def _capped(carry, arrive, p):
        cap = jnp.maximum(p[0] * p[3] * CAP_HOURS, 1.0)
        avail = carry[0] + arrive
        proc = jnp.minimum(avail, cap)
        queue = avail - proc
        lat = p[2] + queue / cap
        new = jnp.stack([queue, carry[1]])
        return new, (proc, queue, lat, p[1] * p[3], jnp.zeros(()))


def mixed_twins(tw):
    """The five built-ins (shed overridden), null and capped."""
    return [tw.SimpleTwin("fifo", 1.9512, 0.0082, 0.15),
            tw.QuickscalingTwin("quick", 1.9512, 0.0082, 0.15),
            tw.make_twin("auto", "autoscale", max_rps=0.5,
                         usd_per_hour=0.002, base_latency_s=0.1,
                         max_instances=32, scale_up_hours=3),
            tw.make_twin("shed", "shed", max_rps=1.0, usd_per_hour=0.0082,
                         base_latency_s=0.15, queue_cap_hours=2),
            tw.make_twin("batch", "batch_window", max_rps=6.15,
                         usd_per_hour=0.0703, base_latency_s=0.06,
                         window_hours=6),
            tw.make_twin("n", "null", max_rps=1.0, usd_per_hour=0.01,
                         base_latency_s=0.1),
            tw.make_twin("c", "capped", max_rps=1.9512,
                         usd_per_hour=0.0082, base_latency_s=0.15,
                         replicas=1.5)]


def traffics(tr):
    return [tr.TrafficModel.honda_default("nominal", R=3.5, G=1.0),
            tr.TrafficModel.honda_default("high(+50%)", R=3.5, G=1.5)]


@pytest.fixture(scope="module")
def jref():
    with reference() as r, restored(r.twin), restored(ptwin):
        register_reference(r.twin)
        register_port()
        yield r


def test_override_loses_its_kernel_branch(jref):
    """``register_policy`` passes no kernel branch: the override of shed
    keeps shed's index and loses branch 3; it, null and capped run
    generated branches, 5 + their index."""
    names = ptwin.policy_names()
    assert names[:5] == ["fifo", "quickscale", "autoscale", "shed",
                         "batch_window"]
    assert names == list(jref.twin.policy_names())
    assert ptwin.kernel_branches() == (0, 1, 2, None, 4, None, None)
    assert cg.generated().branches == (0, 1, 2, 8, 4, 10, 11)
    onehot = torch.from_numpy(ptwin.policy_onehot([3, 0, 6, 5, 4, 1, 2]))
    onehot[4] = 0.0
    np.testing.assert_array_equal(pk._kernel_branch_index(onehot).numpy(),
                                  [8, 0, 11, 10, -1, 1, 2])


@pytest.mark.parametrize("series", [False, True])
def test_run_grid_takes_registered_policies_like_the_reference(jref, series):
    want = jref.whatif.run_grid(mixed_twins(jref.twin),
                                traffics(jref.traffic), slo=jref.slo.SLO(),
                                return_series=series)
    got = pwhatif.run_grid(mixed_twins(ptwin), traffics(ptraffic),
                           slo=pslo.SLO(), return_series=series,
                           device="cpu")
    assert pwhatif.table2_rows(got) == jref.whatif.table2_rows(want)
    assert_same_results(got, want)
    rows = {r["run"]: r for r in pwhatif.table2_rows(got)}
    assert rows["nominal n"]["cost_usd"] == 0.0
    assert rows["nominal c"]["cost_usd"] > 0.0


# ---------------------------------------------------------------------------
# the translation into the kernels
# ---------------------------------------------------------------------------

def lane_block(lanes=41, seed=0):
    """Random lanes, with the zeros a fault's outage gives (max_rps 0)
    and an empty queue."""
    rng = np.random.default_rng(seed)
    carry = rng.uniform(0.0, 5e4, (lanes, CARRY_DIM)).astype(np.float32)
    arrive = rng.uniform(0.0, 2e4, lanes).astype(np.float32)
    params = rng.uniform(0.05, 8.0, (lanes, PARAM_DIM)).astype(np.float32)
    params[::5, 0] = 0.0
    carry[::7] = 0.0
    arrive[::3] = 0.0
    return tuple(torch.from_numpy(x) for x in (carry, arrive, params))


#: registered steps and the built-ins' exact steps (batch_window's fused
#: multiply-add through a float64 bit view as int64 included)
TRANSLATED = ("null", "shed", "capped", "fifo", "quickscale", "autoscale",
              "batch_window")


@pytest.mark.parametrize("dt", [1.0, 1.0 / 60.0])
@pytest.mark.parametrize("policy", TRANSLATED)
def test_translated_step_equals_the_lane_step(jref, policy, dt):
    step = ptwin.policy_spec(policy).lane_step
    prog = cg.translate(step)
    carry, arrive, params = lane_block(seed=len(policy))
    dtt = torch.tensor(dt, dtype=torch.float32)
    want_c, want = step(carry, arrive, params, dtt)
    got_c, got = cg.interpret(prog, carry, arrive, params, dtt)
    np.testing.assert_array_equal(bits(got_c.numpy()), bits(want_c.numpy()))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            bits(g.numpy()), bits(w.expand(arrive.shape[0]).numpy()))
    src = cg.emit_function(prog, "f", policy)
    assert src.count("const ") == len(prog.instrs) + 1   # + const float* p
    assert "__fmaf" not in src and "fmaf(" not in src


def _ops_step(carry, arrive, p, dt):
    """Every elementwise operation the translation takes, but ``where``'s
    scalar forms and the logical ones (``_logic_step``)."""
    x = p[:, 0:2] * dt
    y = (x[:, 0] + torch.tensor(2.0) + torch.clamp(arrive, 0.5, 3e3)
         + arrive ** 2 - 1.0 / (1.0 + p[:, 1]) + torch.abs(-p[:, 4])
         + torch.floor(p[:, 3] * 3.7) - torch.trunc(-p[:, 5] * 2.3)
         + torch.round(p[:, 2] * 10.0) + torch.sqrt(p[:, 4])
         + torch.relu(arrive - 1e4) + torch.square(p[:, 5])
         + p[:, 3] ** 0.5 + torch.reciprocal(p[:, 2] + 1.0)
         + torch.clamp_max(carry[:, 1], 7.0) + (-p[:, 0]))
    z = torch.cat([y[:, None], carry[:, 1:2]], dim=-1)
    w = (y.double() * 1e-3).float()
    return z, (y, w, torch.full_like(arrive, 0.25), 3.0 - y,
               torch.zeros(()))


def _logic_step(carry, arrive, p, dt):
    hi = arrive > 1e4
    ok = torch.logical_and(hi, carry[:, 0] <= 2e4) | (p[:, 3] == p[:, 4])
    odd = torch.logical_not(ok) ^ (p[:, 5] != 1.0)
    m = torch.where(ok, arrive, 0.0) + odd.float() * 0.1
    c = torch.stack([torch.where(hi, 1.5, p[:, 2]), carry[:, 1]], dim=1)
    return c, (m, carry[:, 0], p[:, 2], p[:, 1] * p[:, 3],
               torch.ones_like(arrive).unsqueeze(1).squeeze(1))


@pytest.mark.parametrize("step", [_ops_step, _logic_step])
@pytest.mark.parametrize("dt", [1.0, 1.0 / 60.0])
def test_translated_operations_equal_pytorch(step, dt):
    prog = cg.translate(step)
    carry, arrive, params = lane_block(seed=11)
    dtt = torch.tensor(dt, dtype=torch.float32)
    want_c, want = step(carry, arrive, params, dtt)
    got_c, got = cg.interpret(prog, carry, arrive, params, dtt)
    np.testing.assert_array_equal(bits(got_c.numpy()), bits(want_c.numpy()))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            bits(g.numpy()), bits(w.expand(arrive.shape[0]).numpy()))
    assert all(isinstance(cg._c_expr(i), str) for i in prog.instrs)


def softlat_step(carry, arrive, p, dt):
    """A capped queue whose latency goes through ``exp`` and ``log``
    (ROADMAP C15): the carry and the other outputs are exact operations,
    the latency is not."""
    cap = torch.clamp_min(p[:, 0] * CAP_HOURS * dt, 1.0)
    avail = carry[:, 0] + arrive
    proc = torch.minimum(avail, cap)
    queue = avail - proc
    lat = p[:, 2] + (torch.log(1.0 + queue / cap)
                     * torch.exp(-proc / cap) * 3600.0)
    new = torch.stack([queue, carry[:, 1]], dim=1)
    return new, (proc, queue, lat, p[:, 1] * dt, torch.zeros_like(arrive))


def _explog64_step(carry, arrive, p, dt):
    """``exp`` and ``log`` in float64, rounded once to float32."""
    x = torch.log(arrive.double() + 1.0) * torch.exp(-p[:, 2].double())
    return carry, (arrive, carry[:, 0], x.float(), p[:, 1], arrive)


def _tanh_step(carry, arrive, p, dt):
    return carry, (arrive, carry[:, 0], torch.tanh(p[:, 2] - 4.0), p[:, 1],
                   arrive)


def _sigmoid_step(carry, arrive, p, dt):
    return carry, (arrive, carry[:, 0], torch.sigmoid(p[:, 2] - 4.0),
                   p[:, 1], torch.sigmoid(-arrive))


def _expm1_step(carry, arrive, p, dt):
    return carry, (arrive, carry[:, 0], torch.expm1(p[:, 2] * -0.3),
                   p[:, 1], arrive)


def _log1p_step(carry, arrive, p, dt):
    return carry, (arrive, carry[:, 0], torch.log1p(arrive / p[:, 2]),
                   p[:, 1], arrive)


def _softplus_step(carry, arrive, p, dt):
    """Softplus at its defaults and with a ``beta`` and ``threshold``
    that put lanes on both sides of the threshold."""
    x = p[:, 2] - 4.0
    return carry, (arrive, carry[:, 0], F.softplus(x),
                   F.softplus(x, beta=2.0, threshold=3.0), arrive)


def _pow_step(carry, arrive, p, dt):
    """``pow`` by exponents the CPU computes exactly (3, -2, -0.5: products,
    a square root, quotients) and by others (1.5, 2.2: ``powf``)."""
    x = (p[:, 2] ** 3 + p[:, 3] ** -2.0 + p[:, 4] ** -0.5
         + p[:, 5] ** 1.5 + torch.pow(p[:, 1], 2.2))
    return carry, (arrive, carry[:, 0], x, p[:, 1], arrive)


def _transcendental64_step(carry, arrive, p, dt):
    """The new operations in float64, rounded once to float32."""
    x = p[:, 2].double() - 4.0
    y = (torch.tanh(x) + torch.sigmoid(x) + torch.expm1(-p[:, 1].double())
         + torch.log1p(arrive.double()) + F.softplus(x, 1.5, 2.0)
         + p[:, 3].double() ** 1.7)
    return carry, (arrive, carry[:, 0], y.float(), p[:, 1], arrive)


@pytest.mark.parametrize("step, ops, fns", [
    (softlat_step, ("exp", "log"), ("expf(", "logf(")),
    (_explog64_step, ("exp", "log"), ("exp(", "log(")),
    (_tanh_step, ("tanh",), ("tanhf(",)),
    (_sigmoid_step, ("sigmoid",), ("1.0f / (1.0f + expf(-",)),
    (_expm1_step, ("expm1",), ("expm1f(",)),
    (_log1p_step, ("log1p",), ("log1pf(",)),
    (_softplus_step, ("softplus",), ("log1pf(expf(",)),
    (_pow_step, ("pow", "sqrt", "reciprocal"), ("powf(", "sqrtf(")),
    (_transcendental64_step, ("tanh", "sigmoid", "expm1", "log1p",
                              "softplus", "pow"),
     ("tanh(", "1.0 / (1.0 + exp(-", "expm1(", "log1p(", "pow("))],
    ids=["exp_log", "exp_log64", "tanh", "sigmoid", "expm1", "log1p",
         "softplus", "pow", "all64"])
@pytest.mark.parametrize("dt", [1.0, 1.0 / 60.0])
def test_exp_and_log_translate(step, ops, fns, dt):
    """C15: ``exp``, ``log``, ``tanh``, ``sigmoid``, ``expm1``, ``log1p``,
    ``softplus`` and ``pow`` become CUDA's functions of their type (sigmoid
    and softplus in ATen's formulas); run as their scalar operations on
    the CPU the translation is bitwise the step (the card is held to the
    CPU within an ulp bound, chip_smoke.py phase 11c)."""
    prog = cg.translate(step)
    assert set(ops) <= {i.op for i in prog.instrs}
    carry, arrive, params = lane_block(seed=23)
    dtt = torch.tensor(dt, dtype=torch.float32)
    want_c, want = step(carry, arrive, params, dtt)
    got_c, got = cg.interpret(prog, carry, arrive, params, dtt)
    np.testing.assert_array_equal(bits(got_c.numpy()), bits(want_c.numpy()))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            bits(g.numpy()), bits(w.expand(arrive.shape[0]).numpy()))
    src = cg.emit_function(prog, "f", "explog")
    assert all(fn in src for fn in fns), src
    assert "__fmaf" not in src and "fmaf(" not in src


def test_exp_and_log_steps_run_in_the_kernels():
    """C15: a registered ``exp`` / ``log`` step gets a generated branch,
    not ``REFUSED``, and is listed among the transcendental ones."""
    with restored(ptwin):
        ptwin.register_policy("softlat", ("max_rps", "usd_per_hour",
                                          "base_latency_s"))(softlat_step)
        gen = cg.generated()
        index = ptwin.policy_names().index("softlat")
        assert gen.branches[index] == cg.FIRST_GENERATED + index
        assert gen.transcendental == ("softlat",) and not gen.refused
        assert "expf(" in gen.header and "logf(" in gen.header


def smooth_step(carry, arrive, p, dt):
    """A capped queue whose wait goes through ``tanh``, ``sigmoid``,
    ``log1p``, ``expm1``, ``softplus`` and a ``pow`` (ROADMAP C15), every
    term positive; the carry and the other outputs are exact operations.
    chip_smoke.py's 11c runs the same step on the card."""
    cap = torch.clamp_min(p[:, 0] * CAP_HOURS, 1.0)
    avail = carry[:, 0] + arrive
    proc = torch.minimum(avail, cap)
    queue = avail - proc
    load = queue / cap
    wait = (torch.tanh(load) + torch.sigmoid(load - 2.0) + torch.log1p(load)
            - torch.expm1(-load) + F.softplus(load - 1.0, beta=2.0,
                                              threshold=5.0)
            + load ** 1.5)
    new = torch.stack([queue, carry[:, 1]], dim=1)
    return new, (proc, queue, p[:, 2] + wait * 3600.0, p[:, 1] * dt,
                 torch.zeros_like(arrive))


def register_smooth_reference(jt):
    """``smooth_step`` in the reference's registry (its scalar step;
    softplus written out, as ``jax.nn.softplus`` takes no ``beta`` or
    ``threshold``)."""
    import jax
    import jax.numpy as jnp

    @jt.register_policy("smooth", ("max_rps", "usd_per_hour",
                                   "base_latency_s"))
    def _smooth(carry, arrive, p):
        cap = jnp.maximum(p[0] * CAP_HOURS, 1.0)
        avail = carry[0] + arrive
        proc = jnp.minimum(avail, cap)
        queue = avail - proc
        load = queue / cap
        x = (load - 1.0) * 2.0
        soft = jnp.where(x > 5.0, load - 1.0, jnp.log1p(jnp.exp(x)) / 2.0)
        wait = (jnp.tanh(load) + jax.nn.sigmoid(load - 2.0)
                + jnp.log1p(load) - jnp.expm1(-load) + soft + load ** 1.5)
        return jnp.stack([queue, carry[1]]), (proc, queue,
                                              p[2] + wait * 3600.0, p[1],
                                              jnp.zeros(()))


#: the port's CPU run of ``smooth`` against the reference's: XLA's and
#: ATen's CPU ``tanh``, ``exp``, ``log1p``, ``expm1`` and ``pow`` round
#: apart, by up to 2.7e-7 relative on a bin's latency (2.3 float32 ulps)
#: and 1.2e-8 on a mean latency, measured on this CPU; held to 8 ulps
SMOOTH_REF_RTOL = 8 * 2.0 ** -23
#: the result fields that carry the latency
LATENCY_FIELDS = ("latency_s", "mean_latency_s", "median_latency_s",
                  "p99_latency_s")


def smooth_twins(tw):
    return [tw.make_twin(f"smooth{i}", "smooth", max_rps=0.25 + 0.25 * i,
                         usd_per_hour=0.0082, base_latency_s=0.15)
            for i in range(8)]


def test_transcendental_steps_run_in_the_kernels():
    """C15: ``tanh``, ``sigmoid``, ``expm1``, ``log1p``, ``softplus`` and a
    general ``pow`` get a generated branch beside ``softlat``'s, and both
    policies are listed among the transcendental ones."""
    with restored(ptwin):
        for name, step in (("softlat", softlat_step),
                           ("smooth", smooth_step)):
            ptwin.register_policy(name, ("max_rps", "usd_per_hour",
                                         "base_latency_s"))(step)
        gen = cg.generated()
        names = ptwin.policy_names()
        for name in ("softlat", "smooth"):
            index = names.index(name)
            assert gen.branches[index] == cg.FIRST_GENERATED + index
        assert gen.transcendental == ("softlat", "smooth")
        assert not gen.refused
        for fn in ("tanhf(", "expm1f(", "log1pf(", "powf(",
                   "1.0f / (1.0f + expf(-"):
            assert fn in gen.header, fn


@pytest.mark.parametrize("series", [False, True])
def test_transcendental_step_runs_the_grid_like_the_reference(jref,
                                                               series):
    """``smooth`` through ``run_grid`` on the CPU against the reference's
    registered run on XLA, a full year of 8 twins x 2 traffics: the
    latency within ``SMOOTH_REF_RTOL``, every other field bitwise."""
    with restored(jref.twin), restored(ptwin):
        register_smooth_reference(jref.twin)
        ptwin.register_policy("smooth", ("max_rps", "usd_per_hour",
                                         "base_latency_s"))(smooth_step)
        want = jref.whatif.run_grid(smooth_twins(jref.twin),
                                    traffics(jref.traffic),
                                    slo=jref.slo.SLO(), return_series=series)
        got = pwhatif.run_grid(smooth_twins(ptwin), traffics(ptraffic),
                               slo=pslo.SLO(), return_series=series,
                               device="cpu")
    assert len(got) == len(want) == 16
    for g, r in zip(got, want):
        assert g.name == r.name
        for f in r.__dataclass_fields__:
            if f == "twin":
                continue
            u, v = getattr(g, f), getattr(r, f)
            if f in LATENCY_FIELDS:
                u, v = np.asarray(u, np.float64), np.asarray(v, np.float64)
                assert np.all(np.abs(u - v) <= SMOOTH_REF_RTOL * np.abs(v)), \
                    (r.name, f)
            elif isinstance(v, np.ndarray):
                np.testing.assert_array_equal(u, v, f)
            else:
                assert u == v, (r.name, f, u, v)


def _bitview_step(carry, arrive, p, dt):
    mantissa = (p[:, 2].view(torch.int32) & 0x7FFFFF).float()
    return carry, (arrive, carry[:, 0], mantissa, p[:, 1], arrive)


def _branchy_step(carry, arrive, p, dt):
    lat = p[:, 2] if bool(arrive.sum() > 0) else p[:, 1]
    return carry, (arrive, carry[:, 0], lat, p[:, 1], arrive)


def _cross_lane_step(carry, arrive, p, dt):
    return carry, (arrive, carry[:, 0], p[:, 2], p[:, 1], arrive.cumsum(0))


def _lane_index_step(carry, arrive, p, dt):
    return carry, (arrive, carry[:, 0], p[0, 2] + arrive, p[:, 1], arrive)


@pytest.mark.parametrize("step, what", [
    (_branchy_step, "does not trace"), (_cross_lane_step, "aten.cumsum"),
    (_lane_index_step, "select of dim 0")])
def test_steps_without_a_cuda_form_are_refused(step, what):
    """What stays refused is what the reference refuses too
    (``tests/test_torch_register_policy_ints.py`` shows its refusals)."""
    with pytest.raises(cg.Untranslatable, match=what):
        cg.translate(step)


@pytest.mark.parametrize("step, op", [
    (_bitview_step, "bitcast"),
    (ptwin.policy_spec("batch_window").lane_step, "nextafter")])
def test_bit_views_and_int64_steps_translate(step, op):
    """A bit view (float32 as int32) and batch_window's int64 view of a
    float64 translate, interpreted bitwise the step."""
    prog = cg.translate(step)
    assert op in {i.op for i in prog.instrs}
    carry, arrive, params = lane_block(seed=13)
    dtt = torch.tensor(1.0)
    want_c, want = step(carry, arrive, params, dtt)
    got_c, got = cg.interpret(prog, carry, arrive, params, dtt)
    np.testing.assert_array_equal(bits(got_c.numpy()), bits(want_c.numpy()))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            bits(g.numpy()), bits(w.expand(arrive.shape[0]).numpy()))


def test_refused_rows_raise_on_the_card_path(jref):
    """A registered step with no CUDA form gets ``REFUSED``: the card's
    check names it (here raised at once, as a CPU tensor has no queue),
    and the other policies keep their branches."""
    with restored(ptwin):
        ptwin.register_policy("expo", ("max_rps", "usd_per_hour",
                                       "base_latency_s"))(_cross_lane_step)
        gen = cg.generated()
        assert gen.branches[-1] == cg.REFUSED
        assert "aten.cumsum" in gen.refused["expo"]
        assert gen.branches[:-1] == (0, 1, 2, 8, 4, 10, 11)
        onehot = torch.from_numpy(ptwin.policy_onehot([0, 6, 7]))
        with pytest.raises(NotImplementedError, match="expo.*aten.cumsum"):
            pk._kernel_branch_index(onehot)
        np.testing.assert_array_equal(
            pk._kernel_branch_index(onehot[:2]).numpy(), [0, 11])


def test_generated_header_has_a_branch_a_registered_policy(jref):
    gen = cg.generated()
    assert gen.refused == {}
    for branch, policy in ((8, "shed"), (10, "null"), (11, "capped")):
        assert f"case {branch}: registered_step_{branch}(" in gen.header
        assert f"policy {policy!r}" in gen.header
    assert gen.header.count("case ") == 3
    # a library of its own, keyed by the header's text
    assert (build.library_path("policy_scan", gen.header)
            != build.library_path("policy_scan"))
    assert cg.generated() is gen            # traced once per registry
    src = (build.CSRC / "policy_scan.cu").read_text()
    assert f'#include "{build.GENERATED_HEADER["policy_scan"]}"' in src


def test_registered_rows_are_read_back_with_the_checks(jref):
    """With a policy registered, the count of rows that run a generated
    step rides in the wrappers' one read-back of their checks."""
    branch = pk._kernel_branch_index(
        torch.from_numpy(ptwin.policy_onehot([0, 5, 6, 3, 6, 1])))
    np.testing.assert_array_equal(branch.numpy(), [0, 10, 11, 8, 11, 1])
    checks = []
    pk._row_index(torch.tensor([0, 1, 1, 0, 0, 1], dtype=torch.int32), 6,
                  2, torch.device("cpu"), "load", checks)
    assert pk._raise_failed(checks, pk._registered_count(branch)) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("series", [False, True])
def test_registered_rows_run_in_the_kernels_on_card(jref, series):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    twins = mixed_twins(ptwin)
    reg = [t for t in twins if t.policy in ("shed", "null", "capped")]
    pk.reset_launches()
    card = pwhatif.run_grid(twins, traffics(ptraffic), slo=pslo.SLO(),
                            return_series=series)
    kernel = "policy_scan" if series else "policy_agg"
    assert pk.launches[kernel] > 0
    assert pk.registered_rows[kernel] == 2 * len(reg)
    cpu = pwhatif.run_grid(twins, traffics(ptraffic), slo=pslo.SLO(),
                           return_series=series, device="cpu")
    assert pwhatif.table2_rows(card) == pwhatif.table2_rows(cpu)
