"""The port's serving slice on the CPU against the reference.

Jamba-1.5's smoke config without experts (one attention and seven Mamba
layers per group), at 8 layers (one group) and 16 (two, so the stacked
``groups`` axis and per-group cache slicing run), in float32 and
bfloat16. The port's ``ServeEngine.process_group`` serves two right-padded
prompts of different lengths: a prefill and 4 greedy decode steps. The
reference runs ``repro.models.model.prefill`` / ``decode_step`` under
``ops.pallas_mode(True, interpret=True)`` with the engine's padding
re-created (as ``tests/test_serve_engine.py::
test_greedy_consistency_with_forward`` does), and no mesh: its own
``ServeEngine`` installs a host mesh under which the Pallas SSM kernel
raises on jax 0.9 (ROADMAP C7). Its steps are jitted, as its engine's.
Parameters are drawn once by the reference and converted
(``convert.model_params_from_arrays``); the reference's decode is fed the
port's tokens, so every step's logits compare like with like.

Tolerances (as max |port - ref| / (1 + |ref|), used as atol = rtol),
measured over these runs and set above them. Float32: 5e-5 (measured
6.4e-6 at 8 layers, 9.0e-6 at 16), and the greedy tokens must be equal,
the reference's own argmax included. Bfloat16: 0.15 (measured 7.8e-2 and
9.5e-2 on logits of magnitude ~3). Bf16 activations round at other places
in the two frameworks (XLA may keep float32 inside a fused expression),
and the difference grows with depth. For scale, on the same parameters
and tokens the reference's bf16 logits differ from its own float32 logits
by 9.9e-2 and 0.156, and the port's by 0.128 and 0.141.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.convert import model_params_from_arrays
from repro_torch.core.spans import SpanCollector
from repro_torch.models import model as M
from repro_torch.serve.engine import Request, ServeEngine

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import model_ref as jref  # noqa: F401

LOGIT_TOL = {"float32": 5e-5, "bfloat16": 0.15}
SLOTS, MAX_LEN, MAX_NEW = 2, 32, 5
PROMPTS = ([3, 17, 5, 9, 2, 11, 7, 4, 250],
           [int(t) for t in np.random.default_rng(0).integers(1, 256, 20)])


def jamba(num_layers=8, dtype="float32", mod=None):
    """The Jamba smoke config without experts, from ``mod.configs`` (the
    reference's) or the port's."""
    get = mod.configs.get_smoke_config if mod else get_smoke_config
    return dataclasses.replace(get("jamba-1.5-large-398b"), moe=None,
                               num_layers=num_layers, dtype=dtype)


class Recorder:
    """Wraps an engine step and keeps the logits it returns."""

    def __init__(self, step):
        self.step, self.logits = step, []

    def __call__(self, *args):
        logits, cache = self.step(*args)
        self.logits.append(logits.float().numpy())
        return logits, cache


def close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_layers", [8, 16])
def test_slice_matches_reference(jref, num_layers, dtype):
    jnp = jref.jax.numpy
    jcfg = jamba(num_layers, dtype, jref)
    cfg = jamba(num_layers, dtype)
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
    tokens = np.array([r.output for r in reqs], np.int32)      # [2, 5]
    assert tokens.shape == (SLOTS, MAX_NEW)

    # the engine's padding: prompts left-aligned in [slots, max_len // 2]
    plen = MAX_LEN // 2
    padded = np.zeros((SLOTS, plen), np.int32)
    for i, p in enumerate(PROMPTS):
        p = p[-plen:]                       # the second prompt is cut
        padded[i, :len(p)] = p
    tol = LOGIT_TOL[dtype]
    # jitted, as the reference's serve steps are
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
    for step, (a, b) in enumerate(zip(port_logits, ref_logits)):
        assert a.shape == b.shape == (SLOTS, 1, cfg.vocab_size)
        assert np.isfinite(a).all()
        close(a, b, tol, f"logits at step {step}")
        if dtype == "float32":
            np.testing.assert_array_equal(b[:, -1].argmax(-1),
                                          tokens[:, step],
                                          err_msg=f"tokens at step {step}")


def test_requests_complete_and_timed():
    cfg = jamba()
    params = M.init_params(cfg, seed=0, device="cpu")
    eng = ServeEngine(cfg, params, slots=2, max_len=64, device="cpu")
    reqs = [Request(rid=i, prompt=[1, 2, 3 + i], max_new=3,
                    submitted=0.005 * i) for i in range(5)]
    done = eng.serve(reqs)
    assert len(done) == 5
    for r in done:
        assert len(r.output) == 3
        assert r.ttft_s is not None and r.ttft_s >= 0
        assert r.latency_s >= r.ttft_s
    names = set(eng.collector.stage_names())
    assert {"queue_wait", "prefill", "decode"} <= names
    # groups of at most two (how many depends on the clock): a prefill
    # each, and two decode steps each for max_new 3
    prefills = eng.collector.spans("prefill")
    assert sum(s.records for s in prefills) == 5
    assert all(s.records <= 2 for s in prefills)
    assert len(eng.collector.spans("decode")) == 2 * len(prefills)
    assert len(eng.collector.spans("queue_wait")) == len(prefills)


def test_group_rows_are_independent():
    """A request's tokens do not depend on what shares its group: each
    row's prefill, cache and decode are its own."""
    cfg = jamba()
    params = M.init_params(cfg, seed=1, device="cpu")
    eng = ServeEngine(cfg, params, slots=2, max_len=64, device="cpu")
    alone = Request(rid=0, prompt=list(PROMPTS[1]), max_new=4)
    eng.process_group([alone])
    paired = [Request(rid=1, prompt=list(PROMPTS[0]), max_new=2),
              Request(rid=2, prompt=list(PROMPTS[1]), max_new=4)]
    eng.process_group(paired)
    assert paired[1].output == alone.output
    assert len(paired[0].output) == 2
    assert paired[0].completed <= paired[1].completed


def test_as_pipeline_serves_record_batches():
    cfg = jamba()
    params = M.init_params(cfg, seed=2, device="cpu")
    eng = ServeEngine(cfg, params, slots=2, max_len=32, device="cpu",
                      collector=SpanCollector())
    pipe = eng.as_pipeline()
    pipe.start()
    try:
        pipe.submit({"tokens": np.arange(1, 19).reshape(2, 9)}, records=2)
        assert pipe.drain(timeout=120)
    finally:
        pipe.stop()
    assert not pipe.errors
    assert {"serve_group", "prefill", "decode"} <= set(
        eng.collector.stage_names())
