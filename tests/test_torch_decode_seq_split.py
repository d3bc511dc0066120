"""Serving with a cache split along its sequence (ROADMAP A8.3): the
flash-decoding layout of the reference's dry run, gloo on the CPU.

One spawn per world (``torch_mesh_workers.seq_worker``; worlds of 2 and
4) runs smoke GQA (llama3.2), MLA (minicpm3) and Jamba without experts
(Mamba beside attention), in float32, at three layouts:

* ``seq_model``: (data, model) = (1, 2), the cache's sequence over
  ``model`` (the reference's decode_32k layout): each rank holds half of
  every KV head's positions (MLA's latent), its query heads its own;
  also GQA and MLA with 3 query heads, which 2 does not divide (the
  fall-back, ROADMAP C19): every rank scores every head against its
  chunk, as the dry run's decode_32k cells of qwen2-vl-7b, minicpm3-4b
  and whisper-small do;
* ``seq_data_model``: (2, 2) with a batch of one, the sequence over
  ``("data", "model")`` (its long_500k layout): four chunks, the rows on
  every rank; the GQA cases take one KV head, which the reference's
  specs leave whole over a model axis of 2, as jamba-1.5-large's 8 over
  16 (with two, the spec would name ``model`` twice, which raises);
* ``rows_pod_data``: (pod, data, model) = (2, 2, 1), the rows over
  ``("pod", "data")`` as one group (its multi-pod decode_32k layout);
* ``seq_model_odd``: as ``seq_model`` with a cache of 127 positions,
  which 2 does not divide: the self-attention caches stay whole along
  their sequence, as the reference's specs leave them, with its warning,
  and the step serves as without ``shard_cache_seq`` (bitwise).

Whisper's cross-attention cache (``encoder_seq`` 16 at smoke width) is
split along its sequence too: in two chunks over ``model`` at
``seq_model`` (and in every layout beside a self-attention cache that
stays whole at ``seq_model_odd``), in four over ``("data", "model")``
with one KV head at ``seq_data_model``; with 15 positions it stays
whole. Each rank runs a prefill of 64 tokens (whisper: and 16 frames)
into a cache of 128 (127) and 4 greedy decode steps through
``serve.steps``; this process holds them to:

* the port's one-device steps: greedy tokens equal, logits and every
  gathered cache leaf (Mamba's conv and SSM states, which have no
  sequence dim, among them) within ``SEQ_RTOL`` (max |mesh - one| / (1 +
  max |one|); measured here up to 3.0e-6);
* the reference's jitted single-device ``prefill`` / ``decode_step`` (C7)
  fed the same tokens: within ``REF_TOL``, as the other serving tests;
* smoke llama3.2 in bf16 at ``seq_model``: within C8's 2^-7 of one
  device's bf16 (measured 0.0), tokens equal;
* ``ServeEngine(mesh=)`` at ``seq_model`` serves the one-device engine's
  tokens;
* the collectives: at ``rows_pod_data`` only the rows' gather (one a
  step); at the split layouts a decode step's max and sum all-reduces;
* Jamba with experts at ``seq_data_model``: the expert ranks share their
  row, and each expert slot is multiplied once over them.

Without ranks: a spec naming an axis twice raises (``check_spec``,
``cut_indices``, ``serve_layout``), a cache length the sequence axes do
not divide leaves the leaf whole along its sequence, with the reference's
warning, and the caches of Mamba and RWKV-6 (no sequence dim) take the
same specs with and without the split.
"""
import warnings

import dataclasses

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_arrays
from repro_torch.distributed import sharding as sh
from repro_torch.models import model as M

import torch_mesh_workers as w
from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import model_ref as jref  # noqa: F401

#: float32 over a split cache against one device (logits, caches)
SEQ_RTOL = 1e-5
#: float32 against the reference's single-device steps (C9)
REF_TOL = 5e-5
#: bf16 against one device's bf16 (C8)
BF16_TOL = 2.0 ** -7
CASES = [(layout, case) for layout, _, _, _, _, _, cases in w.SEQ_LAYOUTS
         for case in cases]
IDS = [f"{layout}-{case}" for layout, case in CASES]
LAYOUT = {c[0]: c for c in w.SEQ_LAYOUTS}


def err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / (1.0 + float(np.abs(want).max()))


@pytest.fixture(scope="module")
def params_np(jref):
    out = {}
    for i, (case, _, _) in enumerate(w.SEQ_CASES):
        jcfg = w.seq_cfg(case, "float32", jref.configs.get_smoke_config)
        jp = jref.model.init_params(jcfg, jref.jax.random.PRNGKey(20 + i))
        out[case] = {k: np.asarray(v) for k, v in jp.items()}
    return out


@pytest.fixture(scope="module")
def ranks(params_np, tmp_path_factory):
    root = tmp_path_factory.mktemp("seq_split")
    return {world: w.spawn(w.seq_worker, world, root, params_np)
            for world in (2, 4)}


def one_device_run(params_np, case, b, max_len=w.SEQ_MAX_LEN,
                   dtype="float32"):
    cfg = w.seq_cfg(case, dtype)
    params = model_params_from_arrays(params_np[case], cfg, device="cpu")
    with w.expert_slots() as slots:
        logits, toks, cache, _, _ = w.seq_steps(
            cfg, params, w.seq_batch(cfg, b), max_len=max_len)
    return {"logits": logits, "tokens": toks, "expert_slots": sum(slots),
            "cache": {k: v.float().numpy() for k, v in cache.items()}}


def run_of(layout, case):
    """(case, batch, max_len) of a layout's run of ``case``."""
    return case, LAYOUT[layout][5], w.seq_max_len(layout)


#: the runs of every layout; two layouts share a run where they agree
RUNS = sorted({run_of(layout, case) for layout, case in CASES})


@pytest.fixture(scope="module")
def one_device(params_np):
    runs = {run: one_device_run(params_np, *run) for run in RUNS}
    return {(layout, case): runs[run_of(layout, case)]
            for layout, case in CASES}


@pytest.fixture(scope="module")
def reference(jref, params_np, one_device):
    jnp = jref.jax.numpy
    runs = {}
    for case, b, max_len in RUNS:
        jcfg = w.seq_cfg(case, "float32", jref.configs.get_smoke_config)
        jparams = {k: jnp.asarray(v) for k, v in params_np[case].items()}
        prefill = jref.jax.jit(
            lambda p, bt, c, cfg=jcfg: jref.model.prefill(p, cfg, bt, c))
        decode = jref.jax.jit(
            lambda p, c, bt, cfg=jcfg: jref.model.decode_step(p, cfg, c, bt))
        toks = next(one_device[(layout, c)]["tokens"]
                    for layout, c in CASES
                    if run_of(layout, c) == (case, b, max_len))
        with jref.ops.pallas_mode(True, interpret=True):
            cache = jref.model.init_cache(jcfg, b, max_len)
            logits, cache = prefill(
                jparams, {k: jnp.asarray(v)
                          for k, v in w.seq_batch(jcfg, b).items()}, cache)
            got = [np.asarray(logits)]
            for step in range(w.SEQ_DECODE):
                logits, cache = decode(jparams, cache, {
                    "token": jnp.asarray(toks[:, step:step + 1]
                                         .astype(np.int32))})
                got.append(np.asarray(logits))
        runs[(case, b, max_len)] = got
    return {(layout, case): runs[run_of(layout, case)]
            for layout, case in CASES}


def records(ranks, layout, case, dtype="float32"):
    return [r[(layout, case, dtype)] for r in ranks[LAYOUT[layout][1]]]


@pytest.mark.parametrize("layout, case", CASES, ids=IDS)
def test_matches_one_device(ranks, one_device, layout, case):
    one = one_device[(layout, case)]
    for rec in records(ranks, layout, case):
        np.testing.assert_array_equal(rec["tokens"], one["tokens"])
        for step, (a, b) in enumerate(zip(rec["logits"], one["logits"])):
            assert a.shape == b.shape and np.isfinite(a).all()
            assert err(a, b) <= SEQ_RTOL, (step, err(a, b))
        assert sorted(rec["cache"]) == sorted(one["cache"])
        for k, v in one["cache"].items():
            assert rec["cache"][k].shape == v.shape, k
            assert err(rec["cache"][k], v) <= SEQ_RTOL, (k, err(
                rec["cache"][k], v))


@pytest.mark.parametrize("layout, case", CASES, ids=IDS)
def test_matches_the_reference(ranks, reference, layout, case):
    rec = records(ranks, layout, case)[0]
    for step, (a, b) in enumerate(zip(rec["logits"],
                                      reference[(layout, case)])):
        np.testing.assert_allclose(a, b, atol=REF_TOL, rtol=REF_TOL,
                                   err_msg=f"{case} logits at step {step}")


@pytest.mark.parametrize("layout, case", CASES, ids=IDS)
def test_rank_holds_its_chunk(ranks, layout, case):
    """Each rank's attention caches hold 1/n of the sequence (every KV
    head where the sequence takes ``model``) of its rows, where n divides
    the cache's length (``max_len``, or whisper's ``encoder_seq``); where
    it does not, the whole sequence, as without the split."""
    _, world, shape, axes, seq_axis, b, _ = LAYOUT[layout]
    cfg = w.seq_cfg(case)
    mesh = dict(zip(axes, shape))
    n_seq = sh.axis_size(mesh, tuple(a for a in sh.entry_names(seq_axis)
                                     if a in mesh))
    rows = b // (shape[0] * shape[1] if layout == "rows_pod_data" else 1)
    max_len = w.seq_max_len(layout)
    whole = {k: d.shape for k, d in M.cache_schema(cfg, b, max_len).items()}
    plain = w.serve_plan_shapes(cfg, mesh, b, max_len)[1]
    split = {"attn": n_seq > 1 and max_len % n_seq == 0,
             "cross": n_seq > 1 and cfg.encoder_seq % n_seq == 0}
    checked = 0
    for rec in records(ranks, layout, case):
        assert rec["split"] == (split["attn"],
                                cfg.encdec and split["cross"])
        for name, got in rec["cache_shapes"].items():
            if not name.endswith((".k", ".v", ".attn.ckv",
                                  ".attn.k_rope")):
                continue
            if n_seq > 1 and not split[
                    "cross" if ".cross." in name else "attn"]:
                # as without the split
                assert got == plain[name], (name, got, plain[name])
            else:
                want = list(whole[name])
                want[1] = rows
                want[2] //= n_seq
                if layout == "seq_model" and name.endswith(".k"):
                    assert got[3] == cfg.attention.num_kv_heads
                assert got == tuple(want), (name, got, want)
            checked += 1
    assert checked


def test_bf16_within_c8(ranks, params_np):
    one = one_device_run(params_np, "llama", 4, dtype="bfloat16")
    for rec in records(ranks, "seq_model", "llama", "bfloat16"):
        np.testing.assert_array_equal(rec["tokens"], one["tokens"])
        for a, b in zip(rec["logits"], one["logits"]):
            assert err(a, b) <= BF16_TOL, err(a, b)


@pytest.mark.parametrize("layout", ["seq_model", "seq_model_odd"])
def test_engine_serves_the_one_device_tokens(ranks, params_np, layout):
    cfg = w.seq_cfg("llama")
    params = model_params_from_arrays(params_np["llama"], cfg, device="cpu")
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, params, slots=4, max_len=w.seq_max_len(layout),
                      device="cpu")
    want = [r.output for r in sorted(eng.serve([
        Request(rid=i, prompt=p, max_new=w.ENGINE_NEW)
        for i, p in enumerate(w.engine_prompts(cfg))]),
        key=lambda r: r.rid)]
    for r in ranks[2]:
        assert r[(layout, "engine")] == want


@pytest.mark.parametrize("layout", [c[0] for c in w.SEQ_LAYOUTS])
def test_collectives_issued(ranks, layout):
    for case in LAYOUT[layout][6]:
        coll = records(ranks, layout, case)[0]["collectives"]
        steps = 1 + w.SEQ_DECODE
        if layout == "rows_pod_data":
            assert coll["all-gather"]["count"] == steps
            assert coll["all-reduce"]["count"] == 0
        elif layout == "seq_model_odd":
            # the self-attention caches whole: llama's step issues what it
            # issues without shard_cache_seq
            if case == "llama":
                assert coll == records(ranks, layout, case,
                                       "plain")[0]["collectives"]
        else:
            # a decode step's max and sum over the sequence axes, and its
            # chunks' output, each attention layer
            layers = w.seq_cfg(case).layer_types.count("attn")
            assert coll["all-reduce"]["count"] >= 3 * layers * w.SEQ_DECODE


def test_each_expert_slot_multiplied_once(ranks, one_device):
    """Jamba with experts over (data, model) = (2, 2) with a batch of one:
    the expert ranks (``data``) hold the same row, so each multiplies its
    own experts' slots of the whole batch and gathers the others'
    results (no exchange, which would send each rank's copy of a slot to
    its expert: every slot twice). Over the four ranks the slots
    multiplied are one device's once for each ``model`` rank (each
    multiplies its columns of every slot)."""
    layout, case = "seq_data_model", "jamba_moe_mqa"
    _, _, shape, axes, _, _, _ = LAYOUT[layout]
    one = one_device[(layout, case)]["expert_slots"]
    assert one > 0
    recs = records(ranks, layout, case)
    assert (sum(r["expert_slots"] for r in recs)
            == dict(zip(axes, shape))["model"] * one)
    for rec in recs:
        assert rec["collectives"].get("all-to-all", {"count": 0})[
            "count"] == 0


def test_a_spec_naming_an_axis_twice_raises():
    with pytest.raises(ValueError, match="twice"):
        sh.check_spec((None, ("data", "model"), "model", None))
    with pytest.raises(ValueError, match="twice"):
        sh.cut_indices((2, 64, 2, 16), (None, ("data", "model"), "model",
                                        None), {"data": 2, "model": 2},
                       {"data": 0, "model": 1})
    mesh = {"data": 2, "model": 2}
    # two KV heads over model 2 beside a sequence over (data, model): the
    # reference's spec names model twice
    with pytest.raises(ValueError, match="twice"):
        M.serve_layout(w.seq_cfg("llama"),
                       w.seq_parallel(("data", "model")), mesh, 1,
                       w.SEQ_MAX_LEN)
    # rows over data beside a sequence over (data, model)
    with pytest.raises(ValueError, match="twice"):
        M.serve_layout(w.seq_cfg("llama_mqa"),
                       w.seq_parallel(("data", "model")), mesh, 2,
                       w.SEQ_MAX_LEN)
    # whisper's cross cache over (data, model) beside two KV heads over
    # model
    with pytest.raises(ValueError, match="twice"):
        M.serve_layout(w.seq_cfg("whisper"),
                       w.seq_parallel(("data", "model")), mesh, 1,
                       w.SEQ_MAX_LEN)


def test_a_cache_the_axes_do_not_divide_stays_whole():
    """127 positions over model=2: the reference's specs leave the
    self-attention caches whole along their sequence (the KV heads over
    model, as without the split), and so does the placement, warning
    once with the axis and the size; the serving mesh splits no work
    along the sequence. Whisper's cross cache of 16 still splits."""
    mesh = {"data": 1, "model": 2}
    plain = M.serve_layout(w.seq_cfg("llama"), w.seq_parallel(
        "model").__class__(fsdp_axis=None), mesh, 4, w.SEQ_ODD_LEN)[1]
    sh._REPLICATION_WARNED.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = M.serve_layout(w.seq_cfg("llama"), w.seq_parallel("model"),
                             mesh, 4, w.SEQ_ODD_LEN)[1]
    assert got == plain
    msgs = [str(m.message) for m in caught]
    assert any("dim 127 is not divisible by mesh axis 'model' (size 2)"
               in m for m in msgs), msgs
    wcfg = w.seq_cfg("whisper")
    got = M.serve_layout(wcfg, w.seq_parallel("model"), mesh, 4,
                         w.SEQ_ODD_LEN)[1]
    for name, (spec, _, _) in got.items():
        if name.endswith((".cross.k", ".cross.v")):
            assert spec[-3] == "model", (name, spec)
        elif name.endswith((".attn.k", ".attn.v")):
            assert spec[-3] is None and spec[-2] == "model", (name, spec)


def test_an_odd_cache_serves_as_without_the_split(ranks, params_np):
    """``seq_model_odd``: smoke llama3.2 with a 127-position cache and
    ``shard_cache_seq`` over model=2 serves bitwise what it serves
    without ``shard_cache_seq``, warning that the cache's sequence stays
    whole; ``ServeEngine(mesh=)`` serves one device's tokens."""
    for rec_split, rec_plain in zip(
            records(ranks, "seq_model_odd", "llama"),
            records(ranks, "seq_model_odd", "llama", "plain")):
        np.testing.assert_array_equal(rec_split["tokens"],
                                      rec_plain["tokens"])
        for a, b in zip(rec_split["logits"], rec_plain["logits"]):
            np.testing.assert_array_equal(a, b)
        assert rec_split["split"] == (False, False)
        assert any("dim 127 is not divisible by mesh axis 'model'" in m
                   for m in rec_split["warnings"]), rec_split["warnings"]
        assert not rec_plain["warnings"]


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "rwkv6-7b"])
def test_state_caches_are_not_split(arch):
    cfg = dataclasses.replace(get_config(arch), moe=None)
    mesh = {"data": 16, "model": 16}
    plain = M.serve_layout(cfg, w.seq_parallel("model").__class__(
        fsdp_axis=None), mesh, 1, 524288)[1]
    split = M.serve_layout(cfg, w.seq_parallel(("data", "model")), mesh, 1,
                           524288)[1]
    schema = M.cache_schema(cfg, 1, 524288)
    states = [n for n, d in schema.items() if "cache_seq" not in d.axes]
    assert states
    for name in states:
        assert split[name] == plain[name], name
    for name, d in schema.items():
        if "cache_seq" in d.axes:
            assert split[name][0][d.axes.index("cache_seq")] == (
                "data", "model"), name
