"""Serving over a mesh without ranks (ROADMAP A8.2a): the specs and the
compute layout on an ``{axis: size}`` mapping.

* ``serve.steps.serve_shardings`` is the reference's ``serve_shardings``
  (its parameter, cache and batch specs, as tuples) for all ten configs
  at ``(data=16, model=16)`` and ``(2, 2)``, for the engine's prefill
  and decode batches;
* the compute layout of each case where it is not the specs' contiguous
  chunk, cut at every mesh coordinate and put back by the positions
  ``sharding.split_index`` gives, is the whole leaf bit for bit: a
  Mamba ``in_proj`` (each rank's channels of both halves), ``wk`` /
  ``wv`` and the K/V cache where ``model`` exceeds the KV heads (one
  head a rank), RWKV's channel mix (the specs' own chunks; its compute
  gathers the gate) and whisper's vocabulary, which ``model`` does not
  divide (whole on every rank);
* a query-head count that ``model`` does not divide falls back as the
  reference's specs do (ROADMAP C19): each leaf by its spec, no compute
  layout of its own, and the reference's warning naming the axis; so
  does a KV-head count that neither divides nor is divided by it; every
  config places at ``model`` 2, 4, 8 and 16 with each leaf's local
  element count the reference's spec's, but for C23's whole KV head;
* training over a ``model`` axis (``train_layout``) takes the
  reference's specs with ``embed`` over the FSDP axis, in serving's
  compute layout, for all ten configs; where the axis does not divide a
  width it falls back alike, with the warning;
* the serving mesh is the thread's own, and ``f32_product`` off the
  card is the float32 product of the widened operands.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.config import ParallelConfig
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.distributed import sharding as sh
from repro_torch.models import model as M
from repro_torch.serve.steps import serve_shardings

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import model_ref as jref  # noqa: F401

MESHES = ((16, 16), (2, 2))
SLOTS, MAX_LEN = 4, 256


def jax_mesh(shape):
    """What the reference's rule table reads of a mesh."""
    return SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty(shape, dtype=object))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_shardings_are_the_references(jref, arch, shape):
    from repro.config import ParallelConfig as JParallelConfig
    jax = jref.jax
    cfg, jcfg = get_config(arch), jref.configs.get_config(arch)
    jmesh = jax_mesh(shape)
    mesh = {"data": shape[0], "model": shape[1]}
    for batch in ({"tokens": (SLOTS, MAX_LEN // 2)}, {"token": (SLOTS, 1)}):
        jrules = jref.sharding.build_rules(JParallelConfig(), jmesh)
        jshape = jref.sharding.mesh_shape_dict(jmesh)
        want_p = jref.model.partition_specs(jcfg, jrules, jshape)
        want_c = jref.model.cache_partition_specs(jcfg, SLOTS, MAX_LEN,
                                                  jrules, jshape)
        want_b = jref.sharding.input_batch_specs(
            {k: jax.ShapeDtypeStruct(v, jax.numpy.int32)
             for k, v in batch.items()}, JParallelConfig(), jmesh)
        got_p, got_c, got_b = serve_shardings(
            cfg, ParallelConfig(), mesh,
            {k: torch.empty(v, device="meta") for k, v in batch.items()},
            SLOTS, MAX_LEN)
        for got, want in ((got_p, want_p), (got_c, want_c),
                          (got_b, want_b)):
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k] == tuple(want[k]), (k, got[k], want[k])


def cut_and_rejoin(whole, spec, kind, mesh):
    """Every rank's cut of ``whole`` by the layout, put back into a new
    tensor at the positions each came from."""
    axes = list(mesh)
    out = torch.full_like(whole, float("nan"))
    for flat in range(int(np.prod([mesh[a] for a in axes]))):
        coord = dict(zip(axes, np.unravel_index(flat, [mesh[a]
                                                         for a in axes])))
        cuts = sh.cut_indices(tuple(whole.shape), spec, mesh, coord, kind)
        piece, index = whole, [slice(None)] * whole.dim()
        for dim, _, idx in cuts:
            piece = piece.index_select(dim, idx)
            index[dim] = idx
        grid = torch.meshgrid(*[
            torch.arange(whole.shape[d]) if isinstance(index[d], slice)
            else index[d] for d in range(whole.dim())], indexing="ij")
        out[grid] = piece
    return out


#: (arch, overrides, leaf name suffix, whether it is a cache leaf)
LAYOUT_CASES = (
    ("jamba-1.5-large-398b", {}, "mixer.in_proj", False),
    ("jamba-1.5-large-398b", {}, "mixer.conv", True),
    ("llama3.2-1b", {}, "attn.wk", False),
    ("llama3.2-1b", {}, "attn.v", True),
    ("phi3.5-moe-42b-a6.6b", {}, "moe.w_down", False),
    ("rwkv6-7b", {}, "cmix.wv", False),
    ("rwkv6-7b", {}, "cmix.wr", False),
    ("rwkv6-7b", {}, ".wkv", True),
    ("whisper-small", {"vocab_size": 257}, "embed.table", False),
)


@pytest.mark.parametrize("model", (2, 4))
@pytest.mark.parametrize("arch, kw, leaf, cache", LAYOUT_CASES,
                         ids=[f"{a[:6]}-{n}" for a, _, n, _ in
                              LAYOUT_CASES])
def test_compute_layout_gathers_back_bitwise(arch, kw, leaf, cache, model):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    mesh = {"data": 2, "model": model}
    pl, cl = M.serve_layout(cfg, ParallelConfig(), mesh, SLOTS, MAX_LEN)
    layout = cl if cache else pl
    names = [n for n in layout if n.endswith(leaf)]
    assert names, leaf
    gen = torch.Generator().manual_seed(0)
    for name in names:
        spec, shape, kind = layout[name]
        whole = torch.randn(shape, generator=gen)
        back = cut_and_rejoin(whole, spec, kind, mesh)
        assert torch.equal(back, whole), name
        # the rank's cut is the compute layout's: rank (0, 1)'s channels
        cut = sh.cut_indices(shape, spec, mesh, {"data": 0, "model": 1},
                             kind)
        if leaf == "mixer.in_proj":
            di = shape[-1] // 2
            (_, _, idx), = [c for c in cut if c[1] == "model"]
            part = di // model
            assert idx.tolist() == list(range(part, 2 * part)) + list(
                range(di + part, di + 2 * part))
        if leaf in ("attn.wk", "attn.v") and model == 4:
            # 2 KV heads over 4: rank 1's query heads read head 0
            (dim, _, idx), = [c for c in cut if c[1] == "model"]
            width = shape[dim] // cfg.attention.num_kv_heads
            assert idx.tolist() == list(range(width))
        if leaf == "embed.table":
            assert not [c for c in cut if c[1] == "model"]


@pytest.fixture
def fresh_warnings(monkeypatch):
    """The fall-back warns once a process; each test sees its own."""
    monkeypatch.setattr(sh, "_REPLICATION_WARNED", set())


def test_query_heads_the_model_axis_does_not_divide_raise(fresh_warnings):
    """qwen2-vl-7b's 28 query heads (4 KV heads) over 8: no raise now
    (C19); the reference's warning names the axis, and every leaf is its
    spec's (``wq`` 448 columns, 3.5 heads; ``wk`` 64 columns, half a
    head; ``wo`` 448 rows; the K/V cache whole). So for 12 query heads
    over 3 KV heads at 4: ``wq``'s columns split at whole heads, the KV
    heads fall back (and attention runs over every head)."""
    cfg = get_config("qwen2-vl-7b")         # 28 query heads
    assert M.check_serve_model_axis(cfg, 4) == []
    with pytest.warns(RuntimeWarning, match="'heads_act'.*dim 28 is not "
                      "divisible by mesh axis 'model' \\(size 8\\)"):
        assert M.check_serve_model_axis(cfg, 8) == [("heads_act", 28),
                                                   ("kv_heads_act", 4)]
    mesh = {"data": 1, "model": 8}
    sh._REPLICATION_WARNED.clear()
    with pytest.warns(RuntimeWarning, match="'heads_act'"):
        pl, cl = M.serve_layout(cfg, ParallelConfig(), mesh, SLOTS, MAX_LEN)
    pspecs, cspecs = M.serve_specs(cfg, ParallelConfig(), mesh, SLOTS,
                                   MAX_LEN)
    for layout, specs in ((pl, pspecs), (cl, cspecs)):
        for name, (spec, _, kind) in layout.items():
            assert (spec, kind) == (specs[name], None), name
    assert pl["stack.blk0.attn.wq"][0] == (None, None, "model")
    assert pl["stack.blk0.attn.wk"][0] == (None, None, "model")
    assert pl["stack.blk0.attn.wo"][0] == (None, "model", None)
    assert cl["stack.blk0.attn.k"][0] == (None, None, None, None, None)
    odd = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              attention=dataclasses.replace(
                                  get_smoke_config("llama3.2-1b").attention,
                                  num_heads=12, num_kv_heads=3))
    with pytest.warns(RuntimeWarning, match="'kv_heads_act'.*dim 3 .*"
                      "'model' \\(size 4\\)"):
        assert M.check_serve_model_axis(odd, 4) == [("kv_heads_act", 3)]
        pl, _ = M.serve_layout(odd, ParallelConfig(),
                               {"data": 1, "model": 4}, SLOTS, MAX_LEN)
    assert pl["stack.blk0.attn.wk"] == ((None, None, "model"), (2, 64, 48),
                                        None)


def local_count(shape, spec, mesh, kind=None):
    """The elements of rank (0, 1)'s cut of a leaf."""
    n = int(np.prod(shape))
    coord = {a: 1 if a == "model" else 0 for a in mesh}
    for dim, _, idx in sh.cut_indices(shape, spec, mesh, coord, kind):
        n = n // shape[dim] * len(idx)
    return n


@pytest.mark.parametrize("size", (2, 4, 8, 16))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_config_serves_at_model_2_and_4(jref, arch, size):
    """Every config places over ``model`` = 2, 4, 8 and 16 without a
    raise, and every leaf's local element count is that of the
    reference's spec (``embed`` left whole, C20), but where the axis
    splits the query heads and is a multiple of the KV heads: a rank
    then holds the whole KV head its query heads read (C23)."""
    from repro.config import ParallelConfig as JParallelConfig
    cfg, jcfg = get_config(arch), jref.configs.get_config(arch)
    mesh = {"data": 1, "model": size}
    jmesh = jax_mesh((1, size))
    jrules = dict(jref.sharding.build_rules(JParallelConfig(), jmesh),
                  embed=None)
    jshape = jref.sharding.mesh_shape_dict(jmesh)
    want_p = jref.model.partition_specs(jcfg, jrules, jshape)
    want_c = jref.model.cache_partition_specs(jcfg, SLOTS, MAX_LEN, jrules,
                                              jshape)
    pl, cl = M.serve_layout(cfg, ParallelConfig(), mesh, SLOTS, MAX_LEN)
    a = cfg.attention
    c23 = ("attn" in cfg.block_pattern and a.num_heads % size == 0
           and a.num_kv_heads % size and size % a.num_kv_heads == 0)
    for layout, want in ((pl, want_p), (cl, want_c)):
        assert sorted(layout) == sorted(want)
        for name, (spec, shape, kind) in layout.items():
            got = local_count(shape, spec, mesh, kind)
            ref = local_count(shape, tuple(want[name]), mesh)
            if c23 and kind is not None and kind[1] == "heads":
                # one whole KV head where the spec cuts a part of one
                # (a weight's columns) or keeps every head (a cache)
                n = int(np.prod(shape))
                assert got == n // a.num_kv_heads, name
                assert ref in (n // size, n), name
            else:
                assert got == ref, (name, got, ref)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_training_layout_keeps_fsdp_in_the_compute_layout(arch):
    """Training over (data, model) computes in serving's layout with
    ``embed`` split over ``data`` where the reference's specs split it;
    every other entry and kind is serving's."""
    cfg = get_config(arch)
    par = ParallelConfig()
    for shape in ((2, 2), (1, 4)):
        mesh = {"data": shape[0], "model": shape[1]}
        train = M.train_layout(cfg, par, mesh)
        serve, _ = M.serve_layout(cfg, par, mesh, SLOTS, MAX_LEN)
        ref = M.partition_specs(cfg, sh.build_rules(par, mesh), mesh)
        assert sorted(train) == sorted(serve)
        for name, (spec, shape_, kind) in train.items():
            sspec, sshape, skind = serve[name]
            assert (shape_, kind) == (sshape, skind), name
            for e, s_, r in zip(spec, sspec, ref[name]):
                assert e == (r if r == "data" else s_), (name, spec)


def test_training_over_model_refuses_what_does_not_divide(fresh_warnings):
    """3 query heads (1 KV head) over model=2: no raise now (C19); the
    reference's specs with ``embed`` over the FSDP axis, the column
    shards cut across a head, and the warning naming the axis (the step
    itself runs over gloo ranks in ``tests/test_torch_train_mesh.py`` and
    ``tests/test_torch_serve_fallback.py``)."""
    odd = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              attention=dataclasses.replace(
                                  get_smoke_config("llama3.2-1b").attention,
                                  num_heads=3, num_kv_heads=1))
    for mesh in ({"data": 1, "model": 2}, {"data": 2, "model": 2}):
        sh._REPLICATION_WARNED.clear()
        with pytest.warns(RuntimeWarning, match="'heads_act'.*dim 3 .*"
                          "'model' \\(size 2\\)"):
            layout = M.train_layout(odd, ParallelConfig(), mesh)
        ref = M.partition_specs(odd, sh.build_rules(ParallelConfig(), mesh),
                                mesh)
        for name, (spec, _, kind) in layout.items():
            assert (spec, kind) == (ref[name], None), name
        fsdp = "data" if mesh["data"] > 1 else None
        assert layout["stack.blk0.attn.wq"][0] == (None, fsdp, "model")
        assert layout["stack.blk0.attn.wk"][0] == (None, fsdp, "model")
        assert layout["stack.blk0.attn.wo"][0] == (None, "model", fsdp)


def test_the_serving_mesh_is_this_threads_only():
    """A step serving over a mesh on one thread leaves the steps of
    another thread on one device (``ServeEngine.as_pipeline`` serves on a
    worker thread)."""
    import threading
    mesh = sh.ServeMesh(None, 2, 1, None, 1, 0, None, 1, 0)
    inside, looked = threading.Event(), threading.Event()
    seen = {}

    def other():
        inside.wait(10)
        seen["other"] = sh.serve_mesh()
        looked.set()
    worker = threading.Thread(target=other)
    worker.start()
    with sh.serving(mesh):
        inside.set()
        looked.wait(10)
        seen["here"] = sh.serve_mesh()
    worker.join()
    assert seen == {"other": None, "here": mesh}
    assert sh.serve_mesh() is None


def test_f32_product_off_the_card_is_the_widened_product():
    from repro_torch.models.layers import f32_product
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(8, 5, generator=gen).bfloat16()
    for x in (torch.randn(2, 3, 8, generator=gen).bfloat16(),
              torch.randn(3, 8, generator=gen)):
        y = f32_product(x, w)
        assert y.dtype == torch.float32
        assert torch.equal(y, x.float() @ w.float())


#: the dry run's production meshes: (axes, shape)
PRODUCTION = ((("data", "model"), (16, 16)),
              (("pod", "data", "model"), (2, 16, 16)))


@pytest.mark.parametrize("axes, dims", PRODUCTION,
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("shape_name", ("decode_32k", "long_500k"))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_seq_split_cache_specs_are_the_references(jref, arch, shape_name,
                                                  axes, dims):
    """The flash-decoding layout of the dry run's decode cells
    (``launch.dryrun.default_parallel``: the cache's sequence over
    ``model``, or over ``("data", "model")`` below a batch of 16): the
    port's cache specs are the reference's, ``kv_heads`` left whole where
    ``model`` alone carries the sequence."""
    from repro.config import ParallelConfig as JParallelConfig
    from repro_torch.config import get_shape
    from repro_torch.launch.dryrun import default_parallel, skip_reason
    shape = get_shape(shape_name)
    par = default_parallel(shape)
    assert par.shard_cache_seq
    jpar = JParallelConfig(fsdp_axis=None, shard_cache_seq=True,
                           seq_axis=par.seq_axis)
    jmesh = SimpleNamespace(axis_names=axes,
                            devices=np.empty(dims, dtype=object))
    mesh = dict(zip(axes, dims))
    want = jref.model.cache_partition_specs(
        jref.configs.get_config(arch), shape.global_batch, shape.seq_len,
        jref.sharding.build_rules(jpar, jmesh),
        jref.sharding.mesh_shape_dict(jmesh))
    got = M.cache_partition_specs(get_config(arch), shape.global_batch,
                                  shape.seq_len, sh.build_rules(par, mesh),
                                  mesh)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == tuple(want[k]), (k, got[k], want[k])
    seq = got.get("stack.blk0.attn.k", got.get("stack.blk0.attn.ckv"))
    if seq is None:
        return
    assert seq[2] == par.seq_axis
    if "model" in seq[3:]:
        # KV heads that model divides beside a sequence over (data,
        # model): the reference's spec names model twice, which the
        # port's placement refuses; the dry run skips these cells (pure
        # attention at 500k tokens)
        assert skip_reason(arch, shape)
        with pytest.raises(ValueError, match="twice"):
            sh.check_spec(seq)
