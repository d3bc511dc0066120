"""Serve steps: prefill and single-token decode, on one device or over a
mesh of ranks.

Counterpart: ``repro.serve.steps``. The reference compiles each step with
``jax.jit`` over a sharded mesh and donates the cache; here each is a
plain function under ``torch.inference_mode()``, and the cache is updated
in place. With ``mesh=`` (a ``DeviceMesh`` with axes among ``pod``,
``data`` and ``model``, ``launch.mesh``) every rank calls the step with
its shards of the parameters and cache (``models.model.serve_placement``)
and its rows of the batch (``sharding.ServeMesh``, ``batch_rows``),
inside ``sharding.serving``: the blocks split heads, channels, widths and
the vocabulary over ``model``, the experts over the expert axis and, with
``shard_cache_seq``, the caches along their sequence. The
logits come back whole on every rank, as the reference's replicated
``out_shardings=None`` logits. With neither mesh nor parallel config
they are the one-device steps; a mesh of size one gives their results.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.models import model as M


def serve_shardings(cfg: ModelConfig, parallel: ParallelConfig, mesh,
                    batch_abstract: Dict, batch: int, max_len: int):
    """(parameter specs, cache specs, batch specs) over ``mesh`` (a
    ``DeviceMesh`` or an ``{axis: size}`` mapping), the reference's, as
    tuples."""
    rules = sh.build_rules(parallel, mesh)
    mshape = sh.mesh_shape_dict(mesh)
    pspecs = M.partition_specs(cfg, rules, mshape)
    cspecs = M.cache_partition_specs(cfg, batch, max_len, rules, mshape)
    bspecs = sh.input_batch_specs(batch_abstract, parallel, mesh)
    return pspecs, cspecs, bspecs


def _serve_mesh(cfg: ModelConfig, mesh, parallel: Optional[ParallelConfig],
                max_len: Optional[int]) -> Optional[sh.ServeMesh]:
    if mesh is None:
        return None
    return M.serve_mesh_of(cfg, parallel or ParallelConfig(), mesh, max_len)


def make_prefill_step(cfg: ModelConfig, parallel: ParallelConfig = None,
                      mesh=None, max_len: Optional[int] = None) -> Callable:
    """``step(params, batch, cache) -> (last-position logits [b, 1, vocab],
    cache)``; over a mesh ``b`` is the whole batch's rows. ``max_len``:
    the cache's, needed where ``parallel.shard_cache_seq`` splits it
    (``models.model.serve_mesh_of``)."""
    smesh = _serve_mesh(cfg, mesh, parallel, max_len)

    def step(params, batch_in: Dict, cache) -> Tuple[torch.Tensor, Dict]:
        with torch.inference_mode(), sh.serving(smesh):
            logits, cache = M.prefill(params, cfg, batch_in, cache)
            if smesh is not None:
                logits = smesh.gather_rows(logits)
            return logits, cache
    return step


def make_decode_step(cfg: ModelConfig, parallel: ParallelConfig = None,
                     mesh=None, max_len: Optional[int] = None) -> Callable:
    """``step(params, cache, batch) -> (logits [b, 1, vocab], cache)``;
    over a mesh ``b`` is the whole batch's rows; ``max_len`` as
    ``make_prefill_step``'s."""
    smesh = _serve_mesh(cfg, mesh, parallel, max_len)

    def step(params, cache, batch_in: Dict) -> Tuple[torch.Tensor, Dict]:
        with torch.inference_mode(), sh.serving(smesh):
            logits, cache = M.decode_step(params, cfg, cache, batch_in)
            if smesh is not None:
                logits = smesh.gather_rows(logits)
            return logits, cache
    return step
