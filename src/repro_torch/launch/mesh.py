"""Mesh construction over the ranks of ``torch.distributed``.

Counterpart: ``repro.launch.mesh``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named axes over the
ranks of the default process group, which the caller starts (one process
per GPU: ``torchrun --nproc-per-node=N``, or ``torch.multiprocessing``)
and initializes. Functions, not constants, so importing this module
touches no process group. Single pod: 16 x 16 = 256 ranks, axes
``("data", "model")``; multi-pod: 2 x 16 x 16 = 512, axes ``("pod",
"data", "model")``, the leading axis the slowest varying (rank-major
order, as ``jax.make_mesh`` orders devices).
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import require_ranks, world_size


def _mesh(shape, axes, device) -> DeviceMesh:
    dev = resolve_device(device)
    n = 1
    for s in shape:
        n *= s
    ranks = torch.arange(n, dtype=torch.int64).reshape(shape)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"
                         ) -> DeviceMesh:
    """The production mesh over the first 256 (512 with ``multi_pod``)
    ranks; raises ``ValueError`` naming the shape when the world is
    smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    require_ranks(n, f"make_production_mesh: the {shape} mesh {axes}")
    return _mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, *, device="cuda"
                   ) -> DeviceMesh:
    """A small ``("data", "model")`` mesh over the ranks that exist, the
    reference's clamping: ``data`` at most the world, ``model`` at most
    what is left (ranks past ``data * model`` hold no shard). Raises
    ``ValueError`` without a process group."""
    require_ranks(1, "make_host_mesh")
    n = world_size()
    data = max(1, min(int(data), n))
    model = max(1, min(int(model), n // data))
    return _mesh((data, model), ("data", "model"), device)
