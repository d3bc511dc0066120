"""Fault-tolerant checkpointing.

Counterpart: ``repro.checkpoint.ckpt``, on its on-disk layout, so a
checkpoint written by either package restores in the other:
``<dir>/step_<N:08d>/`` holds ``shard_0.npz`` (one array ``a<i>`` per
leaf, the leaves in sorted key order) and ``manifest.json`` (``step``,
``keys``: each leaf's key, array name, dtype and shape, and ``extra``).
A leaf's key is the reference's ``jax.tree_util.keystr`` of its path:
``[0]['embed.table']`` for a parameter of ``(params, opt_state)``,
``[1].step`` and ``[1].m['embed.table']`` for the optimizer's. bfloat16
leaves are stored widened to float32 (npz cannot hold them) and restored
by the manifest's dtype.

Writes go to ``step_<N>.tmp`` and are published by ``os.replace``, so a
crash mid-write never corrupts the latest checkpoint. ``AsyncCheckpointer``
snapshots the tree to host memory when ``save`` is called and writes on a
worker thread, keeping the newest ``keep`` checkpoints. Trees are nested
dicts, tuples, lists and NamedTuples (``OptState``) of tensors or numpy
arrays; restore places each leaf on the device and in the dtype of the
matching leaf of ``like``.

Over a mesh (``distributed.sharding``) a checkpoint stays whole: the
writer gathers the shards (``gather_tree``) and one rank writes; restore
with ``shardings=`` (a matching tree of ``Sharding``s) cuts each rank's
shard out of the whole leaf, so a checkpoint written by any number of
ranks restores onto any other. ``reshard_tree`` re-places a whole tree
under shardings without touching disk.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"


def _items(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the reference's flattening order, keyed as
    ``jax.tree_util.keystr`` keys them (dict keys sorted)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                _items(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields for kv in
                _items(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, x in enumerate(tree) for kv in
                _items(x, f"{path}[{i}]")]
    if tree is None:
        return []
    return [(path, tree)]


def _rebuild(tree, leaf_of, path: str = ""):
    """``tree`` with each leaf replaced by ``leaf_of(key, leaf)``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_of, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), leaf_of,
                                     f"{path}.{f}") for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, leaf_of, f"{path}[{i}]")
                          for i, x in enumerate(tree))
    if tree is None:
        return None
    return leaf_of(path, tree)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(a host copy numpy can store, the dtype name the manifest keeps)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.to("cpu", torch.float32, copy=True).numpy(), "bfloat16"
        arr = t.to("cpu", copy=True).numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[Dict] = None) -> str:
    """Synchronous atomic checkpoint write; returns the step's directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {}
    manifest = {"step": step, "keys": [], "extra": extra or {}}
    for i, (key, leaf) in enumerate(sorted(_items(tree),
                                           key=lambda kv: kv[0])):
        arr, dtype = ((leaf.array, leaf.dtype) if isinstance(leaf, _Snapshot)
                      else _host(leaf))
        name = f"a{i}"
        arrays[name] = arr
        manifest["keys"].append({"key": key, "name": name, "dtype": dtype,
                                 "shape": list(arr.shape)})
    np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):          # idempotent re-save of the same step
        shutil.rmtree(final)
    os.replace(tmp, final)             # atomic publish
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, MANIFEST)):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _zip_shardings(tree, shardings) -> Dict[str, Any]:
    """{key: Sharding} of ``shardings``, keyed as ``tree``'s leaves."""
    got = dict(_items(shardings))
    keys = [k for k, _ in _items(tree)]
    missing = [k for k in keys if k not in got]
    if missing:
        raise KeyError(f"no sharding for {missing[:3]}")
    return got


def reshard_tree(tree, shardings):
    """Each leaf of a whole ``tree`` (tensors or arrays, on any device)
    cut to this rank's shard under the matching ``Sharding`` of
    ``shardings`` and placed on its device: the reference's re-placement
    of a tree under new shardings, without touching disk."""
    sh = _zip_shardings(tree, shardings)

    def leaf_of(key, leaf):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
            np.asarray(leaf))
        return sh[key].shard(t).to(sh[key].device)
    return _rebuild(tree, leaf_of)


def gather_tree(tree, shardings):
    """The whole tree from every rank's shards (a collective: every rank
    of the mesh calls it), each leaf on its shard's device."""
    sh = _zip_shardings(tree, shardings)
    return _rebuild(tree, lambda key, leaf: sh[key].gather(leaf))


def restore_checkpoint(directory: str, step: Optional[int], like,
                       shardings=None):
    """(tree, step, extra): the checkpoint at ``step`` (the latest when
    None) in the structure of ``like``, each leaf a tensor on the device
    and in the dtype of ``like``'s leaf. With ``shardings`` (a tree of
    ``Sharding``s matching ``like``, whose leaves then only give the
    whole shapes and dtypes: ``meta`` tensors do) each leaf is this
    rank's shard, on its sharding's device."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "shard_0.npz"))
    names = {e["key"]: e["name"] for e in manifest["keys"]}
    sh = None if shardings is None else _zip_shardings(like, shardings)

    def leaf_of(key, leaf):
        if key not in names:
            raise KeyError(f"{key} is not in the checkpoint at {path}")
        arr = data[names[key]]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                             f"expected {tuple(leaf.shape)}")
        t = torch.from_numpy(arr)
        if sh is not None:
            return sh[key].shard(t).to(device=sh[key].device,
                                       dtype=leaf.dtype)
        return t.to(device=leaf.device, dtype=leaf.dtype)
    tree = _rebuild(like, leaf_of)
    return tree, step, manifest.get("extra", {})


class _Snapshot:
    """A leaf already copied to the host: its array and manifest dtype."""
    __slots__ = ("array", "dtype")

    def __init__(self, leaf):
        self.array, self.dtype = _host(leaf)


class AsyncCheckpointer:
    """Snapshot-then-write-async. ``save`` returns once the host snapshot
    exists; the (slow) serialization happens on a worker thread. ``wait``
    drains pending writes (call before exit / before restore); ``close``
    drains them and joins the worker."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue()
        self.errors: list = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, host_tree, extra = item
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
                self._gc()
            except Exception as e:   # noqa: BLE001
                self.errors.append(e)
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory,
                                       f"step_{s:08d}"), ignore_errors=True)

    def save(self, step: int, tree, extra: Optional[Dict] = None):
        host_tree = _rebuild(tree, lambda _, x: _Snapshot(x))
        self._q.put((step, host_tree, extra))

    def wait(self):
        self._q.join()

    def close(self):
        self.wait()
        self._q.put(None)
        self._worker.join(timeout=5)
