"""The JAX reference for the port's parity tests, imported at test time.

``repro`` does not import on jax releases that dropped
``jax.experimental.enable_x64``; ``reference()`` aliases it to
``jax.enable_x64`` when the name is missing, imports the reference
modules, and on exit removes the alias and every ``repro`` module it
imported. Nothing happens at collection, and the rest of the suite sees
the same ``repro`` import state it would see without the port's tests.
"""
import contextlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch


@contextlib.contextmanager
def reference():
    before = set(sys.modules)
    import jax
    import jax.experimental
    aliased = not hasattr(jax.experimental, "enable_x64")
    if aliased:
        jax.experimental.enable_x64 = jax.enable_x64
    try:
        from repro import configs, faults
        from repro.core import cost, simulate, slo, traffic, twin, whatif
        from repro.distributed import sharding
        from repro.kernels import flash_attention, ops, policy_scan, ref
        from repro.kernels import rwkv6_kernel, ssm_scan
        from repro.models import attention, layers, model, rwkv6, ssm
        yield SimpleNamespace(cost=cost, simulate=simulate, slo=slo,
                              traffic=traffic, twin=twin, whatif=whatif,
                              ops=ops, policy_scan=policy_scan, ref=ref,
                              faults=faults, jax=jax, configs=configs,
                              sharding=sharding,
                              flash_attention=flash_attention,
                              ssm_scan=ssm_scan, rwkv6_kernel=rwkv6_kernel,
                              attention=attention, layers=layers,
                              model=model, ssm=ssm, rwkv6=rwkv6)
    finally:
        for name in set(sys.modules) - before:
            if name == "repro" or name.startswith("repro."):
                del sys.modules[name]
        if aliased:
            del jax.experimental.enable_x64


@pytest.fixture(scope="module")
def model_ref():
    """The reference for the model-side tests, with no activation mesh
    installed (its model code then shards nothing; another test may have
    left one), restored afterwards."""
    with reference() as r:
        act = dict(r.sharding._ACT)
        r.sharding.set_activation_mesh(None, None)
        try:
            yield r
        finally:
            r.sharding.set_activation_mesh(act["mesh"], act["rules"])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tests run small tensors, as fast on one intra-op thread;
    the other cores stay with the parallel test workers. Import this
    fixture into a test module to apply it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(jref, a, dtype):
    """One float array as (jax array, torch tensor) of ``dtype`` (float32
    or bfloat16) holding the same values: a bf16 input is rounded once
    and handed to both sides."""
    jnp = jref.jax.numpy
    j = jnp.asarray(np.asarray(a, np.float32)).astype(
        {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(dtype)


def f32(x) -> np.ndarray:
    """A torch tensor or array-like as a float32 numpy array."""
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


def bits(x) -> np.ndarray:
    """The raw bits of a float array (NaN-safe, -0.0 != +0.0)."""
    a = np.ascontiguousarray(np.asarray(x))
    return a.view({8: np.uint64, 4: np.uint32}[a.dtype.itemsize])


def assert_bitwise(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape,
                                                       b.shape, a.dtype,
                                                       b.dtype)
    diff = bits(a) != bits(b)
    assert not diff.any(), (f"{what}: {int(diff.sum())} elements differ, "
                            f"first at {np.argwhere(diff)[0].tolist()}")


def assert_same_results(port, jax_rows):
    """Field-for-field equality of port and reference result rows (the
    twin compared by policy and parameters)."""
    assert len(port) == len(jax_rows)
    for p, r in zip(port, jax_rows):
        assert p.twin.policy == r.twin.policy
        assert p.twin.params == r.twin.params
        for f in r.__dataclass_fields__:
            if f == "twin":
                continue
            u, v = getattr(p, f), getattr(r, f)
            if isinstance(v, np.ndarray):
                assert_bitwise(u, v, f"{r.name}.{f}")
            else:
                assert type(u) is type(v) and (u == v or (u != u and v != v)), \
                    (r.name, f, u, v)
