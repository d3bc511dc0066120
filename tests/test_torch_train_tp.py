"""Training over a (data, model) mesh (ROADMAP A8.2b), world 2: gloo on
the CPU.

One spawn of two ``gloo`` ranks (``torch_mesh_workers.tp_worker``) runs
every case over (data, model) = (1, 2); this process holds their results
to the port's one-device step and to the reference's single-device step
on the whole batch:

* the smoke GQA (llama3.2), MLA (minicpm3), Mamba (Jamba without
  experts), RWKV-6 and MoE (phi3.5-moe) kinds in float32, remat ``none``
  and ``full``: the first step's loss and every leaf's gradient
  (``LOSS_RTOL`` and ``GRAD_RTOL`` of ``tests/test_torch_train_mesh.py``;
  RWKV-6 against the reference ``REF_GRAD_RTOL``) and the parameters
  after two steps (``TP_PARAM_LR``), the ranks' metrics equal and the
  leaves and moments they share bitwise;
* a ``remat="full"`` backward run from a thread other than the
  forward's (the CPU's stand-in for CUDA's device thread) gives the
  gradients of one run on the forward's thread, bitwise;
* ``python -m repro_torch.launch.train --model 2`` trains (its
  parameters near the one-device launcher's).

``tests/test_torch_train_tp4.py`` runs (2, 2) and (1, 4) in a world of 4.
"""
import numpy as np
import pytest
import torch

from repro_torch.config import OptimizerConfig, ParallelConfig

import torch_mesh_workers as w
from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import model_ref as jref  # noqa: F401
from torch_port_ref import reference_train_grads

from test_torch_train_mesh import GRAD_RTOL, LOSS_RTOL, leaf_err, rel

#: the parameters after two float32 steps over ``model`` against one
#: device, in learning rates. A row-parallel sum rounds otherwise than
#: one device's product, and AdamW turns a gradient g near its eps
#: (1e-8) into a step of g / (|g| + eps) lr, which a difference d in g
#: moves by about d / (4 eps) lr: measured on this CPU up to 0.036 lr
#: (Jamba's w_gate; llama 0.027, phi3.5-moe 0.012, rwkv6 0.018), all at
#: gradients within a few eps of zero (test_torch_train_mesh.py's
#: PARAM_LR of 0.01 lr was measured over data alone, whose sums round
#: as one device's)
TP_PARAM_LR = 0.1
#: RWKV-6's gradients against the reference's: the port's one-device
#: step itself reads 4.0e-5 of the reference's (its WKV recurrence
#: rounds otherwise), the mesh 4.1e-5; every other kind GRAD_RTOL
REF_GRAD_RTOL = {"rwkv6": 1e-4}
#: the launcher's bf16 parameters after three steps over model=2
#: against one device's, in learning rates: a bf16 gradient near zero
#: may flip the sign of a step (each moves a parameter by about lr);
#: measured 2.51 (over data=2, 1.43: BF16_PARAM_LR of
#: test_torch_train_mesh.py)
LAUNCH_PARAM_LR = 3.0
WORLD = 2
#: the reference parameters' PRNG key of each case
KEYS = {case: 10 + i for i, (case, _, _) in enumerate(w.TP_CASES)}
CASES = [(shape, case, remat) for shape in w.TP_MESHES[WORLD]
         for case, _, _ in w.TP_CASES for remat in w.TP_REMATS]


def ids(c):
    return f"{c[0][0]}x{c[0][1]}-{c[1]}-{c[2]}"


@pytest.fixture(scope="module")
def refs(jref):
    """{case: (parameters, the reference's first metrics, its
    gradients)}."""
    return {case: reference_train_grads(jref, kw, arch, KEYS[case],
                                        w.tp_batch(case), w.OPT)
            for case, arch, kw in w.TP_CASES}


@pytest.fixture(scope="module")
def ones(refs):
    """{(case, remat): the port's one-device run}."""
    return {(case, remat): w.one_device_run(
        w.tp_cfg(case), OptimizerConfig(**w.OPT),
        ParallelConfig(batch_axes=("data",), remat=remat), refs[case][0],
        w.tp_batch(case)) for case, _, _ in w.TP_CASES
        for remat in w.TP_REMATS}


@pytest.fixture(scope="module")
def ranks(refs, tmp_path_factory):
    root = tmp_path_factory.mktemp("train_tp")
    return w.spawn(w.tp_worker, WORLD, root,
                   {case: r[0] for case, r in refs.items()}, str(root))


def check_case(kind, got, one, ref):
    """The first step's loss and gradients against the port's one-device
    step and the reference's; the parameters after two steps against the
    one-device step's."""
    metrics, whole, grads = one
    _, jm, jgrads = ref
    assert rel(got["metrics"][0]["loss"], jm["loss"]) <= LOSS_RTOL
    for g, m in zip(got["metrics"], metrics):
        assert rel(g["loss"], m["loss"]) <= LOSS_RTOL, (g, m)
        assert g["tokens"] == m["tokens"]
    for k in grads:
        mine = got["grads"][f"['{k}']"]
        assert leaf_err(mine, grads[k]) <= GRAD_RTOL, k
        assert leaf_err(mine, jgrads[k]) <= REF_GRAD_RTOL.get(
            kind, GRAD_RTOL), k
    for k, v in whole.items():
        err = float(np.abs(got["whole"][k] - v).max())
        assert err <= TP_PARAM_LR * w.OPT["lr"], (k, err)


def check_ranks_agree(recs, key, model):
    """Every rank's metrics equal; the ranks of one data index hold the
    leaves and moments they share bitwise alike (K/V heads within each
    group of ranks that read them)."""
    for r in recs[1:]:
        assert r[key]["metrics"] == recs[0][key]["metrics"]
    for i in range(0, len(recs), model):
        group = [r[key]["shared"] for r in recs[i:i + model]]
        assert group[0]
        for k, (holders, a) in group[0].items():
            assert holders == -1 or holders == 0, k
        for k in group[0]:
            same = {}
            for shared in group:
                holders, a = shared[k]
                if holders in same:
                    np.testing.assert_array_equal(a, same[holders],
                                                  err_msg=k)
                same.setdefault(holders, a)
            assert len(same) == 1 or -1 not in same, k


@pytest.mark.parametrize("case", CASES, ids=ids)
def test_step_matches_one_device_and_the_reference(case, ranks, ones, refs):
    shape, kind, remat = case
    check_case(kind, ranks[0][case], ones[(kind, remat)], refs[kind])
    check_ranks_agree(ranks, case, shape[1])


@pytest.mark.parametrize("case", ["llama", "phi35_moe"])
def test_remat_backward_on_another_thread(case, ranks):
    """The recomputation re-enters the forward's context on the
    backward's thread: the same gradients, bitwise, on every rank."""
    for r in ranks:
        got = r["thread"][case]
        assert sorted(got["same"]) == sorted(got["other"])
        for k, g in got["same"].items():
            assert g is not None, k
            np.testing.assert_array_equal(g, got["other"][k], err_msg=k)


def test_launcher_trains_over_model_2(ranks, tmp_path):
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    from repro_torch.distributed.elastic import state_like
    from repro_torch.launch import train as launch_train
    assert ranks[0]["launch_rc"] == 0 and ranks[1]["launch_rc"] == 0
    one = str(tmp_path / "launch_one")
    assert launch_train.main(
        ["--smoke", "--device", "cpu", "--steps", "3", "--seq-len", "32",
         "--batch", "4", "--ckpt-dir", one, "--ckpt-every", "3"]) == 0
    args = launch_train.parse_args(["--smoke", "--steps", "3"])
    cfg, _, ocfg, _ = launch_train.configs(args)
    (p2, _), s2, _ = restore_checkpoint(ranks[0]["launch_dir"], None,
                                        state_like(cfg, ocfg, "cpu"))
    (p1, _), s1, _ = restore_checkpoint(one, None,
                                        state_like(cfg, ocfg, "cpu"))
    assert s1 == s2 == 3
    for k in p1:
        err = float((p2[k] - p1[k]).abs().max())
        assert err <= LAUNCH_PARAM_LR * ocfg.lr, (k, err)


@pytest.mark.parametrize("shapes", [((3, 5, 8), (8, 4)),
                                    ((2, 5, 8), (2, 8, 4))])
def test_f32_product_backward_is_the_operands_dtype_product(shapes,
                                                            monkeypatch):
    """On the card a row-parallel product of bf16 operands is cuBLAS's
    float32-output product, which has no derivative; ``_F32Product``
    gives it the backward of one device's bf16 product, bit for bit (the
    CPU has no float32-output product: the float32 product of the
    widened operands stands in for its forward)."""
    from repro_torch.models import layers as L
    monkeypatch.setattr(L, "_mm_f32", lambda x, w: x.float() @ w.float())
    g = torch.Generator().manual_seed(0)
    x, wt = (torch.randn(s, generator=g).bfloat16().requires_grad_()
             for s in shapes)
    y = L._F32Product.apply(x, wt)
    assert y.dtype == torch.float32
    dy = torch.randn(y.shape, generator=g).bfloat16()
    got = torch.autograd.grad(y, (x, wt), dy.float())
    want = torch.autograd.grad(x @ wt, (x, wt), dy)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b)
