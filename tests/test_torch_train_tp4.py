"""Training over a (data, model) mesh (ROADMAP A8.2b), world 4: gloo on
the CPU.

One spawn of four ``gloo`` ranks (``torch_mesh_workers.tp_worker``) runs
every case of ``tests/test_torch_train_tp.py`` over (data, model) =
(2, 2) and (1, 4), held to the port's one-device step and to the
reference's single-device step with that file's bounds. At (1, 4) each
of smoke llama3.2's and phi3.5-moe's two KV heads is read by two
``model`` ranks: its gradient is summed over them, it is counted once
in the clip norm, and both ranks hold it bitwise alike. Smoke llama3.2
over (2, 2) also runs:

* bf16 compute with int8 moments (a parameter in its moments' block
  layout: the whole leaf's blocks over ``data``, replicated over
  ``model``; every leaf and moment bitwise alike on the model ranks);
* two microbatches;
* a checkpoint (2, 2) -> one device -> (2, 2), bitwise through
  ``gather_tree``, ``elastic_restore`` and ``reshard_tree``.
"""
import numpy as np
import pytest

from repro_torch.config import OptimizerConfig, ParallelConfig

import torch_mesh_workers as w
from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import model_ref as jref  # noqa: F401
from torch_port_ref import reference_train_grads

from test_torch_train_mesh import (BF16_LOSS_RTOL, BF16_PARAM_LR, GRAD_RTOL,
                                   LOSS_RTOL, leaf_err, rel)
from test_torch_train_tp import (KEYS, TP_PARAM_LR, check_case,
                                 check_ranks_agree, ids)

WORLD = 4
CASES = [(shape, case, remat) for shape in w.TP_MESHES[WORLD]
         for case, _, _ in w.TP_CASES for remat in w.TP_REMATS]


@pytest.fixture(scope="module")
def refs(jref):
    return {case: reference_train_grads(jref, kw, arch, KEYS[case],
                                        w.tp_batch(case), w.OPT)
            for case, arch, kw in w.TP_CASES}


@pytest.fixture(scope="module")
def ones(refs):
    return {(case, remat): w.one_device_run(
        w.tp_cfg(case), OptimizerConfig(**w.OPT),
        ParallelConfig(batch_axes=("data",), remat=remat), refs[case][0],
        w.tp_batch(case)) for case, _, _ in w.TP_CASES
        for remat in w.TP_REMATS}


@pytest.fixture(scope="module")
def ranks(refs, tmp_path_factory):
    root = tmp_path_factory.mktemp("train_tp4")
    return w.spawn(w.tp_worker, WORLD, root,
                   {case: r[0] for case, r in refs.items()}, str(root))


@pytest.mark.parametrize("case", CASES, ids=ids)
def test_step_matches_one_device_and_the_reference(case, ranks, ones, refs):
    shape, kind, remat = case
    check_case(kind, ranks[0][case], ones[(kind, remat)], refs[kind])
    check_ranks_agree(ranks, case, shape[1])


def test_bf16_int8_matches_one_device(ranks, refs):
    got = ranks[0]["bf16_int8"]
    metrics, whole, _ = w.one_device_run(
        w.tp_cfg("llama", "bfloat16"),
        OptimizerConfig(state_dtype="int8", **w.OPT),
        ParallelConfig(batch_axes=("data",)), refs["llama"][0],
        w.tp_batch("llama"))
    for g, m in zip(got["metrics"], metrics):
        assert rel(g["loss"], m["loss"]) <= BF16_LOSS_RTOL, (g, m)
    for k, v in whole.items():
        err = float(np.abs(got["whole"][k] - v).max())
        assert err <= BF16_PARAM_LR * w.OPT["lr"], (k, err)
    # int8 moments are replicated over model: every leaf and moment
    check_ranks_agree(ranks, "bf16_int8", 2)
    assert len(ranks[0]["bf16_int8"]["shared"]) == 5 * len(whole) + 1


def test_microbatches_match_one_device(ranks, refs):
    got = ranks[0]["microbatches"]
    metrics, whole, grads = w.one_device_run(
        w.tp_cfg("llama"), OptimizerConfig(**w.OPT),
        ParallelConfig(batch_axes=("data",), microbatches=2),
        refs["llama"][0], w.tp_batch("llama"))
    for g, m in zip(got["metrics"], metrics):
        assert rel(g["loss"], m["loss"]) <= LOSS_RTOL, (g, m)
        assert g["tokens"] == m["tokens"]
    for k in grads:
        assert leaf_err(got["grads"][f"['{k}']"], grads[k]) <= GRAD_RTOL, k
    for k, v in whole.items():
        err = float(np.abs(got["whole"][k] - v).max())
        assert err <= TP_PARAM_LR * w.OPT["lr"], (k, err)
    check_ranks_agree(ranks, "microbatches", 2)


def test_checkpoint_moves_between_2x2_and_one_device(ranks):
    for r in ranks:
        assert r["ckpt"] == {"to_one_bitwise": True, "back_bitwise": True,
                             "reshard_bitwise": True}
