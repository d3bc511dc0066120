"""Dispatch between the port's kernels and their plain versions.

Counterpart: ``repro.kernels.ops`` (its policy scans, ``sdpa``,
``ssm_scan`` and ``rwkv6_scan``). Where the reference selects with a
global Pallas switch, the port selects by the device the tensors are on:
CUDA tensors run the hand-written kernels (``kernels/policy_scan.py``,
``kernels/flash_attention.py``, ``kernels/ssm_scan.py``,
``kernels/rwkv6_kernel.py``), CPU tensors the plain PyTorch versions
(``kernels/ref.py``). The model half routes as the reference does with
Pallas on: ``sdpa`` takes the flash kernel's semantics only for
prefill-shaped calls (no ``kv_len``, no ``logit_cap``, more than one
query) and ``ref.sdpa`` otherwise, on either device; ``ssm_scan`` and
``rwkv6_scan`` always take their scan kernels', prefill and decode alike.
``rwkv6_scan``'s semantics are the exact recurrence of the reference's
oracle, which its Pallas kernel departs from at strong decays.

In the policy half the selector is exactly one of ``onehot`` [N, P] (a
mixed grid, the masked blend) or ``policy_index`` (an int: a uniform
block). On CUDA a uniform index becomes its one-hot row broadcast over the
block, as the reference does for its kernel (with shed's fault rounding
set to the uniform scans', ``SHED_FUSE_ALL``); on the CPU it runs the one
lane step without the blend, like the reference's ``lax.switch`` form.
"""
from __future__ import annotations

import torch

from repro_torch.core.twin import (SHED_FUSE_ALL, SHED_FUSE_DROP,
                                   SHED_FUSE_LATENCY, num_policies)
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import policy_scan as policy_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_kernel
from repro_torch.kernels import ssm_scan as ssm_kernel


def _onehot_rows(policy_index, n: int, device) -> torch.Tensor:
    row = torch.zeros(num_policies(), dtype=torch.float32, device=device)
    row[int(policy_index)] = 1.0
    return row.expand(n, -1).contiguous()


def _check_selector(onehot, policy_index):
    if (onehot is None) == (policy_index is None):
        raise ValueError("pass exactly one of onehot= (mixed grid) or "
                         "policy_index= (uniform lane block)")


def policy_scan(loads, params, onehot=None, dt_hours: float = 1.0, *,
                policy_index=None, loads_t=None, load_index=None,
                caps_t=None, fault_index=None):
    """(carry_end [N, CARRY_DIM], five [N, T] series) — see
    ``kernels.policy_scan.policy_grid_scan`` for the operands; ``caps_t``
    [T, F] + ``fault_index`` [N] run the fault layer."""
    _check_selector(onehot, policy_index)
    shed_fuse = SHED_FUSE_DROP
    if onehot is None:
        if not params.is_cuda:
            return ref.policy_grid_scan(
                policy_kernel.gather_loads(loads, loads_t, load_index),
                params, dt_hours=dt_hours, policy_index=policy_index,
                caps=policy_kernel.gather_rows(caps_t, fault_index))
        onehot = _onehot_rows(policy_index, params.shape[0], params.device)
        shed_fuse = SHED_FUSE_ALL
    return policy_kernel.policy_grid_scan(
        loads, params, onehot, dt_hours, loads_t=loads_t,
        load_index=load_index, caps_t=caps_t, fault_index=fault_index,
        shed_fuse=shed_fuse)


def policy_scan_agg(loads, params, onehot=None, dt_hours: float = 1.0, *,
                    policy_index=None, slo_limit: float = float("inf"),
                    slo_mode: int = 0, loads_t=None, load_index=None,
                    caps_t=None, fmask_t=None, fault_index=None):
    """(carry_end [N, CARRY_DIM], agg [N, AGG_DIM]) — the Table II
    statistics folded into the scan, no [N, T] series on either path;
    see ``kernels.policy_scan.policy_grid_agg``; ``caps_t``/``fmask_t``
    [T, F] + ``fault_index`` [N] run the fault layer."""
    _check_selector(onehot, policy_index)
    shed_fuse = SHED_FUSE_LATENCY
    if onehot is None:
        if not params.is_cuda:
            return ref.policy_grid_agg(
                policy_kernel.gather_loads(loads, loads_t, load_index),
                params, dt_hours=dt_hours, policy_index=policy_index,
                slo_limit=slo_limit, slo_mode=slo_mode,
                caps=policy_kernel.gather_rows(caps_t, fault_index),
                fmask=policy_kernel.gather_rows(fmask_t, fault_index))
        onehot = _onehot_rows(policy_index, params.shape[0], params.device)
        shed_fuse = SHED_FUSE_ALL
    return policy_kernel.policy_grid_agg(
        loads, params, onehot, dt_hours, slo_limit=slo_limit,
        slo_mode=slo_mode, loads_t=loads_t, load_index=load_index,
        caps_t=caps_t, fmask_t=fmask_t, fault_index=fault_index,
        shed_fuse=shed_fuse)


def sdpa(q, k, v, *, causal=True, scale=None, logit_cap=0.0, kv_len=None):
    """Attention, routed as the reference's ``ops.sdpa`` under Pallas:
    the flash kernel (its float32 semantics) for prefill, ``ref.sdpa``
    (bf16 probabilities, ``kv_len`` masking) for decode and capped
    logits."""
    if kv_len is None and logit_cap == 0.0 and q.shape[1] > 1:
        return flash_kernel.flash_attention(q, k, v, causal=causal,
                                            scale=scale)
    return ref.sdpa(q, k, v, causal=causal, scale=scale,
                    logit_cap=logit_cap, kv_len=kv_len)


def ssm_scan(x, dt, A, B, C, D, state=None):
    """The Mamba-1 selective scan: (y [b, s, di], final state [b, di, n]),
    the kernel on CUDA tensors, prefill and decode alike."""
    return ssm_kernel.ssm(x, dt, A, B, C, D, state)


def rwkv6_scan(r, k, v, w, u, state=None):
    """The RWKV-6 WKV recurrence: (out [b, s, h, n], final state
    [b, h, n, n]), the kernel on CUDA tensors, prefill and decode alike."""
    return rwkv6_kernel.rwkv6(r, k, v, w, u, state)
