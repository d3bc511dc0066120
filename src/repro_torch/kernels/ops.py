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

Training mirrors the reference, whose training never enables Pallas
(``ops.use_pallas`` is off, and ``make_train_step`` does not turn it on):
a call in grad mode with an operand that requires grad
(``flash_attention.needs_grad``) takes the reference's non-Pallas route
on the tensors' own device, under
autograd: ``sdpa`` to ``ref.sdpa`` (bf16 probabilities, the causal mask
aligned to the end), ``ssm_scan`` to ``ref.ssm_scan``, ``rwkv6_scan`` to
``ref.rwkv6_scan``. The forward kernels have no backward, and their
wrappers refuse such a call. Calls without a gradient (serving, the
engine, every what-if path) route as above.

In the policy half the selector is exactly one of ``onehot`` [N, P] (a
mixed grid, the masked blend) or ``policy_index`` (an int: a uniform
block). On CUDA a uniform index becomes its one-hot row broadcast over the
block, as the reference does for its kernel (with shed's fault rounding
set to the uniform scans', ``SHED_FUSE_ALL``); on the CPU it runs the one
lane step without the blend, like the reference's ``lax.switch`` form.
Registered policies run in the kernels too, in either selector form, as
steps translated by ``kernels/lane_codegen.py``.

The gradient side (``policy_scan(differentiable=True)`` and
``policy_scan_fold``) runs the checkpointed scans of
``kernels/policy_vjp.py`` as PyTorch operations on either device: the
CUDA policy kernels have no backward.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.core.twin import (SHED_FUSE_ALL, SHED_FUSE_DROP,
                                   SHED_FUSE_LATENCY, num_policies)
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import policy_scan as policy_kernel
from repro_torch.kernels import policy_vjp, ref
from repro_torch.kernels import rwkv6_kernel
from repro_torch.kernels import ssm_scan as ssm_kernel

_state = threading.local()


def set_attn_chunk(chunk: int):
    """The attention chunk of the dry run (``launch.dryrun``), on this
    thread: 0 (the default) routes ``sdpa`` as above; > 0 sends a call
    without ``kv_len`` or ``logit_cap`` whose query and key lengths are
    multiples of it (queries longer than it) to ``ref.sdpa_blocked``, as
    the reference's ``ops.sdpa`` does with Pallas off."""
    _state.attn_chunk = int(chunk)


def get_attn_chunk() -> int:
    return getattr(_state, "attn_chunk", 0)


def _onehot_rows(policy_index, n: int, device) -> torch.Tensor:
    row = torch.zeros(num_policies(), dtype=torch.float32, device=device)
    row[int(policy_index)] = 1.0
    return row.expand(n, -1).contiguous()


def policy_scan(loads, params, onehot=None, dt_hours: float = 1.0, *,
                policy_index=None, loads_t=None, load_index=None,
                caps_t=None, fault_index=None, differentiable=False,
                surrogate=False):
    """(carry_end [N, CARRY_DIM], five [N, T] series) — see
    ``kernels.policy_scan.policy_grid_scan`` for the operands; ``caps_t``
    [T, F] + ``fault_index`` [N] run the fault layer.

    ``differentiable=True`` takes the gradient path on either device:
    the checkpointed scan (``policy_vjp.policy_grid_scan_ckpt``, bitwise
    the plain scan's values), or with a fault schedule the plain scan
    under autograd, as the reference does. Without it a CUDA tensor runs
    the kernel. ``surrogate=True`` (the smooth branches of policy search)
    implies the gradient path."""
    ref.check_selector(onehot, policy_index)
    if differentiable or surrogate:
        loads = policy_kernel.gather_loads(loads, loads_t, load_index)
        caps = policy_kernel.gather_rows(caps_t, fault_index)
        if caps is not None:
            return ref.policy_grid_scan(loads, params, onehot, dt_hours,
                                        policy_index=policy_index,
                                        caps=caps, surrogate=surrogate)
        return policy_vjp.policy_grid_scan_ckpt(
            loads, params, onehot, dt_hours, policy_index=policy_index,
            surrogate=surrogate)
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


def policy_scan_fold(loads=None, params=None, onehot=None,
                     dt_hours: float = 1.0, *, policy_index=None,
                     surrogate=False, caps=None, loads_t=None, caps_t=None,
                     fold_init, fold_step, ops_lane=(), xs=(),
                     acc_sinks=()):
    """The streaming gradient scan: per-bin outputs folded into a
    caller-defined accumulator, no [N, T] series in either direction —
    ``policy_vjp.policy_grid_scan_fold``, the same PyTorch operations on
    either device (the gradient-path sibling of ``policy_scan_agg``);
    ``surrogate`` scans the smooth branches. Returns (carry_end
    [N, CARRY_DIM], acc)."""
    return policy_vjp.policy_grid_scan_fold(
        loads, params, onehot, dt_hours, policy_index=policy_index,
        surrogate=surrogate, caps=caps, loads_t=loads_t, caps_t=caps_t,
        fold_init=fold_init, fold_step=fold_step, ops_lane=ops_lane, xs=xs,
        acc_sinks=acc_sinks)


def policy_scan_agg(loads, params, onehot=None, dt_hours: float = 1.0, *,
                    policy_index=None, slo_limit: float = float("inf"),
                    slo_mode: int = 0, loads_t=None, load_index=None,
                    caps_t=None, fmask_t=None, fault_index=None):
    """(carry_end [N, CARRY_DIM], agg [N, AGG_DIM]) — the Table II
    statistics folded into the scan, no [N, T] series on either path;
    see ``kernels.policy_scan.policy_grid_agg``; ``caps_t``/``fmask_t``
    [T, F] + ``fault_index`` [N] run the fault layer."""
    ref.check_selector(onehot, policy_index)
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
    logits; in training ``ref.sdpa`` always, as the reference trains.
    With a chunk set (``set_attn_chunk``, the dry run) a long call takes
    ``ref.sdpa_blocked``, in training too."""
    chunk = get_attn_chunk()
    if (chunk > 0 and kv_len is None and logit_cap == 0.0
            and q.shape[1] > chunk and q.shape[1] % chunk == 0
            and k.shape[1] % chunk == 0):
        return ref.sdpa_blocked(q, k, v, causal=causal, scale=scale,
                                chunk=chunk)
    if (not flash_kernel.needs_grad(q, k, v) and kv_len is None
            and logit_cap == 0.0 and q.shape[1] > 1):
        return flash_kernel.flash_attention(q, k, v, causal=causal,
                                            scale=scale)
    return ref.sdpa(q, k, v, causal=causal, scale=scale,
                    logit_cap=logit_cap, kv_len=kv_len)


def ssm_scan(x, dt, A, B, C, D, state=None):
    """The Mamba-1 selective scan: (y [b, s, di], final state [b, di, n]),
    the kernel on CUDA tensors, prefill and decode alike; in training
    ``ref.ssm_scan``."""
    if flash_kernel.needs_grad(x, dt, A, B, C, D, state):
        return ref.ssm_scan(x, dt, A, B, C, D, state)
    return ssm_kernel.ssm(x, dt, A, B, C, D, state)


def rwkv6_scan(r, k, v, w, u, state=None):
    """The RWKV-6 WKV recurrence: (out [b, s, h, n], final state
    [b, h, n, n]), the kernel on CUDA tensors, prefill and decode alike;
    in training ``ref.rwkv6_scan``."""
    if flash_kernel.needs_grad(r, k, v, w, u, state):
        return ref.rwkv6_scan(r, k, v, w, u, state)
    return rwkv6_kernel.rwkv6(r, k, v, w, u, state)
