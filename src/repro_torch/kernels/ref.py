"""Plain PyTorch versions of the port's kernels.

Policy half — counterparts ``repro.kernels.ref.policy_grid_scan`` /
``policy_grid_agg``. A Python loop over the T bins steps all N scenarios
at once through the lane steps of ``repro_torch.core.twin`` — the same
arithmetic, in the same order, as the reference, so on the CPU the results
are bitwise the JAX package's. The CPU path of the port runs these;
``chip_smoke.py`` holds the CUDA kernels (``kernels/csrc/policy_scan.cu``)
against them on the card.

The branch selector is exactly one of ``onehot`` [N, P] (mixed grid: the
masked blend ``lane_policy_step``) or ``policy_index`` (an int: one lane
step for a uniform block, selected without the blend). ``caps`` [N, T]
(and, for the aggregate scan, ``fmask`` [N, T]) run the fault layer
(``core.twin.fault_lane_policy_step`` / ``fault_switch_step``): a fault
backlog rides beside the policy carry and folds into ``carry_end[:, 0]``
at the end. ``surrogate=True`` steps through the smooth surrogate
branches (``core.twin.surrogate_lane_branches``), the gradient model of
policy search.

Model half — ``sdpa`` (the reference's ``ref.sdpa``: bf16 probabilities
before the PV product, ``kv_len`` and ``logit_cap``), ``flash_attention``
(what the Pallas ``_flash_kernel`` computes: float32 throughout, only the
output cast), ``sdpa_blocked`` (the reference's online-softmax
fallback over key and query blocks, which its dry run lowers for long
prompts), ``ssm_scan`` (the Mamba-1 recurrence of ``ref.ssm_scan``
and ``_ssm_kernel``) and ``rwkv6_scan`` (the RWKV-6 WKV recurrence of
``ref.rwkv6_scan``, the oracle of ``_wkv_kernel``). ``chip_smoke.py``
holds ``csrc/flash_attention.cu``, ``csrc/ssm_scan.cu`` and
``csrc/rwkv6.cu`` against the last three within stated tolerances.
"""
from __future__ import annotations

import torch

from repro_torch.core.twin import (CARRY_DIM, SHED_FUSE_ALL,
                                   SHED_FUSE_DROP, SHED_FUSE_LATENCY,
                                   fault_lane_branches,
                                   fault_lane_policy_step,
                                   fault_switch_step, finalize_aggregate,
                                   init_aggregate, lane_branches,
                                   lane_policy_step, lane_update_aggregate,
                                   pack_aggregate, surrogate_lane_branches)


def check_selector(onehot, policy_index):
    """Exactly one of ``onehot`` and ``policy_index`` selects the
    policies."""
    if (onehot is None) == (policy_index is None):
        raise ValueError("pass exactly one of onehot= (mixed grid) or "
                         "policy_index= (uniform lane block)")


def _bin_step(params, onehot, policy_index, dt, fuse, columns=None,
              surrogate=False):
    """``step(state, arrive, capmul) -> (state, outs)``. ``fuse`` None is
    the benign scan (the state is the policy carry); a SHED_FUSE_* level
    runs the fault layer (the state is (carry, fault backlog)) with the
    rounding of the reference's scan of that kind. ``columns`` are the
    policies the masked blend evaluates (default: those some lane
    selects); ``surrogate`` takes the smooth branches."""
    check_selector(onehot, policy_index)
    if onehot is not None:
        if columns is None:
            columns = torch.nonzero(onehot.any(dim=0)).flatten().tolist()
        if fuse is not None:
            branches = fault_lane_branches(fuse, surrogate, blend=True)
            return lambda state, arrive, capmul: fault_lane_policy_step(
                state, arrive, capmul, params, onehot, dt, branches,
                columns)
        branches = surrogate_lane_branches(blend=True) if surrogate \
            else lane_branches()
        return lambda carry, arrive, _: lane_policy_step(
            carry, arrive, params, onehot, dt, branches, columns)
    if fuse is not None:
        return lambda state, arrive, capmul: fault_switch_step(
            state, arrive, capmul, params, policy_index, dt, fuse,
            surrogate)
    lstep = (surrogate_lane_branches() if surrogate
             else lane_branches())[int(policy_index)]
    return lambda carry, arrive, _: lstep(carry, arrive, params, dt)


def _fuse_level(caps, policy_index, shed_fuse, mixed_default):
    """The SHED_FUSE_* level of a scan: None without faults, else the
    one asked for, else the reference's rounding for this kind of scan."""
    if caps is None:
        return None
    if shed_fuse is not None:
        return shed_fuse
    return SHED_FUSE_ALL if policy_index is not None else mixed_default


def _start(n, dev, fault: bool):
    carry = torch.zeros((n, CARRY_DIM), dtype=torch.float32, device=dev)
    if not fault:
        return carry
    return carry, torch.zeros(n, dtype=torch.float32, device=dev)


def _carry_end(state, fault: bool):
    """The final carry, the fault backlog folded into the queue slot."""
    if not fault:
        return state
    carry, fq = state
    return torch.stack([carry[:, 0] + fq, carry[:, 1]], dim=1)


def policy_grid_scan(loads: torch.Tensor, params: torch.Tensor,
                     onehot: torch.Tensor = None, dt_hours=1.0,
                     policy_index=None, caps: torch.Tensor = None,
                     shed_fuse: int = None, surrogate: bool = False):
    """loads [N, T] records/bin, params [N, PARAM_DIM], optional caps
    [N, T] -> (carry_end [N, CARRY_DIM], (processed, queue, latency, cost,
    dropped)), each series [N, T] (a transposed view of a scenario-minor
    [T, N] buffer, the kernel's layout). ``shed_fuse`` overrides the
    SHED_FUSE_* level (default: DROP mixed, ALL uniform); ``surrogate``
    scans the smooth branches."""
    n, t_bins = loads.shape
    dev = loads.device
    fault = caps is not None
    dt = torch.tensor(dt_hours, dtype=torch.float32, device=dev)
    step = _bin_step(params, onehot, policy_index, dt,
                     _fuse_level(caps, policy_index, shed_fuse,
                                 SHED_FUSE_DROP), surrogate=surrogate)
    loads_t = loads.t().contiguous()
    caps_t = caps.t().contiguous() if fault else [None] * t_bins
    series = torch.empty((5, t_bins, n), dtype=torch.float32, device=dev)
    state = _start(n, dev, fault)
    for t in range(t_bins):
        state, outs = step(state, loads_t[t], caps_t[t])
        for k, o in enumerate(outs):
            series[k, t] = o
    return (_carry_end(state, fault),
            tuple(series[k].t() for k in range(5)))


def policy_grid_agg(loads: torch.Tensor, params: torch.Tensor,
                    onehot: torch.Tensor = None, dt_hours=1.0, *,
                    policy_index=None, slo_limit: float = float("inf"),
                    slo_mode: int = 0, caps: torch.Tensor = None,
                    fmask: torch.Tensor = None, shed_fuse: int = None):
    """Streaming-aggregate scan: same operands and selector as
    ``policy_grid_scan``, but the Table II statistics fold into the scan
    state (``core.twin.lane_update_aggregate``) and no series is kept.
    ``slo_limit`` is compared in float32. ``caps`` and ``fmask`` come
    together; the statistics stay weighted by the offered load and
    ``fmask`` drives A_FLTH/A_FOKH; ``shed_fuse`` as in
    ``policy_grid_scan`` (default: LATENCY mixed, ALL uniform). Returns
    (carry_end [N, CARRY_DIM],
    agg [N, AGG_DIM]) — the compensated histogram triples recombined in
    f64 by ``finalize_aggregate``."""
    if (caps is None) != (fmask is None):
        raise ValueError("pass caps= and fmask= together (or neither)")
    n, t_bins = loads.shape
    dev = loads.device
    fault = caps is not None
    dt = torch.tensor(dt_hours, dtype=torch.float32, device=dev)
    lim = torch.tensor(slo_limit, dtype=torch.float32, device=dev)
    step = _bin_step(params, onehot, policy_index, dt,
                     _fuse_level(caps, policy_index, shed_fuse,
                                 SHED_FUSE_LATENCY))
    loads_t = loads.t().contiguous()
    caps_t = caps.t().contiguous() if fault else [None] * t_bins
    fmask_t = fmask.t().contiguous() if fault else [None] * t_bins
    state = _start(n, dev, fault)
    agg = init_aggregate(n, dev)
    for t in range(t_bins):
        state, outs = step(state, loads_t[t], caps_t[t])
        agg = lane_update_aggregate(agg, loads_t[t], outs, lim, slo_mode,
                                    fmask_t[t])
    return _carry_end(state, fault), finalize_aggregate(pack_aggregate(agg))


# ---------------------------------------------------------------------------
# Model half
# ---------------------------------------------------------------------------

#: the reference's masked-logit value (``ref.sdpa``, ``flash_attention.py``)
NEG_INF = -1e30


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, scale: float = None, logit_cap: float = 0.0,
         kv_len: torch.Tensor = None) -> torch.Tensor:
    """Grouped-query attention with the reference's (XLA path) numerics.

    q [b, sq, h, dq], k [b, sk, kh, dq], v [b, sk, kh, dv], h a multiple
    of kh (query head i reads kv head i // (h // kh)); ``kv_len`` [b] the
    valid KV prefix (decode). Logits in float32 (bf16 products are exact
    in float32), the causal mask aligned to the end (``tril(k=sk-sq)``),
    the probabilities cast to ``v.dtype`` before the PV product. Returns
    [b, sq, h, dv] in ``v.dtype``."""
    b, sq, h, dq = q.shape
    _, sk, kh, _ = k.shape
    g = h // kh
    scale = scale if scale is not None else dq ** -0.5
    qg = q.reshape(b, sq, kh, g, dq).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if logit_cap > 0.0:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    mask = None
    if causal and sq > 1:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
    if kv_len is not None:
        valid = (torch.arange(sk, device=q.device)[None, :]
                 < kv_len[:, None])                              # [b, sk]
        vmask = valid[:, None, None, None, :]
        mask = vmask if mask is None else (mask[None, None, None] & vmask)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, -1)


def sdpa_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, scale: float = None,
                 chunk: int = 1024) -> torch.Tensor:
    """The reference's ``ref.sdpa_blocked``: online-softmax attention over
    ``chunk``-long blocks of queries and keys, O(s * chunk) memory, the
    semantics of ``sdpa`` without ``kv_len`` / ``logit_cap`` (float32
    scores and accumulator, the causal mask counted from position 0 on
    both axes, -1e30 masked, the denominator floored at 1e-30, the output
    cast to ``q.dtype``). ``sq`` and ``sk`` must be multiples of
    ``chunk``. The dry run (``launch.dryrun``) takes it for long prompts,
    as the reference's does, so its memory counts the blocked algorithm
    rather than an [sq, sk] score matrix."""
    b, sq, h, dq = q.shape
    _, sk, kh, dv = v.shape
    g = h // kh
    scale = scale if scale is not None else dq ** -0.5
    nq, nk = sq // chunk, sk // chunk
    if nq * chunk != sq or nk * chunk != sk:
        raise ValueError(f"sq {sq} and sk {sk} must be multiples of the "
                         f"chunk {chunk}")
    qg = q.reshape(b, nq, chunk, kh, g, dq)
    kc = k.reshape(b, nk, chunk, kh, dq)
    vc = v.reshape(b, nk, chunk, kh, dv)
    outs = []
    for qi in range(nq):
        qb = qg[:, qi].float()                       # [b, chunk, kh, g, dq]
        m = torch.full((b, kh, g, chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kh, g, chunk), dtype=torch.float32,  # noqa: E741
                        device=q.device)
        acc = torch.zeros((b, kh, g, chunk, dv), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk):
            logits = torch.einsum("bckgd,bskd->bkgcs", qb,
                                  kc[:, ki].float()) * scale
            if causal:
                qpos = qi * chunk + torch.arange(chunk, device=q.device)
                kpos = ki * chunk + torch.arange(chunk, device=q.device)
                logits = torch.where(qpos[:, None] >= kpos[None, :],
                                     logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)                          # noqa: E741
            acc = acc * corr[..., None] + torch.einsum(
                "bkgcs,bskd->bkgcd", p, vc[:, ki].float())
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))      # [b, chunk, kh, g, dv]
    out = torch.stack(outs, 1).reshape(b, sq, h, dv)
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float = None) -> torch.Tensor:
    """What the Pallas ``_flash_kernel`` computes, without its tiling.

    q [b, sq, h, d], k/v [b, sk, kh, d] -> [b, sq, h, dv] in ``q.dtype``.
    Everything in float32: scores, the softmax (masked entries -1e30,
    causal as ``qpos >= kpos`` counted from position 0 on both axes) and
    the PV product; the denominator floored at 1e-30; only the output is
    cast. One batch row at a time, so at prefill widths the [kh, g, sq,
    sk] float32 score tensor is the largest thing held."""
    b, sq, h, d = q.shape
    _, sk, kh, dv = v.shape
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    keep = None
    if causal:
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    for i in range(b):
        qg = q[i].reshape(sq, kh, g, d).float()
        s = torch.einsum("qkgd,skd->kgqs", qg, k[i].float()) * scale
        if keep is not None:
            s = torch.where(keep, s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1).clamp_min(1e-30)                     # noqa: E741
        o = torch.einsum("kgqs,skd->qkgd", p, v[i].float())
        o = o / l.permute(2, 0, 1)[..., None]
        out[i] = o.reshape(sq, h, dv).to(q.dtype)
    return out


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
             state: torch.Tensor = None):
    """Mamba-1 selective scan: h = exp(dt A) h + (dt x) B, y = C.h + D x.

    x, dt [b, s, di]; A [di, n] float32; B, C [b, s, n]; D [di] float32;
    ``state`` [b, di, n] (zeros when None). All arithmetic in float32.
    Returns (y [b, s, di] in ``x.dtype``, final state [b, di, n]
    float32)."""
    b, s, di = x.shape
    n = A.shape[-1]
    h = (torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    A, D = A.float(), D.float()
    ys = torch.empty((b, s, di), dtype=torch.float32, device=x.device)
    for t in range(s):
        xt, dtt = x[:, t].float(), dt[:, t].float()              # [b, di]
        Bt, Ct = B[:, t].float(), C[:, t].float()                # [b, n]
        dA = torch.exp(dtt[..., None] * A[None])                 # [b, di, n]
        dBx = (dtt * xt)[..., None] * Bt[:, None, :]
        h = dA * h + dBx
        ys[:, t] = torch.einsum("bdn,bn->bd", h, Ct) + D[None] * xt
    return ys.to(x.dtype), h


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor = None):
    """The RWKV-6 WKV recurrence with data-dependent decay, step by step.

    r, k, v, w [b, s, h, n] (``w`` the decay, already exp(-exp(.)) in
    (0, 1)); u [h, n] the bonus; ``state`` [b, h, n, n] (key x value,
    zeros when None). Per step, in float32,
      o_t = r_t . (S + u k_t v_t^T),   S' = diag(w_t) S + k_t v_t^T.
    Returns (out [b, s, h, n] in ``r.dtype``, final state [b, h, n, n]
    float32). The exact recurrence of the reference's oracle, with no
    chunking and so no clamp on the decay products."""
    b, s, h, n = r.shape
    S = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    u = u.float()[None, :, :, None]                              # [1,h,n,1]
    out = torch.empty((b, s, h, n), dtype=torch.float32, device=r.device)
    for t in range(s):
        rt, kt, vt, wt = (x[:, t].float() for x in (r, k, v, w))  # [b,h,n]
        kv = kt[..., :, None] * vt[..., None, :]                 # [b,h,n,n]
        out[:, t] = torch.einsum("bhi,bhij->bhj", rt, S + u * kv)
        S = wt[..., :, None] * S + kv
    return out.to(r.dtype), S
