"""Digital twins (paper Sec. V-G) on the port: the ``Twin`` record, the
policy registry, the five built-in lane steps and the streaming-aggregate
hooks.

Counterpart: ``repro.core.twin``. A twin is a policy name plus a flat
parameter vector, and every policy is a branchless *lane step* over a
block of L scenarios at once:

    lane_step(carry [L, CARRY_DIM], arrive [L], params [L, PARAM_DIM], dt)
        -> (carry [L, CARRY_DIM], (processed, queue, latency, cost, dropped))

with each output shaped [L] and ``dt`` the bin width in hours as a 0-d
float32 tensor. The port needs only this form: the plain PyTorch scans of
``repro_torch.kernels.ref`` run it over all T bins, and the CUDA kernels of
``kernels/csrc/policy_scan.cu`` hold a per-thread copy of the five
built-ins. Every formula keeps the reference's operation order and float32
rounding as its compiled scans perform them (see the comment above the
lane steps: one reassociation and one fused multiply-add, IEEE division),
so both are bitwise equal to the JAX package's scans on finite inputs.

``lane_policy_step`` blends every registered policy with a [L, P] one-hot
mask exactly as the reference does: on finite branch outputs the blend
equals the selected branch plus +0.0, which is the rule the CUDA kernels
apply instead of evaluating all five.

Policies registered with ``register_policy`` run on the CPU path; the CUDA
kernels know only the five built-ins (``PolicySpec.kernel_branch``) and
refuse any other.

``fault_lane_policy_step`` (and the uniform ``fault_switch_step``) wrap a
step in the fault layer of a chaos suite: capacity multipliers, a fault
backlog beside the policy carry, and the A_FLTH/A_FOKH counters that
``update_agg_scalars`` keeps when given an in-fault mask.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

CARRY_DIM = 2     # [queued/accumulated records, policy state]
PARAM_DIM = 6     # flat parameter vector, zero-padded per policy


@dataclass(frozen=True)
class PolicySpec:
    """One registered scaling/queueing policy."""
    name: str
    index: int                       # one-hot column / branch index (stable)
    lane_step: Callable              # see the module docstring
    param_names: Tuple[str, ...]     # layout of the flat param vector
    defaults: Dict[str, float]
    doc: str
    #: branch id of this policy in the CUDA kernels; None for a policy
    #: the kernels do not implement (any user registration)
    kernel_branch: Optional[int] = None
    #: ``fn(carry, arrive, params, dt, fuse)``: the step as the fault
    #: layer runs it, where the reference's compiled fault scans round it
    #: differently (shed, see SHED_FUSE_*); None: ``lane_step``
    fault_lane_step: Optional[Callable] = None


_REGISTRY: Dict[str, PolicySpec] = {}


def _register(name, param_names, defaults, doc, kernel_branch,
              fault_lane_step=None):
    if len(param_names) > PARAM_DIM:
        raise ValueError(f"{name}: {len(param_names)} params > {PARAM_DIM}")
    if tuple(param_names[:3]) != ("max_rps", "usd_per_hour",
                                  "base_latency_s"):
        raise ValueError(f"{name}: params must start with the shared triple")

    def deco(fn):
        # overriding an existing policy keeps its index so twins built
        # earlier still select the right one-hot column
        prev = _REGISTRY.get(name)
        _REGISTRY[name] = PolicySpec(
            name=name, index=prev.index if prev else len(_REGISTRY),
            lane_step=fn, param_names=tuple(param_names),
            defaults=dict(defaults or {}),
            doc=doc or (fn.__doc__ or "").strip(),
            kernel_branch=kernel_branch, fault_lane_step=fault_lane_step)
        return fn
    return deco


def register_policy(name: str, param_names: Tuple[str, ...],
                    defaults: Optional[Dict[str, float]] = None,
                    doc: str = ""):
    """Decorator: register a lane step ``fn(carry, arrive, params, dt)``
    as policy ``name``. ``param_names`` must start with the shared triple
    (max_rps, usd_per_hour, base_latency_s) and fit within PARAM_DIM. The
    step must stay finite on any lane's parameter vector (other policies'
    parameters share the slots), or the masked blend turns its 0 * inf
    into NaN. Such a policy runs on the CPU path only: the CUDA kernels
    refuse a policy they have no branch for."""
    return _register(name, param_names, defaults, doc, None)


def policy_spec(name: str) -> PolicySpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown twin policy {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def _specs() -> List[PolicySpec]:
    return sorted(_REGISTRY.values(), key=lambda s: s.index)


def policy_names() -> List[str]:
    return [s.name for s in _specs()]


def lane_branches() -> Tuple[Callable, ...]:
    """Lane steps ordered by index (the blend's branch table)."""
    return tuple(s.lane_step for s in _specs())


def fault_lane_branches(fuse: int) -> Tuple[Callable, ...]:
    """Lane steps ordered by index, as the fault layer runs them in the
    scan that ``fuse`` (a SHED_FUSE_* level) names."""
    return tuple(s.lane_step if s.fault_lane_step is None
                 else functools.partial(s.fault_lane_step, fuse=fuse)
                 for s in _specs())


def kernel_branches() -> Tuple[Optional[int], ...]:
    """CUDA branch id of each registered policy, ordered by index."""
    return tuple(s.kernel_branch for s in _specs())


def num_policies() -> int:
    return len(_REGISTRY)


def policy_onehot(policy_idx) -> np.ndarray:
    """[N, P] f32 one-hot mask from [N] policy indices — the lane form's
    branch selector (P = number of registered policies)."""
    idx = np.asarray(policy_idx, np.int32)
    return (idx[:, None] == np.arange(num_policies())[None, :]).astype(
        np.float32)


def lane_policy_step(carry, arrive, params, onehot, dt, branches=None,
                     columns=None):
    """The combined branchless bin-step over a mixed-policy lane block:
    every registered policy on every lane, blended with the [L, P]
    one-hot mask in the reference's order (a masked sum from +0.0).

    ``columns`` limits the blend to the policies some lane selects. A
    column that is zero on every lane only adds 0 * y = +-0.0 to an
    accumulator that is never -0.0, so skipping it changes no bit (as
    long as its branch is finite, the registry's contract)."""
    branches = branches or lane_branches()
    new_carry = torch.zeros_like(carry)
    outs = [torch.zeros_like(arrive) for _ in range(5)]
    for j in range(len(branches)) if columns is None else columns:
        c_j, o_j = branches[j](carry, arrive, params, dt)
        m = onehot[:, j]
        new_carry = new_carry + m[:, None] * c_j
        outs = [acc + m * o for acc, o in zip(outs, o_j)]
    return new_carry, tuple(outs)


def _fault_layer(policy_step, state, arrive, capmul, params):
    """The fault perturbation layer of ``repro.core.twin`` around
    ``policy_step(carry, a_eff, p_eff)``: arrivals are gated on
    ``capmul > 0`` into a fault backlog ``fq`` (which floods back when
    capacity returns), the policy sees ``max_rps * capmul``, and the
    backlog's wait is priced at the NOMINAL ``max_rps``."""
    carry, fq = state
    gate = (capmul > 0).to(torch.float32)
    avail = fq + arrive
    a_eff = gate * avail
    new_fq = avail - a_eff
    p_eff = torch.cat([(params[:, 0] * capmul)[:, None], params[:, 1:]],
                      dim=1)
    carry, outs = policy_step(carry, a_eff, p_eff)
    wait = new_fq / torch.clamp_min(params[:, 0], 1e-9)
    outs = (outs[0], outs[1] + new_fq, outs[2] + wait, outs[3], outs[4])
    return (carry, new_fq), outs


def fault_lane_policy_step(state, arrive, capmul, params, onehot, dt,
                           branches=None, columns=None):
    """``lane_policy_step`` wrapped in the fault layer. ``state`` =
    (policy carry [L, CARRY_DIM], fault backlog [L]); ``capmul`` [L] is
    this bin's capacity multiplier. The branches default to
    ``fault_lane_branches(SHED_FUSE_DROP)``, the series scan's rounding;
    the aggregate scan passes ``fault_lane_branches(SHED_FUSE_LATENCY)``.
    Returns ((carry, backlog), outs)."""
    branches = branches or fault_lane_branches(SHED_FUSE_DROP)
    return _fault_layer(
        lambda c, a, p: lane_policy_step(c, a, p, onehot, dt, branches,
                                         columns),
        state, arrive, capmul, params)


def fault_switch_step(state, arrive, capmul, params, policy_index, dt,
                      fuse=None):
    """The uniform-block form of ``fault_lane_policy_step`` (the
    reference's ``kernels.ref._fault_switch_step``): one policy's fault
    lane step, selected without the blend, rounded at ``fuse`` (default
    SHED_FUSE_ALL, the reference's uniform scans)."""
    fuse = SHED_FUSE_ALL if fuse is None else fuse
    lstep = fault_lane_branches(fuse)[int(policy_index)]
    return _fault_layer(lambda c, a, p: lstep(c, a, p, dt), state, arrive,
                        capmul, params)


# ---------------------------------------------------------------------------
# Streaming aggregates (see the section comment in repro.core.twin): six
# twice-compensated (sum, comp, comp2) f32 sums, the SLO-ok bin count, the
# per-bin max throughput, two fault counters, and a 152-bucket
# quarter-octave load-weighted latency histogram whose buckets are
# compensated triples too, recombined in f64 by ``finalize_aggregate``.
# ---------------------------------------------------------------------------

AGG_HIST_BINS = 152            # quarter-octave latency buckets
#: smallest resolvable latency: 2^-10 s ~ 0.98 ms (bucket 0 clips below)
AGG_HIST_MIN_EXP = -10
AGG_HIST_MIN = float(2.0 ** AGG_HIST_MIN_EXP)
#: (biased exponent | 2-bit mantissa) key of AGG_HIST_MIN — bucket 0
_AGG_HIST_KEY0 = (127 + AGG_HIST_MIN_EXP) << 2
#: bucket width in decades: a quarter octave (top edge 2^28 s ~ 8.5 yr)
AGG_HIST_W = float(np.log10(2.0) / 4.0)

# scalar slot layout: (sum, comp, comp2) triples first, then exact slots
A_PROC = 0                     # sum of processed records
A_COST = 3                     # sum of cost_usd
A_DROP = 6                     # sum of dropped records
A_LATW = 9                     # sum of latency * load (record-weighted)
A_LOAD = 12                    # sum of load
A_OKW = 15                     # sum of load in SLO-ok bins
A_OKH = 18                     # count of SLO-ok bins
A_MAXP = 19                    # max processed per bin
A_FLTH = 20                    # count of bins inside a fault window
A_FOKH = 21                    # count of SLO-ok bins inside fault windows
AGG_SCALARS = 22
AGG_DIM = AGG_SCALARS + AGG_HIST_BINS
#: kernel-internal packed width: each histogram bucket is a
#: twice-compensated (sum, comp, comp2) triple until ``finalize_aggregate``
AGG_KDIM = AGG_SCALARS + 3 * AGG_HIST_BINS

#: SLO metric selector for the aggregate scan
AGG_SLO_LATENCY, AGG_SLO_DROP_RATE = 0, 1


def aggregate_hist_edges() -> np.ndarray:
    """[AGG_HIST_BINS + 1] bucket edges in seconds (quarter-octave)."""
    return np.power(2.0, AGG_HIST_MIN_EXP
                    + np.arange(AGG_HIST_BINS + 1) / 4.0)


def aggregate_hist_centers() -> np.ndarray:
    """[AGG_HIST_BINS] geometric bucket centers in seconds — the
    representative values quantiles read off the histogram CDF."""
    return np.power(2.0, AGG_HIST_MIN_EXP
                    + (np.arange(AGG_HIST_BINS) + 0.5) / 4.0)


def _two_sum(a, b):
    """Branch-free Knuth two-sum: (fl(a+b), exact residual)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _neumaier2(s, c, cc, x):
    """One twice-compensated summation step: (sum, comp, comp2) += x."""
    s, e = _two_sum(s, x)
    c, ee = _two_sum(c, e)
    return s, c, cc + ee


def _hist_bucket(latency: torch.Tensor) -> torch.Tensor:
    """Bucket index on the fixed quarter-octave grid, from the f32 bit
    pattern: (exponent | top 2 mantissa bits) rebased to AGG_HIST_MIN."""
    lat = torch.clamp_min(latency, AGG_HIST_MIN)
    bits = lat.view(torch.int32)
    return torch.clamp((bits >> 21) - _AGG_HIST_KEY0, 0, AGG_HIST_BINS - 1)


def np_hist_bucket(latency: np.ndarray) -> np.ndarray:
    """Numpy twin of ``_hist_bucket`` — same bits, same buckets."""
    buf = np.maximum(np.ascontiguousarray(latency, np.float32),
                     np.float32(AGG_HIST_MIN))
    bits = buf.view(np.int32)
    np.right_shift(bits, 21, out=bits)
    bits -= _AGG_HIST_KEY0
    np.clip(bits, 0, AGG_HIST_BINS - 1, out=bits)
    return bits


def np_latency_histogram(latency: np.ndarray, weights: np.ndarray,
                         weight_rows: np.ndarray = None) -> np.ndarray:
    """[N, T] latencies + [N, T] weights -> [N, AGG_HIST_BINS] f32
    load-weighted histogram (one f64 ``np.bincount`` per scenario) — the
    host oracle of the in-scan histogram. With ``weight_rows`` [N],
    ``weights`` is the [K, T] load matrix and row i weighs by
    ``weights[weight_rows[i]]``."""
    buckets = np_hist_bucket(latency)
    n = buckets.shape[0]
    out = np.empty((n, AGG_HIST_BINS), np.float32)
    w64 = np.asarray(weights, np.float64)
    for i in range(n):
        w = w64[i] if weight_rows is None else w64[weight_rows[i]]
        out[i] = np.bincount(buckets[i], weights=w,
                             minlength=AGG_HIST_BINS)
    return out


def init_agg_scalars(n: int, device=None):
    """Zeroed scalar-statistic state: (sums, okh, maxp, flth, fokh) with
    ``sums`` = (sum, comp, comp2), each [6, n] — row j is the triple of
    slot 3 * j (A_PROC .. A_OKW) — and the other leaves [n] f32."""
    z = torch.zeros(n, dtype=torch.float32, device=device)
    z6 = torch.zeros((6, n), dtype=torch.float32, device=device)
    return ((z6, z6, z6), z, z, z, z)


def update_agg_scalars(state, arrive, outs, slo_limit, slo_mode,
                       fmask=None):
    """Fold one bin's step outputs into the scalar statistics.
    ``slo_limit`` is compared in float32 (pass a 0-d f32 tensor, or a
    float that is rounded to one here); ``slo_mode`` is AGG_SLO_*.
    ``arrive`` is the OFFERED load, also under the fault layer. ``fmask``
    (0/1, [L]) marks bins inside a fault window and drives A_FLTH and
    A_FOKH; None leaves both at zero."""
    sums, okh, maxp, flth, fokh = state
    processed, _queue, latency, cost, dropped = outs
    if slo_mode == AGG_SLO_DROP_RATE:
        val = dropped / torch.clamp_min(arrive, 1e-9)
    else:
        val = latency
    lim = torch.as_tensor(slo_limit, dtype=torch.float32,
                          device=arrive.device)
    ok = (val <= lim).to(torch.float32)
    # row order IS the slot order: A_PROC, A_COST, A_DROP, A_LATW,
    # A_LOAD, A_OKW (elementwise, so one stacked step rounds like six)
    x = torch.stack((processed, cost, dropped, latency * arrive, arrive,
                     arrive * ok))
    if fmask is not None:
        flth = flth + fmask
        fokh = fokh + fmask * ok
    return (_neumaier2(*sums, x), okh + ok, torch.maximum(maxp, processed),
            flth, fokh)


def pack_agg_scalars(state) -> torch.Tensor:
    """[N, AGG_SCALARS] slot layout of a scalar-statistic state."""
    (s, c, cc), okh, maxp, flth, fokh = state
    sums = torch.stack((s, c, cc), dim=1).reshape(18, -1)
    return torch.cat([sums, torch.stack((okh, maxp, flth, fokh))]).t()


def init_aggregate(n: int, device=None):
    """Zeroed full aggregate state: (scalar state, hist triple of
    [n, AGG_HIST_BINS] per-bucket (sum, comp, comp2) columns)."""
    z = torch.zeros((n, AGG_HIST_BINS), dtype=torch.float32, device=device)
    return (init_agg_scalars(n, device), (z, z, z))


def lane_update_aggregate(state, arrive, outs, slo_limit, slo_mode,
                          fmask=None):
    """Fold one bin into the full aggregate state: scalars through
    ``update_agg_scalars`` (``fmask`` as there), the histogram, weighted
    by the offered load, as a masked compare-add over
    the bucket axis through the same ``_neumaier2`` step. (The CUDA
    kernel adds into the hit bucket only; adding +0.0 leaves a
    non-negative triple's bits unchanged, so the two agree bitwise.)"""
    scal, (hs, hc, hcc) = state
    scal = update_agg_scalars(scal, arrive, outs, slo_limit, slo_mode,
                              fmask)
    bucket = _hist_bucket(outs[2])
    buckets = torch.arange(AGG_HIST_BINS, device=arrive.device)
    x = torch.where(bucket[:, None] == buckets[None, :], arrive[:, None],
                    0.0)
    return (scal, _neumaier2(hs, hc, hcc, x))


def pack_aggregate(state) -> torch.Tensor:
    """Flatten a full aggregate state into the [N, AGG_KDIM] layout
    (scalars, then the three histogram planes)."""
    scal, hist = state
    return torch.cat([pack_agg_scalars(scal)] + list(hist), dim=-1)


def unpack_aggregate(packed: torch.Tensor):
    """Inverse of ``pack_aggregate`` ([N, AGG_KDIM] rows)."""
    b = AGG_HIST_BINS
    tri = packed[:, :18].t().reshape(6, 3, -1)
    return (((tri[:, 0], tri[:, 1], tri[:, 2]),
             packed[:, A_OKH], packed[:, A_MAXP],
             packed[:, A_FLTH], packed[:, A_FOKH]),
            (packed[..., AGG_SCALARS:AGG_SCALARS + b],
             packed[..., AGG_SCALARS + b:AGG_SCALARS + 2 * b],
             packed[..., AGG_SCALARS + 2 * b:]))


def finalize_aggregate(packed: torch.Tensor) -> torch.Tensor:
    """[..., AGG_KDIM] kernel rows -> [..., AGG_DIM] public rows: each
    bucket's (sum, comp, comp2) triple recombined in f64, then cast to
    f32 once — an f32-only recombination double-rounds at ties and loses
    bit parity with the f64 ``np.bincount`` oracle."""
    b = AGG_HIST_BINS
    hs = packed[..., AGG_SCALARS:AGG_SCALARS + b].to(torch.float64)
    hc = packed[..., AGG_SCALARS + b:AGG_SCALARS + 2 * b]
    hcc = packed[..., AGG_SCALARS + 2 * b:]
    hist = (hs + hc + hcc).to(torch.float32)
    return torch.cat([packed[..., :AGG_SCALARS], hist], dim=-1)


def policy_table_rows() -> List[Dict]:
    """Catalog rows for report.render_table (docs / examples)."""
    rows = []
    for s in _specs():
        extras = ", ".join(p for p in s.param_names[3:]) or "-"
        rows.append({"policy": s.name, "extra_params": extras,
                     "behaviour": s.doc.split("\n")[0]})
    return rows


# ---------------------------------------------------------------------------
# The Twin record
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Twin:
    """A fitted pipeline model: policy name + flat parameter vector.

    ``params`` is laid out per ``policy_spec(policy).param_names``; the
    first three entries are always (max_rps, usd_per_hour, base_latency_s).
    """
    name: str
    policy: str = "fifo"
    params: Tuple[float, ...] = ()
    kind: str = "fit"

    @property
    def max_rps(self) -> float:
        return self.params[0]

    @property
    def usd_per_hour(self) -> float:
        return self.params[1]

    @property
    def base_latency_s(self) -> float:
        return self.params[2]

    def param(self, pname: str) -> float:
        """Named lookup into the flat vector (falls back to the default)."""
        spec = policy_spec(self.policy)
        i = spec.param_names.index(pname)
        if i < len(self.params):
            return self.params[i]
        return float(spec.defaults[pname])

    def with_params(self, **updates) -> "Twin":
        """A copy with named parameters changed."""
        spec = policy_spec(self.policy)
        vals = dict(zip(spec.param_names, self.padded_params()))
        unknown = set(updates) - set(spec.param_names)
        if unknown:
            raise KeyError(f"{self.policy} has no params {sorted(unknown)}")
        vals.update(updates)
        return replace(self, params=tuple(float(vals[p])
                                          for p in spec.param_names))

    def padded_params(self) -> np.ndarray:
        """[PARAM_DIM] f32 vector: params, then defaults, then zeros."""
        spec = policy_spec(self.policy)
        vals = [float(v) for v in self.params[:len(spec.param_names)]]
        for pname in spec.param_names[len(vals):]:
            vals.append(float(spec.defaults.get(pname, 0.0)))
        vals += [0.0] * (PARAM_DIM - len(vals))
        return np.asarray(vals, np.float32)

    @property
    def policy_index(self) -> int:
        return policy_spec(self.policy).index


def make_twin(name: str, policy: str, *, kind: str = "fit",
              **params: float) -> Twin:
    """Build a Twin by named parameters, filling registered defaults."""
    spec = policy_spec(policy)
    vals = dict(spec.defaults)
    unknown = set(params) - set(spec.param_names)
    if unknown:
        raise KeyError(f"{policy} has no params {sorted(unknown)}; "
                       f"expects {spec.param_names}")
    vals.update(params)
    missing = [p for p in spec.param_names if p not in vals]
    if missing:
        raise KeyError(f"{policy} missing params {missing}")
    return Twin(name=name, policy=policy, kind=kind,
                params=tuple(float(vals[p]) for p in spec.param_names))


def SimpleTwin(name: str, max_rps: float, usd_per_hour: float,
               base_latency_s: float, policy: str = "fifo",
               kind: str = "simple") -> Twin:
    """Fixed-capacity FIFO twin (paper Table I)."""
    return Twin(name=name, policy=policy, kind=kind,
                params=(float(max_rps), float(usd_per_hour),
                        float(base_latency_s)))


def QuickscalingTwin(name: str, max_rps: float, usd_per_hour: float,
                     base_latency_s: float, policy: str = "quickscale",
                     kind: str = "quickscaling") -> Twin:
    """Optimal horizontal-scaling twin."""
    return Twin(name=name, policy=policy, kind=kind,
                params=(float(max_rps), float(usd_per_hour),
                        float(base_latency_s)))


# ---------------------------------------------------------------------------
# The built-in lane steps, each the reference's ``_*_lane`` operation for
# operation, as the reference's scans compute them once XLA has compiled
# them (its jnp oracle, Pallas and XLA switch scans agree bitwise). XLA
# rewrites two things there, and the port writes both out so that it
# rounds alike:
#
# * ``max_rps * 3600.0 * dt`` becomes ``max_rps * (3600.0 * dt)`` (XLA
#   gathers the constant and the scalar ``dt``; the same at dt = 1);
# * XLA:CPU always allows floating-point contraction: a product feeding
#   an add inside one fused expression becomes one fused multiply-add.
#   In the scans that happens once, in batch_window's latency: its
#   parameter-only head ``base_lat + 0.5 * window * 3600.0`` is hoisted
#   out of the loop as one expression and fused. Other products that are
#   loop-invariant (shed's ``qmax``, batch_window's ``usd_hr * idle_frac
#   * dt``) are hoisted and rounded on their own, and the rest are never
#   fused. ``_fma`` is that one operation, exactly rounded; the CUDA
#   kernels use ``__fmaf_rn`` at the same place and contract nothing
#   else.
#
# Under the fault layer (``fault_lane_policy_step``) the policy sees
# ``max_rps * capmul``, which changes every bin, so shed's ``qmax`` is no
# longer loop-invariant and is not hoisted: its product fuses into
# ``backlog - qmax`` as ``fma(-qcap_h, cap_hour, backlog)`` wherever the
# product has that one use inside a fused expression. Which uses those
# are depends on the scan (XLA recomputes shed's chain in each consumer,
# and the mixed-policy scans share the product with batch_window's
# ``cap_hour * window``, which reads the same parameter slot):
#
# * mixed series scan (the reference's jnp oracle and its XLA series
#   path): only the REPORTED ``dropped`` is fused;
# * mixed aggregate scan (the oracle, the Pallas fault kernel and the XLA
#   aggregate path, all bitwise equal): also the new queue that prices
#   latency, while the carried queue keeps ``backlog - round(qmax)``;
# * uniform-policy block (``ref._fault_switch_step``): every use.
#
# ``_shed(..., fuse=SHED_FUSE_*)`` writes those three forms out, and the
# CUDA kernels take the same level; no other step changes. The
# reference's XLA switch scans through
# the fault layer (``simulate._grid_scan_fault_xla`` and the aggregate
# ``_grid_scan_agg_fault_xla`` / ``_agg_scan_uniform_fault``) rebuild the
# parameter vector every bin, so batch_window's ``usd_hr * idle_frac *
# dt`` turns loop-variant there and its last product fuses into the cost
# sum (at dt = 1 the static ``* dt`` folds away first): their
# batch_window cost differs from their own Pallas kernel by an ulp in
# some bins. The port follows the kernel.
#
# Divisions are guarded with clamp_min(.., 1e-9) so every branch stays
# finite on any lane's parameters; the kernel branch ids (0..4) are the
# ``switch`` cases of kernels/csrc/policy_scan.cu.
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """Float32 ``a * b + c`` with ONE rounding (a fused multiply-add).

    The f64 product of two f32 values is exact; the f64 sum is rounded to
    odd (its exact two-sum residual picks the odd neighbour when it is
    inexact), and 53 >= 24 + 2 bits makes the final rounding to f32 the
    correctly rounded result."""
    p = a.to(torch.float64) * b
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    to_odd = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(torch.float64)
    return torch.where(to_odd, torch.nextafter(s, toward), s).to(
        torch.float32)


@_register("fifo", ("max_rps", "usd_per_hour", "base_latency_s"), None,
           "", kernel_branch=0)
def _fifo_lane(carry, arrive, p, dt):
    """Fixed capacity, fixed $/hr, FIFO infinite queue (paper Table I)."""
    max_rps, usd_hr, base_lat = p[:, 0], p[:, 1], p[:, 2]
    cap_bin = max_rps * (3600.0 * dt)
    queue = carry[:, 0]
    avail = queue + arrive
    processed = torch.minimum(avail, cap_bin)
    new_q = avail - processed
    # a record arriving this bin waits behind ~the average queue
    avg_q = 0.5 * (queue + new_q)
    latency = base_lat + avg_q / torch.clamp_min(max_rps, 1e-9)
    return (torch.stack([new_q, carry[:, 1]], dim=1),
            (processed, new_q, latency, usd_hr * dt,
             torch.zeros_like(arrive)))


@_register("quickscale", ("max_rps", "usd_per_hour", "base_latency_s"),
           None, "", kernel_branch=1)
def _quickscale_lane(carry, arrive, p, dt):
    """Optimal scaling: never queues; pay ceil(load/capacity) instances."""
    max_rps, usd_hr, base_lat = p[:, 0], p[:, 1], p[:, 2]
    cap_bin = max_rps * (3600.0 * dt)
    queue = carry[:, 0]
    instances = torch.clamp_min(
        torch.ceil(arrive / torch.clamp_min(cap_bin, 1e-9)), 1.0)
    processed = arrive
    new_q = queue * 0.0
    cost = usd_hr * instances * dt
    return (torch.stack([new_q, carry[:, 1]], dim=1),
            (processed, new_q, base_lat, cost, torch.zeros_like(arrive)))


def _clip(x, lo, hi):
    """``jnp.clip``: min(max(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


@_register("autoscale",
           ("max_rps", "usd_per_hour", "base_latency_s",
            "min_instances", "max_instances", "scale_up_hours"),
           {"min_instances": 1.0, "max_instances": 64.0,
            "scale_up_hours": 1.0}, "", kernel_branch=2)
def _autoscale_lane(carry, arrive, p, dt):
    """Horizontal scaling with scale-up delay and min/max instance bounds.

    Demand (queue + arrivals) sets a target instance count; booting is
    first-order with time constant ``scale_up_hours`` (teardown is
    immediate). params[0:2] are per-instance capacity and $/hr.
    """
    max_rps, usd_hr, base_lat = p[:, 0], p[:, 1], p[:, 2]
    min_i, max_i, delay = p[:, 3], p[:, 4], p[:, 5]
    cap1 = max_rps * (3600.0 * dt)
    queue, prev = carry[:, 0], carry[:, 1]
    prev = _clip(prev, min_i, max_i)      # bin 0: carry starts at min_i
    avail = queue + arrive
    target = _clip(torch.ceil(avail / torch.clamp_min(cap1, 1e-9)),
                   min_i, max_i)
    booting = prev + (target - prev) * dt / torch.maximum(delay, dt)
    inst = torch.where(target > prev, booting, target)
    processed = torch.minimum(avail, inst * cap1)
    new_q = avail - processed
    avg_q = 0.5 * (queue + new_q)
    latency = base_lat + avg_q / torch.clamp_min(inst * max_rps, 1e-9)
    cost = usd_hr * inst * dt
    return (torch.stack([new_q, inst], dim=1),
            (processed, new_q, latency, cost, torch.zeros_like(arrive)))


#: Which uses of shed's ``backlog - qmax`` the reference's fault scans
#: fuse into one fma (see the note above), by the scan that runs the step:
SHED_FUSE_DROP = 0     # mixed-policy series scan: the reported dropped only
SHED_FUSE_LATENCY = 1  # mixed aggregate scan: also the queue latency prices
SHED_FUSE_ALL = 2      # uniform-policy block: also the carried queue


def _shed(carry, arrive, p, dt, fuse=None):
    """Shed's arithmetic; ``fuse`` None is the benign step, a SHED_FUSE_*
    level the fault layer's."""
    max_rps, usd_hr, base_lat, qcap_h = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    cap_hour = max_rps * 3600.0
    cap_bin = max_rps * (3600.0 * dt)
    qmax = qcap_h * cap_hour          # hours-of-capacity, not bins
    queue = carry[:, 0]
    avail = queue + arrive
    processed = torch.minimum(avail, cap_bin)
    backlog = avail - processed
    dropped = torch.clamp_min(backlog - qmax, 0.0)
    new_q = lat_q = backlog - dropped
    if fuse is not None:
        dropped = torch.clamp_min(_fma(-qcap_h, cap_hour, backlog), 0.0)
        if fuse >= SHED_FUSE_LATENCY:
            lat_q = backlog - dropped
        if fuse >= SHED_FUSE_ALL:
            new_q = lat_q
    avg_q = 0.5 * (queue + lat_q)
    latency = base_lat + avg_q / torch.clamp_min(max_rps, 1e-9)
    return (torch.stack([new_q, carry[:, 1]], dim=1),
            (processed, new_q, latency, usd_hr * dt, dropped))


@_register("shed",
           ("max_rps", "usd_per_hour", "base_latency_s", "queue_cap_hours"),
           {"queue_cap_hours": 4.0}, "", kernel_branch=3,
           fault_lane_step=_shed)
def _shed_lane(carry, arrive, p, dt):
    """Bounded queue with load shedding: overflow beyond the cap is dropped.

    The queue holds at most ``queue_cap_hours`` hours of capacity worth of
    records; anything beyond is shed and reported in the dropped series.
    """
    return _shed(carry, arrive, p, dt)


@_register("batch_window",
           ("max_rps", "usd_per_hour", "base_latency_s",
            "window_hours", "idle_cost_fraction"),
           {"window_hours": 6.0, "idle_cost_fraction": 0.1}, "",
           kernel_branch=4)
def _batch_window_lane(carry, arrive, p, dt):
    """Accumulate-then-flush batching: cheap hours, half-a-window latency.

    Records accumulate for ``window_hours``; a flush then processes up to
    a full window of capacity at once. Cost is pay-per-use plus an
    ``idle_cost_fraction`` keep-warm charge every hour.
    """
    max_rps, usd_hr, base_lat = p[:, 0], p[:, 1], p[:, 2]
    window, idle_frac = p[:, 3], p[:, 4]
    cap_hour = max_rps * 3600.0
    acc, timer = carry[:, 0], carry[:, 1]
    timer = timer + dt                 # hours since last flush
    flush = timer >= window
    avail = acc + arrive
    processed = torch.where(flush, torch.minimum(avail, cap_hour * window),
                            0.0)
    new_acc = avail - processed
    latency = (_fma(0.5 * window, 3600.0, base_lat)
               + new_acc / torch.clamp_min(max_rps, 1e-9))
    cost = (usd_hr * idle_frac * dt
            + usd_hr * processed / torch.clamp_min(cap_hour, 1e-9))
    new_timer = torch.where(flush, 0.0, timer)
    return (torch.stack([new_acc, new_timer], dim=1),
            (processed, new_acc, latency, cost, torch.zeros_like(arrive)))
