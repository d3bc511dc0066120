"""Declarative search spaces over twin-policy parameters.

Counterpart: ``repro.search.space``. A ``SearchSpace`` names, for one
registered policy, which parameters the optimizer may move (policy extras
like queue caps, batch windows, autoscale thresholds — or capacity
itself), the box each one lives in, and how the remaining parameters are
pinned to a *base* twin. The optimizer never touches parameters directly:
free slots ride the sigmoid/softplus bound bijection of twin calibration
(``repro_torch.calibrate.objective.params_from_z`` over
``PolicySpec.bounds``), so every step stays inside the box by
construction — the "projection" of the projected-AdamW search is the
reparameterisation itself.

Beyond calibration's layout, a space supports *tied* parameters:
``tie={"usd_per_hour": ("max_rps", ratio)}`` computes a parameter as a
fixed multiple of another (differentiably), which is how capacity sizing
stays priced — doubling ``max_rps`` doubles the hourly rate at the base
twin's price per unit capacity. ``default_space`` uses exactly that for
policies with no extras (fifo / quickscale).

``SearchSpace.grid(n)`` materialises an ~n-point exhaustive sweep over
the free parameters (full factorial, log-spaced where the space fits in
log space) — the brute-force baseline the optimizer is measured against.
Every array of a space, its starts (``z0``, from
``np.random.default_rng(seed)``) and its grid equal the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.calibrate.objective import params_from_z, z_from_params
from repro_torch.core.twin import PARAM_DIM, Twin, policy_spec

#: z kept inside +-Z_CLIP after every optimizer step: sigmoid(10) is
#: within 5e-5 of the box edge, while gradients still flow (the true
#: asymptote is a dead zone)
Z_CLIP = 10.0


@dataclass(frozen=True)
class SearchSpace:
    """One policy's searchable configuration box (see module docstring).

    lo/hi/log_mask follow the calibration reparam layout; ``free_mask``
    marks the searched slots, ``fixed`` pins everything else to the base
    twin, and ``tie_src``/``tie_coeff`` compute tied slots as
    ``coeff * params[src]`` after the bijection (src must itself be free
    or fixed, not tied).
    """
    policy: str
    base: Twin
    param_names: Tuple[str, ...]
    lo: np.ndarray            # [PARAM_DIM] f32
    hi: np.ndarray            # [PARAM_DIM] f32
    log_mask: np.ndarray      # [PARAM_DIM] bool
    free_mask: np.ndarray     # [PARAM_DIM] bool
    fixed: np.ndarray         # [PARAM_DIM] f32
    tie_src: np.ndarray       # [PARAM_DIM] int32, -1 = untied
    tie_coeff: np.ndarray     # [PARAM_DIM] f32

    @property
    def free_names(self) -> Tuple[str, ...]:
        return tuple(n for i, n in enumerate(self.param_names)
                     if self.free_mask[i])

    @property
    def num_free(self) -> int:
        return int(self.free_mask.sum())

    @property
    def policy_index(self) -> int:
        return policy_spec(self.policy).index

    @property
    def needs_surrogate(self) -> bool:
        """True when any parameter this space VARIES (free or tied) is
        hard-gated in the exact step (``PolicySpec.nondiff_params``).
        Only then does the optimizer scan the smooth-surrogate branch —
        otherwise the exact lane step is its own best gradient model and
        the search descends the true landscape."""
        spec = policy_spec(self.policy)
        varying = {n for i, n in enumerate(self.param_names)
                   if self.free_mask[i] or self.tie_src[i] >= 0}
        return bool(varying & set(spec.nondiff_params))

    # -- the z <-> params mapping (differentiable) --------------------------

    def params_of_z(self, z: torch.Tensor) -> torch.Tensor:
        """[..., PARAM_DIM] unconstrained z -> boxed parameter vectors
        with ties applied (the optimizer differentiates this)."""
        p = params_from_z(z, self.lo, self.hi, self.log_mask,
                          self.free_mask, self.fixed)
        return apply_ties(p, self.tie_src, self.tie_coeff)

    def z0(self, restarts: int, seed: int = 0) -> np.ndarray:
        """[K, PARAM_DIM] starts: start 0 is the base twin (clipped into
        the box), the rest Gaussian in z — spread across the box through
        the bijection, exactly like calibration restarts."""
        rng = np.random.default_rng(seed)
        z = rng.normal(0.0, 1.5, (restarts, PARAM_DIM)).astype(np.float32)
        base_p = np.clip(self.base.padded_params(),
                         self.lo * (1 + 1e-6) + 1e-12, self.hi)
        z[0] = z_from_params(base_p, self.lo, self.hi, self.log_mask)
        return np.clip(z, -Z_CLIP, Z_CLIP)

    def twin(self, params: np.ndarray, name: str) -> Twin:
        """Materialise a candidate parameter vector as a Twin."""
        p = np.asarray(params, np.float64)
        return Twin(name=name, policy=self.policy, kind="searched",
                    params=tuple(float(v)
                                 for v in p[:len(self.param_names)]))

    # -- the exhaustive baseline --------------------------------------------

    def grid(self, n: int, name_prefix: str = "grid") -> List[Twin]:
        """~n-point full-factorial sweep over the free parameters: each
        free dim gets ``round(n ** (1/d))`` points across its box
        (geometric where the space fits the exponent), ties applied — the
        brute-force baseline ``search`` is measured against."""
        free = [i for i in range(PARAM_DIM) if self.free_mask[i]]
        if not free:
            return [self.twin(self._resolve(self.base.padded_params()),
                              f"{name_prefix}-0")]
        m = max(2, int(round(n ** (1.0 / len(free)))))
        axes = []
        for i in free:
            lo, hi = float(self.lo[i]), float(self.hi[i])
            if not np.isfinite(hi):
                raise ValueError(
                    f"{self.policy}.{self.param_names[i]}: cannot grid a "
                    f"half-open box ({lo:g}, inf) — give the parameter a "
                    f"finite upper bound (bounds=) for the exhaustive "
                    f"baseline")
            if self.log_mask[i]:
                axes.append(np.geomspace(max(lo, 1e-12), hi, m))
            else:
                axes.append(np.linspace(lo, hi, m))
        mesh = np.meshgrid(*axes, indexing="ij")
        pts = np.stack([ax.ravel() for ax in mesh], axis=1)
        twins = []
        for k, row in enumerate(pts):
            p = self.base.padded_params().astype(np.float64)
            p[free] = row
            twins.append(self.twin(self._resolve(p), f"{name_prefix}-{k}"))
        return twins

    def _resolve(self, p: np.ndarray) -> np.ndarray:
        """Apply ties host-side (numpy twin of ``apply_ties``)."""
        p = np.asarray(p, np.float64).copy()
        tied = self.tie_src >= 0
        p[tied] = self.tie_coeff[tied] * p[self.tie_src[tied]]
        return p


def apply_ties(p: torch.Tensor, tie_src, tie_coeff) -> torch.Tensor:
    """Overwrite tied slots of ``p`` [..., PARAM_DIM] with ``coeff *
    p[src]`` in float32 (differentiable; untied slots gather slot 0
    harmlessly and are masked back to their own value)."""
    src = torch.as_tensor(tie_src, device=p.device)
    coeff = torch.as_tensor(tie_coeff, dtype=torch.float32,
                            device=p.device)
    gathered = coeff * p[..., torch.clamp_min(src, 0).long()]
    return torch.where(src >= 0, gathered, p)


def search_space(base: Twin, search: Optional[Sequence[str]] = None, *,
                 bounds: Optional[Dict[str, Tuple[float, float]]] = None,
                 tie: Optional[Dict[str, Tuple[str, float]]] = None
                 ) -> SearchSpace:
    """Build a ``SearchSpace`` for ``base``'s policy.

    ``search`` names the free parameters (default: the policy's extras —
    everything past the shared triple; for extra-less policies, capacity
    itself with the hourly rate tied to it, see ``default_space``).
    ``bounds`` overrides the registry boxes per parameter; ``tie`` maps
    ``name -> (source_name, coeff)`` so a parameter is computed, not
    searched. A base value outside a searched box is an error naming the
    parameter and policy — a silently clamped warm start is how searches
    return "optima" the operator never asked about.
    """
    spec = policy_spec(base.policy)
    names = spec.param_names
    if search is None:
        return default_space(base, bounds=bounds, tie=tie)
    unknown = set(search) - set(names)
    if unknown:
        raise KeyError(f"{spec.name} has no params {sorted(unknown)}; "
                       f"expects {names}")
    tie = dict(tie or {})
    unknown_tie = (set(tie) | {src for src, _ in tie.values()}) - set(names)
    if unknown_tie:
        raise KeyError(f"{spec.name} has no params {sorted(unknown_tie)} "
                       f"(tie=)")
    overlap = set(tie) & set(search)
    if overlap:
        raise ValueError(f"{spec.name}: {sorted(overlap)} cannot be both "
                         f"searched and tied")
    for src, _coeff in tie.values():
        if src in tie:
            raise ValueError(f"{spec.name}: tie source {src!r} is itself "
                             f"tied — chained ties are not supported")

    lo = np.zeros(PARAM_DIM, np.float32)
    hi = np.ones(PARAM_DIM, np.float32)
    log_mask = np.zeros(PARAM_DIM, bool)
    free_mask = np.zeros(PARAM_DIM, bool)
    fixed = np.zeros(PARAM_DIM, np.float32)
    tie_src = np.full(PARAM_DIM, -1, np.int32)
    tie_coeff = np.zeros(PARAM_DIM, np.float32)
    base_p = base.padded_params()
    for i, pname in enumerate(names):
        b_lo, b_hi = (bounds or {}).get(pname) or spec.bound(pname)
        if not b_lo < b_hi:
            raise ValueError(f"{spec.name}.{pname}: empty box "
                             f"({b_lo}, {b_hi})")
        lo[i], hi[i] = b_lo, b_hi
        # log-scale geometry: registry-declared log params, plus any box
        # spanning >= 2 decades (instance counts, queue caps): a linear
        # sigmoid over (1, 4096) puts the economical 1-10 region in the
        # bottom 0.2% of z-space and starves both restarts and grids
        log_mask[i] = (pname in spec.log_params
                       or (b_lo > 0 and np.isfinite(b_hi)
                           and b_hi / b_lo >= 100.0))
        if pname in tie:
            src_name, coeff = tie[pname]
            tie_src[i] = names.index(src_name)
            tie_coeff[i] = float(coeff)
        elif pname in search:
            free_mask[i] = True
            if not np.isfinite(b_hi):
                # the optimizer's z-clip caps a softplus half-open box at
                # lo + ~10, silently — demand the finite box grid()
                # already requires instead of returning a capped "optimum"
                raise ValueError(
                    f"{spec.name}.{pname}: searched parameters need a "
                    f"finite box, got ({b_lo:g}, inf) — pass bounds= with "
                    f"a finite upper bound")
            if not b_lo <= base_p[i] <= b_hi:
                raise ValueError(
                    f"{spec.name}.{pname}: base value {base_p[i]:g} lies "
                    f"outside the search box ({b_lo:g}, {b_hi:g}) — widen "
                    f"bounds= or fix the base twin")
        else:
            fixed[i] = base_p[i]
    return SearchSpace(policy=spec.name, base=base, param_names=names,
                       lo=lo, hi=hi, log_mask=log_mask,
                       free_mask=free_mask, fixed=fixed,
                       tie_src=tie_src, tie_coeff=tie_coeff)


def default_space(base: Twin, *,
                  bounds: Optional[Dict[str, Tuple[float, float]]] = None,
                  tie: Optional[Dict[str, Tuple[str, float]]] = None
                  ) -> SearchSpace:
    """The policy's natural knobs: its extras when it has any (queue
    caps, windows, instance bounds, boot delays); otherwise capacity
    sizing — ``max_rps`` free with ``usd_per_hour`` tied at the base
    twin's price per unit capacity, so fifo/quickscale searches answer
    "how big an instance should we buy", not "what if compute were
    free"."""
    spec = policy_spec(base.policy)
    extras = tuple(spec.param_names[3:])
    if extras:
        return search_space(base, extras, bounds=bounds, tie=tie)
    if tie is None:
        ratio = base.usd_per_hour / max(base.max_rps, 1e-12)
        tie = {"usd_per_hour": ("max_rps", ratio)}
    return search_space(base, ("max_rps",), bounds=bounds, tie=tie)
