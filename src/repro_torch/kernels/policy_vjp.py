"""The checkpointed gradient scan of the TwinPolicy lane scan.

Counterpart: ``repro.kernels.policy_vjp``. Autograd through the plain
scan (``ref.policy_grid_scan``) tapes every bin of the horizon; here the
same scan is a ``torch.autograd.Function`` with the O(√T) segment
-checkpoint schedule of the reference's ``jax.custom_vjp``:

* **forward** — one plain scan over all T bins under no-grad, the same
  arithmetic as ``ref.policy_grid_scan`` (bitwise its values). It keeps
  the state at the start of each of the ~√T segments of ~√T bins
  (``_segment_plan``) as it passes them — the reference recomputes them
  in its backward with one carry-only replay; the values are the same
  and the port saves that scan;
* **backward** — the segments are rematerialised back to front under
  ``torch.enable_grad()`` from detached entry states, and the state
  cotangent is chained through them. Live are the entry states and one
  segment's tape, never the whole horizon's.

When the tape of *all* segments at once fits ``PARALLEL_REMAT_BYTES``
(short horizons: a calibration trace of a few hundred bins) the
backward rematerialises every segment in one batched pass instead of
one after another: the segments are independent given their entry
states, so they run as extra lanes. The chain between them is linear:
one batched pass with a basis cotangent per state slot (one lane
replica each) gives every segment's Jacobian of exit state against
entry state, the chain is then a few [N, S, S] products, and a second
batched pass with the chained cotangents gives the operand gradients.
That is the same gradient in ~2√T sequential bins instead of ~T, which
is what the eager backward pays for, bin by bin, on either device.
Longer horizons take the one-segment-at-a-time schedule of the
reference. The two schedules associate the chain differently: where a
huge state cotangent cancels inside a segment (a saturated queue under a
reconnect flood, ~1e8), one at a time loses the small remainder to
float32 rounding, as plain autograd and the reference do, and the
Jacobian products keep it — there the schedules differ by more than
rounding. Each schedule sums the per-lane operands' gradient over the
bins in plain autograd's order (last bin first; ``_Remat.cotangents``).

Gradients flow to ``params``, ``loads`` and ``onehot`` (and, in the
fold, to ``caps``, the fold's per-lane operands and its per-bin rows);
``dt_hours`` and the selector are constants. ``surrogate=True`` scans
the smooth surrogate branches (``core.twin.surrogate_lane_branches``),
the gradient model of ``repro_torch.search``, in both directions.

``policy_grid_scan_fold`` is the streaming sibling: instead of five
[N, T] series the per-bin outputs fold into a caller-defined
accumulator carried in the scan state (``fold_init(n, device)`` and
``fold_step(acc, arrive, outs, ops_lane, xs_row)``), so neither
direction holds an [N, T] intermediate. It also runs the fault layer
(``caps=`` / ``caps_t=``) and folds the fault backlog into
``carry_end[:, 0]`` as the reference does. Operand layout: the
accumulator's leaves and the ``ops_lane`` leaves carry the lanes on
their first axis ([N, ...]); ``xs`` leaves are [T, ...] rows shared by
every lane (a row broadcasts against lane-first tensors).

The schedule is chosen from the lane count, so a caller that runs a
share of a problem's lanes (a rank of a restart mesh) says how many
lanes the whole problem has (``whole_lanes``): every rank then takes
the schedule the unsharded call takes, and each lane's gradient is the
same bit for bit.

The CUDA policy kernels have no backward; on the card these scans run
as PyTorch operations, the same code as on the CPU.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.core.twin import CARRY_DIM, SHED_FUSE_ALL, SHED_FUSE_DROP
from repro_torch.kernels import ref

#: the most a backward may tape at once to rematerialise every segment
#: in one batched pass; beyond it segments run one at a time
PARALLEL_REMAT_BYTES = 64 << 20
#: bytes the tape keeps per lane and bin (an estimate: ~64 float32 values)
TAPE_BYTES_PER_LANE_BIN = 256
#: segment length of the batched rematerialisation
PARALLEL_SEG_BINS = 4


#: lanes of the whole problem per lane of this call (``whole_lanes``)
_LANE_FACTOR = [1]


@contextlib.contextmanager
def whole_lanes(factor: int):
    """Within the block, plan the backward as for ``factor`` times the
    lanes each call has: the call runs one of ``factor`` equal shares of
    a problem's lanes."""
    prev = _LANE_FACTOR[0]
    _LANE_FACTOR[0] = int(factor)
    try:
        yield
    finally:
        _LANE_FACTOR[0] = prev


def _segment_plan(t_bins: int):
    """(seg_len, num_segments, tail_len) with seg_len ≈ √T — the classic
    even split; whatever T leaves over runs as one shorter tail segment."""
    seg = max(1, math.isqrt(max(t_bins, 1)))
    nseg = t_bins // seg
    return seg, nseg, t_bins - nseg * seg


def _plan(t_bins: int, n: int, reps: int):
    """(seg_len, num_segments, tail_len, parallel): the reference's √T
    plan, one segment at a time; or, when ``reps`` lane replicas of the
    whole horizon fit ``PARALLEL_REMAT_BYTES``, segments of
    ``PARALLEL_SEG_BINS`` bins rematerialised all at once (their batched
    passes are that many bins long, and the chain between them is one
    small product per segment)."""
    seg, nseg, tail = _segment_plan(t_bins)
    n = n * _LANE_FACTOR[0]
    if reps * t_bins * n * TAPE_BYTES_PER_LANE_BIN <= PARALLEL_REMAT_BYTES:
        pseg = min(PARALLEL_SEG_BINS, t_bins)
        if t_bins // pseg > 1:
            return pseg, t_bins // pseg, t_bins % pseg, True
    return seg, nseg, tail, False


# ---------------------------------------------------------------------------
# pytrees of tensors (nested tuples / lists)
# ---------------------------------------------------------------------------

def _flatten(tree):
    if isinstance(tree, torch.Tensor):
        return [tree], None
    if isinstance(tree, (tuple, list)):
        leaves, specs = [], []
        for x in tree:
            sub, spec = _flatten(x)
            leaves += sub
            specs.append((len(sub), spec))
        return leaves, (type(tree), specs)
    raise TypeError(f"fold operands are tensors or tuples/lists of them, "
                    f"got {type(tree).__name__}")


def _unflatten(spec, leaves):
    if spec is None:
        return leaves[0]
    typ, specs = spec
    out, i = [], 0
    for n, sub in specs:
        out.append(_unflatten(sub, leaves[i:i + n]))
        i += n
    return typ(out)


def _width(t: torch.Tensor) -> int:
    """Slots per lane of a lane-first tensor."""
    return math.prod(t.shape[1:])


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

class _Scan:
    """One scan's constants: the policy step (selector, bin width, fault
    layer), the fold, and the operand layout. The state steps as
    (carry, fault backlog or None, accumulator or None) and is saved and
    rematerialised as its flat list of lane-first leaves (``pack``;
    ``init_state`` records the accumulator's structure)."""

    def __init__(self, dt_hours, policy_index, columns, fault, fold_init,
                 fold_step, ops_spec, xs_spec, n_ops, n_xs, sinks=(),
                 surrogate=False):
        self.sinks = tuple(sinks)
        self.surrogate = bool(surrogate)
        self.dt_hours = float(dt_hours)
        self.policy_index = (None if policy_index is None
                             else int(policy_index))
        self.columns = columns
        self.fault = fault
        # the fault layer's rounding, ``ref.policy_grid_scan``'s: the
        # uniform blocks fuse every use of shed's overflow, the mixed
        # series scan the reported drop only
        self.fuse = (None if not fault else SHED_FUSE_DROP
                     if policy_index is None else SHED_FUSE_ALL)
        self.fold_init = fold_init
        self.fold_step = fold_step
        self.ops_spec, self.xs_spec = ops_spec, xs_spec
        self.n_ops, self.n_xs = n_ops, n_xs
        self.acc_spec = None

    # -- the bin step -------------------------------------------------------

    def bin_fn(self, params, onehot, ops, dt, all_columns=False):
        """``fn(state, arrive, capmul, xs_row) -> (state, outs)`` with
        ``state`` = (carry, fault backlog or None, accumulator or None):
        the step ``ref.policy_grid_scan`` runs (the fault layer at its
        rounding), then the fold. ``all_columns`` blends every policy
        (the one-hot gradient needs the unselected branches too)."""
        columns = self.columns
        if all_columns and onehot is not None:
            columns = list(range(onehot.shape[1]))
        pstep = ref._bin_step(params, onehot, self.policy_index, dt,
                              self.fuse, columns, self.surrogate)
        fold = self.fold_step
        ops_tree = (None if fold is None
                    else _unflatten(self.ops_spec, list(ops)))

        def fn(state, arrive, capmul, xs_row):
            carry, fq, acc = state
            if fq is None:
                carry, outs = pstep(carry, arrive, capmul)
            else:
                (carry, fq), outs = pstep((carry, fq), arrive, capmul)
            if fold is not None:
                acc = fold(acc, arrive, outs, ops_tree, xs_row)
            return (carry, fq, acc), outs
        return fn

    def pack(self, state) -> list:
        """(carry, backlog, accumulator) -> the flat list of leaves."""
        carry, fq, acc = state
        leaves = [carry] + ([fq] if self.fault else [])
        if self.fold_step is not None:
            leaves += _flatten(acc)[0]
        return leaves

    def unpack(self, leaves):
        carry = leaves[0]
        fq = leaves[1] if self.fault else None
        acc = (None if self.fold_step is None else
               _unflatten(self.acc_spec, list(leaves[1 + self.fault:])))
        return carry, fq, acc

    def rows(self, loads, caps, xs):
        """Per-bin (arrive, capmul, xs_row) of [T, ...] row operands."""
        la = loads.unbind(0)
        ca = caps.unbind(0) if caps is not None else None
        xa = [x.unbind(0) for x in xs]
        for t in range(len(la)):
            xs_row = (None if self.fold_step is None else
                      _unflatten(self.xs_spec, [x[t] for x in xa]))
            yield la[t], (None if ca is None else ca[t]), xs_row

    def sink_mask(self, leaves) -> list:
        """One bool per slot of the state: True on the accumulator's sink
        leaves (see ``policy_grid_scan_fold``)."""
        first = 1 + self.fault
        return [i - first in self.sinks for i, x in enumerate(leaves)
                for _ in range(_width(x))]

    def replicas(self, leaves, series) -> int:
        """Lane replicas of the batched Jacobian pass: one per non-sink
        slot, one for all the sinks, one for the series outputs."""
        sink = self.sink_mask(leaves)
        return sink.count(False) + any(sink) + series

    def init_state(self, n, dev):
        state = [torch.zeros((n, CARRY_DIM), dtype=torch.float32,
                             device=dev)]
        if self.fault:
            state.append(torch.zeros(n, dtype=torch.float32, device=dev))
        if self.fold_step is not None:
            leaves, self.acc_spec = _flatten(self.fold_init(n, dev))
            state += leaves
        return state

    # -- forward ------------------------------------------------------------

    def forward(self, params, loads_t, onehot, caps_t, ops, xs, series):
        """The plain scan (no grad): the final state's leaves, the entry
        state of every segment of the backward's plan (``_plan``, and of
        the tail), the plan, and with ``series`` the five [T, N]
        series."""
        t_bins, n = loads_t.shape
        dev = loads_t.device
        dt = torch.tensor(self.dt_hours, dtype=torch.float32, device=dev)
        fn = self.bin_fn(params, onehot, ops, dt)
        init = self.init_state(n, dev)
        plan = _plan(t_bins, n, self.replicas(init, series))
        seg, nseg = plan[:2]
        state = self.unpack(init)
        out = (torch.empty((5, t_bins, n), dtype=torch.float32, device=dev)
               if series else None)
        entries = []
        # inference mode dispatches each operation faster than no-grad;
        # what leaves it (entries, final state) is cloned into ordinary
        # tensors the backward can rematerialise from
        with torch.inference_mode():
            for t, row in enumerate(self.rows(loads_t, caps_t, xs)):
                if t % seg == 0 and len(entries) <= nseg:
                    entries.append(self.pack(state))
                state, outs = fn(state, *row)
                if series:
                    for k, o in enumerate(outs):
                        out[k, t] = o
        entries = [[x.clone() for x in e] for e in entries]
        return ([x.clone() for x in self.pack(state)], entries, plan, out)


def _rows(src, starts, length):
    """[length, G, ...]: rows ``starts[g] + b`` of a [T, ...] operand for
    bins b < length of G segments."""
    idx = (starts[None, :] + torch.arange(length, device=starts.device)
           [:, None]).reshape(-1)
    return src.index_select(0, idx).reshape(
        (length, starts.numel()) + src.shape[1:])


def _lanes_rows(src, starts, length, reps, n, per_scenario):
    """[length, reps * G * n, ...] per-lane rows of a [T, ...] operand for
    G segments (lanes ordered replica, segment, scenario): ``src`` is
    [T, n] per scenario, or [T, *rest] rows shared by every lane."""
    rows = _rows(src, starts, length)
    g = starts.numel()
    if per_scenario:                                  # [length, G, n]
        rows = rows[:, None].expand(length, reps, g, n)
        return rows.reshape(length, reps * g * n)
    rest = rows.shape[2:]                             # [length, G, *rest]
    rows = rows[:, None, :, None].expand((length, reps, g, n) + rest)
    return rows.reshape((length, reps * g * n) + rest)


def _tile(x, times):
    """[n, ...] lane-first -> [times * n, ...], the block repeated."""
    if x is None:
        return None
    return x.repeat((times,) + (1,) * (x.dim() - 1))


def _lanes_state(entries, reps):
    """Entry states of G segments ([n, ...] leaves each) -> batched leaves
    [reps * G * n, ...] (replica-major)."""
    out = []
    for leaves in zip(*entries):
        st = torch.stack(leaves)                     # [G, n, ...]
        st = st[None].expand((reps,) + st.shape)
        out.append(st.reshape((-1,) + st.shape[3:]))
    return out


def _split_slots(flat, like):
    """[..., S] -> leaves shaped like ``like``'s leaves."""
    out, i = [], 0
    for leaf in like:
        w = _width(leaf)
        out.append(flat[..., i:i + w].reshape(leaf.shape))
        i += w
    return out


def _slots(leaves, lead):
    """Lane-first leaves -> [*lead, S] (their slots side by side)."""
    return torch.cat([x.reshape(lead + (-1,)) for x in leaves], dim=-1)


def _or_zeros(grads, like):
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(like, grads)]


class _Remat:
    """The backward's rematerialisations: segments of one length run from
    their saved entry states as extra lanes, and the operand gradients
    they contribute are accumulated in ``grads`` (params, loads_t,
    onehot, caps_t, *ops, *xs)."""

    def __init__(self, scan, inputs, needs, g_series):
        (self.params, self.loads_t, self.onehot, self.caps_t,
         self.ops, self.xs) = inputs
        self.scan = scan
        self.needs = needs          # (params, loads, onehot, caps, ops, xs)
        self.g_series = g_series    # [5, T, n] or None (the fold)
        self.n = self.loads_t.shape[1]
        self.dev = self.loads_t.device
        self.dt = torch.tensor(scan.dt_hours, dtype=torch.float32,
                               device=self.dev)
        self.grads = [None] * (4 + len(self.ops) + len(self.xs))
        # per-bin gradient terms of the per-lane operands, by bin
        self.terms = {i: {} for i in [0, 2] + [4 + j for j in
                                              range(len(self.ops))]}

    def _run(self, state, rows, length, operands):
        """Scan ``length`` bins of batched lanes: the exit state and, for
        the series scan, the outputs stacked [length, 5, L].
        ``operands`` is (params, onehot, ops), or a list of one such
        triple per bin."""
        scan = self.scan
        shared = isinstance(operands, tuple)
        if shared:
            fn = scan.bin_fn(*operands, self.dt, all_columns=self.needs[2])
        state = scan.unpack(state)
        outs_all = []
        for b, row in enumerate(scan.rows(*rows)):
            if not shared:
                fn = scan.bin_fn(*operands[b], self.dt,
                                 all_columns=self.needs[2])
            state, outs = fn(state, *row)
            if self.g_series is not None:
                outs_all.append(torch.stack(outs))
        return (scan.pack(state),
                torch.stack(outs_all) if outs_all else None)

    def _series_cot(self, starts, length, reps, replica):
        """Output cotangents [length, 5, L]: the series cotangent rows of
        the segments in replica ``replica``, zero in the others."""
        rows = _rows(self.g_series.permute(1, 0, 2), starts, length)
        g = starts.numel()                           # rows [len, G, 5, n]
        full = torch.zeros((length, 5, reps, g, self.n),
                           dtype=torch.float32, device=self.dev)
        full[:, :, replica] = rows.permute(0, 2, 1, 3)
        return full.reshape(length, 5, reps * g * self.n)

    def _starts(self, starts):
        return torch.tensor(starts, dtype=torch.long, device=self.dev)

    def jacobians(self, entries, starts, length, g_sink):
        """For G segments of ``length`` bins from bins ``starts``, one
        batched pass with a lane replica per exit slot that is not a sink:
        J [G, n, R, S] (d exit slot ``free[r]`` / d entry slot s), and the
        entry cotangent [G, n, S] that the sinks' constant cotangent
        ``g_sink`` [n, S] (zero off the sinks) and, for the series scan,
        the outputs contribute (one replica for each)."""
        n, g = self.n, len(entries)
        s_dim = sum(_width(x) for x in entries[0])
        sink = self.scan.sink_mask(entries[0])
        free = [i for i, is_sink in enumerate(sink) if not is_sink]
        nfree, has_sink = len(free), any(sink)
        series = self.g_series is not None
        reps = nfree + has_sink + series
        idx = self._starts(starts)
        with torch.enable_grad():
            state = [x.detach().requires_grad_()
                     for x in _lanes_state(entries, reps)]
            rows = (_lanes_rows(self.loads_t, idx, length, reps, n, True),
                    None if self.caps_t is None else
                    _lanes_rows(self.caps_t, idx, length, reps, n, True),
                    [_lanes_rows(x, idx, length, reps, n, False)
                     for x in self.xs])
            times = reps * g
            exit_, outs = self._run(
                list(state), rows, length,
                (_tile(self.params, times), _tile(self.onehot, times),
                 [_tile(x, times) for x in self.ops]))
            basis = torch.zeros((reps, g, n, s_dim), dtype=torch.float32,
                                device=self.dev)
            basis[torch.arange(nfree, device=self.dev), :, :,
                  torch.tensor(free, device=self.dev)] = 1.0
            if has_sink:
                basis[nfree] = g_sink[None]
            outputs = list(exit_)
            cots = _split_slots(basis.reshape(-1, s_dim), exit_)
            if series:
                outputs.append(outs)
                cots.append(self._series_cot(idx, length, reps, reps - 1))
            grads = torch.autograd.grad(outputs, state, cots,
                                        allow_unused=True)
        flat = _slots(_or_zeros(grads, state), (reps, g, n))  # [R, G, n, S]
        jac = flat[:nfree].permute(1, 2, 0, 3)                # [G, n, R, S]
        contrib = flat[nfree:].sum(dim=0) if reps > nfree else None
        return free, jac, contrib

    def cotangents(self, entries, starts, length, g_exit):
        """Rematerialise G consecutive segments of ``length`` bins from
        bins ``starts`` once, with their exit cotangents ``g_exit``
        [G, n, S]: accumulates the operand gradients and returns the first
        segment's entry cotangent [n, S].

        The per-lane operands (params, onehot, ops) sum their gradient
        over the bins of the horizon. The sum runs in the order plain
        autograd through the whole scan (and the reference's scan
        transpose) runs it, last bin first: one segment (G = 1) takes the
        running sum of the later segments as the first term of its own
        (the operand is an output of the pass, with that sum as its
        cotangent); G segments at once give each bin's term apart, and
        ``result`` adds them back to front."""
        n, g = self.n, len(entries)
        t0, t1 = starts[0], starts[-1] + length
        need_p, need_l, need_oh, need_c, need_ops, need_xs = self.needs
        lane_ops = [(0, self.params, need_p), (2, self.onehot, need_oh)]
        lane_ops += [(4 + j, x, need_ops) for j, x in enumerate(self.ops)]
        lane_ops = [op for op in lane_ops if op[1] is not None]
        with torch.enable_grad():
            state = [x.detach().requires_grad_()
                     for x in _lanes_state(entries, 1)]
            tiled = {i: _tile(x.detach(), g) for i, x, _ in lane_ops}
            per_bin = [{i: tiled[i].detach().requires_grad_(need)
                        for i, _, need in lane_ops}
                       for _ in range(1 if g == 1 else length)]
            operands = [(lv[0], lv.get(2),
                         [lv[4 + j] for j in range(len(self.ops))])
                        for lv in per_bin]
            loads = self.loads_t[t0:t1].detach().requires_grad_(need_l)
            caps = (None if self.caps_t is None else
                    self.caps_t[t0:t1].detach().requires_grad_(need_c))
            xs = [x[t0:t1].detach().requires_grad_(need_xs)
                  for x in self.xs]

            def lane_rows(x, per_scenario):
                # [G * length, ...] -> [length, G * n, ...]
                x = x.reshape((g, length) + x.shape[1:]).transpose(0, 1)
                if not per_scenario:
                    x = x[:, :, None].expand((length, g, n) + x.shape[2:])
                return x.reshape((length, g * n) + x.shape[3:])

            rows = (lane_rows(loads, True),
                    None if caps is None else lane_rows(caps, True),
                    [lane_rows(x, False) for x in xs])
            exit_, outs = self._run(list(state), rows, length,
                                    operands[0] if g == 1 else operands)
            outputs = list(exit_)
            cots = _split_slots(g_exit.reshape(g * n, -1), exit_)
            if self.g_series is not None:
                outputs.append(outs)
                cots.append(self._series_cot(self._starts(starts), length,
                                             1, 0))
            if g == 1:              # the later segments' sum goes first
                for i, _, need in lane_ops:
                    if need and self.grads[i] is not None:
                        outputs.append(per_bin[0][i])
                        cots.append(self.grads[i])
            wanted = [(state, True)]
            wanted += [([lv[i] for lv in per_bin], need)
                       for i, _, need in lane_ops]
            wanted += [([loads], need_l), ([caps], need_c), (xs, need_xs)]
            inputs = [x for group, need in wanted if need for x in group]
            grads = list(torch.autograd.grad(outputs, inputs, cots,
                                             allow_unused=True))
        g_state = _or_zeros(grads[:len(state)], state)
        rest = grads[len(state):]
        for i, x, need in lane_ops:
            if not need:
                continue
            terms = [rest.pop(0) for _ in per_bin]
            if g == 1:
                if terms[0] is not None:
                    self.grads[i] = terms[0]
                continue
            for b, gr in enumerate(terms):        # bin starts[k] + b
                if gr is None:
                    continue
                for k, gr_k in enumerate(gr.reshape((g, n) + x.shape[1:])):
                    self.terms[i][starts[k] + b] = gr_k
        if need_l:
            self._put(1, rest.pop(0), t0, t1, self.loads_t)
        if need_c:
            self._put(3, rest.pop(0), t0, t1, self.caps_t)
        k = 4 + len(self.ops)
        for x in self.xs:
            if need_xs:
                self._put(k, rest.pop(0), t0, t1, x)
            k += 1
        return _slots(g_state, (g, n))[0]                      # [n, S]

    def result(self):
        """The gradients: each per-lane operand's bin terms from a batched
        pass added back to front onto the running sum."""
        for i, terms in self.terms.items():
            acc = self.grads[i]
            for t in sorted(terms, reverse=True):
                acc = terms[t] if acc is None else acc + terms[t]
            self.grads[i] = acc
            terms.clear()
        return self.grads

    def _put(self, i, gr, t0, t1, like):
        if self.grads[i] is None:
            self.grads[i] = torch.zeros_like(like)
        if gr is not None:
            self.grads[i][t0:t1] = gr


def _backward(scan, inputs, entries, plan, g_final, needs, g_series):
    """The checkpointed backward over the forward's ``plan``: the tail
    first, then the body segments back to front — one at a time (the
    reference's schedule), or all at once through their Jacobians.
    Returns the gradients of (params, loads_t, onehot, caps_t, *ops,
    *xs), None where none was asked for."""
    n = inputs[1].shape[1]
    seg, nseg, tail, parallel = plan
    remat = _Remat(scan, inputs, needs, g_series)
    g = _slots(g_final, (n,))                                  # [n, S]
    if tail:
        g = remat.cotangents([entries[nseg]], [nseg * seg], tail, g[None])
    starts = [i * seg for i in range(nseg)]
    if parallel:
        # the sinks' cotangent is the same at every segment's exit: theirs
        # at the end of the horizon
        sink = torch.tensor(scan.sink_mask(entries[0]), device=g.device)
        g_sink = torch.where(sink, g, torch.zeros_like(g))
        free, jac, contrib = remat.jacobians(entries[1:nseg], starts[1:],
                                             seg, g_sink)
        free = torch.tensor(free, device=g.device)
        g_exit = [None] * nseg
        g_exit[-1] = g
        for i in range(nseg - 1, 0, -1):
            ge = (g_exit[i][:, free, None] * jac[i - 1]).sum(dim=1)
            g_exit[i - 1] = ge if contrib is None else ge + contrib[i - 1]
        remat.cotangents(entries[:nseg], starts, seg, torch.stack(g_exit))
    else:
        for i in range(nseg - 1, -1, -1):
            g = remat.cotangents([entries[i]], [starts[i]], seg, g[None])
    return remat.result()


class _CkptScan(torch.autograd.Function):
    """(params, loads_t [T, N], onehot) -> (carry_end [N, CARRY_DIM],
    series [5, T, N])."""

    @staticmethod
    def forward(ctx, scan, params, loads_t, onehot):
        state, entries, plan, series = scan.forward(
            params, loads_t, onehot, None, [], [], True)
        ctx.scan, ctx.plan = scan, plan
        ctx.n_leaves = len(state)
        ctx.n_entries = len(entries)
        ctx.has_onehot = onehot is not None
        flat = [x for e in entries for x in e]
        ctx.save_for_backward(params, loads_t,
                              *([onehot] if onehot is not None else []),
                              *flat)
        return state[0], series

    @staticmethod
    def backward(ctx, g_carry, g_series):
        saved = list(ctx.saved_tensors)
        params, loads_t = saved[:2]
        onehot = saved[2] if ctx.has_onehot else None
        flat = saved[2 + ctx.has_onehot:]
        k = ctx.n_leaves
        entries = [flat[i * k:(i + 1) * k] for i in range(ctx.n_entries)]
        needs = (ctx.needs_input_grad[1], ctx.needs_input_grad[2],
                 ctx.has_onehot and ctx.needs_input_grad[3], False,
                 False, False)
        grads = _backward(ctx.scan, (params, loads_t, onehot, None, [], []),
                          entries, ctx.plan, [g_carry], needs, g_series)
        return None, grads[0], grads[1], grads[2]


class _FoldScan(torch.autograd.Function):
    """(params, loads_t [T, N], onehot, caps_t [T, N], *ops, *xs) -> the
    final state leaves (carry, fault backlog, accumulator)."""

    @staticmethod
    def forward(ctx, scan, params, loads_t, onehot, caps_t, *rest):
        ops, xs = list(rest[:scan.n_ops]), list(rest[scan.n_ops:])
        state, entries, plan, _ = scan.forward(params, loads_t, onehot,
                                               caps_t, ops, xs, False)
        ctx.scan, ctx.plan = scan, plan
        ctx.n_leaves = len(state)
        ctx.n_entries = len(entries)
        ctx.has = (onehot is not None, caps_t is not None)
        flat = [x for e in entries for x in e]
        ctx.save_for_backward(
            params, loads_t, *([onehot] if onehot is not None else []),
            *([caps_t] if caps_t is not None else []), *ops, *xs, *flat)
        return tuple(state)

    @staticmethod
    def backward(ctx, *g_state):
        scan = ctx.scan
        saved = list(ctx.saved_tensors)
        params, loads_t = saved.pop(0), saved.pop(0)
        has_oh, has_caps = ctx.has
        onehot = saved.pop(0) if has_oh else None
        caps_t = saved.pop(0) if has_caps else None
        ops = saved[:scan.n_ops]
        xs = saved[scan.n_ops:scan.n_ops + scan.n_xs]
        flat = saved[scan.n_ops + scan.n_xs:]
        k = ctx.n_leaves
        entries = [flat[i * k:(i + 1) * k] for i in range(ctx.n_entries)]
        need = ctx.needs_input_grad
        needs = (need[1], need[2], has_oh and need[3],
                 has_caps and need[4], any(need[5:5 + scan.n_ops]),
                 any(need[5 + scan.n_ops:]))
        grads = _backward(scan, (params, loads_t, onehot, caps_t, ops, xs),
                          entries, ctx.plan, list(g_state), needs, None)
        return (None,) + tuple(grads)


def _columns(onehot):
    """The policies some lane selects (the blend skips the others)."""
    return torch.nonzero(onehot.any(dim=0)).flatten().tolist()


def policy_grid_scan_ckpt(loads, params, onehot=None, dt_hours=1.0, *,
                          policy_index=None, surrogate: bool = False):
    """``ref.policy_grid_scan`` semantics with the O(√T) checkpointed
    backward: loads [N, T], params [N, PARAM_DIM], exactly one of
    ``onehot`` [N, P] or ``policy_index`` (an int) -> (carry_end
    [N, CARRY_DIM], five [N, T] series). The values are bitwise the plain
    scan's; only the gradient schedule differs. ``surrogate`` scans the
    smooth branches."""
    ref.check_selector(onehot, policy_index)
    loads_t = loads.t().contiguous()
    scan = _Scan(dt_hours, policy_index,
                 None if onehot is None else _columns(onehot), False, None,
                 None, None, None, 0, 0, surrogate=surrogate)
    carry_end, series = _CkptScan.apply(scan, params, loads_t, onehot)
    return carry_end, tuple(series[k].t() for k in range(5))


def policy_grid_scan_fold(loads=None, params=None, onehot=None,
                          dt_hours=1.0, *, policy_index=None,
                          surrogate: bool = False, caps=None, loads_t=None,
                          caps_t=None, fold_init, fold_step, ops_lane=(),
                          xs=(), acc_sinks=()):
    """Streaming lane scan: fold per-bin policy outputs into a caller
    -defined accumulator instead of materialising [N, T] series.

    ``fold_init(n, device)`` builds the accumulator (a tensor or nested
    tuple of lane-first tensors) for ``n`` lanes;
    ``fold_step(acc, arrive, outs, ops_lane, xs_row)`` folds one bin's
    ``outs = (processed, queue, latency, cost, dropped)`` (each [N]) into
    it. ``ops_lane`` holds differentiable per-lane operands ([N, ...]
    leaves); ``xs`` per-bin rows shared by every lane ([T, ...] leaves).
    Operands may come scenario-minor (``loads_t`` / ``caps_t`` [T, N]).
    ``acc_sinks`` names accumulator leaves (by position among its
    flattened leaves) that are sinks: the fold only adds into them, and
    nothing else reads them (compensated sums). Their cotangent is then
    the same at every bin, and the batched backward carries it as one
    lane replica instead of one per slot.
    ``caps`` / ``caps_t`` run the fault layer, as ``ref.policy_grid_scan``
    does (uniform blocks at SHED_FUSE_ALL, mixed grids at
    SHED_FUSE_DROP), and the backlog residue folds into
    ``carry_end[:, 0]``. ``surrogate`` scans the smooth branches.
    Returns (carry_end [N, CARRY_DIM], acc)."""
    ref.check_selector(onehot, policy_index)
    if (loads is None) == (loads_t is None):
        raise ValueError("pass exactly one of loads= ([N, T]) or "
                         "loads_t= ([T, N] scenario-minor)")
    if loads_t is None:
        loads_t = loads.t()
    if caps is not None and caps_t is not None:
        raise ValueError("pass caps= or caps_t=, not both")
    if caps is not None:
        caps_t = caps.t()
    ops_leaves, ops_spec = _flatten(ops_lane)
    xs_leaves, xs_spec = _flatten(xs)
    scan = _Scan(dt_hours, policy_index,
                 None if onehot is None else _columns(onehot),
                 caps_t is not None, fold_init, fold_step, ops_spec,
                 xs_spec, len(ops_leaves), len(xs_leaves), acc_sinks,
                 surrogate)
    state = _FoldScan.apply(scan, params, loads_t, onehot, caps_t,
                            *ops_leaves, *xs_leaves)
    carry = state[0]
    if caps_t is not None:
        fq = state[1]
        carry = torch.stack([carry[:, 0] + fq, carry[:, 1]], dim=1)
    acc = _unflatten(scan.acc_spec, list(state[1 + (caps_t is not None):]))
    return carry, acc
