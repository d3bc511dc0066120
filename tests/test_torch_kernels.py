"""The port's policy-scan kernels: plain versions against the reference.

On the CPU the wrappers of ``repro_torch.kernels.policy_scan`` run their
plain PyTorch versions (``kernels/ref.py``); these must equal, bit for
bit, both the reference's Pallas kernels in interpret mode and its jnp
oracles, for a mixed-policy block (T = 336, N = 13, foreign parameters in
every slot) at dt 1 h and 1 min, with both branch selectors. A CPU tensor
must never reach the CUDA build or bump a launch counter. The tests
marked ``cuda`` run only where a card is visible: they hold the CUDA
kernels, benign and fault, against the plain versions (``python3
chip_smoke.py`` covers them at full width), the series kernels on grids
that break their block, staging chunk and policy sort, and run the
aggregate kernel at 7.2 M scenarios, where its histogram offsets pass
2^32 elements. The fault scans' plain versions are held against the
reference in ``test_torch_faults.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import twin as pt
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import policy_scan as pk

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import assert_bitwise, bucket_run_histogram, reference

N, T = 13, 336
DTS = [1.0, 1.0 / 60.0]
SLOS = [(0, 4 * 3600.0), (1, 0.01)]


@pytest.fixture(scope="module")
def jref():
    with reference() as r:
        yield r


def _grid(seed=0):
    rng = np.random.default_rng(seed)
    loads = rng.uniform(0.0, 2e4, (N, T)).astype(np.float32)
    params = rng.uniform(0.05, 8.0, (N, pt.PARAM_DIM)).astype(np.float32)
    idx = np.arange(N) % 5          # every policy, mixed
    rng.shuffle(idx)
    return loads, params, idx, pt.policy_onehot(idx)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dt", DTS)
def test_plain_scan_matches_reference(jref, dt):
    loads, params, _, onehot = _grid()
    jnp = jref.jax.numpy
    j_args = (jnp.asarray(loads), jnp.asarray(params), jnp.asarray(onehot),
              dt)
    c_pl, s_pl = jref.policy_scan.policy_grid_scan(*j_args, interpret=True)
    c_or, s_or = jref.ref.policy_grid_scan(*j_args)
    c_p, s_p = pk.policy_grid_scan(_t(loads), _t(params), _t(onehot), dt)
    for want in ((c_pl, s_pl), (c_or, s_or)):
        assert_bitwise(c_p.numpy(), np.asarray(want[0]), "carry_end")
        for k, (a, b) in enumerate(zip(s_p, want[1])):
            assert_bitwise(a.numpy(), np.asarray(b), f"series {k}")


@pytest.mark.parametrize("slo_mode,slo_limit", SLOS)
@pytest.mark.parametrize("dt", DTS)
def test_plain_agg_matches_reference(jref, dt, slo_mode, slo_limit):
    loads, params, _, onehot = _grid(1)
    jnp = jref.jax.numpy
    j_args = (jnp.asarray(loads), jnp.asarray(params), jnp.asarray(onehot),
              dt)
    kw = dict(slo_limit=slo_limit, slo_mode=slo_mode)
    c_pl, a_pl = jref.policy_scan.policy_grid_agg(*j_args, interpret=True,
                                                  **kw)
    c_or, a_or = jref.ref.policy_grid_agg(*j_args, **kw)
    c_p, a_p = pk.policy_grid_agg(_t(loads), _t(params), _t(onehot), dt,
                                  **kw)
    for c_w, a_w in ((c_pl, a_pl), (c_or, a_or)):
        assert_bitwise(c_p.numpy(), np.asarray(c_w), "carry_end")
        assert_bitwise(a_p.numpy(), np.asarray(a_w), "agg rows")


@pytest.mark.parametrize("slo_mode,slo_limit", SLOS)
@pytest.mark.parametrize("dt", DTS)
def test_bucket_run_histogram_matches_reference(jref, dt, slo_mode,
                                                slo_limit):
    """The CUDA aggregate kernel keeps the last bucket's triple in
    registers and touches the histogram in memory only when the bucket
    changes; a numpy model of that is bitwise the plain version's and the
    reference's histogram, on the grid above."""
    loads, params, _, onehot = _grid(1)
    _, (_, _, latency, _, _) = ref.policy_grid_scan(
        _t(loads), _t(params), _t(onehot), dt)
    hist, changes, revisits = bucket_run_histogram(latency.numpy(), loads)
    # the bins leave their bucket, and at dt 1 h come back to one
    assert changes > 2 * N and (revisits > 0 or dt != 1.0)
    jnp = jref.jax.numpy
    _, a_j = jref.ref.policy_grid_agg(jnp.asarray(loads), jnp.asarray(params),
                                      jnp.asarray(onehot), dt,
                                      slo_limit=slo_limit, slo_mode=slo_mode)
    _, a_p = ref.policy_grid_agg(_t(loads), _t(params), _t(onehot), dt,
                                 slo_limit=slo_limit, slo_mode=slo_mode)
    assert_bitwise(hist, a_p[:, pt.AGG_SCALARS:].numpy(), "plain histogram")
    assert_bitwise(hist, np.asarray(a_j)[:, pt.AGG_SCALARS:],
                   "reference histogram")


def test_float64_reciprocal_quotient_is_the_float32_quotient():
    """The CUDA aggregate kernels divide by a scenario's fixed divisors as
    RN32(RN64(a * RN64(1 / d))) (``csrc/policy_scan.cu``, ``quot``): bit
    for bit the IEEE float32 quotient, on random operands over 60 binades
    of each, on the policy steps' magnitudes, and on quotients built to
    lie next to a float32 midpoint."""
    rng = np.random.default_rng(7)
    k = 1 << 20
    a = (rng.uniform(1, 2, k) * 2.0 ** rng.integers(-30, 30, k))
    d = (rng.uniform(1, 2, k) * 2.0 ** rng.integers(-30, 30, k))
    steps_a = rng.uniform(0, 1e7, k)                     # queues, loads
    steps_d = np.maximum(rng.uniform(0, 3e4, k), 1e-9)   # rates, delays
    # a / d next to m, the midpoint between two float32 neighbours
    near_d = rng.uniform(1, 2, k).astype(np.float32)
    m = rng.uniform(1, 2, k).astype(np.float32).astype(np.float64)
    m += np.spacing(m.astype(np.float32)).astype(np.float64) / 2
    near_a = (m * near_d).astype(np.float32)
    for x, y in ((a, d), (steps_a, steps_d), (near_a, near_d)):
        x, y = np.float32(x), np.float32(y)
        assert np.all(y > 0)
        want = x / y
        got = (x.astype(np.float64) * (1.0 / y.astype(np.float64))
               ).astype(np.float32)
        assert_bitwise(got, want, "quotient")


@pytest.mark.parametrize("policy", range(5))
def test_uniform_policy_index_matches_reference(jref, policy):
    loads, params, _, _ = _grid(2)
    jnp = jref.jax.numpy
    j_args = (jnp.asarray(loads), jnp.asarray(params))
    c_j, s_j = jref.ref.policy_grid_scan(*j_args, None, 1.0,
                                         policy_index=policy)
    c_p, s_p = ops.policy_scan(_t(loads), _t(params), policy_index=policy)
    assert_bitwise(c_p.numpy(), np.asarray(c_j), "carry_end")
    for k, (a, b) in enumerate(zip(s_p, s_j)):
        assert_bitwise(a.numpy(), np.asarray(b), f"series {k}")
    c_j, a_j = jref.ref.policy_grid_agg(*j_args, None, 1.0,
                                        policy_index=policy,
                                        slo_limit=3600.0)
    c_p, a_p = ops.policy_scan_agg(_t(loads), _t(params),
                                   policy_index=policy, slo_limit=3600.0)
    assert_bitwise(c_p.numpy(), np.asarray(c_j), "agg carry_end")
    assert_bitwise(a_p.numpy(), np.asarray(a_j), "agg rows")


def test_matrix_and_index_operands_equal_stacked_loads():
    loads, params, _, onehot = _grid(3)
    rows = np.random.default_rng(3).integers(0, 4, N)
    matrix = loads[:4]
    stacked = pk.policy_grid_agg(_t(matrix[rows]), _t(params), _t(onehot))
    indexed = pk.policy_grid_agg(None, _t(params), _t(onehot),
                                 loads_t=_t(matrix.T),
                                 load_index=_t(rows.astype(np.int32)))
    for a, b in zip(stacked, indexed):
        assert_bitwise(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="exactly one"):
        pk.policy_grid_scan(_t(loads), _t(params), _t(onehot),
                            loads_t=_t(loads.T))


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def no_build(*_a, **_k):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(build, "build", no_build)
    loads, params, _, onehot = _grid(4)
    pk.reset_launches()
    caps_t = torch.ones((24, 2))
    findex = torch.zeros(N, dtype=torch.int32)
    pk.policy_grid_scan(_t(loads[:, :24]), _t(params), _t(onehot))
    pk.policy_grid_agg(_t(loads[:, :24]), _t(params), _t(onehot))
    ops.policy_scan_agg(_t(loads[:, :24]), _t(params), policy_index=2)
    pk.policy_grid_scan(_t(loads[:, :24]), _t(params), _t(onehot),
                        caps_t=caps_t, fault_index=findex)
    pk.policy_grid_agg(_t(loads[:, :24]), _t(params), _t(onehot),
                       caps_t=caps_t, fmask_t=caps_t * 0.0,
                       fault_index=findex)
    assert pk.launches == {"policy_scan": 0, "policy_agg": 0,
                           "policy_scan_fault": 0, "policy_agg_fault": 0}


def test_kernel_branch_index_from_onehot(monkeypatch):
    onehot = torch.from_numpy(pt.policy_onehot([4, 0, 2, 1, 3]))
    onehot[1] = 0.0
    np.testing.assert_array_equal(pk._kernel_branch_index(onehot).numpy(),
                                  [4, -1, 2, 1, 3])
    with pytest.raises(ValueError, match="one-hot"):
        pk._kernel_branch_index(onehot * 0.5)
    # a policy without a built-in branch (any user registration, here an
    # override of batch_window) runs its translated step: branch 5 + its
    # index, a bit view included (C15); one whose step has no CUDA form
    # (an operation across lanes, as the reference refuses it too) is
    # refused by name
    saved = dict(pt._REGISTRY)
    monkeypatch.setattr(pt, "_VERSION", pt._VERSION)
    try:
        @pt.register_policy("batch_window", ("max_rps", "usd_per_hour",
                                             "base_latency_s"))
        def _batch_v2(carry, arrive, p, dt):
            return carry, (arrive, carry[:, 0], p[:, 2], p[:, 1],
                           torch.zeros_like(arrive))
        np.testing.assert_array_equal(
            pk._kernel_branch_index(onehot).numpy(), [9, -1, 2, 1, 3])

        @pt.register_policy("batch_window", ("max_rps", "usd_per_hour",
                                             "base_latency_s"))
        def _batch_v3(carry, arrive, p, dt):
            mantissa = (p[:, 2].view(torch.int32) & 0x7FFFFF).float()
            return carry, (arrive, carry[:, 0], mantissa,
                           p[:, 1], torch.zeros_like(arrive))
        np.testing.assert_array_equal(
            pk._kernel_branch_index(onehot).numpy(), [9, -1, 2, 1, 3])

        @pt.register_policy("batch_window", ("max_rps", "usd_per_hour",
                                             "base_latency_s"))
        def _batch_v4(carry, arrive, p, dt):
            return carry, (arrive, carry[:, 0], p[:, 2], p[:, 1],
                           arrive.cumsum(0))
        with pytest.raises(NotImplementedError,
                           match="batch_window.*aten.cumsum"):
            pk._kernel_branch_index(onehot)
    finally:
        pt._REGISTRY.clear()
        pt._REGISTRY.update(saved)


@pytest.mark.parametrize("n", [1, 33, 4097])
def test_policy_order_round_trips_through_the_destination_index(n):
    """The series wrappers run the scenarios sorted by policy and the
    kernel writes sorted scenario j to the caller's column ``dest[j]``:
    on CPU tensors, the order sorts a mixed policy vector (all-zero rows,
    -1, included), keeps the caller's order within a policy, and a write
    through ``dest`` of anything computed from the sorted operands puts
    every value back in its caller's column, with no gather."""
    rng = np.random.default_rng(n)
    branch = torch.from_numpy(rng.integers(-1, 5, n).astype(np.int32))
    order, dest = pk.policy_order(branch)
    assert order.dtype == torch.int64 and dest.dtype == torch.int32
    ran = branch[order]
    assert bool((ran[1:] >= ran[:-1]).all())
    for b in range(-1, 5):          # stable: caller's order within a policy
        mine = order[ran == b]
        assert bool((mine[1:] > mine[:-1]).all())
    t_bins = 3
    x = torch.from_numpy(rng.uniform(0, 1, (n, t_bins)).astype(np.float32))
    # a [T, N] series written the kernel's way, column dest[j] for row j
    series = torch.empty((t_bins, n))
    series[:, dest.long()] = (x[order] * 2.0 + branch[order, None]).t()
    assert torch.equal(series.t(), x * 2.0 + branch[:, None])


def test_card_checks_are_read_back_once_in_order():
    """The CUDA path queues the checks that read the card (one-hot rows,
    row indices) and reads them back in one copy, after its sort and
    gathers are queued and before the launch, with the count of rows
    that run a registered policy's step beside them when one is
    registered; the first failing check raises, as it would have where
    it was made."""
    onehot = torch.from_numpy(pt.policy_onehot([0, 1, 2]))
    checks = []
    pk._kernel_branch_index(onehot * 0.5, checks)        # queued, no raise
    pk._row_index(torch.tensor([0, 5, 1], dtype=torch.int32), 3, 4,
                  torch.device("cpu"), "load", checks)
    assert len(checks) == 2
    with pytest.raises(ValueError, match="one-hot"):
        pk._raise_failed(checks, torch.tensor(1))
    with pytest.raises(ValueError, match="out of range"):
        pk._raise_failed(checks[1:])
    ok = []
    pk._kernel_branch_index(onehot, ok)
    assert pk._raise_failed(ok, torch.tensor(2)) == 2    # the count
    assert pk._raise_failed([]) == 0


def test_build_flags_keep_ieee_rounding():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags and "-prec-div=true" in flags
    assert "fast_math" not in flags and "-ftz=false" in flags
    assert build.library_path("policy_scan").parent == build.BUILD_DIR
    assert (build.CSRC / "policy_scan.cu").is_file()


def _fault_rows(seed, t_bins):
    """[T, F] capacity rows (outage runs, brownouts, all ones), in-fault
    masks, and a fault index for the N scenarios."""
    rng = np.random.default_rng(seed)
    cap = np.ones((4, t_bins), np.float32)
    for f in range(1, 4):
        for start in rng.integers(0, t_bins - 12, 6):
            cap[f, start:start + rng.integers(2, 12)] = 0.0
        brown = rng.uniform(0.0, 1.0, t_bins) < 0.15
        cap[f, brown] *= rng.uniform(0.3, 0.7, int(brown.sum()))
    fmask = (cap != 1.0).astype(np.float32)
    return (_t(cap.T), _t(fmask.T),
            _t(rng.integers(0, 4, N).astype(np.int32)))


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    loads, params, _, onehot = _grid(5)
    cuda = [x.to(dev) for x in (_t(loads), _t(params), _t(onehot))]
    for dt in DTS:
        c_k, s_k = pk.policy_grid_scan(*cuda, dt)
        c_p, s_p = ref.policy_grid_scan(*cuda, dt)
        for a, b in zip((c_k,) + s_k, (c_p,) + s_p):
            assert_bitwise(a.cpu().numpy(), b.cpu().numpy())
        for slo_mode, slo_limit in SLOS:
            got = pk.policy_grid_agg(*cuda, dt, slo_limit=slo_limit,
                                     slo_mode=slo_mode)
            want = ref.policy_grid_agg(*cuda, dt, slo_limit=slo_limit,
                                       slo_mode=slo_mode)
            for a, b in zip(got, want):
                assert_bitwise(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.cuda
def test_fault_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    loads, params, _, onehot = _grid(6)
    cuda = [x.to(dev) for x in (_t(loads), _t(params), _t(onehot))]
    caps_t, fmask_t, findex = (x.to(dev) for x in _fault_rows(6, T))
    fault = dict(caps_t=caps_t, fault_index=findex)
    pk.reset_launches()
    for dt in DTS:
        got = pk.policy_grid_scan(*cuda, dt, **fault)
        want = pk.policy_grid_scan(*(x.cpu() for x in cuda), dt,
                                   **{k: v.cpu() for k, v in fault.items()})
        for a, b in zip((got[0],) + got[1], (want[0],) + want[1]):
            assert_bitwise(a.cpu().numpy(), b.numpy())
        for slo_mode, slo_limit in SLOS:
            kw = dict(fault, fmask_t=fmask_t, slo_limit=slo_limit,
                      slo_mode=slo_mode)
            got = pk.policy_grid_agg(*cuda, dt, **kw)
            want = pk.policy_grid_agg(
                *(x.cpu() for x in cuda), dt,
                **{k: v.cpu() if torch.is_tensor(v) else v
                   for k, v in kw.items()})
            for a, b in zip(got, want):
                assert_bitwise(a.cpu().numpy(), b.numpy())
    assert pk.launches["policy_scan_fault"] == 2
    assert pk.launches["policy_agg_fault"] == 4


#: scenarios past which bucket 150's offset in the [152][N][4] histogram,
#: 4 * 150 * N floats, no longer fits in 32 bits
WIDE_N = 7_200_000


@pytest.mark.cuda
def test_agg_histogram_offsets_past_32_bits_on_card():
    """At 7.2 M scenarios ([152, N, 4] float32 is 17.5 GB) the offsets of
    buckets 150 and 151 pass 2^32 floats: each scenario's histogram, scalars
    and end carry must still equal those of the same scenario in a grid of
    128. The 128 are overloaded (max_rps 1e-6..1e-2), so their latencies
    reach every range of buckets up to the last; three warps of one policy
    and one of all five."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    m, t_bins = 128, 48
    rng = np.random.default_rng(11)
    loads_t = _t(rng.uniform(1e5, 1e7, (t_bins, m)).astype(np.float32))
    params = rng.uniform(0.05, 8.0, (m, pt.PARAM_DIM)).astype(np.float32)
    params[:, 0] = rng.uniform(1e-6, 1e-2, m)
    branch = np.concatenate([np.repeat([0, 2, 4], 32), np.arange(32) % 5])
    lib = pk._lib()

    def run(n):
        reps = n // m
        lidx = torch.arange(m, dtype=torch.int32).repeat(reps)
        args = [x.to(dev) for x in (
            loads_t, lidx, _t(params).repeat(reps, 1),
            _t(branch.astype(np.int32)).repeat(reps))]
        carry = torch.empty((n, pt.CARRY_DIM), device=dev)
        scal = torch.empty((pt.AGG_SCALARS, n), device=dev)
        hist = torch.zeros((pt.AGG_HIST_BINS, n, 4), device=dev)
        with torch.cuda.device(dev):
            rc = lib.policy_agg_launch(
                args[0].data_ptr(), m, t_bins, args[1].data_ptr(),
                args[2].data_ptr(), args[3].data_ptr(), n, 1.0, 4 * 3600.0,
                0, carry.data_ptr(), scal.data_ptr(), hist.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        pk._check(lib, rc, "policy_agg")
        torch.cuda.synchronize(dev)
        return carry, scal, hist

    carry_m, scal_m, hist_m = run(m)
    assert bool((hist_m[150:, :, 0] > 0).any()), "no bin reached bucket 150"
    assert 4 * 150 * WIDE_N >= 2 ** 32 and WIDE_N % m == 0
    reps = WIDE_N // m
    carry, scal, hist = run(WIDE_N)
    assert torch.equal(carry.view(reps, m, -1),
                       carry_m.expand(reps, m, -1))
    assert torch.equal(scal.view(-1, reps, m),
                       scal_m[:, None].expand(-1, reps, m))
    for b in range(pt.AGG_HIST_BINS):
        assert torch.equal(hist[b].view(reps, m, 4),
                           hist_m[b].expand(reps, m, 4)), f"bucket {b}"


def _series_case(n, t_bins, layout, k_rows=7, f_rows=16, seed=0):
    """Operands of one series-kernel case: loads (a tenth of them zero,
    so that some dividends are zero) through a load index, random
    parameters, and policies laid out as ``layout`` says: "stride" (all
    five interleaved at stride 1, every warp mixed), "random" (sorting
    leaves mixed warps at the policy boundaries; some all-zero rows), or
    a policy name (one policy). The F fault rows: half change their
    capacity multiplier every bin (zeros among the values), half hold
    outage runs and brownouts."""
    rng = np.random.default_rng(seed)
    loads_t = rng.uniform(0.0, 2e4, (t_bins, k_rows)).astype(np.float32)
    loads_t[rng.uniform(0, 1, loads_t.shape) < 0.1] = 0.0
    params = rng.uniform(0.05, 8.0, (n, pt.PARAM_DIM)).astype(np.float32)
    names = pt.policy_names()
    if layout == "stride":
        pol = np.arange(n) % 5
    elif layout == "random":
        pol = rng.integers(0, 5, n)
    else:
        pol = np.full(n, names.index(layout))
    onehot = pt.policy_onehot(pol)
    if layout == "random":
        onehot[rng.choice(n, min(n, 7), replace=False)] = 0.0
    cap = np.ones((f_rows, t_bins), np.float32)
    for f in range(f_rows):
        if f % 2:
            # a new value every bin: the reciprocals are made again each bin
            levels = np.float32([0.0, 0.25, 0.3, 0.5, 0.75, 0.9, 1.0])
            at = np.cumsum(rng.integers(1, len(levels), t_bins))
            cap[f] = levels[at % len(levels)]
        else:
            for start in rng.integers(0, max(1, t_bins - 4), 4):
                cap[f, start:start + rng.integers(1, 12)] = 0.0
            brown = rng.uniform(0.0, 1.0, t_bins) < 0.15
            cap[f, brown] *= rng.uniform(0.3, 0.7, int(brown.sum()))
    return dict(loads_t=_t(loads_t), params=_t(params), onehot=_t(onehot),
                load_index=_t(rng.integers(0, k_rows, n).astype(np.int32)),
                caps_t=_t(cap.T),
                fault_index=_t(rng.integers(0, f_rows, n).astype(np.int32)))


#: (N, T, layout): N not a multiple of the 32-thread block, T not a
#: multiple of the 32-bin staging chunk, every warp mixed, and grids of
#: one policy
SERIES_CASES = ([(1, 1, "stride"), (33, 31, "stride"), (33, 33, "random"),
                 (4097, 33, "random"), (4097, 31, "stride"),
                 (33, 8737, "stride")]
                + [(65, 97, name) for name in
                   ("fifo", "quickscale", "autoscale", "shed",
                    "batch_window")])


@pytest.mark.cuda
@pytest.mark.parametrize("n,t_bins,layout", SERIES_CASES)
def test_series_kernels_match_plain_on_card(n, t_bins, layout):
    """Both series kernels, benign and through F = 16 fault rows, bit for
    bit their plain versions (run on the CPU) at dt 0.25 h and 1 h, in
    the caller's order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    case = _series_case(n, t_bins, layout, seed=n + t_bins)
    cuda = {k: v.to(dev) for k, v in case.items()}
    pk.reset_launches()
    for fault in (False, True):
        keys = ("loads_t", "load_index") + (("caps_t", "fault_index")
                                            if fault else ())
        for dt in (0.25, 1.0):
            got = pk.policy_grid_scan(None, cuda["params"], cuda["onehot"],
                                      dt, **{k: cuda[k] for k in keys})
            want = pk.policy_grid_scan(None, case["params"], case["onehot"],
                                       dt, **{k: case[k] for k in keys})
            for k, (a, b) in enumerate(zip((got[0],) + got[1],
                                           (want[0],) + want[1])):
                assert_bitwise(a.cpu().numpy(), b.numpy(),
                               f"fault={fault} dt={dt} output {k}")
    assert pk.launches["policy_scan"] == 2
    assert pk.launches["policy_scan_fault"] == 2
