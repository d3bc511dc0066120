"""The port's policy-scan kernels: plain versions against the reference.

On the CPU the wrappers of ``repro_torch.kernels.policy_scan`` run their
plain PyTorch versions (``kernels/ref.py``); these must equal, bit for
bit, both the reference's Pallas kernels in interpret mode and its jnp
oracles, for a mixed-policy block (T = 336, N = 13, foreign parameters in
every slot) at dt 1 h and 1 min, with both branch selectors. A CPU tensor
must never reach the CUDA build or bump a launch counter. The last three
tests run only where a card is visible: two hold the CUDA kernels, benign
and fault, against the plain versions (``python3 chip_smoke.py`` covers
them at full width), and one runs the aggregate kernel at 7.2 M scenarios,
where its histogram offsets pass 2^32 elements. The fault scans' plain
versions are held against the reference in ``test_torch_faults.py``.
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
    # a policy without a CUDA branch (any user registration) is refused
    monkeypatch.setattr(pk, "kernel_branches", lambda: (0, 1, 2, 3, None))
    with pytest.raises(NotImplementedError, match="batch_window"):
        pk._kernel_branch_index(onehot)


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
