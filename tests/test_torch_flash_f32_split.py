"""The float32 flash kernel's arithmetic, emulated on the CPU.

``csrc/flash_attention.cu`` runs float32 attention on the TF32 tensor
cores in 3xTF32 (``csrc/tf32_mma.cuh``): each float x is split into a
TF32 high part, hi = (bits(x) + 0x1000) & 0xffffe000 (rounded to nearest
on TF32's 10 mantissa bits), and the exact remainder lo = x - hi, which
the tensor core reads with its low 13 bits dropped; a product is taken as
lo hi + hi lo + hi hi by ``mma.sync.m16n8k8`` with float32 accumulation.
``emulate`` repeats that with torch on the CPU: S = Q K^T over groups of
8 dims, hi hi in one sum and the cross terms in another, added once a
key tile; the online softmax tile by tile (exp2 with log2(e) folded into
the scale, masked scores -1e30); a tile's P V over groups of 8 keys in
the kernel's permuted order (A's column q is key 2q, its column q + 4
key 2q + 1), the cross terms before hi hi, into a sum of its own, then
O = O corr + that sum. Key tiles of 32, the kernel's.

Held against the reference's Pallas ``_flash_kernel`` in interpret mode
(float32) within 1e-5 (``MODEL_TOL[float32]`` of ``chip_smoke.py``, atol
= rtol): at whisper-small's head (d 64, 1,500 encoder frames, not causal,
32 decoder queries as in cross-attention; the Pallas wrapper needs blocks
that divide sq and sk, so 300-key blocks), at a causal 512 x 512 block
with GQA (2 query heads over 1 kv head), and at dqk = dv = 256. One TF32
pass (hi hi alone) at the same inputs
misses that bound: the reason for the split. Inputs from a numpy seed.

The kernel itself is held against ``ref.flash_attention`` on the card
(``cuda`` marker; skips without one) at 14g's shape and at sq / sk
straddling its 64-row q tile and its 32-key tiles.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ref

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import model_ref as jref  # noqa: F401

TOL = 1e-5
LOG2E = 1.4426950408889634
#: A's column j of an 8-key group is key PERM[j] (keys 2q, then 2q + 1)
PERM = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def tf32_hi(x):
    """The kernel's high part: half a TF32 step added to the bits, the
    low 13 cleared (int32 views; a negative float's view wraps alike)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_read(x):
    """A float as the tensor core reads a TF32 operand: low 13 bits
    dropped."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def tf32_product(a, b, acc, cross, three=True):
    """acc += a @ b over groups of 8 of a's last dim, as mma.sync does it:
    each group's sum in float32 into the running sum. With ``three`` the
    cross terms lo hi + hi lo go into ``cross`` (or, when it is None,
    into acc before hi hi); else one TF32 pass, hi hi alone."""
    for g0 in range(0, a.shape[-1], 8):
        ag, bg = a[..., g0:g0 + 8], b[..., g0:g0 + 8, :]
        ah, bh = tf32_hi(ag), tf32_hi(bg)
        if three:
            t = tf32_read(ag - ah) @ bh + ah @ tf32_read(bg - bh)
            if cross is None:
                acc = acc + t
            else:
                cross = cross + t
        acc = acc + ah @ bh
    return acc, cross


def emulate(q, k, v, causal, keys=32, three=True):
    """The kernel's arithmetic on float32 q [b, sq, h, dqk], k [b, sk, kh,
    dqk], v [b, sk, kh, dv], key tiles of ``keys``."""
    b, sq, h, dq = q.shape
    sk, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kh
    scale_log2 = torch.tensor(dq ** -0.5 * LOG2E, dtype=torch.float32)
    qh = q.permute(0, 2, 1, 3)
    kt = k.permute(0, 2, 3, 1).repeat_interleave(g, 1)      # [b, h, d, sk]
    vt = v.permute(0, 2, 1, 3).repeat_interleave(g, 1)      # [b, h, sk, dv]
    m = torch.full((b, h, sq, 1), -math.inf)
    l = torch.zeros((b, h, sq, 1))                          # noqa: E741
    o = torch.zeros((b, h, sq, dv))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, sk, keys):
        n = min(keys, sk - k0)
        zero = torch.zeros((b, h, sq, n))
        s, cross = tf32_product(qh, kt[..., k0:k0 + n], zero, zero.clone(),
                                three)
        s = s + cross
        if causal:
            s = torch.where(qpos >= k0 + torch.arange(n)[None, :], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new)
        l = l * corr + p.sum(-1, keepdim=True)              # noqa: E741
        # keys past sk weigh 0: pad the tile to whole 8-key groups
        pad = (-n) % 8
        p = torch.nn.functional.pad(p, (0, pad))
        vv = torch.nn.functional.pad(vt[..., k0:k0 + n, :], (0, 0, 0, pad))
        order = (torch.arange(0, n + pad, 8)[:, None] + PERM).reshape(-1)
        t, _ = tf32_product(p[..., order], vv[..., order, :],
                            torch.zeros_like(o), None, three)
        o = o * corr + t
        m = m_new
    return (o / l.clamp_min(1e-30)).permute(0, 2, 1, 3)


def test_split_is_exact_and_rounds_to_nearest():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4096) * 10.0 ** rng.integers(
        -30, 30, 4096), [1.0, -1.0, 1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11,
                         -(1 + 2.0 ** -11), 3.0e38, 1e-37]]).astype(np.float32)
    t = torch.from_numpy(x)
    hi = tf32_hi(t)
    lo = t - hi
    assert torch.equal(hi + lo, t)                       # exact remainder
    assert not (hi.view(torch.int32) & 0x1fff).any()     # TF32: 10 bits
    # hi is x rounded to nearest on 10 mantissa bits, ties away from zero
    xd = np.abs(x.astype(np.float64))
    step = 2.0 ** (np.floor(np.log2(xd)) - 10)
    want = np.sign(x) * np.floor(xd / step + 0.5) * step
    np.testing.assert_array_equal(hi.numpy().astype(np.float64), want)
    assert (lo.abs() <= 2.0 ** -11 * t.abs()).all()
    # what the tensor core reads of a normal lo loses at most 2^-10 of it
    normal = lo.abs() >= torch.finfo(torch.float32).tiny
    assert normal.sum() > 4000
    assert ((tf32_read(lo) - lo).abs()[normal]
            <= 2.0 ** -10 * lo.abs()[normal]).all()


def test_three_products_hold_a_float32_product():
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.standard_normal(65536).astype(np.float32))
            for _ in range(2))
    ah, bh = tf32_hi(a), tf32_hi(b)
    three = tf32_read(a - ah) * bh + ah * tf32_read(b - bh) + ah * bh
    exact = a.double() * b.double()
    rel3 = ((three.double() - exact).abs() / exact.abs()).max()
    rel1 = ((ah * bh).double() - exact).abs().div(exact.abs()).max()
    assert rel3 <= 2.0 ** -20 and rel1 > 2.0 ** -12


#: (b, sq, sk, h, kh, dqk, dv, causal, Pallas block_q, block_k):
#: whisper-small's cross-attention head, a causal GQA block, dqk = dv =
#: 256
CASES = {
    "whisper_cross": (1, 32, 1500, 2, 2, 64, 64, False, 128, 300),
    "causal_gqa_512": (1, 512, 512, 2, 1, 64, 64, True, 128, 128),
    "d256": (1, 96, 160, 2, 1, 256, 256, True, 32, 32),
}


def _inputs(jref, case):
    b, sq, sk, h, kh, dq, dv = CASES[case][:7]
    rng = np.random.default_rng(sum(map(ord, case)))
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, sq, h, dq), (b, sk, kh, dq), (b, sk, kh, dv))]
    jnp = jref.jax.numpy
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.fixture(scope="module")
def pallas_out(jref):
    """The Pallas kernel's float32 output of each case, in interpret
    mode."""
    out = {}
    for case, (*_, causal, bq, bk) in CASES.items():
        (jq, jk, jv), _ = _inputs(jref, case)
        out[case] = np.asarray(jref.flash_attention.flash_attention(
            jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
            interpret=True))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_3xtf32_emulation_matches_pallas_kernel(jref, pallas_out, case):
    causal = CASES[case][7]
    _, (q, k, v) = _inputs(jref, case)
    got = emulate(q, k, v, causal).numpy()
    want = pallas_out[case]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_one_tf32_pass_misses_the_float32_bound(jref, pallas_out, case):
    causal = CASES[case][7]
    _, (q, k, v) = _inputs(jref, case)
    got = emulate(q, k, v, causal, three=False).numpy()
    want = pallas_out[case]
    outside = np.abs(got - want) > TOL * (1 + np.abs(want))
    assert outside.any(), float(np.abs(got - want).max())


def test_emulation_matches_plain_flash_at_ragged_tiles():
    """Keys past sk (a last tile of 13 keys, not a multiple of 8) weigh 0,
    and causal rows past the diagonal: the emulation against the plain
    version ``ref.flash_attention``, which the kernel is held to on the
    card."""
    g = torch.Generator().manual_seed(3)
    for sq, sk, causal in ((77, 141, True), (65, 77, False)):
        q = torch.randn(1, sq, 4, 40, generator=g)
        k = torch.randn(1, sk, 2, 40, generator=g)
        v = torch.randn(1, sk, 2, 24, generator=g)
        got = emulate(q, k, v, causal)
        want = ref.flash_attention(q, k, v, causal=causal)
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


#: sq / sk around the kernel's 64-row q tile and 32-key tiles
CARD_SEQS = ((1, 1), (63, 64), (64, 63), (65, 65), (31, 33), (129, 200),
             (24, 1500))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=dev).manual_seed(0)
    cases = [(4, 1500, 1500, 12, 12, 64, 64, False)]       # 14g's shape
    cases += [(1, sq, sk, 6, 2, dq, dv, causal) for sq, sk in CARD_SEQS
              for dq, dv in ((64, 64), (96, 64), (256, 256), (24, 16))
              for causal in (False, True)]
    fk.reset_launches()
    with torch.no_grad():
        for b, sq, sk, h, kh, dq, dv, causal in cases:
            q = torch.randn(b, sq, h, dq, generator=g, device=dev)
            k = torch.randn(b, sk, kh, dq, generator=g, device=dev)
            v = torch.randn(b, sk, kh, dv, generator=g, device=dev)
            got = fk.flash_attention(q, k, v, causal=causal)
            want = ref.flash_attention(q, k, v, causal=causal)
            torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    assert fk.launches["flash_attention_f32"] == len(cases)
