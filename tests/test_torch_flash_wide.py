"""The wide flash kernels (head dims past 256): the float32 kernel's
arithmetic emulated on the CPU, and both kernels on the card.

``csrc/flash_attention.cu`` runs a head dim past 256 (either of q/k and
v) through ``flash_wide_f32_kernel`` (float32) and
``flash_wide_wgmma_kernel`` (bf16). A block holds a 64-row q tile and up
to 512 columns of v, split between two halves of its warps that share one
S, so no block recomputes S for v's columns. In the float32 kernel the
two warps of a 16-row band split the columns of q and K, groups of 8
columns taken in turn (the even groups half 0's, the odd half 1's), and
swap their
partial S through shared memory; each then holds the whole S, the same
softmax and the same denominator, and multiplies P by its own half of
V's columns. ``emulate_wide`` repeats that arithmetic with torch on the
CPU: every value split into its TF32 high part and remainder
(``tf32_hi``, read by the tensor core with its low 13 bits dropped); each
half's partial S over its groups of 8 dims, hi hi in one sum and the
cross terms in another, the two added once a key tile; S = half 0's part
+ half 1's; the online softmax tile by tile (exp2 with log2(e) folded into
the scale, masked scores -1e30); a tile's P V over groups of 8 keys, the
cross terms before hi hi, into a sum of its own for each 64 output
columns, then O = O corr + that sum. Key tiles of 32, the kernel's.

Held against the reference's Pallas ``_flash_kernel`` in interpret mode
(float32) within 1e-5 (``MODEL_TOL[float32]`` of ``chip_smoke.py``, atol
= rtol): at DeepSeek-V2-Lite's absorbed MLA (dqk 576, dv 512) and at
(320, 320), 16 query heads over one kv head, 96 queries and keys in
32-row Pallas blocks (the kernel's 32-key tiles, three of them), causal
or not. And against ``ref.flash_attention`` where the tiles are ragged:
sq and sk not multiples of the 64-row q tile or the 32-key tile, a last
tile of keys past sk, an odd number of 8-column groups of q and K, dv
split unevenly between the halves. Inputs from a numpy seed.

The kernels themselves are held against ``ref.flash_attention`` on the
card (``cuda`` marker; skips without one) with sq / sk straddling the
64-row q tile, the 32-key tiles and the bf16 kernel's 16-key halves, at
(576, 512), (320, 320), (264, 264), (64, 264), (1,024, 64) and (1,280,
512), where the bf16 kernel's q no longer fits its shared memory whole
and streams beside K; the wide counters count one launch a call.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ref

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import model_ref as jref  # noqa: F401
from test_torch_flash_f32_split import tf32_hi, tf32_product

TOL = 1e-5
LOG2E = 1.4426950408889634
KEYS = 32          # keys a tile holds
PIECE = 64         # output columns a P V pass covers


def half_dims(dq, half):
    """The q/K columns a band's warp of half ``half`` multiplies: the
    even (half 0) or odd groups of 8 columns."""
    cols = torch.arange(dq)
    return cols[(cols // 8) % 2 == half]


def emulate_wide(q, k, v, causal):
    """The float32 wide kernel's arithmetic on float32 q [b, sq, h, dqk],
    k [b, sk, kh, dqk], v [b, sk, kh, dv] (dv up to 512: one block's)."""
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
    for k0 in range(0, sk, KEYS):
        n = min(KEYS, sk - k0)
        parts = []
        for half in range(2):
            cols = half_dims(dq, half)
            zero = torch.zeros((b, h, sq, n))
            s, cross = tf32_product(qh[..., cols], kt[..., cols, k0:k0 + n],
                                    zero, zero.clone(), True)
            parts.append(s + cross)
        s = parts[0] + parts[1]
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
        for c0 in range(0, dv, PIECE):
            t, _ = tf32_product(p, vv[..., c0:c0 + PIECE],
                                torch.zeros_like(o[..., c0:c0 + PIECE]),
                                None, True)
            o[..., c0:c0 + PIECE] = o[..., c0:c0 + PIECE] * corr + t
        m = m_new
    return (o / l.clamp_min(1e-30)).permute(0, 2, 1, 3)


def test_halves_take_every_dim_once():
    """The band's two warps split the q/K columns: together every column
    once, an odd group count's last group to half 0."""
    for dq in (264, 320, 576, 584, 1024):
        both = torch.cat([half_dims(dq, 0), half_dims(dq, 1)]).sort().values
        assert torch.equal(both, torch.arange(dq))
    assert len(half_dims(264, 0)) == 136 and len(half_dims(264, 1)) == 128


def test_split_parts_are_tf32():
    """A value's split: a high part with TF32's 10 mantissa bits and the
    exact remainder."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi = tf32_hi(x)
    assert not (hi.view(torch.int32) & 0x1fff).any()
    assert torch.equal(hi + (x - hi), x)


#: (b, sq, sk, h, kh, dqk, dv): DeepSeek-V2-Lite's absorbed MLA and a
#: square 320, 16 query heads over one kv head, 96 rows in 32-row Pallas
#: blocks
CASES = {"mla_576_512": (1, 96, 96, 16, 1, 576, 512),
         "d320": (1, 96, 96, 16, 1, 320, 320)}


def _inputs(case):
    b, sq, sk, h, kh, dq, dv = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, dq), (b, sk, kh, dq), (b, sk, kh, dv))]


@pytest.fixture(scope="module")
def pallas_out(jref):
    """The Pallas kernel's float32 output of each case, causal or not, in
    interpret mode."""
    jnp = jref.jax.numpy
    out = {}
    for case in CASES:
        jq, jk, jv = (jnp.asarray(a) for a in _inputs(case))
        for causal in (True, False):
            out[case, causal] = np.asarray(
                jref.flash_attention.flash_attention(
                    jq, jk, jv, causal=causal, block_q=32, block_k=32,
                    interpret=True))
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_wide_emulation_matches_pallas_kernel(pallas_out, case, causal):
    q, k, v = (torch.from_numpy(a) for a in _inputs(case))
    got = emulate_wide(q, k, v, causal).numpy()
    want = pallas_out[case, causal]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("sq, sk, dq, dv, causal", [
    (77, 141, 264, 264, True),      # a last key tile of 13 keys
    (65, 77, 320, 136, False),      # dv split 72 / 64, one piece each
    (130, 45, 64, 264, True),       # more queries than keys
    (33, 200, 584, 40, False),      # 73 groups of 8 q/K columns
])
def test_wide_emulation_matches_plain_flash_at_ragged_tiles(sq, sk, dq, dv,
                                                            causal):
    """Keys past sk weigh 0, causal rows past the diagonal, ragged q and
    key tiles and v columns split unevenly: the emulation against the
    plain version ``ref.flash_attention``, which the kernel is held to on
    the card."""
    g = torch.Generator().manual_seed(sq + sk + dv)
    q = torch.randn(1, sq, 4, dq, generator=g)
    k = torch.randn(1, sk, 2, dq, generator=g)
    v = torch.randn(1, sk, 2, dv, generator=g)
    got = emulate_wide(q, k, v, causal)
    want = ref.flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


#: (dqk, dv) on the card: phase 11's pairs and one whose bf16 q streams
CARD_PAIRS = ((576, 512), (320, 320), (264, 264), (64, 264), (1024, 64),
              (1280, 512))
#: sq / sk around the 64-row q tile, the 32-key tiles and their halves
CARD_SEQS = ((1, 1), (15, 17), (31, 33), (63, 64), (64, 63), (65, 65),
             (129, 200), (300, 127))
#: the tolerances the card's kernels are held to (``MODEL_TOL``)
CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.mark.cuda
def test_wide_kernels_match_plain_on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=dev).manual_seed(0)
    cases = [(1, sq, sk, h, kh, dq, dv, causal, dtype)
             for dq, dv in CARD_PAIRS for sq, sk in CARD_SEQS
             for h, kh in ((16, 1), (6, 2)) for causal in (False, True)
             for dtype in (torch.float32, torch.bfloat16)]
    fk.reset_launches()
    with torch.no_grad():
        for b, sq, sk, h, kh, dq, dv, causal, dtype in cases:
            q = torch.randn(b, sq, h, dq, generator=g, device=dev).to(dtype)
            k = torch.randn(b, sk, kh, dq, generator=g, device=dev).to(dtype)
            v = torch.randn(b, sk, kh, dv, generator=g, device=dev).to(dtype)
            got = fk.flash_attention(q, k, v, causal=causal)
            want = ref.flash_attention(q, k, v, causal=causal)
            tol = CARD_TOL[dtype]
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)
    n = len(cases) // 2
    assert fk.launches == {"flash_attention": 0, "flash_attention_f32": 0,
                           "flash_attention_wide": n,
                           "flash_attention_wide_f32": n}
