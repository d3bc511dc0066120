"""The flash kernel's head dims on the CPU: the plain version at the
dims the configs add, and the wrapper's head-dim rule.

``ref.flash_attention`` (the plain version every CUDA tensor's kernel is
held to on the card) against the reference's Pallas kernel in interpret
mode, at the (dqk, dv) pairs phase 10 of ``chip_smoke.py`` serves:
stablelm-3b's 80, gemma-7b's 256, minicpm3-4b's MLA prefill (q/k 64 + 32,
v 64) and its smoke config's (16 + 8, 16); GQA g 1 and 7 (qwen2-vl-7b's
28 / 4); causal or not; both types. Sequences of 128 in 64-row Pallas
blocks, so the online softmax walks two key blocks. Inputs from a numpy
seed; bf16 inputs are rounded once and handed to both sides.

Tolerances, as in ``tests/test_torch_models.py`` (atol = rtol): float32
1e-6 (the same float32 math, a global softmax against an online one;
measured 2.8e-7 here), bf16 2^-7, one bf16 step of the output (measured
1.5e-3).

The wrapper's rule (``flash_attention.check_head_dims``): q/k and v head
dims each from 1 up; the kernels run multiples of 8, and the wrapper
pads any other dim with zero columns (``pad_head_dims``), scales by the
real q/k dim and slices the output back to the real v dim. It takes every
pair of the ten configs and their smoke configs; at (20, 20), (96, 20)
and (4, 4) the padded plain route is bitwise the unpadded plain flash
(zero columns add exact zeros to every product); 264 is taken, by the
wide kernel (``kernel_name``; ROADMAP C17), and 0 is refused with
``ValueError``. ``_check_operands``, run before every launch on the card,
applies it. Past 256: the plain flash against the Pallas kernel at
(264, 264), DeepSeek-V2-Lite's absorbed (576, 512) and (320, 64), 64
rows (the Pallas block), g 1 and 8.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import all_archs, get_config, get_smoke_config
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ref
from repro_torch.models.model import encoder_cfg

from torch_port_ref import one_torch_thread  # noqa: F401
from torch_port_ref import model_ref as jref  # noqa: F401
from torch_port_ref import both, f32

BF16_STEP = 2.0 ** -7
FLASH_TOL = {torch.float32: 1e-6, torch.bfloat16: BF16_STEP}
#: (dqk, dv) pairs: stablelm-3b, gemma-7b, minicpm3's smoke MLA, its MLA
DIM_PAIRS = [(80, 80), (256, 256), (24, 16), (96, 64)]


def attention_dims(cfg):
    """The (dqk, dv) pair a config's prefill hands the flash kernel."""
    a = cfg.attention
    if a.kind == "mla":
        return a.qk_nope_head_dim + a.qk_rope_head_dim, a.v_head_dim
    return a.head_dim, a.head_dim


@pytest.mark.parametrize("dq, dv", DIM_PAIRS)
@pytest.mark.parametrize("h, kh", [(2, 2), (7, 1)], ids=["g1", "g7"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_plain_flash_matches_pallas_kernel_at_new_dims(jref, dq, dv, h, kh,
                                                       causal, dtype):
    b, s = 1, 128
    rng = np.random.default_rng(dq * 1000 + dv + h)
    jq, q = both(jref, rng.standard_normal((b, s, h, dq)), dtype)
    jk, k = both(jref, rng.standard_normal((b, s, kh, dq)), dtype)
    jv, v = both(jref, rng.standard_normal((b, s, kh, dv)), dtype)
    want = jref.flash_attention.flash_attention(
        jq, jk, jv, causal=causal, block_q=64, block_k=64, interpret=True)
    got = ref.flash_attention(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == (b, s, h, dv)
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)


#: (dqk, dv) pairs past 256 (C17): a square 264, DeepSeek-V2-Lite's
#: absorbed MLA (kv_lora_rank 512 + rope 64, v 512), a wide q/k over a
#: narrow v
WIDE_PAIRS = [(264, 264), (576, 512), (320, 64)]
#: past 256, float32: the model tolerance the card's kernels are held to
#: (``MODEL_TOL``), as each score sums 264-576 products in another order
#: than the Pallas kernel's blocked dots (measured 1.9e-6 at 576 / 512,
#: past FLASH_TOL's 1e-6); bf16 as FLASH_TOL
WIDE_TOL = {torch.float32: 1e-5, torch.bfloat16: BF16_STEP}


@pytest.mark.parametrize("dq, dv", WIDE_PAIRS)
@pytest.mark.parametrize("h, kh", [(2, 2), (8, 1)], ids=["g1", "g8"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_plain_flash_matches_pallas_kernel_past_256(jref, dq, dv, h, kh,
                                                    causal, dtype):
    """The plain flash every wide-kernel launch is held to on the card,
    against the Pallas kernel in interpret mode at head dims past 256:
    sq = sk = 64 (the Pallas kernel's block divides sq), GQA, causal or
    not, both types; ``WIDE_TOL``."""
    b, s = 1, 64
    rng = np.random.default_rng(dq * 1000 + dv + h)
    jq, q = both(jref, rng.standard_normal((b, s, h, dq)), dtype)
    jk, k = both(jref, rng.standard_normal((b, s, kh, dq)), dtype)
    jv, v = both(jref, rng.standard_normal((b, s, kh, dv)), dtype)
    want = jref.flash_attention.flash_attention(
        jq, jk, jv, causal=causal, block_q=64, block_k=64, interpret=True)
    got = ref.flash_attention(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == (b, s, h, dv)
    tol = WIDE_TOL[dtype]
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)
    fk.check_head_dims(dq, dv)


def test_head_dim_rule_takes_every_config():
    pairs = set()
    for arch in all_archs():
        for cfg in (get_config(arch), get_smoke_config(arch)):
            if "attn" not in cfg.block_pattern:     # rwkv6: no attention
                continue
            pairs.add(attention_dims(cfg))
            if cfg.encdec:
                pairs.add(attention_dims(encoder_cfg(cfg)))
    assert {(80, 80), (256, 256), (96, 64), (24, 16), (64, 64),
            (128, 128), (16, 16), (32, 32)} <= pairs
    for dq, dv in sorted(pairs | set(DIM_PAIRS)):
        fk.check_head_dims(dq, dv)
    for d in (8, 136, 192, 248):
        fk.check_head_dims(d, 256 - d + 8)


@pytest.mark.parametrize("dq, dv", [(20, 20), (264, 264), (96, 20),
                                    (64, 264), (0, 64), (4, 4)])
def test_head_dim_rule_refuses_the_rest(dq, dv):
    """The rule refuses a head dim below 1 only: dims past 256 go to the
    wide kernel (C17), the others pad to a multiple of 8."""
    g = torch.Generator().manual_seed(dq * 1000 + dv)
    q = torch.randn(1, 70, 4, dq, generator=g)
    k = torch.randn(1, 70, 2, dq, generator=g)
    v = torch.randn(1, 70, 2, dv, generator=g)
    if max(dq, dv) > fk.MAX_HEAD_DIM:
        fk.check_head_dims(dq, dv)
        fk._check_operands(q, k, v)
        assert "past 256" in fk.HEAD_DIM_RULE
        assert fk.kernel_name(torch.bfloat16, dq, dv) == \
            "flash_attention_wide"
        assert fk.kernel_name(torch.float32, dq, dv) == \
            "flash_attention_wide_f32"
        pq, _, pv = fk.pad_head_dims(q, k, v)
        assert (pq.shape[3], pv.shape[3]) == (dq, dv)   # multiples of 8
        return
    if min(dq, dv) < 1:
        with pytest.raises(ValueError, match="at least one"):
            fk.check_head_dims(dq, dv)
        with pytest.raises(ValueError, match="at least one"):
            fk._check_operands(q, k, v)
        return
    fk._check_operands(q, k, v)
    pq, pk_, pv = fk.pad_head_dims(q, k, v)
    assert pq.shape[3] == pk_.shape[3] == fk.padded_dim(dq) >= dq
    assert pv.shape[3] == fk.padded_dim(dv) >= dv
    assert (pq.shape[3], pv.shape[3]) != (dq, dv)
    assert pq.shape[3] % 8 == pv.shape[3] % 8 == 0
    for causal in (True, False):
        padded = ref.flash_attention(pq, pk_, pv, causal=causal,
                                     scale=dq ** -0.5)[..., :dv]
        assert torch.equal(padded, ref.flash_attention(q, k, v,
                                                       causal=causal))


def test_wrapper_takes_a_value_head_dim_of_its_own():
    """k and v share batch, keys and heads; only their last dims may
    differ, and the output takes v's."""
    q, k = torch.zeros(2, 5, 4, 96), torch.zeros(2, 7, 2, 96)
    fk._check_operands(q, k, torch.zeros(2, 7, 2, 64))
    with pytest.raises(ValueError, match="do not match"):
        fk._check_operands(q, k, torch.zeros(2, 6, 2, 64))
    with pytest.raises(ValueError, match="do not match"):
        fk._check_operands(q, torch.zeros(2, 7, 2, 64),
                           torch.zeros(2, 7, 2, 64))
    out = fk.flash_attention(torch.randn(2, 5, 4, 96),
                             torch.randn(2, 7, 2, 96),
                             torch.randn(2, 7, 2, 64), causal=False)
    assert out.shape == (2, 5, 4, 64)
