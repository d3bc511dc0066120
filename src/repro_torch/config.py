"""Configuration dataclasses, a copy of ``repro.config``.

Frozen, hashable configs. Every assigned architecture has a module under
``repro_torch.configs`` exporting ``CONFIG`` (full size) and
``smoke_config()`` (reduced, runnable on CPU);
``repro_torch.configs.get_config`` is the registry. The port's model runs
the subset its slices have ported (``repro_torch.models.model``) and
raises ``NotImplementedError`` for the rest.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AttentionConfig:
    """Attention family configuration.

    kind:
      gqa   — grouped-query attention (MHA/MQA are special cases)
      mla   — multi-head latent attention (DeepSeek/MiniCPM3 style)
      none  — attention-free (RWKV/SSM layers)
    """
    kind: str = "gqa"
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    # rope: standard | mrope | none
    rope: str = "standard"
    rope_theta: float = 10000.0
    # fraction of head_dim that is rotated (stablelm uses 0.25)
    rotary_pct: float = 1.0
    # M-RoPE section split of head_dim//2 (temporal, height, width)
    mrope_sections: Tuple[int, ...] = ()
    # MLA-specific
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    causal: bool = True
    # logit soft-capping (gemma-2 style); 0 disables
    logit_cap: float = 0.0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim


# ---------------------------------------------------------------------------
# MoE / SSM / RWKV
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    capacity_factor: float = 1.25
    num_shared_experts: int = 0    # moonlight-style always-on shared experts
    router_noise: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 style selective SSM."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64    # lora rank for data-dependent decay (w)
    mix_lora: int = 32      # lora rank for token-shift mixes
    gate_lora: int = 64


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | vlm | ssm | hybrid | audio
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # layer pattern within one repeating group; e.g. jamba:
    # ("attn", "mamba", ..., "mamba") with moe_every=2.
    # Default: ("attn",) * 1 — homogeneous attention stack.
    block_pattern: Tuple[str, ...] = ("attn",)
    # every Nth layer uses MoE for its MLP (0 = all-MoE if moe set, else dense)
    moe_every: int = 0
    mlp_kind: str = "swiglu"          # swiglu | geglu | gelu
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # encoder-decoder (whisper)
    encdec: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0              # encoder memory length (stub frames)
    frontend: str = "none"            # none | audio | vision
    # M-RoPE needs 3-row positions
    position_rows: int = 1
    # numerics
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"
    # embedding scale (gemma multiplies by sqrt(d_model))
    scale_embeddings: bool = False
    # attention-free pure-recurrent model (no kv cache at all)
    max_seq_len: int = 524288

    @property
    def layer_types(self) -> Tuple[str, ...]:
        """Expanded per-layer block kinds of length num_layers."""
        pat = self.block_pattern
        reps = (self.num_layers + len(pat) - 1) // len(pat)
        return tuple((pat * reps)[: self.num_layers])

    def layer_uses_moe(self, idx: int) -> bool:
        if self.moe is None:
            return False
        if self.moe_every <= 1:
            return True
        return (idx % self.moe_every) == (self.moe_every - 1)

    @property
    def sub_quadratic(self) -> bool:
        """True if serve-state is O(1)/linear in context (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")


# ---------------------------------------------------------------------------
# Parallelism / run configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParallelConfig:
    """Sharding rules: map logical axes to mesh axes (None = replicate).

    Mesh axes: pod (multi-pod DP), data (FSDP/DP/EP/SP), model (TP).
    """
    batch_axes: Tuple[str, ...] = ("pod", "data")
    fsdp_axis: Optional[str] = "data"
    tp_axis: Optional[str] = "model"
    expert_axis: Optional[str] = "data"
    # sequence-parallel axis for the KV-cache seq dim (str or tuple of axes)
    seq_axis: Any = "data"
    # shard KV-cache sequence dim over seq_axis when batch < data axis
    shard_cache_seq: bool = False
    remat: str = "none"                  # none | full | dots
    # gradient all-reduce compression: none | int8
    grad_compression: str = "none"
    # microbatches for grad accumulation (1 = off)
    microbatches: int = 1


@dataclass(frozen=True)
class ShapeConfig:
    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; options: {[s.name for s in SHAPES]}")


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    # optimizer state dtype: float32 | bfloat16 | int8 (block-quantized)
    state_dtype: str = "float32"
    state_block: int = 256            # quantization block for int8 state


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    seq_len: int = 512
    global_batch: int = 8
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    async_checkpoint: bool = True
    log_every: int = 10
    seed: int = 0


def replace(cfg, **kw):
    """dataclasses.replace that tolerates nested dotted keys."""
    return dataclasses.replace(cfg, **kw)
