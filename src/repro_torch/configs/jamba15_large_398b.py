"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576,
MoE 16e top-2; Mamba:attention 7:1 interleave, MoE every other layer.
[arXiv:2403.19887; hf]"""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    d_ff=24576,
    vocab_size=65536,
    attention=AttentionConfig(kind="gqa", num_heads=64, num_kv_heads=8,
                              head_dim=128, rope="none"),  # jamba: no rope
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=24576),
    moe_every=2,          # MoE every other layer
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    block_pattern=("attn",) + ("mamba",) * 7,   # 7:1 mamba:attention
    mlp_kind="swiglu",
    norm="rmsnorm",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="jamba-smoke", num_layers=8, d_model=64, d_ff=96,
        vocab_size=256,
        attention=dataclasses.replace(CONFIG.attention, num_heads=4,
                                      num_kv_heads=2, head_dim=16),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff=96),
        ssm=SSMConfig(d_state=4, d_conv=2, expand=2),
        max_seq_len=256)
