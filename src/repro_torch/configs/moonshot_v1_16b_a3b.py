"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64e top-6 (+2 shared experts, moonlight/deepseek style).
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    d_ff=1408,           # per-expert hidden
    vocab_size=163840,
    attention=AttentionConfig(kind="gqa", num_heads=16, num_kv_heads=16,
                              head_dim=128, rope="standard", rope_theta=50000.0),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff=1408, num_shared_experts=2),
    moe_every=1,          # all layers MoE
    mlp_kind="swiglu",
    norm="rmsnorm",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="moonshot-smoke", num_layers=2, d_model=64, d_ff=32,
        vocab_size=256,
        attention=dataclasses.replace(CONFIG.attention, num_heads=4,
                                      num_kv_heads=4, head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff=32, num_shared_experts=1),
        max_seq_len=256)
