"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16e top-2. [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    d_ff=6400,
    vocab_size=32064,
    attention=AttentionConfig(kind="gqa", num_heads=32, num_kv_heads=8,
                              head_dim=128, rope="standard", rope_theta=10000.0),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=6400),
    moe_every=1,
    mlp_kind="swiglu",
    norm="layernorm",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="phi3.5-smoke", num_layers=2, d_model=64, d_ff=96,
        vocab_size=256,
        attention=dataclasses.replace(CONFIG.attention, num_heads=4,
                                      num_kv_heads=2, head_dim=16),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff=96),
        max_seq_len=256)
