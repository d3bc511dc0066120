"""stablelm-3b [dense]: 32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.
Partial rotary (25%). [hf:stabilityai/stablelm-2-1_6b; unverified]"""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    d_ff=6912,
    vocab_size=50304,
    attention=AttentionConfig(kind="gqa", num_heads=32, num_kv_heads=32,
                              head_dim=80, rope="standard",
                              rope_theta=10000.0, rotary_pct=0.25),
    mlp_kind="swiglu",
    norm="layernorm",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="stablelm-smoke", num_layers=2, d_model=64, d_ff=128,
        vocab_size=256,
        attention=dataclasses.replace(CONFIG.attention, num_heads=4,
                                      num_kv_heads=4, head_dim=16),
        max_seq_len=256)
