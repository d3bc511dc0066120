"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B; unverified]"""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    d_ff=8192,
    vocab_size=128256,
    attention=AttentionConfig(kind="gqa", num_heads=32, num_kv_heads=8,
                              head_dim=64, rope="standard", rope_theta=500000.0),
    mlp_kind="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llama3.2-smoke", num_layers=2, d_model=64, d_ff=128,
        vocab_size=256,
        attention=dataclasses.replace(CONFIG.attention, num_heads=4,
                                      num_kv_heads=2, head_dim=16),
        max_seq_len=256)
