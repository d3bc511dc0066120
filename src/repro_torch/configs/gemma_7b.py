"""gemma-7b [dense]: 28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000.
GeGLU, head_dim=256 (q dim 4096 != d_model), scaled embeddings, tied unembed.
[arXiv:2403.08295; hf]"""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    d_ff=24576,
    vocab_size=256000,
    attention=AttentionConfig(kind="gqa", num_heads=16, num_kv_heads=16,
                              head_dim=256, rope="standard", rope_theta=10000.0),
    mlp_kind="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    scale_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="gemma-smoke", num_layers=2, d_model=64, d_ff=128,
        vocab_size=256,
        attention=dataclasses.replace(CONFIG.attention, num_heads=4,
                                      num_kv_heads=4, head_dim=32),
        max_seq_len=256)
