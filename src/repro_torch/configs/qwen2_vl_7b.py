"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
M-RoPE, dynamic resolution (vision frontend is a stub: input_specs provides
precomputed patch embeddings at model width). [arXiv:2409.12191; hf]"""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig

# number of stub patch embeddings prepended to the text sequence
N_PATCHES = 256

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    d_ff=18944,
    vocab_size=152064,
    attention=AttentionConfig(kind="gqa", num_heads=28, num_kv_heads=4,
                              head_dim=128, rope="mrope", rope_theta=1000000.0,
                              mrope_sections=(16, 24, 24)),
    mlp_kind="swiglu",
    norm="rmsnorm",
    frontend="vision",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-vl-smoke", num_layers=2, d_model=64, d_ff=128,
        vocab_size=256,
        attention=dataclasses.replace(CONFIG.attention, num_heads=4,
                                      num_kv_heads=2, head_dim=16,
                                      mrope_sections=(2, 3, 3)),
        max_seq_len=256)
