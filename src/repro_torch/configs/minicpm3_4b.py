"""minicpm3-4b [dense]: 62L d_model=2560 40H (GQA kv=40) d_ff=6400 vocab=73448.
MLA (multi-head latent attention). [hf:openbmb/MiniCPM3-4B; hf]"""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    d_ff=6400,
    vocab_size=73448,
    attention=AttentionConfig(kind="mla", num_heads=40, num_kv_heads=40,
                              head_dim=64, rope="standard", rope_theta=10000.0,
                              q_lora_rank=768, kv_lora_rank=256,
                              qk_nope_head_dim=64, qk_rope_head_dim=32,
                              v_head_dim=64),
    mlp_kind="swiglu",
    norm="rmsnorm",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="minicpm3-smoke", num_layers=2, d_model=64, d_ff=128,
        vocab_size=256,
        attention=dataclasses.replace(
            CONFIG.attention, num_heads=4, num_kv_heads=4, head_dim=16,
            q_lora_rank=24, kv_lora_rank=16, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16),
        max_seq_len=256)
