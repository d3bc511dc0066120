"""rwkv6-7b [ssm]: 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536.
Finch — data-dependent decay. [arXiv:2404.05892; hf]"""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    attention=AttentionConfig(kind="none", rope="none"),
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
    block_pattern=("rwkv",),
    norm="layernorm",     # rwkv uses LN
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="rwkv6-smoke", num_layers=2, d_model=64, d_ff=128,
        vocab_size=256, rwkv=RWKVConfig(head_dim=16, decay_lora=8, mix_lora=8),
        max_seq_len=256)
