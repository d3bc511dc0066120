"""whisper-small [audio]: 12L d_model=768 12H (GQA kv=12) d_ff=3072 vocab=51865.
Encoder-decoder; conv frontend is a stub (input_specs provides precomputed
frame embeddings, 1500 frames). [arXiv:2212.04356; unverified]"""
import dataclasses

from repro_torch.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,           # decoder layers
    d_model=768,
    d_ff=3072,
    vocab_size=51865,
    attention=AttentionConfig(kind="gqa", num_heads=12, num_kv_heads=12,
                              head_dim=64, rope="none"),
    mlp_kind="gelu",
    norm="layernorm",
    encdec=True,
    encoder_layers=12,
    encoder_seq=1500,        # 30 s of audio at 50 Hz post-conv
    frontend="audio",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-smoke", num_layers=2, encoder_layers=2,
        encoder_seq=16, d_model=64, d_ff=128, vocab_size=256,
        attention=dataclasses.replace(CONFIG.attention, num_heads=4,
                                      num_kv_heads=4, head_dim=16),
        max_seq_len=256)
