"""whisper-small [audio] - encoder-decoder, conv frontend stubbed.
[arXiv:2212.04356]

12L decoder (+12L encoder) d_model=768 12H (kv=12, MHA) d_ff=3072
vocab=51865. Audio arrives as (B, 1500, 768) frame embeddings (the
mel+conv frontend is the reference's stub).
"""
import dataclasses

from repro_torch.models.config import ModelConfig

ARCH_ID = "whisper-small"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="encdec",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab_size=51865,
        encoder_layers=12, encoder_seq=1500,
        input_mode="audio+tokens",
        act="gelu", norm="layernorm", tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, encoder_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=256, vocab_size=512, encoder_seq=16,
        dtype="float32")
