"""yi-6b [dense] - llama-architecture GQA. [arXiv:2403.04652]

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

ARCH_ID = "yi-6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
        d_ff=11008, vocab_size=64000,
        rope_theta=5_000_000.0, tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab_size=512, dtype="float32")
