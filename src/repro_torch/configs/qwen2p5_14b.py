"""qwen2.5-14b [dense] - GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B]

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen2.5-14b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="dense",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=13824, vocab_size=152064,
        qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab_size=512, dtype="float32")
