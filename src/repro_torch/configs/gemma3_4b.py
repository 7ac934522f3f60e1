"""gemma3-4b [dense] - 5:1 local(1024):global attention, qk-norm, dual
RoPE bases (local 10k / global 1M), 128k context. [hf:google/gemma-3-1b-pt]

34L d_model=2560 8H (GQA kv=4, head_dim=256) d_ff=10240 vocab=262144.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

ARCH_ID = "gemma3-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="dense",
        n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=10240, vocab_size=262144,
        pattern="lllllg", window=1024,
        qk_norm=True, post_norm=True, emb_scale=True, tie_embeddings=True,
        rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, window=16, dtype="float32")
