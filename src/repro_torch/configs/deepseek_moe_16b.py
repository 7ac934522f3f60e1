"""deepseek-moe-16b [moe] - fine-grained MoE: 2 shared + 64 routed top-6.
[arXiv:2401.06066]

28L d_model=2048 16H (kv=16, MHA) expert d_ff=1408 vocab=102400.
"""
import dataclasses

from repro_torch.models.config import ModelConfig, MoEConfig

ARCH_ID = "deepseek-moe-16b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=102400,
        moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408),
        rope_theta=10_000.0, tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=64, vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, n_shared=1, d_ff_expert=64),
        dtype="float32")
