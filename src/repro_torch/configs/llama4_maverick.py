"""llama4-maverick-400b-a17b [moe] - 128 routed experts top-1 + 1 shared.
[hf:meta-llama/Llama-4-Scout-17B-16E]

48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048.
Text backbone (early-fusion vision arrives as embeddings in the VLM arch);
every layer is MoE (the released model interleaves).
"""
import dataclasses

from repro_torch.models.config import ModelConfig, MoEConfig

ARCH_ID = "llama4-maverick-400b-a17b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab_size=202048,
        moe=MoEConfig(n_experts=128, top_k=1, n_shared=1, d_ff_expert=8192),
        rope_theta=500_000.0, tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=64, vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=1, n_shared=1, d_ff_expert=64),
        dtype="float32")
