"""llava-next-mistral-7b [vlm] - mistral-7b decoder; the ViT/SigLIP tower
and the anyres tiling projector are stubbed: inputs arrive as (B, S,
4096) patch+text embeddings. [hf:llava-hf/llava-v1.6-mistral-7b-hf]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

ARCH_ID = "llava-next-mistral-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="vlm",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=32000,
        input_mode="embeddings",
        rope_theta=1_000_000.0, tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab_size=512, dtype="float32")
