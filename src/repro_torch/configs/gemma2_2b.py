"""gemma2-2b [dense] - alternating local(4096):global attention, attention
and final logit softcaps, pre+post sublayer norms, tied embeddings.
[arXiv:2408.00118]

26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216 vocab=256000.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

ARCH_ID = "gemma2-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=9216, vocab_size=256000,
        pattern="lg", window=4096,
        attn_softcap=50.0, final_softcap=30.0,
        post_norm=True, emb_scale=True, tie_embeddings=True,
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, window=16, dtype="float32")
