"""mamba2-2.7b [ssm] - SSD (state-space duality), attention-free.
[arXiv:2405.21060]

64L d_model=2560 ssm_state=128, expand=2 -> d_inner=5120, head_dim=64
(80 SSM heads), vocab=50280.
"""
import dataclasses

from repro_torch.models.config import ModelConfig, SSMConfig

ARCH_ID = "mamba2-2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="ssm",
        n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab_size=50280,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4,
                      n_groups=1, chunk=128),
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, vocab_size=512,
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, d_conv=4,
                      n_groups=1, chunk=8),
        dtype="float32")
