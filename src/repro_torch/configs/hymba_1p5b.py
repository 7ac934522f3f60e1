"""hymba-1.5b [hybrid] - parallel attention + mamba heads per layer, SWA
everywhere except 3 global layers (first/middle/last), 128 meta tokens.
[arXiv:2411.13676]

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Meta tokens are realized as a learned per-layer KV prefix + learned SSM
initial state (the state is carried in the tree but, as in the
reference, never read by the forward or the decode).
"""
import dataclasses

from repro_torch.models.config import ModelConfig, SSMConfig


ARCH_ID = "hymba-1.5b"


def _pattern(n_layers: int) -> str:
    # global attention at the first, middle, and last layer
    pat = ["l"] * n_layers
    for i in (0, n_layers // 2, n_layers - 1):
        pat[i] = "g"
    return "".join(pat)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab_size=32001,
        pattern=_pattern(32), window=1024,
        ssm=SSMConfig(d_state=16, head_dim=64, expand=2, d_conv=4,
                      n_groups=1, chunk=128),
        meta_tokens=128, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab_size=512, pattern=_pattern(2), window=16,
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, d_conv=4,
                      n_groups=1, chunk=8),
        meta_tokens=8, dtype="float32")
