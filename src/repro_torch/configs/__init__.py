"""Architecture registry (port of ``repro/configs/__init__.py``).

``get_config(arch_id)`` returns the exact published configuration;
``get_config(arch_id, smoke=True)`` the reduced CPU-test variant. The
port carries the dense GQA family: yi-6b (untied head), gemma2-2b (tied
head, alternating sliding-window and global layers, softcaps,
post-sublayer norms), gemma3-4b (5:1 local:global layers, qk-norm, a
local RoPE base), qwen2.5-14b (QKV bias) and llava-next-mistral-7b (the
mistral decoder on embedding input, its vision tower stubbed), and the
MoE family: deepseek-moe-16b (2 shared + 64 routed experts, top-6) and
llama4-maverick-400b-a17b (1 shared + 128 routed, top-1), the SSM and
hybrid family: mamba2-2.7b (SSD, attention-free) and hymba-1.5b
(parallel attention and SSD heads, 128 meta tokens), and the
encoder-decoder family: whisper-small (12 + 12 layers, layernorm, gelu,
sinusoidal positions, 1500 stubbed audio frames). Every architecture of
the reference's registry is here.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "yi-6b": "repro_torch.configs.yi_6b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "qwen2.5-14b": "repro_torch.configs.qwen2p5_14b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2p7b",
    "hymba-1.5b": "repro_torch.configs.hymba_1p5b",
    "whisper-small": "repro_torch.configs.whisper_small",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port serves "
                       f"{ARCH_IDS} (see ROADMAP.md for the others)")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.smoke_config() if smoke else mod.config()
