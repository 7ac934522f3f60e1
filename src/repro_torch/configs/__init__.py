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
the reference's registry is here, in its order. ``INPUT_SHAPES`` are
the shapes the dry run (``launch.dryrun``) models each arch at.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig

_MODULES = {
    "whisper-small": "repro_torch.configs.whisper_small",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2p7b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "hymba-1.5b": "repro_torch.configs.hymba_1p5b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "qwen2.5-14b": "repro_torch.configs.qwen2p5_14b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
}

ARCH_IDS = tuple(_MODULES)

# the assigned input shapes: name -> (seq_len, global_batch, kind)
INPUT_SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention (or a sliding window): the
# other archs are full-attention, or capped by design (whisper), and the
# dry run skips them at that shape
LONG_CONTEXT_ARCHS = ("mamba2-2.7b", "hymba-1.5b", "gemma2-2b", "gemma3-4b")


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port serves "
                       f"{ARCH_IDS} (see ROADMAP.md for the others)")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.smoke_config() if smoke else mod.config()


def shape_applicable(arch_id: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_id in LONG_CONTEXT_ARCHS
    return True
