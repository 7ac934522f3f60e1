"""Architecture registry (port of ``repro/configs/__init__.py``).

``get_config(arch_id)`` returns the exact published configuration;
``get_config(arch_id, smoke=True)`` the reduced CPU-test variant. The
port carries the architectures it serves: the dense GQA decoders yi-6b
(untied head) and gemma2-2b (tied head, alternating sliding-window and
global layers, softcaps, post-sublayer norms).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "yi-6b": "repro_torch.configs.yi_6b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port serves "
                       f"{ARCH_IDS} (see ROADMAP.md for the others)")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.smoke_config() if smoke else mod.config()
