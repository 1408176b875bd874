"""Config registry of the 10 LM architectures (a copy of ``repro/configs``;
the AF2 configs are ``repro_torch.core.config``).

``get_config(arch_id)`` -> LMConfig; ``get_smoke_config(arch_id)`` -> reduced
same-family config for CPU smoke tests; ``SHAPES`` / ``arch_shapes`` the
dry run's input shapes (``configs/shapes.py``) each architecture runs at
(``launch/dryrun.py``).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.shapes import (SHAPES, ShapeSpec,  # noqa: F401
                                        applicable_shapes)

_MODULES = {
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "zamba2-7b": "zamba2_7b",
    "glm4-9b": "glm4_9b",
    "qwen1.5-110b": "qwen1_5_110b",
    "deepseek-67b": "deepseek_67b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "mamba2-2.7b": "mamba2_2_7b",
    "whisper-medium": "whisper_medium",
    "internvl2-26b": "internvl2_26b",
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str, **overrides):
    return get_config(arch_id).reduced(**overrides)


def arch_shapes(arch_id: str) -> list[str]:
    return applicable_shapes(get_config(arch_id).family)
