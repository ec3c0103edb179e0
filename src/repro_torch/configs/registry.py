"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      smoke_config)

_ARCH_MODULES = {
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return smoke_config(get_config(arch))


def get_shape(name: str) -> ShapeConfig:
    """One of the assigned LM shapes (``train_4k``, ``prefill_32k``,
    ``decode_32k``, ``long_500k``)."""
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {list(SHAPES)}")
    return SHAPES[name]


def all_cells():
    """Yield every (arch, shape) cell of the assignment (40 total)."""
    for arch in ARCH_IDS:
        for shape in SHAPES.values():
            yield arch, shape


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """Classify a cell: 'native', 'retrieval' (runs via the paper's pHNSW
    retrieval attention), or 'skip:<reason>'."""
    if shape.name == "long_500k" and shape.kind == "decode":
        if cfg.sub_quadratic:
            return "native"
        # a full-attention arch: the paper's technique makes it runnable
        return "retrieval"
    return "native"
