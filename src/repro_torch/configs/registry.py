"""Architecture registry: ``--arch <id>`` resolution (port of
``repro.configs.registry``): every architecture of the reference, the
assigned shape cells and the dry-run cell list."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (FabricConfig, ModelConfig, SHAPES,
                                      ShapeConfig)

ARCHS = {
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
}


# served at the smoke config only: about 1 T parameters (2 TB in bf16) fit
# no single 80 GB card; the full config is there for --arch and
# param_count
SMOKE_ONLY = frozenset({"kimi-k2-1t-a32b"})


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch]).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch]).smoke()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def get_fabric(arch: str) -> FabricConfig:
    """The memory-movement fabric an architecture names."""
    return get_config(arch).resolved_fabric


def cells():
    """All ``(arch, shape, skip)`` dry-run cells; ``long_500k`` is skipped
    for every architecture that is not subquadratic."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            skip = (shape.name == "long_500k" and not cfg.subquadratic)
            out.append((arch, shape.name, skip))
    return out
