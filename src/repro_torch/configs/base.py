"""Detector configs of the port: its own copy of the two counters'
entries of ``repro.configs.base`` (``DetectorConfig``, the registry and
``reduced``), so the port never imports the reference package."""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class DetectorConfig:
    """Paper's own DNN counters (YOLO-style single-shot detectors)."""

    name: str
    family: str = "detector"
    input_size: int = 416
    widths: Tuple[int, ...] = (16, 32, 64, 128, 256)
    n_blocks_per_stage: int = 1
    n_classes: int = 8
    n_anchors: int = 3
    param_dtype: str = "float32"
    remat: str = "none"


_ARCH_MODULES = {
    "targetfuse-space": "repro_torch.configs.targetfuse_space",
    "targetfuse-ground": "repro_torch.configs.targetfuse_ground",
}


def get_config(arch: str) -> DetectorConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def reduced(cfg: DetectorConfig) -> DetectorConfig:
    """Shrink a counter to something a CPU test can run: the first three
    stages at half width (floor 8), 64-px input. The ground tier stays
    wider than the space tier."""
    if not isinstance(cfg, DetectorConfig):
        raise TypeError(type(cfg))
    w = tuple(max(8, x // 2) for x in cfg.widths[:3])
    return replace(cfg, name=cfg.name + "-smoke", input_size=64,
                   widths=w, param_dtype="float32")
