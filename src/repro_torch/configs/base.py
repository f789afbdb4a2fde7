"""Configs of the port: its own copy of the entries of
``repro.configs.base`` that the port runs (``DetectorConfig`` for the two
counters, ``LMConfig`` for the dense LMs, the LM shape set, the registry
and ``reduced``), so the port never imports the reference package."""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple


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


@dataclass(frozen=True)
class LMConfig:
    """Decoder-only LM. The port runs dense GQA only: ``moe`` and ``mla``
    are None in every registered config, and ``models.lm.init``, the one
    place that checks, refuses a config that sets them."""

    name: str
    family: str = "lm"
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 512
    vocab_size: int = 1024
    rope_theta: float = 10000.0
    qk_norm: bool = False
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[Any] = None
    mla: Optional[Any] = None
    param_dtype: str = "bfloat16"

    @property
    def n_params(self) -> int:
        """Total parameter count (embedding + trunk) of a dense GQA LM."""
        d, n = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * self.head_dim * (self.n_heads * 2 + self.n_kv_heads * 2)
        return emb + n * (attn + 3 * d * self.d_ff)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int = 0
    global_batch: int = 0


LM_SHAPES = (
    ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
    ShapeSpec("long_500k", "decode", seq_len=524288, global_batch=1),
)

_ARCH_MODULES = {
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3p8b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "targetfuse-space": "repro_torch.configs.targetfuse_space",
    "targetfuse-ground": "repro_torch.configs.targetfuse_ground",
}


def get_config(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def reduced(cfg):
    """Shrink a config to something a CPU test can run. An LM: 2 layers,
    d_model 64, 4 heads (at most 2 kv heads) of 16, d_ff 128, vocab 256,
    float32. A counter: the first three stages at half width (floor 8),
    64-px input; the ground tier stays wider than the space tier."""
    if isinstance(cfg, LMConfig):
        return replace(
            cfg, name=cfg.name + "-smoke", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2), head_dim=16,
            d_ff=128, vocab_size=256, param_dtype="float32")
    if not isinstance(cfg, DetectorConfig):
        raise TypeError(type(cfg))
    w = tuple(max(8, x // 2) for x in cfg.widths[:3])
    return replace(cfg, name=cfg.name + "-smoke", input_size=64,
                   widths=w, param_dtype="float32")
