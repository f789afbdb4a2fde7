"""Configs of the port: its own copy of the entries of
``repro.configs.base`` that the port runs (``DetectorConfig`` for the two
counters, ``LMConfig`` with its ``MoESpec`` and ``MLASpec`` for the four
LMs, the LM shape set, the registry and ``reduced``), so the port never
imports the reference package."""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional, Tuple


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
class MoESpec:
    """Mixture-of-experts block spec (routed + always-on shared experts)."""

    n_routed: int
    n_shared: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    # Layers that use a dense FFN instead of MoE (e.g. deepseek layer 0).
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    # Pad the expert dim to this count (qwen2-moe: 60 -> 64); padded
    # experts are masked out of the router and never receive tokens.
    # 0 = no padding.
    pad_experts_to: int = 0


@dataclass(frozen=True)
class MLASpec:
    """Multi-head Latent Attention (DeepSeek-V2) spec."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class LMConfig:
    """Decoder-only LM: dense GQA (qwen3-8b, phi4-mini), or with an MoE
    FFN (``moe``: qwen2-moe, deepseek) and MLA attention (``mla``:
    deepseek). The reference's training-only fields (``remat``,
    ``scan_layers``) are left out: the port runs its layers in a loop and
    has no backward for the LMs."""

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
    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None
    param_dtype: str = "bfloat16"

    def _emb_attn(self):
        """(embedding and head, one layer's attention) parameter counts."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.mla is None:
            return emb, d * self.head_dim * (self.n_heads * 2 + self.n_kv_heads * 2)
        m = self.mla
        return emb, (d * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                     + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                     + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                     + self.n_heads * m.v_head_dim * d)

    def _count(self, experts: int) -> int:
        d, n = self.d_model, self.n_layers
        emb, attn = self._emb_attn()
        if self.moe is None:
            return emb + n * (attn + 3 * d * self.d_ff)
        e = self.moe
        moe_ffn = experts * 3 * d * e.d_expert + d * e.n_routed
        return (emb + n * attn + e.first_dense_layers * 3 * d * self.d_ff
                + (n - e.first_dense_layers) * moe_ffn)

    @property
    def n_params(self) -> int:
        """Total parameter count (embedding + trunk); padded experts are
        not counted."""
        return self._count(self.moe.n_routed + self.moe.n_shared if self.moe else 0)

    @property
    def n_active_params(self) -> int:
        """Params touched per token (MoE: shared + top_k routed only)."""
        return self._count(self.moe.top_k + self.moe.n_shared if self.moe else 0)


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
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2p7b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
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
    float32; an MoE at most 8 routed experts (2 shared, top-2) of 64,
    unpadded, with ``capacity_factor = 8.0`` (``n_routed``: provably
    drop-free, so prefill and decode match the full forward); MLA at
    rank 32 with heads of 16 + 8 (value 16). A counter: the first three
    stages at half width (floor 8), 64-px input; the ground tier stays
    wider than the space tier."""
    if isinstance(cfg, LMConfig):
        moe, mla = cfg.moe, cfg.mla
        if moe is not None:
            moe = replace(moe, n_routed=min(moe.n_routed, 8), n_shared=min(moe.n_shared, 2),
                          top_k=min(moe.top_k, 2), d_expert=64, capacity_factor=8.0,
                          pad_experts_to=0)
        if mla is not None:
            mla = replace(mla, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                          v_head_dim=16)
        return replace(
            cfg, name=cfg.name + "-smoke", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2), head_dim=16,
            d_ff=128, vocab_size=256, moe=moe, mla=mla, param_dtype="float32")
    if not isinstance(cfg, DetectorConfig):
        raise TypeError(type(cfg))
    w = tuple(max(8, x // 2) for x in cfg.widths[:3])
    return replace(cfg, name=cfg.name + "-smoke", input_size=64,
                   widths=w, param_dtype="float32")
