"""Configs of the port: its own copy of ``repro.configs.base``
(``DetectorConfig`` for the counters, ``LMConfig`` with its ``MoESpec``
and ``MLASpec`` for the four LMs, ``VisionConfig`` for ViT, ConvNeXt and
ResNet, ``DiffusionConfig`` for DiT and the UNet, every family's shape
set, the registry with ``ASSIGNED_ARCHS``, ``list_archs`` and
``all_cells``, and ``reduced``), so the port never imports the
reference package."""
from __future__ import annotations

import dataclasses
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

    @property
    def n_params(self) -> int:
        total = 3 * 3 * 3 * self.widths[0]
        prev = self.widths[0]
        for w in self.widths[1:]:
            total += (3 * 3 * prev * w) * self.n_blocks_per_stage
            prev = w
        return total + prev * self.n_anchors * (5 + self.n_classes)


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
    deepseek). ``remat`` is the reference's: "none", "full" (each block
    saves nothing and recomputes everything in the backward) or
    "dots_saveable" (it keeps the outputs of its matrix products,
    ``layers.remat``). The reference's ``scan_layers`` is left out: the
    port runs its layers in a loop."""

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
    remat: str = "dots_saveable"

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
class VisionConfig:
    """An image classifier: ``kind`` "vit" (patch, n_layers, d_model,
    n_heads, d_ff), "convnext" (depths, dims) or "resnet" (bottleneck
    depths, width). ``remat`` is the reference's: "none", or any other
    value for a training forward that recomputes each block in its
    backward and keeps only its matrix products' and convolutions'
    outputs (``layers.remat``, the counterpart of JAX's
    ``dots_saveable``). The reference's ``scan_layers`` is left out: the
    port runs the layers in a loop."""

    name: str
    family: str = "vision"
    kind: str = "vit"  # 'vit' | 'convnext' | 'resnet'
    img_res: int = 224
    n_classes: int = 1000
    # vit
    patch: int = 16
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    # convnext / resnet
    depths: Tuple[int, ...] = ()
    dims: Tuple[int, ...] = ()
    width: int = 64
    param_dtype: str = "bfloat16"
    remat: str = "dots_saveable"

    @property
    def n_params(self) -> int:
        """The reference's count: weights of the convolutions and dense
        layers (ViT: with the cls token, without position embeddings,
        norms and biases)."""
        if self.kind == "vit":
            d = self.d_model
            emb = 3 * self.patch * self.patch * d + d  # patch embed (+cls)
            blk = 4 * d * d + 2 * d * self.d_ff
            return emb + self.n_layers * blk + d * self.n_classes
        if self.kind == "convnext":
            total = 3 * 4 * 4 * self.dims[0]
            for i, (dep, dim) in enumerate(zip(self.depths, self.dims)):
                total += dep * (7 * 7 * dim + dim * 4 * dim * 2)  # dwconv + 2 pw
                if i + 1 < len(self.dims):
                    total += dim * self.dims[i + 1] * 2 * 2  # downsample conv
            return total + self.dims[-1] * self.n_classes
        w = self.width
        total = 3 * 7 * 7 * w
        in_ch = w
        for i, dep in enumerate(self.depths):
            mid = w * (2**i)
            out = mid * 4
            for b in range(dep):
                total += in_ch * mid + 3 * 3 * mid * mid + mid * out
                if b == 0 and in_ch != out:
                    total += in_ch * out
                in_ch = out
        return total + in_ch * self.n_classes


@dataclass(frozen=True)
class DiffusionConfig:
    """A latent diffusion model on 8x-downsampled, 4-channel VAE latents:
    ``kind`` "dit" (patch, n_layers, d_model, n_heads, n_classes) or
    "unet" (ch, ch_mult, n_res_blocks, attn_levels, and the text
    context's ctx_dim and ctx_len). ``remat`` as ``VisionConfig``'s; the
    reference's ``scan_layers`` is left out: the port runs the layers in
    a loop."""

    name: str
    family: str = "diffusion"
    kind: str = "dit"  # 'dit' | 'unet'
    img_res: int = 256
    latent_factor: int = 8  # VAE downsample; latent_res = img_res // 8
    latent_ch: int = 4
    # dit
    patch: int = 2
    n_layers: int = 12
    d_model: int = 384
    n_heads: int = 6
    n_classes: int = 1000
    # unet
    ch: int = 320
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    n_res_blocks: int = 2
    attn_levels: Tuple[int, ...] = (0, 1, 2)  # levels (by downsample) with attention
    ctx_dim: int = 768
    ctx_len: int = 77
    param_dtype: str = "bfloat16"
    remat: str = "dots_saveable"

    @property
    def n_params(self) -> int:
        """The reference's count: DiT's dense weights and embeddings;
        for the UNet its own estimate from the channel schedule (457.6 M
        at full width, where the parameter tree holds 859.3 M)."""
        if self.kind == "dit":
            d = self.d_model
            emb = self.latent_ch * self.patch * self.patch * d
            blk = 4 * d * d + 2 * d * 4 * d + 6 * d * d  # attn + mlp + adaLN
            out = d * self.patch * self.patch * self.latent_ch * 2
            return emb + self.n_layers * blk + out + 256 * d + self.n_classes * d
        total = 0
        ch = self.ch
        chans = [ch * m for m in self.ch_mult]
        prev = ch
        for lvl, c in enumerate(chans):
            for _ in range(self.n_res_blocks):
                total += 3 * 3 * prev * c + 3 * 3 * c * c + 4 * ch * c
                if lvl in self.attn_levels:
                    total += 4 * c * c + 2 * c * self.ctx_dim + 8 * c * c
                prev = c
            if lvl + 1 < len(chans):
                total += 3 * 3 * c * c
        total *= 2  # down + up paths (approx.)
        total += 2 * (3 * 3 * chans[-1] * chans[-1])  # mid block
        return total + 3 * 3 * self.latent_ch * ch * 2


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode' | 'gen' | 'cls' | 'serve'
    seq_len: int = 0
    global_batch: int = 0
    img_res: int = 0
    steps: int = 0


LM_SHAPES = (
    ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
    ShapeSpec("long_500k", "decode", seq_len=524288, global_batch=1),
)

DIFFUSION_SHAPES = (
    ShapeSpec("train_256", "train", img_res=256, global_batch=256, steps=1000),
    ShapeSpec("gen_1024", "gen", img_res=1024, global_batch=4, steps=50),
    ShapeSpec("gen_fast", "gen", img_res=512, global_batch=16, steps=4),
    ShapeSpec("train_1024", "train", img_res=1024, global_batch=32, steps=1000),
)

VISION_SHAPES = (
    ShapeSpec("cls_224", "cls", img_res=224, global_batch=256),
    ShapeSpec("cls_384", "cls", img_res=384, global_batch=64),
    ShapeSpec("serve_b1", "serve", img_res=224, global_batch=1),
    ShapeSpec("serve_b128", "serve", img_res=224, global_batch=128),
)

DETECTOR_SHAPES = (
    ShapeSpec("tiles_416_b256", "serve", img_res=416, global_batch=256),
    ShapeSpec("train_416_b64", "train", img_res=416, global_batch=64),
)

FAMILY_SHAPES = {
    "lm": LM_SHAPES,
    "diffusion": DIFFUSION_SHAPES,
    "vision": VISION_SHAPES,
    "detector": DETECTOR_SHAPES,
}

_ARCH_MODULES = {
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3p8b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2p7b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "dit-s2": "repro_torch.configs.dit_s2",
    "unet-sd15": "repro_torch.configs.unet_sd15",
    "convnext-b": "repro_torch.configs.convnext_b",
    "vit-l16": "repro_torch.configs.vit_l16",
    "vit-h14": "repro_torch.configs.vit_h14",
    "resnet-152": "repro_torch.configs.resnet_152",
    "targetfuse-space": "repro_torch.configs.targetfuse_space",
    "targetfuse-ground": "repro_torch.configs.targetfuse_ground",
    "ssd-mobilenetv2": "repro_torch.configs.ssd_mobilenetv2",
}

# the model zoo's archs; the paper's own counters are not assigned
ASSIGNED_ARCHS = tuple(k for k in _ARCH_MODULES if not k.startswith(("targetfuse", "ssd")))


def list_archs():
    return tuple(_ARCH_MODULES)


def get_config(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_shapes(arch: str) -> Tuple[ShapeSpec, ...]:
    return FAMILY_SHAPES[get_config(arch).family]


def get_shape(arch: str, shape_name: str) -> ShapeSpec:
    for s in get_shapes(arch):
        if s.name == shape_name:
            return s
    raise KeyError(f"{arch}: unknown shape {shape_name!r}")


def all_cells():
    """Every assigned (arch, shape) cell: the 40-cell matrix."""
    return [(arch, s.name) for arch in ASSIGNED_ARCHS for s in get_shapes(arch)]


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def reduced(cfg):
    """Shrink a config to something a CPU test can run. An LM: 2 layers,
    d_model 64, 4 heads (at most 2 kv heads) of 16, d_ff 128, vocab 256,
    float32; an MoE at most 8 routed experts (2 shared, top-2) of 64,
    unpadded, with ``capacity_factor = 8.0`` (``n_routed``: provably
    drop-free, so prefill and decode match the full forward); MLA at
    rank 32 with heads of 16 + 8 (value 16). A vision model: 32-px input,
    10 classes, float32; ViT 2 layers of d_model 32 (2 heads, d_ff 64) on
    8-px patches, ConvNeXt one block a stage at dims 8-16-24-32, ResNet
    one bottleneck a stage at width 8. LMs, vision and diffusion models
    get ``remat="none"``, as the reference's. A diffusion model, float32: DiT 2
    layers of d_model 32 (2 heads) at 32 px, 10 classes; the UNet at 64
    px, ch 16, two levels (1, 2) of one res block, attention at level 1
    only, a context of 8 x 32. A counter: the first three stages
    at half width (floor 8), 64-px input; the ground tier stays wider
    than the space tier."""
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
            d_ff=128, vocab_size=256, moe=moe, mla=mla, param_dtype="float32",
            remat="none")
    if isinstance(cfg, VisionConfig):
        small = dict(name=cfg.name + "-smoke", img_res=32, n_classes=10, param_dtype="float32",
                     remat="none")
        if cfg.kind == "vit":
            return replace(cfg, patch=8, n_layers=2, d_model=32, n_heads=2, d_ff=64, **small)
        if cfg.kind == "convnext":
            return replace(cfg, depths=(1, 1, 1, 1), dims=(8, 16, 24, 32), **small)
        return replace(cfg, depths=(1, 1, 1, 1), width=8, **small)
    if isinstance(cfg, DiffusionConfig):
        if cfg.kind == "dit":
            return replace(cfg, name=cfg.name + "-smoke", img_res=32, n_layers=2, d_model=32,
                           n_heads=2, n_classes=10, param_dtype="float32", remat="none")
        return replace(cfg, name=cfg.name + "-smoke", img_res=64, ch=16, ch_mult=(1, 2),
                       n_res_blocks=1, attn_levels=(1,), ctx_dim=32, ctx_len=8,
                       param_dtype="float32", remat="none")
    if not isinstance(cfg, DetectorConfig):
        raise TypeError(type(cfg))
    w = tuple(max(8, x // 2) for x in cfg.widths[:3])
    return replace(cfg, name=cfg.name + "-smoke", input_size=64,
                   widths=w, param_dtype="float32")
