"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60e top-4 — 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]. The 60 routed experts are padded to 64,
as the reference pads them."""
from repro_torch.configs.base import LMConfig, MoESpec

CONFIG = LMConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    rope_theta=1000000.0,
    moe=MoESpec(n_routed=60, n_shared=4, top_k=4, d_expert=1408,
                pad_experts_to=64),
)
