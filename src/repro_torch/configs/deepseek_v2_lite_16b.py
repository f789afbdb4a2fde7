"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408
vocab=102400, MLA kv_lora=512, MoE 64 routed + 2 shared top-6
[arXiv:2405.04434; hf]. 64 routed experts, as the published
DeepSeek-V2-Lite and the reference; layer 0 has a dense FFN of width
d_ff 10944."""
from repro_torch.configs.base import LMConfig, MLASpec, MoESpec

CONFIG = LMConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,
    vocab_size=102400,
    rope_theta=10000.0,
    moe=MoESpec(n_routed=64, n_shared=2, top_k=6, d_expert=1408,
                first_dense_layers=1),
    mla=MLASpec(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                v_head_dim=128),
)
