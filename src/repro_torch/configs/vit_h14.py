"""vit-h14 [vision] — img_res=224 patch=14 n_layers=32 d_model=1280
n_heads=16 d_ff=5120 [arXiv:2010.11929; paper]."""
from repro_torch.configs.base import VisionConfig

CONFIG = VisionConfig(
    name="vit-h14",
    kind="vit",
    img_res=224,
    patch=14,
    n_layers=32,
    d_model=1280,
    n_heads=16,
    d_ff=5120,
)
