"""vit-l16 [vision] — img_res=224 patch=16 n_layers=24 d_model=1024
n_heads=16 d_ff=4096 [arXiv:2010.11929; paper]."""
from repro_torch.configs.base import VisionConfig

CONFIG = VisionConfig(
    name="vit-l16",
    kind="vit",
    img_res=224,
    patch=16,
    n_layers=24,
    d_model=1024,
    n_heads=16,
    d_ff=4096,
)
