"""convnext-b [vision] — img_res=224 depths=3-3-27-3 dims=128-256-512-1024
[arXiv:2201.03545; paper]."""
from repro_torch.configs.base import VisionConfig

CONFIG = VisionConfig(
    name="convnext-b",
    kind="convnext",
    img_res=224,
    depths=(3, 3, 27, 3),
    dims=(128, 256, 512, 1024),
)
