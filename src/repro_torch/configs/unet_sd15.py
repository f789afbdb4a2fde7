"""unet-sd15 [diffusion] — img_res=512 latent_res=64 ch=320
ch_mult=1-2-4-4 n_res_blocks=2 attn at the first three levels
ctx_dim=768 [arXiv:2112.10752; paper]."""
from repro_torch.configs.base import DiffusionConfig

CONFIG = DiffusionConfig(
    name="unet-sd15",
    kind="unet",
    img_res=512,
    ch=320,
    ch_mult=(1, 2, 4, 4),
    n_res_blocks=2,
    attn_levels=(0, 1, 2),
    ctx_dim=768,
    ctx_len=77,
)
