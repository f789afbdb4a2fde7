"""dit-s2 [diffusion] — img_res=256 patch=2 n_layers=12 d_model=384
n_heads=6 [arXiv:2212.09748; paper]. Operates on 8x-downsampled VAE
latents (latent stub), 4 channels."""
from repro_torch.configs.base import DiffusionConfig

CONFIG = DiffusionConfig(
    name="dit-s2",
    kind="dit",
    img_res=256,
    patch=2,
    n_layers=12,
    d_model=384,
    n_heads=6,
)
