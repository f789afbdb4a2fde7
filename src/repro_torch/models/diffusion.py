"""Diffusion sampling and training of the port, shared by DiT and the
UNet: the cosine noise schedule, ``add_noise``, the eps-prediction
``train_loss`` and the deterministic DDIM sampler.

Counterpart of ``repro/models/diffusion.py``. The schedule is the
reference's float32 table bit for bit: XLA's CPU ``cos`` is glibc's
``cosf``, which ``torch.cos`` differs from in the last bit of 52 of its
1000 entries, so the port takes glibc's (``orbits.propagation.cosf``).
The timestep table is ``jnp.linspace(999, 0, n + 1).astype(int32)``
with JAX's float32 formula as XLA compiles it (for n_steps 3, 6, 9, 12
and 30 its second entry is 665, where ``torch.linspace`` gives 666).

The sampler runs on the host as a loop of ``ddim_step`` (one forward a
step), where the reference scans: the timesteps and the schedule's
coefficients are host floats, each the reference's float32 value, so a
step never syncs with the card. ``sample`` takes its starting noise from
the caller, who draws it with an explicit ``torch.Generator`` (the
tests pass the reference's own array). ``train_loss`` takes its
timesteps and noise from the caller too, where the reference draws them
from a JAX key inside: ``draw_train_inputs`` draws them from an explicit
generator (the tests derive the key's own).
"""
from __future__ import annotations

import functools
import math
from typing import Callable

import torch

from repro_torch.orbits.propagation import cosf

N_TRAIN_STEPS = 1000


@functools.lru_cache(maxsize=None)
def _alphas_cumprod_cpu(n: int) -> torch.Tensor:
    t = torch.arange(n + 1, dtype=torch.float32) / n
    f = cosf((t + 0.008) / 1.008 * math.pi / 2) ** 2
    return torch.clamp(f / f[0], 1e-5, 1.0)[1:]


def alphas_cumprod(n: int = N_TRAIN_STEPS, device="cpu") -> torch.Tensor:
    """(n,) float32: cos((t + 0.008) / 1.008 * pi / 2)^2 over t = i / n,
    divided by its value at t = 0, clipped to [1e-5, 1], without t = 0.
    Computed once on the CPU."""
    return _alphas_cumprod_cpu(n).to(device)


def timesteps(n_steps: int) -> list:
    """The DDIM table, ``n_steps + 1`` ints from 999 down to 0: JAX's
    ``linspace(999, 0, n_steps + 1)`` in float32, start * (1 - s) + stop
    * s with s = i * float32(1 / n) (XLA multiplies by the divisor's
    reciprocal) and the endpoint appended, truncated to int32."""
    step = torch.arange(n_steps, dtype=torch.float32) * torch.tensor(1.0 / n_steps)
    out = (N_TRAIN_STEPS - 1) * (1 - step) + 0.0 * step
    return [int(v) for v in out.to(torch.int32)] + [0]


def add_noise(latents: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0): sqrt(a_t) * latents + sqrt(1 - a_t) * noise, t (B,)
    int in [0, N)."""
    a = alphas_cumprod(device=latents.device)[t][:, None, None, None]
    return torch.sqrt(a) * latents + torch.sqrt(1 - a) * noise


def draw_train_inputs(latents: torch.Tensor, gen: torch.Generator):
    """A training step's draws, from ``gen`` on the latents' device ->
    (t (B,) int32 uniform in [0, N_TRAIN_STEPS), noise float32 standard
    normal of the latents' shape)."""
    t = torch.randint(0, N_TRAIN_STEPS, (latents.shape[0],), generator=gen,
                      device=latents.device, dtype=torch.int32)
    noise = torch.randn(latents.shape, generator=gen, device=latents.device,
                        dtype=torch.float32)
    return t, noise


def train_loss(eps_fn: Callable, latents: torch.Tensor, t: torch.Tensor,
               noise: torch.Tensor) -> torch.Tensor:
    """The eps-prediction loss of ``repro/models/diffusion.py``'s
    ``train_loss`` on the caller's ``t`` and ``noise``: x_t =
    ``add_noise`` of the latents in float32, eps = eps_fn(x_t, t), then
    mean((eps - noise)^2), a 0-d float32 tensor."""
    x_t = add_noise(latents.float(), noise, t)
    return torch.mean(torch.square(eps_fn(x_t, t) - noise))


@functools.lru_cache(maxsize=None)
def coef_table(n: int = N_TRAIN_STEPS) -> tuple:
    """(sqrt(a_t), sqrt(1 - a_t)) for t in [0, n), float32 on the CPU, as
    host floats: read on the host with no tensor op (a dry run's fake
    tensors hold no values)."""
    a = _alphas_cumprod_cpu(n)
    return tuple(zip(torch.sqrt(a).tolist(), torch.sqrt(1 - a).tolist()))


def _coefs(t: int):
    """(sqrt(a_t), sqrt(1 - a_t)) in float32, as host floats; a_t = 1
    for t < 0."""
    return coef_table()[t] if t >= 0 else (1.0, 0.0)


def ddim_step(eps_fn: Callable, x: torch.Tensor, t_cur: int, t_prev: int) -> torch.Tensor:
    """One deterministic DDIM update of ``x`` (float32) from timestep
    ``t_cur`` to ``t_prev`` (host ints): eps = eps_fn(x, t (B,) int32),
    x0 = (x - sqrt(1 - a_cur) eps) / sqrt(a_cur), then sqrt(a_prev) x0 +
    sqrt(1 - a_prev) eps."""
    s_cur, n_cur = _coefs(t_cur)
    s_prev, n_prev = _coefs(t_prev)
    eps = eps_fn(x, torch.full((x.shape[0],), t_cur, dtype=torch.int32, device=x.device))
    x0 = (x - n_cur * eps) / s_cur
    return s_prev * x0 + n_prev * eps


def sample(eps_fn: Callable, noise: torch.Tensor, n_steps: int) -> torch.Tensor:
    """The DDIM sampler from ``noise`` (B, Hl, Wl, C) float32: ``n_steps``
    forwards along ``timesteps(n_steps)``."""
    ts = timesteps(n_steps)
    x = noise
    for i in range(n_steps):
        x = ddim_step(eps_fn, x, ts[i], ts[i + 1])
    return x
