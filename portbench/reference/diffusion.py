"""The DDPM's schedule and the strided ancestral sampler's update, in plain
PyTorch and NumPy: the benchmark's reference for fea-diffusion's
GaussianDiffusion (cosine schedule, 'pred_noise').

The schedule is computed in float64 and kept as float32 scalars, as the
published sampler does; one step's update is

    mean = (x - beta_t / sqrt(1 - alphabar_t) * eps) / sqrt(alpha_t)
    x'   = mean + sqrt(posterior_var_t) * z

and the last step (t = 0) returns clamp((x - sqrt(1 - alphabar_0) eps) /
sqrt(alphabar_0), -1, 1).
"""

import numpy as np
import torch


def cosine_betas(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = np.arange(timesteps + 1) / timesteps
    alphas_bar = np.cos((steps + s) / (1 + s) * np.pi / 2) ** 2
    alphas_bar = alphas_bar / alphas_bar[0]
    return np.clip(1.0 - alphas_bar[1:] / alphas_bar[:-1], 0.0, 0.999)


def sample_timesteps(timesteps: int, steps: int) -> list:
    """T-1 down to 0 in `steps` points, rounded half to even."""
    return [int(t) for t in np.round(np.linspace(timesteps - 1, 0, steps))]


class Schedule:
    def __init__(self, timesteps: int):
        betas = cosine_betas(timesteps)
        alphas = 1.0 - betas
        alphas_bar = np.cumprod(alphas)
        prev = np.concatenate([np.ones(1), alphas_bar[:-1]])
        self.timesteps = timesteps
        self.betas = betas.astype(np.float32)
        self.alphas = alphas.astype(np.float32)
        self.alphas_bar = alphas_bar.astype(np.float32)
        self.sqrt_ab = np.sqrt(alphas_bar).astype(np.float32)
        self.sqrt_1mab = np.sqrt(1.0 - alphas_bar).astype(np.float32)
        self.posterior_var = (betas * (1.0 - prev) / (1.0 - alphas_bar)).astype(np.float32)


def update(schedule: Schedule, t: int, x: torch.Tensor, eps: torch.Tensor,
           z: torch.Tensor = None) -> torch.Tensor:
    """One step of the sampler from x at time t with the predicted noise
    eps; z is the step's fresh noise (unused at t = 0). Computed in x's
    dtype."""
    if t == 0:
        a = float(max(schedule.sqrt_ab[0], np.float32(1e-8)))
        return ((x - float(schedule.sqrt_1mab[0]) * eps) / a).clamp(-1.0, 1.0)
    beta, alpha, ab = schedule.betas[t], schedule.alphas[t], schedule.alphas_bar[t]
    coef = float(beta / np.sqrt(np.float32(1.0) - ab))
    mean = (x - coef * eps) / float(np.sqrt(alpha))
    return mean + float(np.sqrt(schedule.posterior_var[t])) * z
