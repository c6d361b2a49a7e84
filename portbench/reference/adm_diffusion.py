"""The learned-range sampler over a respaced schedule, in plain PyTorch and
NumPy: the benchmark's reference for openai/guided-diffusion's
`gaussian_diffusion.py` (ModelVarType.LEARNED_RANGE, clip_denoised=True)
under `respace.py`'s SpacedDiffusion, with the linear beta schedule.

The schedule is computed in float64 and each step's scalars taken as
float32, as guided-diffusion's `_extract_into_tensor` takes them. One step
from x at respaced index i, the model's output split into eps and v:

    x0     = clamp(sqrt(1/abar_i) x - sqrt(1/abar_i - 1) eps, -1, 1)
    mean   = coef1_i x0 + coef2_i x
    logvar = (v+1)/2 log beta_i + (1 - (v+1)/2) log var_clipped_i
    x'     = mean + exp(logvar / 2) z        (x' = mean at i = 0)
"""

import numpy as np
import torch


def linear_betas(timesteps: int) -> np.ndarray:
    scale = 1000 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps, dtype=np.float64)


def space_timesteps(num_timesteps, section_counts):
    """respace.space_timesteps, as guided-diffusion writes it (without the
    "ddimN" form): the set of time steps kept."""
    if isinstance(section_counts, str):
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        if section_count <= 1:
            frac_stride = 1
        else:
            frac_stride = (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken_steps = []
        for _ in range(section_count):
            taken_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken_steps
        start_idx += size
    return set(all_steps)


class Schedule:
    """SpacedDiffusion over `steps` of `timesteps` linear-schedule steps."""

    def __init__(self, timesteps: int, steps: int):
        base = np.cumprod(1.0 - linear_betas(timesteps))
        use = space_timesteps(timesteps, str(steps))
        last, betas, self.timestep_map = 1.0, [], []
        for i, alpha_cumprod in enumerate(base):
            if i in use:
                betas.append(1 - alpha_cumprod / last)
                last = alpha_cumprod
                self.timestep_map.append(i)
        betas = np.array(betas, dtype=np.float64)
        alphas = 1.0 - betas
        ab = np.cumprod(alphas, axis=0)
        ab_prev = np.append(1.0, ab[:-1])
        posterior_variance = betas * (1.0 - ab_prev) / (1.0 - ab)
        f32 = np.float32
        self.steps = steps
        self.sqrt_recip_ab = np.sqrt(1.0 / ab).astype(f32)
        self.sqrt_recipm1_ab = np.sqrt(1.0 / ab - 1).astype(f32)
        self.coef1 = (betas * np.sqrt(ab_prev) / (1.0 - ab)).astype(f32)
        self.coef2 = ((1.0 - ab_prev) * np.sqrt(alphas) / (1.0 - ab)).astype(f32)
        self.max_log = np.log(betas).astype(f32)
        self.min_log = np.log(np.append(posterior_variance[1],
                                        posterior_variance[1:])).astype(f32)

    def order(self):
        """(step, respaced index, original t) from the first step to the
        last."""
        return [(s, i, self.timestep_map[i]) for s, i in enumerate(reversed(range(self.steps)))]


def update(schedule: Schedule, i: int, x: torch.Tensor, out: torch.Tensor,
           z: torch.Tensor = None) -> torch.Tensor:
    """One step from x (NHWC, C channels) at respaced index i, the model's
    output `out` (NHWC, 2C: eps then v); z is the step's fresh noise
    (unused at i = 0). Computed in x's dtype."""
    c = x.shape[-1]
    eps, v = out[..., :c], out[..., c:]
    x0 = (float(schedule.sqrt_recip_ab[i]) * x
          - float(schedule.sqrt_recipm1_ab[i]) * eps).clamp(-1.0, 1.0)
    mean = float(schedule.coef1[i]) * x0 + float(schedule.coef2[i]) * x
    if i == 0:
        return mean
    frac = (v + 1.0) / 2.0
    log_var = frac * float(schedule.max_log[i]) + (1.0 - frac) * float(schedule.min_log[i])
    return mean + torch.exp(0.5 * log_var) * z
