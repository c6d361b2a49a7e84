"""Conditional DDPM over FDN-UNet, the port of fea_tpu/models/diffusion.py:
schedules, q_sample, the training loss and the ancestral / strided sampler.

The schedules are computed in float64 and cast once to float32. The
sampler is a Python loop over the time steps; its per-step scalars are
float32, as in fea_tpu.

With `self_condition` the model also takes an estimate of x0 (Chen, Zhang
& Hinton 2022, as lucidrains' GaussianDiffusion(self_condition=True)
feeds it): the sampler hands each step the last step's clamped x0, and
zeros at the first; the loss, on a coin its caller draws once a batch,
first estimates x0 with a forward under no_grad and hands it on detached. fea_tpu stores the
setting and reads it nowhere.

A model with `learned_range` (the ADM UNet, `models/adm.py`) returns the
noise estimate and a variance interpolant v for each channel, and samples
as openai/guided-diffusion's SpacedDiffusion does with LEARNED_RANGE and
clip_denoised: the steps kept by `space_timesteps(timesteps, steps)`,
betas recomputed over them, the model fed the original t, the posterior
mean taken from the clamped x0, and log var = (v+1)/2 log beta_t +
(1 - (v+1)/2) log(clipped posterior var_t). Its loss (guided-diffusion's
hybrid L_simple + lambda L_vlb) is not supported.
"""

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..utils.precision import model_precision
from ..utils.profiling import request_span, span
from . import graphed
from .fdnunet import FDNUNet
from .initializers import materialize


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    scale = 1000.0 / timesteps
    return np.linspace(scale * 1e-4, scale * 0.02, timesteps)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = np.arange(timesteps + 1) / timesteps
    alphas_bar = np.cos((steps + s) / (1 + s) * np.pi / 2) ** 2
    alphas_bar = alphas_bar / alphas_bar[0]
    betas = 1.0 - alphas_bar[1:] / alphas_bar[:-1]
    return np.clip(betas, 0.0, 0.999)


BETA_SCHEDULES = {"cosine": cosine_beta_schedule, "linear": linear_beta_schedule}


def sample_timesteps(timesteps: int, steps: int) -> list:
    """The sampler's time steps, T-1 down to 0, rounded half to even as
    jnp.round does."""
    return [int(t) for t in np.round(np.linspace(timesteps - 1, 0, steps))]


def space_timesteps(num_timesteps: int, steps: int) -> list:
    """guided-diffusion's respace.space_timesteps(num_timesteps, str(steps)),
    one section: the time steps kept, sorted, `steps` of them spread evenly
    over the process, rounded as Python's round does."""
    if steps > num_timesteps:
        raise ValueError(f"cannot divide {num_timesteps} steps into {steps}")
    stride = 1 if steps <= 1 else (num_timesteps - 1) / (steps - 1)
    kept, cur = set(), 0.0
    for _ in range(steps):
        kept.add(round(cur))
        cur += stride
    return sorted(kept)


def respaced_schedule(alphas_bar: np.ndarray, kept: Sequence[int]) -> dict:
    """The learned-range sampler's per-step scalars over the time steps
    `kept` (guided-diffusion's SpacedDiffusion): betas recomputed as
    1 - alphabar_{t_i} / alphabar_{t_{i-1}}, then its GaussianDiffusion's
    quantities of them, in f64; "timestep_map" is the original t of each
    respaced step."""
    kept = sorted(kept)
    ab_kept = alphas_bar[kept]
    betas = 1.0 - ab_kept / np.concatenate([np.ones(1), ab_kept[:-1]])
    ab = np.cumprod(1.0 - betas)
    prev = np.concatenate([np.ones(1), ab[:-1]])
    posterior_var = betas * (1.0 - prev) / (1.0 - ab)
    return {
        "timestep_map": list(kept),
        "sqrt_recip_ab": np.sqrt(1.0 / ab),
        "sqrt_recipm1_ab": np.sqrt(1.0 / ab - 1.0),
        "coef1": betas * np.sqrt(prev) / (1.0 - ab),
        "coef2": (1.0 - prev) * np.sqrt(1.0 - betas) / (1.0 - ab),
        "log_betas": np.log(betas),
        "log_var_clipped": np.log(np.concatenate([posterior_var[1:2], posterior_var[1:]])),
    }


class GaussianDiffusion:
    """DDPM over (H, W, 2) displacement images, conditioned on the stack
    [forces(2), constraints(1), materials(2)]: an FDNUNet, whose model
    predicts noise ('pred_noise') or the clean image ('pred_x0'), or an
    ADMUNet with its learned-range variance.

    `self_cond_fed` and `self_cond_zero` count, process-wide, the
    self-conditioned model's forwards that were handed an estimate of x0
    and those that were handed zeros (or None, which the model turns into
    zeros). For a `learned_range` model (module docstring)
    `learned_range_steps` counts the steps whose update drew its variance
    from the model's output, and `final_steps` the last steps (t = 0),
    which add no noise."""

    self_cond_fed = 0
    self_cond_zero = 0
    learned_range_steps = 0
    final_steps = 0

    def __init__(
        self,
        model: nn.Module,
        timesteps: int = 1000,
        objective: str = "pred_noise",
        beta_schedule: str = "cosine",
        self_condition: bool = False,
    ):
        if objective not in ("pred_noise", "pred_x0"):
            raise ValueError(f"unknown objective {objective}")
        if beta_schedule not in BETA_SCHEDULES:
            raise ValueError(f"unknown beta schedule {beta_schedule}")
        if not model.use_time_embedding:
            raise ValueError("diffusion needs the time embedding")
        if self_condition and model.num_condition_channels is None:
            raise ValueError("self-conditioning needs a model built with num_condition_channels "
                             "(make_diffusion_model(self_condition=True))")
        self.learned_range = getattr(model, "learned_range", False)
        if self.learned_range and (objective != "pred_noise" or self_condition):
            raise ValueError("a learned-range model predicts the noise, without self-conditioning")
        self.model = model
        self.timesteps = timesteps
        self.objective = objective
        self.self_condition = self_condition

        betas = BETA_SCHEDULES[beta_schedule](timesteps)
        alphas = 1.0 - betas
        alphas_bar = np.cumprod(alphas)
        alphas_bar_prev = np.concatenate([np.ones((1,)), alphas_bar[:-1]])
        schedules = {
            "betas": betas,
            "alphas": alphas,
            "alphas_bar": alphas_bar,
            "sqrt_ab": np.sqrt(alphas_bar),
            "sqrt_1mab": np.sqrt(1.0 - alphas_bar),
            "posterior_var": betas * (1.0 - alphas_bar_prev) / (1.0 - alphas_bar),
        }
        device = next(model.parameters()).device
        # float32 on the host for the sampler's scalars, and on the device
        # for per-example indexing
        self.host = {k: v.astype(np.float32) for k, v in schedules.items()}
        for name, value in self.host.items():
            setattr(self, name, torch.from_numpy(value).to(device))
        self._alphas_bar = alphas_bar  # f64, for respacing
        self._respaced = {}  # learned-range steps -> their f32 host scalars
        # the sampler's forwards, one CUDA graph replay a step on the card
        self.graphs = graphed.GraphedForward()

    def q_sample(self, x0, t, noise):
        a = self.sqrt_ab[t][:, None, None, None]
        s = self.sqrt_1mab[t][:, None, None, None]
        return a * x0 + s * noise

    def _x0_from_noise(self, x_t, t, noise):
        a = self.sqrt_ab[t][:, None, None, None]
        s = self.sqrt_1mab[t][:, None, None, None]
        return (x_t - s * noise) / a.clamp_min(1e-8)

    def loss(
        self,
        x0: torch.Tensor,
        condition: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        t: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        coin: Optional[float] = None,
    ) -> torch.Tensor:
        """Mean-squared diffusion loss on a batch: NHWC x0 (B, H, W, 2) and
        condition (B, H, W, 5). The time steps t (B,) uniform over
        [0, timesteps) and the noise (x0's shape) are drawn from `generator`
        unless given. The target is the noise ('pred_noise') or x0.

        With self_condition the caller passes `coin`, uniform over [0, 1)
        (DiffusionTrainer draws it on the host; the loss draws none, so the
        host never waits on the card for it): under 0.5 a forward under
        no_grad estimates x0 (unclamped, as lucidrains' model_predictions
        gives it to its loss) and the graded forward takes it detached;
        else the graded forward takes zeros."""
        if self.learned_range:
            raise NotImplementedError(
                "a learned-range model trains on guided-diffusion's hybrid loss "
                "(L_simple + lambda L_vlb), which is not supported")
        if generator is None and (t is None or noise is None):
            raise ValueError("loss needs a generator or both t and the noise")
        if self.self_condition and coin is None:
            raise ValueError("a self-conditioned loss takes the coin (coin=)")
        b = x0.shape[0]
        if t is None:
            t = torch.randint(
                0, self.timesteps, (b,), generator=generator, device=x0.device
            )
        if noise is None:
            noise = torch.randn(
                x0.shape, generator=generator, device=x0.device, dtype=x0.dtype
            )
        x_t = self.q_sample(x0, t, noise)
        if not self.self_condition:
            pred = self.model(x_t, condition, time=t.float())
        else:
            x_self = None
            if coin < 0.5:
                with torch.no_grad(), span("train.self_cond"):
                    estimate = self.model(x_t, condition, time=t.float())
                    if self.objective == "pred_noise":
                        estimate = self._x0_from_noise(x_t, t, estimate)
                    x_self = estimate.detach()
                GaussianDiffusion.self_cond_zero += 1  # the estimate's own forward
            pred = self.model(x_t, condition, x_self_condition=x_self, time=t.float())
            if x_self is None:
                GaussianDiffusion.self_cond_zero += 1
            else:
                GaussianDiffusion.self_cond_fed += 1
        target = noise if self.objective == "pred_noise" else x0
        return torch.mean((pred - target) ** 2)

    @torch.no_grad()
    @model_precision()
    def sample(
        self,
        condition: torch.Tensor,
        num_steps: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Ancestral DDPM sampling, strided when num_steps < timesteps.
        condition is NHWC (B, H, W, 5). The random draws come from
        `generator`, one image at a time as the loop needs it, or from
        `noise` of shape (steps + 1, B, H, W, 2): noise[0] is the initial
        image and noise[i + 1] step i's noise. On the card each step's
        model forward is replayed from a CUDA graph (`graphed`), captured
        at the first call at a shape; the update stays eager. With
        self_condition step 0's model takes a zeros tensor made once a
        call and step i > 0 step i - 1's clamped x0, so that every step
        replays one graph. A learned-range model samples over the respaced
        steps (module docstring)."""
        b, h, w, _ = condition.shape
        shape = (b, h, w, 2)
        steps = num_steps or self.timesteps
        if noise is not None:
            if noise.shape != (steps + 1,) + shape:
                raise ValueError(f"noise {tuple(noise.shape)} is not {(steps + 1,) + shape}")

            def draw(i):
                return noise[i]
        elif generator is not None:

            def draw(_):
                return torch.randn(
                    shape, generator=generator,
                    device=condition.device, dtype=condition.dtype,
                )
        else:
            raise ValueError("sample needs a generator or the noise")

        f32 = np.float32
        with request_span("sample.request") as request, graphed.scope(self.graphs):
            x = draw(0)
            if self.learned_range:
                return self._sample_learned_range(x, condition, steps, draw, request.request)
            x_self = torch.zeros_like(x) if self.self_condition else None
            for i, t in enumerate(sample_timesteps(self.timesteps, steps)):
                with span("sample.step", step=i, request=request.request):
                    tb = torch.full((b,), t, device=condition.device)
                    if x_self is None:
                        pred = self.model(x, condition, time=tb.float())
                    else:
                        pred = self.model(x, condition, x_self_condition=x_self,
                                          time=tb.float())
                        if i:
                            GaussianDiffusion.self_cond_fed += 1
                        else:
                            GaussianDiffusion.self_cond_zero += 1
                    if self.objective == "pred_noise":
                        noise_pred = pred
                        x0 = self._x0_from_noise(x, tb, pred)
                    else:
                        x0 = pred
                        a = self.sqrt_ab[tb][:, None, None, None]
                        s = self.sqrt_1mab[tb][:, None, None, None]
                        noise_pred = (x - a * x0) / s.clamp_min(1e-8)
                    x0 = x0.clamp(-1.0, 1.0)
                    if x_self is not None:
                        x_self = x0
                    if t == 0:
                        x = x0
                        continue
                    beta, alpha, ab, var = (
                        self.host[k][t] for k in ("betas", "alphas", "alphas_bar", "posterior_var")
                    )
                    coef = float(beta / np.sqrt(f32(1.0) - ab))
                    mean = (x - coef * noise_pred) / float(np.sqrt(alpha))
                    x = mean + float(np.sqrt(var)) * draw(i + 1)
            return x

    def respaced(self, steps: int) -> dict:
        """The learned-range sampler's schedule over `steps` respaced steps
        (`respaced_schedule`), its scalars as f32 on the host."""
        if steps not in self._respaced:
            kept = space_timesteps(self.timesteps, steps)
            schedule = respaced_schedule(self._alphas_bar, kept)
            self._respaced[steps] = {
                k: v if k == "timestep_map" else v.astype(np.float32)
                for k, v in schedule.items()}
        return self._respaced[steps]

    def _sample_learned_range(self, x, condition, steps, draw, request):
        """The respaced learned-range loop from the initial image x, step
        i's fresh noise draw(i + 1)."""
        b, c = x.shape[0], x.shape[-1]
        s = self.respaced(steps)
        for step, i in enumerate(reversed(range(steps))):
            with span("sample.step", step=step, request=request):
                tb = torch.full((b,), s["timestep_map"][i], device=condition.device)
                out = self.model(x, condition, time=tb.float())
                eps, v = out[..., :c], out[..., c:]
                x0 = (float(s["sqrt_recip_ab"][i]) * x
                      - float(s["sqrt_recipm1_ab"][i]) * eps).clamp(-1.0, 1.0)
                mean = float(s["coef1"][i]) * x0 + float(s["coef2"][i]) * x
                if i == 0:
                    GaussianDiffusion.final_steps += 1
                    x = mean
                    continue
                frac = (v + 1.0) / 2.0
                log_var = (frac * float(s["log_betas"][i])
                           + (1.0 - frac) * float(s["log_var_clipped"][i]))
                x = mean + torch.exp(0.5 * log_var) * draw(step + 1)
                GaussianDiffusion.learned_range_steps += 1
        return x


def make_diffusion_model(
    image_size: int = 256,
    input_dim: int = 64,
    num_stages: int = 4,
    timesteps: int = 1000,
    objective: str = "pred_noise",
    *,
    device,
    generator: torch.Generator,
    self_condition: bool = False,
    **kw,
) -> GaussianDiffusion:
    """GaussianDiffusion over an FDNUNet with the time embedding and the
    5-channel condition stack, on `device`, weights drawn from
    `generator`; with self_condition the model takes the x0 estimate too
    (num_condition_channels=2) and the diffusion feeds it. `**kw` (e.g.
    use_flash_attention, use_full_attention) goes to FDNUNet."""
    with torch.device("meta"):
        model = FDNUNet(
            input_dim=input_dim,
            num_stages=num_stages,
            num_channels=2,
            num_auxiliary_condition_channels=5,  # forces(2)+constraints(1)+materials(2)
            num_condition_channels=2 if self_condition else None,
            use_time_embedding=True,
            **kw,
        )
    materialize(model, device, generator)
    return GaussianDiffusion(model, timesteps=timesteps, objective=objective,
                             self_condition=self_condition)
