"""Conditional DDPM over FDN-UNet, the port of fea_tpu/models/diffusion.py:
schedules, q_sample, the training loss and the ancestral / strided sampler.

The schedules are computed in float64 and cast once to float32. The
sampler is a Python loop over the time steps; its per-step scalars are
float32, as in fea_tpu.

With `self_condition` the model also takes an estimate of x0 (Chen, Zhang
& Hinton 2022, as lucidrains' GaussianDiffusion(self_condition=True)
feeds it): the sampler hands each step the last step's clamped x0, and
zeros at the first; the loss, on one coin a batch, first estimates x0
with a forward under no_grad and hands it on detached. fea_tpu stores the
setting and reads it nowhere.
"""

from typing import Optional

import numpy as np
import torch

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


class GaussianDiffusion:
    """DDPM over (H, W, 2) displacement images with FDN conditioning. The
    condition stack is [forces(2), constraints(1), materials(2)]; the model
    predicts noise ('pred_noise') or the clean image ('pred_x0').

    `self_cond_fed` and `self_cond_zero` count, process-wide, the
    self-conditioned model's forwards that were handed an estimate of x0
    and those that were handed zeros (or None, which the model turns into
    zeros)."""

    self_cond_fed = 0
    self_cond_zero = 0

    def __init__(
        self,
        model: FDNUNet,
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

        With self_condition, a coin uniform over [0, 1), drawn from
        `generator` after t and the noise unless given (the host waits on
        a generator of the card's; DiffusionTrainer draws it on the host):
        under 0.5 a forward under no_grad estimates x0 (unclamped, as
        lucidrains' model_predictions gives it to its loss) and the graded
        forward takes it detached; else the graded forward takes zeros."""
        if generator is None and (t is None or noise is None):
            raise ValueError("loss needs a generator or both t and the noise")
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
            if coin is None:
                if generator is None:
                    raise ValueError("a self-conditioned loss needs a generator or the coin")
                coin = float(torch.rand((), generator=generator, device=x0.device))
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
        replays one graph."""
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
