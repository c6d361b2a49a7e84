"""The port's DDPM sampler (fea_tpu_torch.models.diffusion) against a
reference loop built from fea_tpu's model and schedules, fed the same noise:
the serving slice as a whole, FDNUNet with time embedding and flash
attention, at timesteps 8, 4 sampling steps and batch 2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fea_tpu.models import diffusion as jdiffusion
from fea_tpu_torch.models import diffusion
from fea_tpu_torch.models.convert import load_flax
from fea_tpu_torch.models.fdnunet import FDNUNet

torch.set_num_threads(1)

S, B, T, STEPS = 32, 2, 8, 4
MODEL_KW = dict(
    input_dim=16, num_stages=2, num_channels=2,
    num_auxiliary_condition_channels=5, use_time_embedding=True,
    use_flash_attention=True,
)


@pytest.fixture(scope="module")
def pair():
    """fea_tpu's GaussianDiffusion and the port's over the same params."""
    with jax.enable_x64(False):
        jd = jdiffusion.make_diffusion_model(
            image_size=S, input_dim=16, num_stages=2, timesteps=T,
            use_flash_attention=True,
        )
        params = jd.init(jax.random.PRNGKey(0), S, batch=B)["params"]
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    with torch.device("meta"):
        model = FDNUNet(**MODEL_KW)
    td = diffusion.GaussianDiffusion(load_flax(model, params, device="cpu").eval(), timesteps=T)
    return jd, params, td


@pytest.mark.parametrize("name", [
    "betas", "alphas", "alphas_bar", "sqrt_ab", "sqrt_1mab", "posterior_var",
])
def test_schedules(pair, name):
    """float64 schedules cast once to float32 against fea_tpu's: atol 1e-6."""
    jd, _, td = pair
    np.testing.assert_allclose(
        getattr(td, name).numpy(), np.asarray(getattr(jd, name)), atol=1e-6, rtol=0
    )


@pytest.mark.parametrize("name", ["betas", "alphas_bar", "posterior_var"])
def test_linear_schedules(pair, name):
    """beta_schedule="linear", the other schedule fea_tpu offers, at the
    shipped 1000 steps (it scales its betas by 1000 / timesteps, so at 8
    steps they pass 1): atol 1e-6."""
    jd, _, td = pair
    with jax.enable_x64(False):
        jd = jdiffusion.GaussianDiffusion(jd.model, timesteps=1000, beta_schedule="linear")
    td = diffusion.GaussianDiffusion(td.model, timesteps=1000, beta_schedule="linear")
    np.testing.assert_allclose(
        getattr(td, name).numpy(), np.asarray(getattr(jd, name)), atol=1e-6, rtol=0
    )


def test_unknown_beta_schedule_raises(pair):
    with pytest.raises(ValueError):
        diffusion.GaussianDiffusion(pair[2].model, timesteps=T, beta_schedule="sigmoid")


@pytest.mark.parametrize("timesteps,steps", [(8, 4), (8, 8), (1000, 25), (1000, 7)])
def test_sample_timesteps(timesteps, steps):
    """The strided time steps round half to even, as jnp.round does."""
    with jax.enable_x64(False):
        want = jnp.linspace(timesteps - 1, 0, steps).round().astype(jnp.int32)
    assert diffusion.sample_timesteps(timesteps, steps) == np.asarray(want).tolist()


def test_q_sample(pair):
    """x_t = sqrt_ab[t] x0 + sqrt_1mab[t] noise per example: atol 1e-6."""
    jd, _, td = pair
    rng = np.random.default_rng(1)
    x0, noise = (rng.normal(size=(3, 4, 4, 2)).astype(np.float32) for _ in range(2))
    t = np.array([0, 4, 7])
    with jax.enable_x64(False):
        want = jd.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    got = td.q_sample(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def reference_sample(jd, params, condition, noise):
    """fea_tpu's sampling loop (models/diffusion.py:115-148) with its noise
    taken from `noise` instead of jax.random: float32 schedules, jitted
    fea_tpu._predict."""
    sched = {
        k: np.asarray(getattr(jd, k), np.float32)
        for k in ("betas", "alphas", "alphas_bar", "sqrt_ab", "sqrt_1mab", "posterior_var")
    }
    with jax.enable_x64(False):
        predict = jax.jit(jd._predict)
        ts = jnp.linspace(T - 1, 0, STEPS).round().astype(jnp.int32)
        x = jnp.asarray(noise[0])
        for i, t in enumerate(np.asarray(ts).tolist()):
            tb = jnp.full((B,), t, jnp.float32)
            pred = predict(params, x, tb, jnp.asarray(condition))
            a, s = sched["sqrt_ab"][t], sched["sqrt_1mab"][t]
            if jd.objective == "pred_noise":
                noise_pred, x0 = pred, (x - s * pred) / max(a, 1e-8)
            else:
                noise_pred, x0 = (x - a * pred) / max(s, 1e-8), pred
            x0 = jnp.clip(x0, -1.0, 1.0)
            beta, alpha, ab = (sched[k][t] for k in ("betas", "alphas", "alphas_bar"))
            mean = (x - beta / np.sqrt(np.float32(1.0) - ab) * noise_pred) / np.sqrt(alpha)
            x_next = mean + np.sqrt(sched["posterior_var"][t]) * noise[i + 1]
            x = x_next if t > 0 else x0
        return np.asarray(x)


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0"])
def test_sample_matches_reference_loop(pair, objective):
    """Tolerance atol 5e-4: at t = T - 1 the cosine schedule clips beta to
    0.999, so the step divides by sqrt(alpha) = 0.032 and multiplies the
    model's float32 differences (~1e-6) by about 30; the largest difference
    seen was 7.5e-5 (pred_noise) and 3.5e-6 (pred_x0). With pred_noise most
    of the output is x0 clipped to +-1; with pred_x0 the output is the
    model's last prediction, mostly inside (-1, 1), which is what makes
    that case a strong check of the whole trajectory."""
    jd, params, td = pair
    jd = jdiffusion.GaussianDiffusion(jd.model, timesteps=T, objective=objective)
    td = diffusion.GaussianDiffusion(td.model, timesteps=T, objective=objective)
    rng = np.random.default_rng(0)
    condition = rng.normal(size=(B, S, S, 5)).astype(np.float32)
    noise = rng.normal(size=(STEPS + 1, B, S, S, 2)).astype(np.float32)

    want = reference_sample(jd, params, condition, noise)
    got = td.sample(torch.from_numpy(condition), STEPS, noise=torch.from_numpy(noise))
    assert got.shape == (B, S, S, 2)
    assert torch.isfinite(got).all()
    if objective == "pred_x0":
        assert (np.abs(want) < 1.0).mean() > 0.5
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)


def test_sample_needs_noise_or_generator(pair):
    _, _, td = pair
    with pytest.raises(ValueError):
        td.sample(torch.zeros(B, S, S, 5), STEPS)


def test_sample_draws_from_the_generator_step_by_step(pair):
    """With a generator, sample draws the initial image and then one step's
    noise at a time (none at t = 0), so its output equals sample(noise=...)
    fed the same draws in that order: exact equality."""
    _, _, td = pair
    condition = torch.from_numpy(
        np.random.default_rng(2).normal(size=(B, S, S, 5)).astype(np.float32)
    )
    got = td.sample(condition, STEPS, generator=torch.Generator().manual_seed(3))
    generator = torch.Generator().manual_seed(3)
    draws = [torch.randn((B, S, S, 2), generator=generator) for _ in range(STEPS)]
    noise = torch.stack(draws + [torch.zeros(B, S, S, 2)])
    want = td.sample(condition, STEPS, noise=noise)
    assert got.shape == (B, S, S, 2) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=0, rtol=0)
