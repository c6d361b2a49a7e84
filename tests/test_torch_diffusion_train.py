"""The port's DiffusionTrainer and GaussianDiffusion.loss against fea_tpu's
on the CPU, at 32 px, input_dim 16, 2 stages, 8 time steps, batch 8: one
step from the same params (the port's seeded init), the same batch, and
fea_tpu's own draws of t and the noise, handed to the port. The dataset
folder and the tolerances are those of tests/test_torch_train.py."""

import functools

import jax
import numpy as np
import pytest
import torch

from fea_tpu.models import diffusion as jdiffusion
from fea_tpu.train import diffusion_trainer as jdiffusion_trainer
from fea_tpu_torch.models.convert import from_flax
from fea_tpu_torch.train import diffusion_trainer
from test_torch_train import (
    BATCH, CONDITIONS, DIM, LR, S, STAGES, STEPS, assert_adam_step_close, flax_params,
    max_rel, to_numpy, write_dataset,
)

torch.set_num_threads(1)

T = 8
DIFFUSION_KW = dict(
    dataset_image_size=S, conditions_per_plate=CONDITIONS,
    num_steps_per_condition=STEPS, train_batch_size=BATCH, num_train_steps=1,
    timesteps=T, input_dim=DIM, num_stages=STAGES, skip_dataset_size_check=True,
    train_learning_rate=LR,
)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """fea_tpu's DiffusionTrainer and the port's over the same params (the
    port's seeded init, handed to fea_tpu, whose own init would run op by
    op), the same batch, and fea_tpu's draws of t and the noise for its
    first step."""
    folder = write_dataset(tmp_path_factory.mktemp("fea_data"))
    kw = dict(DIFFUSION_KW, dataset_folder=str(folder))
    pt = diffusion_trainer.DiffusionTrainer(diffusion_trainer.DiffusionConfig(
        **kw, results_folder=str(tmp_path_factory.mktemp("pdres"))), device="cpu")
    init = jdiffusion.GaussianDiffusion.init

    def from_port(self, rng, image_size, batch=1):
        abstract = jax.eval_shape(functools.partial(init, self, rng, image_size, batch))
        return {"params": flax_params(pt.diffusion.model.state_dict(), abstract["params"])}

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
        mp.setattr(jdiffusion.GaussianDiffusion, "init", from_port)
        jt = jdiffusion_trainer.DiffusionTrainer(jdiffusion_trainer.DiffusionConfig(
            **kw, results_folder=str(tmp_path_factory.mktemp("jdres")), n_devices=1))
        x0, cond = jt._fetch(0)
        _, rng_loss = jax.random.split(jt.state.rng)
        rng_t, rng_n = jax.random.split(rng_loss)
        t = jax.random.randint(rng_t, (BATCH,), 0, T)
        noise = jax.random.normal(rng_n, x0.shape, x0.dtype)
    feed = [torch.from_numpy(np.array(a)) for a in (x0, cond, t, noise)]
    return jt, pt, (x0, cond), feed


def test_loss_draws_from_the_generator_or_takes_them(pair):
    """t and the noise come from the given generator (the same seed gives
    the same loss) or are passed in; without either the loss raises."""
    _, pt, _, (x0, cond, t, noise) = pair
    with torch.no_grad():
        a, b = (pt.diffusion.loss(x0, cond, torch.Generator().manual_seed(5)) for _ in range(2))
        assert float(a) == float(b)
        x0_pred = pt.diffusion.model(pt.diffusion.q_sample(x0, t, noise), cond, time=t.float())
        pt.diffusion.objective = "pred_x0"
        try:
            got = pt.diffusion.loss(x0, cond, t=t, noise=noise)
        finally:
            pt.diffusion.objective = "pred_noise"
    torch.testing.assert_close(got, torch.mean((x0_pred - x0) ** 2))
    with pytest.raises(ValueError):
        pt.diffusion.loss(x0, cond)


def test_step_matches_fea_tpu(pair):
    """One clipped Adam step + EMA through GaussianDiffusion.loss, from the
    same params and draws: loss rtol 1e-5; Adam's first moment (the
    clipped gradient x 0.1) relative 1e-4; params as in the regression
    step; the EMA weights then sample finite images."""
    jt, pt, (x0, cond), (tx0, tcond, t, noise) = pair
    with jax.enable_x64(False):
        state, jloss = jt._train_step(jt.state, x0, cond)
    loss = pt._train_step(tx0, tcond, t=t, noise=noise)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    adam = state.opt_state[1][0]
    assert int(adam.count) == int(pt.opt_state.count) == 1
    assert max_rel(dict(zip(pt.names, pt.opt_state.mu)), from_flax(to_numpy(adam.mu))) < 1e-4
    assert_adam_step_close(pt.diffusion.model.state_dict(), from_flax(to_numpy(state.params)))
    assert_adam_step_close(dict(zip(pt.names, pt.ema_params)),
                           from_flax(to_numpy(state.ema_params)), scale=0.005)
    sample = pt.sample(tcond[:1], num_steps=2)
    assert sample.shape == (1, S, S, 2) and torch.isfinite(sample).all()


def test_train_loop_and_checkpoint(pair):
    """train() steps on to num_train_steps and saves 'final'; a new trainer
    loads it back exactly: params, Adam state, EMA, step and the
    generator's position."""
    _, pt, _, _ = pair
    pt.config.num_train_steps = pt.step + 1
    assert np.isfinite(pt.train())
    assert pt.train() is None  # nothing left to run
    other = diffusion_trainer.DiffusionTrainer(pt.config, device="cpu")
    other.load_checkpoint("final")
    assert other.step == pt.step
    for a, b in ((other.params, pt.params), (other.ema_params, pt.ema_params),
                 (other.opt_state.mu, pt.opt_state.mu), (other.opt_state.nu, pt.opt_state.nu)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(other.opt_state.count) == int(pt.opt_state.count)
    assert torch.equal(torch.randn(4, generator=other.generator),
                       torch.randn(4, generator=pt.generator))
