"""The full-attention, self-conditioned DDPM (`make_diffusion_model(
use_full_attention=True, self_condition=True)`) against the benchmark's
plain reference, `portbench/reference/fdnunet_fullattn.py`, on the CPU at
32 px, input_dim 16, 4 stages, from the same seeded weights: the forward
with and without an estimate, the sampler step by step, the loss on both
sides of its coin with its gradients, the reference's blocked attention,
the flash call shapes the benchmark counts at 256 px, the counters and
the span, the trainer's checkpoint of the two settings, its host-side
coin and its refusal of scores that do not fit, and the CLI's flags.
Imports no JAX.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fea_tpu_torch.models import make_diffusion_model
from fea_tpu_torch.models.attention import FullAttention, LinearAttention
from fea_tpu_torch.models.diffusion import GaussianDiffusion
from fea_tpu_torch.utils.profiling import recording

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench.counts import fullattn as counts  # noqa: E402
from portbench.reference import diffusion as ref_diffusion, fdnunet, fdnunet_fullattn  # noqa: E402
from portbench.reference.weights import make_weights  # noqa: E402

torch.set_num_threads(1)

S, DIM, STAGES, T, B = 32, 16, 4, 1000, 2
# the same f32 arithmetic in other orders (channels_last convolutions, the
# flash kernel's plain version against two matmuls): the forwards differ
# by under 1e-6 of their maximum
F32_REL = 2e-5


def config(size=S, input_dim=DIM):
    return {"model": {"kind": fdnunet_fullattn.KIND, "image_size": size, "input_dim": input_dim,
                      "num_stages": STAGES, "num_channels": 2,
                      "num_auxiliary_condition_channels": 5, "num_groups": 8,
                      "num_attention_heads": 4, "attention_head_dim": 32, "timesteps": T}}


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def pair():
    """The port's diffusion and the reference denoiser over one set of
    seeded weights."""
    reference = fdnunet_fullattn.build(config())["model"]
    weights = make_weights({"model": reference}, 2**31 + 11, "cpu")["model"]
    reference.load_state_dict({k: v.clone() for k, v in weights.items()}, assign=True)
    program = make_diffusion_model(image_size=S, input_dim=DIM, num_stages=STAGES, timesteps=T,
                                   device="cpu", generator=torch.Generator().manual_seed(0),
                                   use_flash_attention=True, use_full_attention=True,
                                   self_condition=True)
    program.model.load_state_dict(weights)
    return program, reference.eval()


def draws(seed, *shapes):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g) for shape in shapes]


def test_the_model_has_full_attention_everywhere_and_the_estimates_channels(pair):
    program, _ = pair
    attention = [m for n, m in program.model.named_children() if n.endswith("attention")]
    assert len(attention) == 2 * STAGES + 1
    assert all(isinstance(m, FullAttention) and m.use_flash for m in attention)
    assert not any(isinstance(m, LinearAttention) for m in program.model.modules())
    assert program.model.initial_conv.weight.shape[1] == 4  # [x, x_self]
    assert program.self_condition


@pytest.mark.parametrize("with_estimate", [False, True])
def test_forward_matches_the_reference(pair, with_estimate):
    program, reference = pair
    x, cond, x_self = draws(1, (B, S, S, 2), (B, S, S, 5), (B, S, S, 2))
    t = torch.tensor([3.0, 812.0])
    given = x_self if with_estimate else None
    with torch.no_grad():
        got = program.model(x, cond, given, time=t)
        want = reference(x, cond, t, given)
    assert rel(got, want) < F32_REL
    if not with_estimate:  # no estimate is zeros, on both sides
        with torch.no_grad():
            assert torch.equal(got, program.model(x, cond, torch.zeros_like(x), time=t))


def test_sample_follows_the_reference_step_by_step(pair):
    """Five strided steps: each step's model input (x and the estimate) and
    prediction against the reference loop's, and the output. The chain
    amplifies a step's f32 differences (at t = 999 the update divides by
    sqrt(alpha) = 0.032), hence 1e-4 on the states, as the DDPM's test."""
    program, reference = pair
    steps = 5
    cond, *noise = draws(2, (B, S, S, 5), *[(B, S, S, 2)] * (steps + 1))
    noise = torch.stack(noise)
    rec = []
    handle = program.model.register_forward_hook(
        lambda m, args, kwargs, out: rec.append((args[0], kwargs["x_self_condition"], out)),
        with_kwargs=True)
    try:
        got = program.sample(cond, steps, noise=noise)
    finally:
        handle.remove()
    schedule = ref_diffusion.Schedule(T)
    times = ref_diffusion.sample_timesteps(T, steps)
    want, ref_steps = fdnunet_fullattn.sample(reference, schedule, cond, noise, times)
    assert len(rec) == steps and torch.equal(rec[0][1], torch.zeros(B, S, S, 2))
    for i, ((x, x_self, eps), (rx, rx_self, reps)) in enumerate(zip(rec, ref_steps)):
        assert rel(x, rx) < 1e-4 and rel(eps, reps) < 1e-4
        if i:
            assert rel(x_self, rx_self) < 1e-4
            # the estimate is the last step's clamped x0 from the program's
            # own state and prediction, to an f32 ulp
            x0 = fdnunet_fullattn.x0_estimate(schedule, times[i - 1], rec[i - 1][0],
                                              rec[i - 1][2])
            assert rel(x_self, x0) < 1e-6 and x_self.abs().max() <= 1.0
    assert rel(got, want) < 1e-4


def test_sample_counts_one_zeros_forward_a_call(pair):
    program, _ = pair
    cond, = draws(3, (1, S, S, 5))
    before = GaussianDiffusion.self_cond_fed, GaussianDiffusion.self_cond_zero
    program.sample(cond, 4, generator=torch.Generator().manual_seed(4))
    assert (GaussianDiffusion.self_cond_fed - before[0],
            GaussianDiffusion.self_cond_zero - before[1]) == (3, 1)


@pytest.mark.parametrize("coin", [0.25, 0.75])
def test_loss_and_gradients_match_the_reference_on_each_side_of_the_coin(pair, coin):
    """Value rtol 1e-5; gradients, all leaves together, within 1e-4 of the
    largest: f32 sums in other orders through the backward. Under 0.5 the
    estimate moves the loss."""
    program, reference = pair
    x0, cond, noise = draws(5, (B, S, S, 2), (B, S, S, 5), (B, S, S, 2))
    t = torch.tensor([40, 700])
    schedule = ref_diffusion.Schedule(T)
    params = list(program.model.parameters())
    before = GaussianDiffusion.self_cond_fed, GaussianDiffusion.self_cond_zero
    with recording() as recorder:
        loss = program.loss(x0, cond, t=t, noise=noise, coin=coin)
    counted = (GaussianDiffusion.self_cond_fed - before[0],
               GaussianDiffusion.self_cond_zero - before[1])
    grads = torch.autograd.grad(loss, params)
    want = fdnunet_fullattn.loss(reference, schedule, x0, cond, t, noise, coin)
    want_grads = torch.autograd.grad(want, list(reference.parameters()))
    loss, want = float(loss.detach()), float(want.detach())
    np.testing.assert_allclose(loss, want, rtol=1e-5)
    flat = torch.cat([g.flatten() for g in grads])
    want_flat = torch.cat([g.flatten() for g in want_grads])
    assert rel(flat, want_flat) < 1e-4
    spans = [s for s in recorder.spans if s.name == "train.self_cond"]
    zeros = float(fdnunet_fullattn.loss(reference, schedule, x0, cond, t, noise, 1.0).detach())
    if coin < 0.5:
        assert counted == (1, 1) and len(spans) == 1
        assert abs(want - zeros) > 1e-6 * zeros
    else:
        assert counted == (0, 1) and not spans
        assert want == zeros


def test_the_coin_comes_from_the_generator_after_t_and_the_noise(pair):
    """The self-conditioned loss draws no coin: without `coin=` it raises,
    with a generator or without. With the coin given, t and then the noise
    still come from the generator, in that order."""
    program, _ = pair
    x0, cond = draws(6, (B, S, S, 2), (B, S, S, 5))
    g = torch.Generator().manual_seed(9)
    t = torch.randint(0, T, (B,), generator=g)
    noise = torch.randn(x0.shape, generator=g)
    coin = 0.25  # the estimate's side
    losses = []
    for _ in range(2):
        with torch.no_grad():
            losses.append(float(program.loss(x0, cond, torch.Generator().manual_seed(9),
                                             coin=coin)))
    with torch.no_grad():
        want = float(program.loss(x0, cond, t=t, noise=noise, coin=coin))
    assert losses == [want, want]
    with pytest.raises(ValueError):
        program.loss(x0, cond, torch.Generator().manual_seed(9))  # a generator, no coin
    with pytest.raises(ValueError):
        program.loss(x0, cond, t=t, noise=noise)  # no generator, no coin


def test_a_model_without_the_estimates_channels_refuses_self_conditioning():
    plain = make_diffusion_model(image_size=S, input_dim=8, num_stages=2, timesteps=10,
                                 device="cpu", generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        GaussianDiffusion(plain.model, timesteps=10, self_condition=True)


def test_blocked_reference_attention_matches_the_unblocked():
    """Blocks of 100 query rows over 1,028 keys against fdnunet.FullAttention
    in one piece: the scale applied in the product is within an f32 ulp of
    scaling the scores afterwards."""
    attention = fdnunet_fullattn.build(config())["model"].down0_attention
    weights = make_weights({"a": attention}, 3, "cpu")["a"]
    attention.load_state_dict(weights, assign=True)
    x, = draws(7, (2, DIM, S, S))
    with torch.no_grad():
        whole = fdnunet.FullAttention.forward(attention, x)
        rows = S * S
        attention.scores_bytes = 2 * 4 * (rows + 4) * 4 * 100
        blocked = attention(x)
    assert rel(blocked, whole) < 1e-6


def test_flash_calls_at_256_px_and_batch_2():
    """The nine flash calls the benchmark counts for one forward at the
    cell's shape, on meta tensors: every stage down and up and the
    middle."""
    shapes = counts.flash_shapes(config(256, 64), 2)
    assert sorted(shapes) == sorted(
        [(8, 65536, 65540, 32)] * 2 + [(8, 16384, 16388, 32)] * 2 + [(8, 4096, 4100, 32)] * 2
        + [(8, 1024, 1028, 32)] * 3)


def _dataset(n=4):
    g = np.random.default_rng(0)
    return [{k: g.normal(size=(S, S, c)).astype(np.float32)
             for k, c in (("displacement", 2), ("forces", 2), ("constraints", 1),
                          ("materials", 2))} for _ in range(n)]


def _trainer_config(tmp_path, **settings):
    from fea_tpu_torch.train.diffusion_trainer import DiffusionConfig

    kw = dict(dataset_image_size=S, train_batch_size=2, num_train_steps=1, timesteps=10,
              input_dim=8, num_stages=2, skip_dataset_size_check=True,
              results_folder=str(tmp_path), seed=5)
    return DiffusionConfig(**{**kw, **settings})


def test_a_checkpoint_records_the_network_and_a_loading_trainer_rebuilds_it(tmp_path):
    from fea_tpu_torch.train.diffusion_trainer import DiffusionTrainer

    trainer = DiffusionTrainer(_trainer_config(tmp_path, use_full_attention=True,
                                               self_condition=True),
                               dataset=_dataset(), device="cpu")
    assert trainer.diffusion.self_condition
    assert np.isfinite(trainer.train())
    config = _trainer_config(tmp_path)
    other = DiffusionTrainer(config, dataset=_dataset(), device="cpu")
    assert not other.diffusion.self_condition
    other.load_checkpoint("final")
    assert other.config.use_full_attention and other.config.self_condition
    assert not config.self_condition  # the caller's config is left as it was
    assert torch.equal(other.coin_generator.get_state(), trainer.coin_generator.get_state())
    assert other.diffusion.self_condition and other.diffusion.model.num_condition_channels == 2
    assert not any(isinstance(m, LinearAttention) for m in other.diffusion.model.modules())
    assert other.names == trainer.names and other.step == trainer.step
    assert all(torch.equal(a, b) for a, b in zip(other.params, trainer.params))
    assert all(torch.equal(a, b) for a, b in zip(other.ema_params, trainer.ema_params))
    sample = other.sample(torch.zeros(1, S, S, 5), num_steps=2)
    assert sample.shape == (1, S, S, 2) and torch.isfinite(sample).all()


def test_the_trainers_coin_comes_from_a_host_generator_of_its_seed(tmp_path):
    """The self-conditioned step takes its coin from a CPU generator seeded
    from the config, so that it does not wait on the card, and the
    device's generator draws t and the noise alone."""
    from fea_tpu_torch.train.diffusion_trainer import DiffusionTrainer

    trainer = DiffusionTrainer(_trainer_config(tmp_path, self_condition=True),
                               dataset=_dataset(), device="cpu")
    assert trainer.coin_generator.device.type == "cpu"
    x0, cond = trainer._fetch(0)
    coins = []
    loss = trainer.diffusion.loss
    trainer.diffusion.loss = lambda *a, **kw: coins.append(kw["coin"]) or loss(*a, **kw)
    device = torch.Generator().set_state(trainer.generator.get_state())
    trainer._train_step(x0, cond)
    host = torch.Generator().manual_seed(5)
    assert coins == [float(torch.rand((), generator=host))]
    assert torch.equal(trainer.coin_generator.get_state(), host.get_state())
    torch.randint(0, 10, (2,), generator=device)
    torch.randn(x0.shape, generator=device)
    assert torch.equal(trainer.generator.get_state(), device.get_state())


def test_the_trainer_refuses_full_attention_whose_scores_do_not_fit(tmp_path):
    """Without flash attention (its kernel has no backward) stage 0's
    scores at 256 px and batch 16 are 1.1 TB a call: the trainer refuses
    to build, and a trainer that fits refuses to sample a batch that does
    not; without full attention the same sizes build."""
    from fea_tpu_torch.train.diffusion_trainer import DiffusionTrainer

    big = dict(dataset_image_size=256, train_batch_size=16)
    with pytest.raises(ValueError, match="full attention cannot train at 256 px"):
        DiffusionTrainer(_trainer_config(tmp_path, **big, use_full_attention=True),
                         dataset=_dataset(), device="cpu")
    DiffusionTrainer(_trainer_config(tmp_path, **big), dataset=_dataset(), device="cpu")
    small = DiffusionTrainer(_trainer_config(tmp_path, use_full_attention=True),
                             dataset=_dataset(), device="cpu")
    with pytest.raises(ValueError, match="full attention cannot sample at 256 px"):
        small.sample(torch.zeros(16, 256, 256, 5), num_steps=1)


def test_train_diffusion_flags_reach_the_trainer(monkeypatch):
    from fea_tpu_torch import cli
    from fea_tpu_torch.train import diffusion_trainer

    seen = []

    class Recording:
        def __init__(self, config, device=None):
            seen.append(config)

        def train(self):
            return None

    monkeypatch.setattr(diffusion_trainer, "DiffusionTrainer", Recording)
    for flags in ([], ["--use_full_attention", "--self_condition"]):
        args = cli.build_parser().parse_args(["train-diffusion", *flags])
        cli._cmd_train_diffusion(args, "cpu")
    assert [(c.use_full_attention, c.self_condition) for c in seen] == [(False, False),
                                                                        (True, True)]


def test_self_conditioning_off_calls_the_model_as_before():
    """With self_condition off the sampler's forward takes no estimate
    argument: the call, and so the graph's key, of the parent's sampler."""
    diffusion = make_diffusion_model(image_size=S, input_dim=8, num_stages=2, timesteps=10,
                                     device="cpu", generator=torch.Generator().manual_seed(0))
    calls = []
    handle = diffusion.model.register_forward_hook(
        lambda m, args, kwargs, out: calls.append((len(args), sorted(kwargs))),
        with_kwargs=True)
    try:
        diffusion.sample(torch.zeros(1, S, S, 5), 3, generator=torch.Generator())
    finally:
        handle.remove()
    assert calls == [(2, ["time"])] * 3
