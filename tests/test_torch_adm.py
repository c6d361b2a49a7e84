"""The port's ADM UNet (fea_tpu_torch/models/adm.py) and its learned-range,
respaced sampler (models/diffusion.py) against the benchmark's plain
references (portbench/reference/adm.py, adm_diffusion.py), which follow
openai/guided-diffusion's unet.py, gaussian_diffusion.py and respace.py,
on the CPU at a small size: 64 channels, channel_mult (1, 2), attention at
downsample rate 2 (16 px) in heads of 64 channels, 32 px images.

Every parameter is drawn from the seed (portbench/reference/weights.py),
the ones guided-diffusion initializes to zero too, so that every residual
branch and the output see an error in them. The `gpu` test holds the
graph-replayed sampler to the eager one on the card. Imports no JAX.
"""

import numpy as np
import pytest
import torch

from fea_tpu_torch.models import ADMUNet, graphed, make_adm_diffusion_model
from fea_tpu_torch.models import adm as port_adm
from fea_tpu_torch.models.diffusion import GaussianDiffusion, respaced_schedule, space_timesteps
from portbench.reference import adm as ref_adm, adm_diffusion as ref_diffusion
from portbench.reference.weights import make_weights

torch.set_num_threads(2)

S, B, SEED = 32, 2, 2**31 + 11
SMALL = dict(model_channels=64, channel_mult=(1, 2), attention_resolutions=(2,))
CONFIG = {"model": {"kind": "adm", "image_size": S, "num_channels": 2,
                    "num_auxiliary_condition_channels": 5, "model_channels": 64,
                    "num_res_blocks": 2, "attention_resolutions": [S // 2],
                    "channel_mult": [1, 2]}}
F32_REL = 2e-5  # the same f32 arithmetic in other orders
# guided-diffusion's space_timesteps(1000, "25"), as its code gives them
RESPACED_25 = [0, 42, 83, 125, 166, 208, 250, 291, 333, 375, 416, 458, 500, 541, 583, 624,
               666, 708, 749, 791, 832, 874, 916, 957, 999]


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def pair():
    """The port's diffusion and the reference network over one set of
    weights drawn from the seed."""
    reference = ref_adm.build(CONFIG)
    weights = make_weights(reference, SEED, "cpu")["model"]
    reference["model"].load_state_dict({k: v.clone() for k, v in weights.items()}, assign=True)
    diffusion = make_adm_diffusion_model(S, device="cpu",
                                         generator=torch.Generator().manual_seed(0), **SMALL)
    diffusion.model.load_state_dict(weights)
    return diffusion, reference["model"].eval(), weights


def inputs(seed=1, steps=5):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((B, S, S, 2), generator=g), torch.randn((B, S, S, 5), generator=g),
            torch.randn((steps + 1, B, S, S, 2), generator=g))


def test_parameters_at_published_widths():
    with torch.device("meta"):
        model = ADMUNet()
        reference = ref_adm.ADM()
    n = sum(p.numel() for p in model.parameters())
    # guided-diffusion's published 554 M for the 256 px model, less its class embedding
    assert n == sum(p.numel() for p in reference.parameters()) == 552_818_692
    assert [k for k, _ in model.named_parameters()] == [
        k for k, _ in reference.named_parameters()]


def test_every_zero_initialized_parameter_is_drawn_nonzero(pair):
    diffusion, _, weights = pair
    names = {n for n, p in diffusion.model.named_parameters()
             if any(p is q for m in port_adm.zero_modules(diffusion.model)
                    for q in m.parameters())}
    # each ResBlock's last conv, each attention's projection and the output's
    counts = [sum(isinstance(m, kind) for m in diffusion.model.modules())
              for kind in (port_adm.ResBlock, port_adm.AttentionBlock)]
    assert counts == [14, 6] and len(names) == 2 * (14 + 6 + 1)
    assert all(weights[n].abs().min() > 0 for n in names if n.endswith("weight"))
    fresh = make_adm_diffusion_model(S, device="cpu",
                                     generator=torch.Generator().manual_seed(0), **SMALL)
    assert all(not p.any() for m in port_adm.zero_modules(fresh.model) for p in m.parameters())


@pytest.mark.parametrize("t", [(999.0, 0.0), (10.0, 541.0)])
def test_forward_matches_the_reference(pair, t):
    diffusion, reference, _ = pair
    x, cond, _ = inputs()
    time = torch.tensor(t)
    with torch.no_grad():
        got = diffusion.model(x, cond, time)
        want = reference(x, cond, time)
    assert got.shape == (B, S, S, 4)
    assert rel(got, want) < F32_REL


def test_the_kernels_take_every_norm_silu_and_attention(pair, monkeypatch):
    """The in-layers' and the output's GroupNorm+SiLU go through the fused
    kernel's entry with 32 groups and eps 1e-5; each attention block is one
    flash call at head dim 64."""
    diffusion, _, _ = pair
    norms, calls = [], []
    group_norm_silu, flash_attention = port_adm.group_norm_silu, port_adm.flash_attention

    def norm(x, w, b, groups, eps):
        norms.append((x.shape[1], groups, eps))
        return group_norm_silu(x, w, b, groups, eps)

    def flash(q, k, v, scale):
        calls.append((tuple(q.shape), tuple(k.shape), scale))
        return flash_attention(q, k, v, scale)

    monkeypatch.setattr(port_adm, "group_norm_silu", norm)
    monkeypatch.setattr(port_adm, "flash_attention", flash)
    x, cond, _ = inputs()
    with torch.no_grad():
        diffusion.model(x, cond, torch.tensor([5.0, 7.0]))
    blocks = [m for m in diffusion.model.modules() if isinstance(m, port_adm.ResBlock)]
    assert len(norms) == len(blocks) + 1
    assert {(g, e) for _, g, e in norms} == {(32, 1e-5)}
    # attention at 16 px, 128 channels in 2 heads: two input blocks, the
    # middle, three output blocks
    assert calls == [((2 * B, 256, 64), (2 * B, 256, 64), 0.125)] * 6


def test_respaced_steps_follow_guided_diffusion():
    assert space_timesteps(1000, 25) == RESPACED_25
    assert sorted(ref_diffusion.space_timesteps(1000, "25")) == RESPACED_25
    for steps in (1, 2, 10, 50, 250, 999, 1000):
        assert space_timesteps(1000, steps) == sorted(
            ref_diffusion.space_timesteps(1000, str(steps))), steps
    with pytest.raises(ValueError):
        space_timesteps(10, 11)


def test_the_respaced_schedule_matches_the_reference(pair):
    diffusion, _, _ = pair
    s = diffusion.respaced(25)
    ref = ref_diffusion.Schedule(1000, 25)
    assert s["timestep_map"] == ref.timestep_map == RESPACED_25
    for mine, theirs in (("sqrt_recip_ab", "sqrt_recip_ab"), ("sqrt_recipm1_ab", "sqrt_recipm1_ab"),
                         ("coef1", "coef1"), ("coef2", "coef2"), ("log_betas", "max_log"),
                         ("log_var_clipped", "min_log")):
        assert (s[mine] == getattr(ref, theirs)).all(), mine
    # every step kept: the linear schedule's own betas, unrespaced
    full = respaced_schedule(diffusion._alphas_bar, range(1000))
    betas = torch.linspace(1e-4, 0.02, 1000, dtype=torch.float64).numpy()
    assert abs(full["log_betas"] - np.log(betas)).max() < 1e-12


def test_every_respaced_step_matches_the_reference_update(pair):
    """The sampler's update at each of 25 steps, from the state it hands
    the model and a stand-in model's output, against the reference update
    with the step's noise: the same f32 arithmetic, bit for bit."""
    diffusion, _, _ = pair
    _, cond, noise = inputs(steps=25)
    seen = []

    def model(x, condition, time):
        out = torch.cat([torch.tanh(x) * 0.7, torch.sin(3 * x)], dim=-1)
        seen.append((x, out, float(time[0])))
        return out

    real, diffusion.model = diffusion.model, model
    try:
        got = diffusion.sample(cond, 25, noise=noise)
    finally:
        diffusion.model = real
    schedule = ref_diffusion.Schedule(1000, 25)
    assert torch.equal(seen[0][0], noise[0])
    for step, i, t in schedule.order():
        x, out, time = seen[step]
        assert time == t
        want = ref_diffusion.update(schedule, i, x, out, noise[step + 1] if i else None)
        assert torch.equal(seen[step + 1][0] if step < 24 else got, want), step


def test_sampling_matches_the_reference_loop(pair):
    """Five respaced steps, the noise given: the port's sampler against the
    reference loop through the reference network."""
    diffusion, reference, _ = pair
    _, cond, noise = inputs(steps=5)
    before = GaussianDiffusion.learned_range_steps, GaussianDiffusion.final_steps
    got = diffusion.sample(cond, 5, noise=noise)
    assert (GaussianDiffusion.learned_range_steps - before[0],
            GaussianDiffusion.final_steps - before[1]) == (4, 1)
    schedule = ref_diffusion.Schedule(1000, 5)
    x = noise[0]
    with torch.no_grad():
        for step, i, t in schedule.order():
            out = reference(x, cond, torch.full((B,), float(t)))
            x = ref_diffusion.update(schedule, i, x, out, noise[step + 1] if i else None)
    # each forward within F32_REL; the first step's x0 multiplies its
    # rounding by sqrt(1/abar_999 - 1), 157 in the linear schedule
    assert rel(got, x) < 160 * F32_REL


def test_the_model_is_fed_the_original_time_steps(pair, monkeypatch):
    diffusion, _, _ = pair
    seen = []
    forward = ADMUNet._forward

    def spy(self, x, condition, time):
        seen.append(float(time[0]))
        return forward(self, x, condition, time)

    monkeypatch.setattr(ADMUNet, "_forward", spy)
    _, cond, _ = inputs()
    diffusion.sample(cond, 25, generator=torch.Generator().manual_seed(3))
    assert seen == RESPACED_25[::-1]


def test_the_learned_range_loss_and_settings_are_refused(pair):
    diffusion, _, _ = pair
    x, cond, _ = inputs()
    with pytest.raises(NotImplementedError, match="hybrid"):
        diffusion.loss(x, cond, torch.Generator().manual_seed(0))
    for kw in ({"objective": "pred_x0"}, {"self_condition": True}):
        with pytest.raises(ValueError):
            GaussianDiffusion(diffusion.model, **kw)
    with pytest.raises(ValueError, match="divisible"):
        with torch.no_grad():
            diffusion.model(x[:, :31, :31], cond[:, :31, :31], torch.zeros(B))


# ---- the card -----------------------------------------------------------


@pytest.mark.gpu
def test_graphed_sampling_matches_eager_bit_for_bit_on_the_card():
    """ADM at the published widths' small cousin on the card: the graphed
    sampler against the eager one, bit for bit; one capture, then replays;
    flash at head dim 64 on its mma.sync route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fea_tpu_torch.models.graphed import GraphedForward
    from fea_tpu_torch.ops import flash_attention

    device = torch.device("cuda")
    diffusion = make_adm_diffusion_model(64, device=device,
                                         generator=torch.Generator(device=device).manual_seed(0),
                                         model_channels=128, channel_mult=(1, 2, 2),
                                         attention_resolutions=(2, 4))
    weights = make_weights(ref_adm.build({"model": dict(
        CONFIG["model"], image_size=64, model_channels=128, channel_mult=[1, 2, 2],
        attention_resolutions=[32, 16])}), SEED, device)["model"]
    diffusion.model.load_state_dict(weights)
    g = torch.Generator(device=device).manual_seed(1)
    cond = torch.randn((2, 64, 64, 5), generator=g, device=device)
    noise = torch.randn((26, 2, 64, 64, 2), generator=g, device=device)
    active = graphed.active
    graphed.active = lambda: None
    try:
        eager = diffusion.sample(cond, 25, noise=noise)
    finally:
        graphed.active = active
    counts = GraphedForward.captures, GraphedForward.replays
    launches = flash_attention.launches, flash_attention.launches_wgmma
    first = diffusion.sample(cond, 25, noise=noise)
    second = diffusion.sample(cond, 25, noise=noise)
    torch.cuda.synchronize()
    assert (GraphedForward.captures - counts[0], GraphedForward.replays - counts[1]) == (1, 49)
    # attention at 32 and 16 px: 2 + 2 input blocks, the middle, 3 + 3 output blocks
    assert flash_attention.launches - launches[0] == 2 * 25 * 11
    assert flash_attention.launches_wgmma == launches[1]
    assert torch.equal(first, eager) and torch.equal(second, eager)
