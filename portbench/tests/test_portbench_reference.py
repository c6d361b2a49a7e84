"""The benchmark's plain reference against the port, on the CPU at 32 px,
from the same weights; and the reference's independence from the port."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import diffusion as ref_diffusion, fdnunet
from portbench.reference.weights import make_weights, stream_seed

REFERENCE_DIR = Path(fdnunet.__file__).parent
SMALL = dict(image_size=32, input_dim=8)
F32_REL = 2e-5  # the same f32 arithmetic in other orders


def config(kind):
    model = {"kind": kind, "num_stages": 4, "num_channels": 2, "num_groups": 8, **SMALL}
    if kind == "regression":
        model["num_auxiliary_condition_channels"] = 3
    else:
        model.update(num_auxiliary_condition_channels=5, num_attention_heads=4,
                     attention_head_dim=32, timesteps=1000)
    return {"model": model}


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def loaded(kind, seed=5):
    cfg = config(kind)
    reference = fdnunet.build(cfg)
    weights = make_weights(reference, seed, "cpu")
    for key, module in reference.items():
        module.load_state_dict({k: v.clone() for k, v in weights[key].items()}, assign=True)
    return cfg, reference, weights


def test_reference_imports_nothing_of_the_program():
    for path in REFERENCE_DIR.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("fea_tpu", "fea_tpu_torch", "jax", "flax"), (
                    f"{path.name} imports {name}")


def test_regression_forward_matches_the_port():
    from fea_tpu_torch.models import create_models

    cfg, reference, weights = loaded("regression")
    encoder, decoder, _ = create_models(
        input_dim=8, image_height=32, image_width=32, num_stages=4, num_channels=2,
        num_auxiliary_condition_channels=3, device="cpu",
        generator=torch.Generator().manual_seed(0))
    encoder.load_state_dict(weights["encoder"])
    decoder.load_state_dict(weights["decoder"])
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randn((3, 32, 32, c), generator=g)
             for k, c in (("materials", 2), ("forces", 2), ("constraints", 1))}
    batch["geometry"] = torch.where(torch.rand((3, 32, 32, 1), generator=g) < 0.7, 1.0, -1.0)
    with torch.no_grad():
        want = fdnunet.regression_prediction(reference["encoder"], reference["decoder"], batch)
        image = decoder(*encoder(batch["materials"],
                                 torch.cat([batch["forces"], batch["constraints"]], dim=-1)))
    got = ((image + 1.0) / 2.0 * (batch["geometry"] + 1.0) / 2.0) * 2.0 - 1.0
    assert rel(got, want) < F32_REL


def test_denoiser_forward_and_sampler_match_the_port():
    from fea_tpu_torch.models import make_diffusion_model

    cfg, reference, weights = loaded("ddpm")
    program = make_diffusion_model(image_size=32, input_dim=8, num_stages=4, device="cpu",
                                   generator=torch.Generator().manual_seed(0),
                                   use_flash_attention=True)
    program.model.load_state_dict(weights["model"])
    steps = 5
    g = torch.Generator().manual_seed(2)
    cond = torch.randn((2, 32, 32, 5), generator=g)
    noise = torch.randn((steps + 1, 2, 32, 32, 2), generator=g)
    got = program.sample(cond, steps, noise=noise)

    schedule = ref_diffusion.Schedule(1000)
    x = noise[0]
    with torch.no_grad():
        for i, t in enumerate(ref_diffusion.sample_timesteps(1000, steps)):
            eps = reference["model"](x, cond, torch.full((2,), float(t)))
            x = ref_diffusion.update(schedule, t, x, eps, noise[i + 1] if t else None)
    assert rel(got, x) < 1e-4  # five steps of the chain, each within F32_REL


def test_schedule_matches_the_port():
    from fea_tpu_torch.models.diffusion import cosine_beta_schedule, sample_timesteps

    np.testing.assert_array_equal(ref_diffusion.cosine_betas(1000), cosine_beta_schedule(1000))
    assert ref_diffusion.sample_timesteps(1000, 25) == sample_timesteps(1000, 25)


def test_weights_repeat_from_the_seed_and_differ_between_seeds():
    cfg = config("regression")
    a = make_weights(fdnunet.build(cfg), 2**31 + 5, "cpu")
    b = make_weights(fdnunet.build(cfg), 2**31 + 5, "cpu")
    c = make_weights(fdnunet.build(cfg), 2**31 + 6, "cpu")
    name = "initial_conv.weight"
    assert torch.equal(a["encoder"][name], b["encoder"][name])
    assert not torch.equal(a["encoder"][name], c["encoder"][name])
    assert stream_seed(2**40 + 3, 1) != stream_seed(3, 1)


@pytest.mark.parametrize("kind", ["regression", "ddpm"])
def test_parameter_counts_at_published_widths(kind):
    published = {"regression": 41093440 + 18471106, "ddpm": 62749698}[kind]
    cfg = config(kind)
    cfg["model"].update(image_size=256, input_dim=64)
    modules = fdnunet.build(cfg)
    assert sum(p.numel() for m in modules.values() for p in m.parameters()) == published


def test_max_routes_find_near_tied_peaks_and_move_the_gradient():
    from portbench.reference.train import max_routes

    out = torch.zeros((1, 2, 8, 8))
    out[0, 0, 1, 1], out[0, 0, 6, 6] = 1.0, 0.999  # two peaks 1e-3 apart
    out[0, 1, 2, 2], out[0, 1, 5, 5] = 1.0, 0.9  # one clear maximum
    argmax, alternates, found = max_routes(out, 5e-3, 8)
    assert found == 1 and argmax.tolist() == [[9, 18]] and alternates == [(0, 0, 54)]
    moved = argmax.clone()
    moved[0, 0] = 54
    x = out.clone().requires_grad_()
    grads = [torch.autograd.grad(fdnunet.amax_normalize(x, route=r).sum(), x)[0]
             for r in (argmax, moved)]
    assert torch.equal(fdnunet.amax_normalize(x, route=moved), fdnunet.amax_normalize(x))
    assert grads[0][0, 0, 1, 1] != grads[1][0, 0, 1, 1]
    assert grads[0][0, 0, 6, 6] != grads[1][0, 0, 6, 6]


def test_route_choices_add_each_moves_change_to_the_argmax_gradient():
    from portbench.reference.train import gradients, route_choices

    cfg, reference, _ = loaded("regression")
    g = torch.Generator().manual_seed(3)
    batch = {k: torch.randn((2, 32, 32, c), generator=g)
             for k, c in (("materials", 2), ("forces", 2), ("constraints", 1),
                          ("displacement", 2))}
    batch["geometry"] = torch.ones((2, 32, 32, 1))
    with torch.no_grad():
        raw = fdnunet.regression_output(reference["encoder"], reference["decoder"], batch)
    argmax = raw.flatten(2).argmax(-1)
    second = raw.flatten(2).topk(2, -1).indices[..., 1]
    alternates = [(0, 0, int(second[0, 0])), (1, 1, int(second[1, 1]))]
    choices = dict(route_choices(reference, batch, argmax, alternates))
    assert len(choices) == 4  # argmax, each move alone, both
    both = argmax.clone()
    both[0, 0], both[1, 1] = second[0, 0], second[1, 1]
    direct = gradients(reference, batch, both)
    label = f"{alternates[0][2]},{alternates[1][2]}"
    got = torch.cat([t.flatten() for t in choices[label]])
    want = torch.cat([t.flatten() for t in direct])
    assert rel(got, want) < 1e-5  # the same backward, summed in another order
