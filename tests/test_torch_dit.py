"""The port's DiT (fea_tpu_torch/models/dit.py) through its learned-range,
respaced sampler (models/diffusion.py) against the benchmark's plain
reference (portbench/reference/dit.py, which follows facebookresearch/DiT's
models.py, and adm_diffusion.py for the sampler's update), on the CPU at a
small size: width 64, depth 2, 4 heads of 16, 32 px images in patches of 8.

Every parameter is drawn from the seed (portbench/reference/weights.py),
the ones DiT initializes to zero too (the adaLN modulations and the final
linear): with zeros every block would be the identity and the output 0,
so the comparison would be blind. Also here: the parameter counts at
DiT-XL's published shapes, the position table against entries computed by
hand, and the precision policy's matmul scope (DiT's matmuls in TF32, every
other model's left strict, the FEM's guard holding after a DiT sample).
The `gpu` test holds the graph-replayed sampler to the eager one on the
card. Imports no JAX.
"""

import math

import numpy as np
import pytest
import torch

from fea_tpu_torch.fem import problem
from fea_tpu_torch.models import DiT, graphed, make_adm_diffusion_model, make_dit_diffusion_model
from fea_tpu_torch.models import dit as port_dit
from fea_tpu_torch.models import make_diffusion_model
from fea_tpu_torch.models.diffusion import GaussianDiffusion
from fea_tpu_torch.utils.precision import matmul_precision, model_precision
from portbench.reference import adm_diffusion as ref_diffusion, dit as ref_dit
from portbench.reference.weights import make_weights

torch.set_num_threads(2)

S, B, SEED = 32, 2, 2**31 + 23
SMALL = dict(patch_size=8, hidden_size=64, depth=2, num_heads=4)
CONFIG = {"model": {"kind": "dit", "image_size": S, "patch_size": 8, "num_channels": 2,
                    "num_auxiliary_condition_channels": 5, "hidden_size": 64, "depth": 2,
                    "num_heads": 4, "mlp_ratio": 4.0}}
XL = dict(CONFIG["model"], image_size=256, hidden_size=1152, depth=28, num_heads=16)
F32_REL = 2e-5  # the same f32 arithmetic in other orders


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def pair():
    """The port's diffusion and the reference network over one set of
    weights drawn from the seed, each with its own position table."""
    reference = ref_dit.build(CONFIG)["model"]
    weights = make_weights({"model": reference}, SEED, "cpu")["model"]
    reference.load_state_dict(dict({k: v.clone() for k, v in weights.items()},
                                   pos_embed=ref_dit.pos_embed(CONFIG)), assign=True)
    diffusion = make_dit_diffusion_model(S, device="cpu",
                                         generator=torch.Generator().manual_seed(0), **SMALL)
    missing, unexpected = diffusion.model.load_state_dict(weights, strict=False)
    assert missing == ["pos_embed"] and not unexpected
    return diffusion, reference.eval(), weights


def inputs(seed=1, steps=5):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((B, S, S, 2), generator=g), torch.randn((B, S, S, 5), generator=g),
            torch.randn((steps + 1, B, S, S, 2), generator=g))


def test_parameters_at_published_shapes():
    """DiT-XL at the cell's shapes: 674,437,504 trained parameters and the
    1,179,648-entry position table; the reference's structure at
    DiT-XL/2-256's (4 latent channels, p 2, a 32 x 32 latent, the
    1001-row label table) counts 675,129,632 with its table, the figure
    DiT's train.py logs."""
    with torch.device("meta"):
        model = DiT()
        reference = ref_dit.build({"model": XL})["model"]
        published = ref_dit.DiT(input_size=32, patch_size=2, in_channels=4, out_channels=8,
                                num_classes=1000)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(p.numel() for p in reference.parameters()) == 674_437_504
    assert model.pos_embed.numel() == reference.pos_embed.numel() == 1_179_648
    assert (sum(p.numel() for p in published.parameters())
            + published.pos_embed.numel()) == 675_129_632
    assert [k for k, _ in model.named_parameters()] == [
        k for k, _ in reference.named_parameters()]
    assert sorted(model.state_dict()) == sorted(reference.state_dict())
    heads = {(m.num_heads, m.head_dim) for m in model.modules()
             if isinstance(m, port_dit.Attention)}
    assert heads == {(16, 72)}


@pytest.mark.parametrize("token, index", [((3, 5), 0), ((3, 5), 287), ((3, 5), 288),
                                          ((3, 5), 600), ((31, 0), 1151), ((0, 17), 575)])
def test_the_position_table_against_entries_by_hand(token, index):
    """Token (row r, column c) of the 32 x 32 grid, width 1152: entries
    0-287 sin(c w_j), 288-575 cos(c w_j), 576-863 sin(r w_j), 864-1151
    cos(r w_j), w_j = 10000^(-j / 288)."""
    r, c = token
    half, quarter = divmod(index, 576)[0], index % 576
    pos = (c, r)[half]
    j = quarter % 288
    value = (math.sin, math.cos)[quarter // 288](pos * 10000 ** (-j / 288))
    table = port_dit.pos_embed_table(1152, 32)
    assert table.shape == (1024, 1152)
    assert abs(float(table[r * 32 + c, index]) - value) < 1e-7
    reference = ref_dit.get_2d_sincos_pos_embed(1152, 32)
    assert abs(float(reference[r * 32 + c, index]) - value) < 1e-12
    assert torch.equal(table, reference.float())


def test_every_zero_initialized_parameter_is_drawn_nonzero(pair):
    diffusion, _, weights = pair
    names = {n for n, p in diffusion.model.named_parameters()
             if any(p is q for m in port_dit.zero_modules(diffusion.model)
                    for q in m.parameters())}
    # each block's adaLN linear, the final layer's and its output linear
    assert len(names) == 2 * (SMALL["depth"] + 2)
    assert all(weights[n].abs().min() > 0 for n in names if n.endswith("weight"))
    assert all(weights[n].abs().max() > 0 for n in names)
    fresh = make_dit_diffusion_model(S, device="cpu",
                                     generator=torch.Generator().manual_seed(0), **SMALL)
    assert all(not p.any() for m in port_dit.zero_modules(fresh.model) for p in m.parameters())
    assert torch.equal(fresh.model.pos_embed[0], port_dit.pos_embed_table(64, S // 8))


@pytest.mark.parametrize("t", [(999.0, 0.0), (10.0, 541.0)])
def test_forward_matches_the_reference(pair, t):
    """Both halves of the output, the noise estimate and v."""
    diffusion, reference, _ = pair
    x, cond, _ = inputs()
    time = torch.tensor(t)
    with torch.no_grad():
        got = diffusion.model(x, cond, time)
        want = reference(x, cond, time)
    assert got.shape == (B, S, S, 4)
    assert rel(got[..., :2], want[..., :2]) < F32_REL
    assert rel(got[..., 2:], want[..., 2:]) < F32_REL
    assert want[..., :2].abs().max() > 0.1 and want[..., 2:].abs().max() > 0.1


def test_each_attention_is_one_flash_call(pair, monkeypatch):
    """At head dim 16 here (72 at DiT-XL's widths), scale 1/sqrt(16), over
    the batch's heads and the 16 tokens of a 32 px image in patches of 8."""
    diffusion, _, _ = pair
    calls = []
    flash_attention = port_dit.flash_attention

    def flash(q, k, v, scale):
        calls.append((tuple(q.shape), tuple(k.shape), q.is_contiguous(), scale))
        return flash_attention(q, k, v, scale)

    monkeypatch.setattr(port_dit, "flash_attention", flash)
    x, cond, _ = inputs()
    with torch.no_grad():
        diffusion.model(x, cond, torch.tensor([5.0, 7.0]))
    assert calls == [((4 * B, 16, 16), (4 * B, 16, 16), True, 0.25)] * SMALL["depth"]


def test_every_respaced_step_matches_the_reference_update(pair):
    """The sampler's update at each of 25 steps, from the state it hands
    DiT and DiT's output, against the reference update with the step's
    noise: the same f32 arithmetic, bit for bit."""
    diffusion, _, _ = pair
    _, cond, noise = inputs(steps=25)
    seen = []
    handle = diffusion.model.register_forward_hook(
        lambda m, args, kwargs, out: seen.append((args[0], out, float(kwargs["time"][0]))),
        with_kwargs=True)
    try:
        got = diffusion.sample(cond, 25, noise=noise)
    finally:
        handle.remove()
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


def test_the_loss_and_other_sizes_are_refused(pair):
    diffusion, _, _ = pair
    x, cond, _ = inputs()
    with pytest.raises(NotImplementedError, match="hybrid"):
        diffusion.loss(x, cond, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="32 x 32"):
        with torch.no_grad():
            diffusion.model(x[:, :24, :24], cond[:, :24, :24], torch.zeros(B))
    with pytest.raises(ValueError, match="not whole"):
        DiT(input_size=36, patch_size=8)


# ---- the precision policy's matmul scope --------------------------------


def matmul_flag():
    return torch.backends.cuda.matmul.fp32_precision


@pytest.fixture
def linear_flags():
    """The matmul flag at every nn.Linear's forward, through a global
    module hook; the flag put back after the test."""
    saved, seen = matmul_flag(), []

    def pre(module, args):
        if isinstance(module, torch.nn.Linear):
            seen.append(matmul_flag())

    hook = torch.nn.modules.module.register_module_forward_pre_hook(pre)
    try:
        yield seen
    finally:
        hook.remove()
        torch.backends.cuda.matmul.fp32_precision = saved


def test_dit_samples_with_tf32_matmuls_and_hands_the_flag_back(pair, linear_flags):
    diffusion, _, _ = pair
    _, cond, noise = inputs(steps=3)
    before = matmul_flag()
    diffusion.sample(cond, 3, noise=noise)
    # 144 linears a forward at depth 28: here 2 + 5 a block + 2
    assert len(linear_flags) == 3 * (4 + 5 * SMALL["depth"])
    assert set(linear_flags) == {"tf32"}
    assert matmul_flag() == before and matmul_precision() is None


def test_an_explicit_scope_wins_over_what_dit_declares(pair, linear_flags):
    diffusion, _, _ = pair
    _, cond, noise = inputs(steps=2)
    with model_precision(matmul="ieee"):
        diffusion.sample(cond, 2, noise=noise)
        assert matmul_flag() == "ieee"
    assert set(linear_flags) == {"ieee"}


@pytest.mark.parametrize("kind", ["fdnunet", "adm"])
def test_other_models_leave_the_matmul_flag_alone(linear_flags, kind):
    g = torch.Generator().manual_seed(0)
    if kind == "fdnunet":
        diffusion = make_diffusion_model(S, 8, 2, timesteps=10, device="cpu", generator=g,
                                         use_flash_attention=True)
    else:
        diffusion = make_adm_diffusion_model(S, device="cpu", generator=g, model_channels=32,
                                             channel_mult=(1, 2), attention_resolutions=(2,))
    _, cond, noise = inputs(steps=2)
    before = matmul_flag()
    diffusion.sample(cond, 2, noise=noise)
    assert linear_flags and set(linear_flags) == {before}
    assert matmul_flag() == before


def test_unknown_matmul_precision_raises():
    before = matmul_flag()
    with pytest.raises(ValueError, match="matmul precision"), model_precision(matmul="bf16"):
        pass
    assert matmul_flag() == before and matmul_precision() is None


def test_the_fem_refuses_tf32_and_accepts_strict_matmuls_after_a_dit_sample(pair, monkeypatch):
    """In one process: a DiT sample, then the FEM's guard passes and a
    solve runs; inside a TF32 scope, or with the legacy flag on, the guard
    refuses."""
    diffusion, _, _ = pair
    _, cond, noise = inputs(steps=2)
    diffusion.sample(cond, 2, noise=noise)
    problem._require_true_f32()
    square = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
    from fea_tpu_torch.mesh import mesher

    mesh = mesher.triangulate(np.array(square), mesh_size=0.34)
    n = mesh.num_nodes
    loads = np.zeros((n, 2))
    loads[mesh.coords[:, 0] > 1 - 1e-9, 0] = 1.0
    p = problem.StaticProblem(mesh.coords, mesh.triangles, np.full(mesh.num_triangles, 1e4),
                              np.full(mesh.num_triangles, 0.3), mesh.coords[:, 0] < 1e-9,
                              loads, num_steps=2)
    assert p.solve(device="cpu").success
    with model_precision(matmul="tf32"), pytest.raises(RuntimeError, match="allow_tf32"):
        p.solve(device="cpu")
    assert not problem.matmul_tf32()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        problem._require_true_f32()


# ---- the card -----------------------------------------------------------


@pytest.mark.gpu
def test_graphed_sampling_matches_eager_bit_for_bit_on_the_card():
    """A narrow DiT with DiT-XL's heads of 72 on the card: the graphed
    sampler against the eager one, bit for bit; one capture, then replays;
    every attention one flash call at head dim 72, counted at each
    replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fea_tpu_torch.models.graphed import GraphedForward
    from fea_tpu_torch.ops import flash_attention

    device = torch.device("cuda")
    shape = dict(patch_size=8, hidden_size=288, depth=3, num_heads=4)
    diffusion = make_dit_diffusion_model(64, device=device,
                                         generator=torch.Generator(device=device).manual_seed(0),
                                         **shape)
    config = {"model": dict(CONFIG["model"], image_size=64, **shape)}
    weights = make_weights(ref_dit.build(config), SEED, device)["model"]
    diffusion.model.load_state_dict(weights, strict=False)
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
    launches = flash_attention.launches, flash_attention.launches_d72
    first = diffusion.sample(cond, 25, noise=noise)
    second = diffusion.sample(cond, 25, noise=noise)
    torch.cuda.synchronize()
    assert (GraphedForward.captures - counts[0], GraphedForward.replays - counts[1]) == (1, 49)
    assert flash_attention.launches - launches[0] == 2 * 25 * 3
    assert flash_attention.launches_d72 - launches[1] == 2 * 25 * 3
    assert torch.equal(first, eager) and torch.equal(second, eager)
    assert torch.isfinite(eager).all()
