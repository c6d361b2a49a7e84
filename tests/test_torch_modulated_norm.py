"""The port's modulated GroupNorm+SiLU forward
(fea_tpu_torch.ops.fused_norm.group_norm_modulated_silu) and the blocks that
call it: the FDN's per-pixel scale and shift (`FeatureDenormalization`), and
the time embedding's per-channel scale and shift (`ResnetSubBlock`, ADM's
`ResBlock`).

On the CPU: the plain version is each block's own expression, the blocks
take PyTorch's chain wherever a gradient is needed (output and gradients
bit for bit the chain's) and the fused entry elsewhere, the main path hands
the entry the shapes and layouts its kernels take, and bad inputs raise.
The tests marked `gpu` hold the CUDA kernels to the plain version; they
skip where there is no CUDA device and import no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_modulated_norm.py
"""

import pytest
import torch
import torch.nn.functional as F

from fea_tpu_torch.models import adm, blocks
from fea_tpu_torch.ops import graphs
from fea_tpu_torch.ops.fused_norm import (
    forward_plan, forward_route, group_norm_modulated_silu,
    group_norm_modulated_silu_reference, group_norm_silu, modulation, needs_grad,
)

torch.set_num_threads(1)

EPS = {8: 1e-6, 32: 1e-5}  # the FDN-UNet's (flax's) and ADM's (GroupNorm32's)
FWD_TOL = dict(atol=5e-5, rtol=1e-4)  # fea_tpu's forward bounds, as the unmodulated kernel's
BF16_TOL = dict(atol=1e-2, rtol=1e-2)  # one bf16 rounding of y


def draw(*shape, seed=0, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


def case(mode, shape, affine=True, seed=0, dtype=torch.float32, device="cpu"):
    """x, gamma, beta (None without affine), scale and shift as the blocks
    hand them over: per pixel two convolutions' outputs, contiguous like x;
    per channel the two halves of one (B, 2C, 1, 1) embedding."""
    b, c = shape[:2]
    x = draw(*shape, seed=seed, dtype=dtype, device=device)
    gamma = beta = None
    if affine:
        gamma, beta = (draw(c, seed=seed + i, device=device) for i in (1, 2))
    if mode == "pixel":
        scale, shift = (0.5 * draw(*shape, seed=seed + i, dtype=dtype, device=device)
                        for i in (3, 4))
    else:
        emb = 0.5 * draw(b, 2 * c, 1, 1, seed=seed + 3, dtype=dtype, device=device)
        scale, shift = emb.chunk(2, dim=1)
    return x, gamma, beta, scale, shift


# the three call sites' expressions as the blocks wrote them before the
# fused entry, on x, gamma, beta, scale and shift
PRESENT = {
    "fdn": lambda x, g, b, scale, shift, groups, eps: F.silu(
        F.group_norm(x, groups, eps=eps) * (scale + 1.0) + shift),
    "resnet": lambda x, g, b, scale, shift, groups, eps: F.silu(
        F.group_norm(x, groups, g, b, eps) * (scale + 1.0) + shift),
    "adm": lambda x, g, b, scale, shift, groups, eps: F.silu(
        F.group_norm(x, groups, g, b, eps) * (1 + scale) + shift),
}
SITE_MODES = {"fdn": ("pixel", False), "resnet": ("channel", True), "adm": ("channel", True)}


@pytest.mark.parametrize("groups", [8, 32])
@pytest.mark.parametrize("site", list(PRESENT))
def test_reference_is_each_call_sites_expression(site, groups):
    """Per pixel without gamma and beta (the FDN), per channel with them
    (the time-conditioned blocks), at 8 and 32 groups: to 1e-6 relative,
    and in fact the same bits."""
    mode, affine = SITE_MODES[site]
    args = case(mode, (2, 64, 8, 8), affine)
    want = PRESENT[site](*args, groups, EPS[groups])
    got = group_norm_modulated_silu_reference(*args, groups, EPS[groups])
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-6
    assert torch.equal(got, want)


def fdn_block():
    """The block, its forward and the parent's expression as functions of
    (x, the extra input), x's shape, and the extra input: the features."""
    block = blocks.FeatureDenormalization(64, 16, 8)

    def present(x, features):  # the parent's FeatureDenormalization.forward
        x = F.group_norm(x, block.num_groups, eps=blocks.GROUP_NORM_EPS)
        return F.silu(x * (block.scale_conv(features) + 1.0) + block.shift_conv(features))

    return block, block, present, (2, 64, 8, 8), draw(2, 16, 8, 8, seed=5)


def resnet_block():
    """The same for a time-conditioned sub-block; the extra input is the
    time embedding's (B, 2C, 1, 1) scale and shift."""
    block = blocks.ResnetSubBlock(32, 64, 8)

    def forward(x, emb):
        return block(x, emb.chunk(2, dim=1))

    def present(x, emb):  # the parent's ResnetSubBlock.forward with a scale-shift
        scale, shift = emb.chunk(2, dim=1)
        return F.silu(block.GroupNorm_0(block.Conv_0(x)) * (scale + 1.0) + shift)

    return block, forward, present, (2, 32, 8, 8), draw(2, 128, 1, 1, seed=6)


def adm_block():
    """The same for ADM's ResBlock (with up-sampling); the extra input is
    the time embedding."""
    block = adm.ResBlock(64, 32, 64, up=True)

    def present(x, emb):  # the parent's ResBlock.forward
        h = adm.norm_silu(block.in_layers[0], x)
        h = block.in_layers[2](block._resample(h))
        x = block._resample(x)
        scale, shift = block.emb_layers(emb)[..., None, None].chunk(2, dim=1)
        norm = block.out_layers[0]
        h = F.group_norm(h, adm.GROUPS, norm.weight, norm.bias, adm.EPS) * (1 + scale) + shift
        h = block.out_layers[3](F.silu(h))
        return block.skip_connection(x) + h

    return block, block, present, (2, 64, 8, 8), draw(2, 32, seed=7)


BLOCKS = {"fdn": fdn_block, "resnet": resnet_block, "adm": adm_block}


@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_blocks_take_the_chain_under_grad_and_the_entry_without(name, grad, monkeypatch):
    """Under grad each block runs PyTorch's chain, never the fused entry,
    and its output and the gradients of x, the extra input and every
    parameter are bit for bit the parent's expression's; without grad it
    calls the fused entry once, whose plain version on CPU tensors gives
    the same bits."""
    block, forward, present, shape, extra = BLOCKS[name]()
    with torch.no_grad():  # non-zero gammas and betas, unlike a fresh GroupNorm's
        for i, p in enumerate(block.parameters()):
            p.copy_(0.2 * draw(*p.shape, seed=100 + i))
    calls = []

    def entry(*args):
        if grad:
            raise AssertionError("the fused entry was called where a gradient is needed")
        calls.append(modulation(args[0], args[3], args[4]))
        return group_norm_modulated_silu(*args)

    monkeypatch.setattr(blocks, "group_norm_modulated_silu", entry)
    x = draw(*shape, seed=8)
    if not grad:
        with torch.no_grad():
            assert torch.equal(forward(x, extra), present(x, extra))
        assert calls == [SITE_MODES[name][0]]
        return
    params = list(block.parameters())
    outputs, grads = [], []
    for fn in (forward, present):
        leaves = [t.detach().clone().requires_grad_() for t in (x, extra)]
        y = fn(*leaves)
        outputs.append(y)
        grads.append(torch.autograd.grad(y, leaves + params, draw(*y.shape, seed=9)))
    assert torch.equal(*outputs)
    assert len(grads[0]) == 2 + len(params)
    assert all(torch.equal(g, w) for g, w in zip(*grads))


@pytest.mark.parametrize("mode", ["pixel", "channel"])
def test_cpu_tensors_take_the_plain_path(mode):
    """No launch is counted, and the output is the plain version's."""
    args = case(mode, (2, 32, 4, 4), affine=mode == "channel")
    before = group_norm_modulated_silu.launches
    got = group_norm_modulated_silu(*args, 8, 1e-6)
    assert group_norm_modulated_silu.launches == before
    assert torch.equal(got, group_norm_modulated_silu_reference(*args, 8, 1e-6))


@pytest.mark.parametrize("grad_mode, requiring, want", [
    (True, None, False),  # grad on, nothing requires grad
    (True, "x", True),
    (True, "scale", True),
    (True, "gamma", True),
    (False, "x", False),  # under no_grad
])
def test_needs_grad_is_grad_mode_and_an_operand_requiring_grad(grad_mode, requiring, want):
    """The one rule both the blocks' choice and the entry's refusal read:
    a gradient is needed where grad mode is on and an operand requires
    grad; None operands (the FDN's affine-free norm) are skipped. (The
    entry's refusal on the card: `test_cuda_modulated_raises_on_bad_input`.)"""
    x, gamma, beta, scale, shift = case("pixel", (2, 8, 4, 4))
    operands = dict(x=x, gamma=gamma, beta=beta, scale=scale, shift=shift)
    if requiring is not None:
        operands[requiring].requires_grad_()
    with torch.set_grad_enabled(grad_mode):
        assert needs_grad(*operands.values(), None) is want


@pytest.mark.parametrize("bad", [
    "per_channel_2d", "shapes_differ", "per_row", "shift_f64", "scale_bf16", "scale_elsewhere",
])
def test_bad_scale_or_shift_raises(bad):
    """Scale and shift must both be (B, C, 1, 1) or of x's shape, in x's
    type, and on x's device."""
    x, gamma, beta, scale, shift = case("pixel", (2, 32, 4, 4), affine=True)
    if bad == "per_channel_2d":  # (B, C) would broadcast along H and W
        scale, shift = scale[:, :, 0, 0], shift[:, :, 0, 0]
    elif bad == "shapes_differ":
        shift = shift[:, :, :1, :1]
    elif bad == "per_row":
        scale, shift = scale[..., :1], shift[..., :1]
    elif bad == "shift_f64":
        shift = shift.double()
    elif bad == "scale_bf16":
        scale = scale.bfloat16()
    else:
        scale = scale.to("meta")
    with pytest.raises(TypeError if bad in ("shift_f64", "scale_bf16") else ValueError):
        group_norm_modulated_silu(x, gamma, beta, scale, shift, 8, 1e-6)


# an H100 as plain numbers: SMs, and the shared memory one block may ask for
H100 = (132, 232448)
# the shapes (B, C, H, W) of the modulated calls of a DDPM forward at 256 px
# and batch 2 (the FDN's and the up path's), then of an ADM forward
MAIN_PATH_SHAPES = [
    (2, 64, 256, 256), (2, 128, 128, 128), (2, 256, 64, 64), (2, 512, 32, 32),
    (2, 256, 256, 256), (2, 256, 128, 128), (2, 512, 64, 64), (2, 1024, 16, 16),
    (2, 1024, 8, 8),
]


@pytest.mark.parametrize("size", [4, 2])
@pytest.mark.parametrize("shape", MAIN_PATH_SHAPES)
def test_modulated_calls_take_the_unmodulated_plans(shape, size):
    """A modulated call is planned by `forward_route` itself: where x, scale
    and shift are aligned, the plan of an unmodulated call of x's shape; a
    scale 4 bytes off 16 takes the two-pass route at the vector that
    allows."""
    b, c, h, w = shape
    for groups in (8, 32):
        plain = forward_route(b, c, h * w, groups, size, 0, *H100)
        aligned = forward_route(b, c, h * w, groups, size, 0 | 256 | 4096, *H100)
        assert aligned == plain
        off = forward_route(b, c, h * w, groups, size, 0 | (256 + 4) | 4096, *H100)
        assert off.route == "two_pass" and off.vec == 4 // size


def dense(t):
    """Contiguous, or channels-last contiguous (the entry copies it)."""
    return t.is_contiguous() or t.is_contiguous(memory_format=torch.channels_last)


def ddpm_and_adm_calls(monkeypatch):
    """Every call of the fused entry in one no-grad forward of a 4-stage
    DDPM FDN-UNet and of the small ADM (CPU, 32 px), as (mode, x dense,
    scale and shift in a layout of their mode the entry takes, no affine,
    groups, eps)."""
    from fea_tpu_torch.models import make_adm_diffusion_model, make_diffusion_model

    seen = []

    def recorder(x, gamma, beta, scale, shift, groups, eps):
        mode = modulation(x, scale, shift)
        layout = (dense(scale) and dense(shift) if mode == "pixel"
                  else scale.stride(1) == shift.stride(1) == 1)
        seen.append((mode, dense(x), layout, gamma is None, groups, eps))
        return group_norm_modulated_silu(x, gamma, beta, scale, shift, groups, eps)

    monkeypatch.setattr(blocks, "group_norm_modulated_silu", recorder)
    gen = torch.Generator().manual_seed(0)
    ddpm = make_diffusion_model(image_size=32, input_dim=8, num_stages=4, device="cpu",
                                generator=gen, use_flash_attention=True)
    x, cond = draw(2, 32, 32, 2, seed=1), draw(2, 32, 32, 5, seed=2)
    with torch.no_grad():
        ddpm.model(x, cond, time=torch.tensor([3.0, 9.0]))
    ddpm_calls, seen[:] = list(seen), []
    admd = make_adm_diffusion_model(32, device="cpu", generator=gen, model_channels=64,
                                    channel_mult=(1, 2), attention_resolutions=(2,))
    with torch.no_grad():
        admd.model(x, cond, torch.tensor([5.0, 7.0]))
    res_blocks = sum(isinstance(m, adm.ResBlock) for m in admd.model.modules())
    return ddpm_calls, list(seen), res_blocks


def test_main_path_gives_the_entry_its_calls_and_layouts(monkeypatch):
    """A DDPM forward makes 29 calls: 20 per pixel without affine (the
    FDN's: 4 in each of 4 down stages, 4 in the middle) and 9 per channel
    with it (block1 of the 8 up blocks and of final_resnet); ADM one per
    channel for each ResBlock. x and per-pixel scale and shift are NCHW or
    channels-last (the first stage's, from the NHWC input) without gaps,
    per-channel ones at channel stride 1."""
    ddpm, adm_calls, res_blocks = ddpm_and_adm_calls(monkeypatch)
    assert [c[:4] for c in ddpm].count(("pixel", True, True, True)) == 20
    assert [c[:4] for c in ddpm].count(("channel", True, True, False)) == 9
    assert len(ddpm) == 29 and {c[4:] for c in ddpm} == {(8, 1e-6)}
    assert adm_calls == [("channel", True, True, False, 32, 1e-5)] * res_blocks


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# (mode, shape, affine, groups): the DDPM's stage-0 FDN call (cluster route,
# 16 blocks of a 2 MiB slab, 96 KiB kept in f32) and its 32 px one, a slab
# of 4 MiB in f32 (two-pass route, 16-byte vectors), ADM's stage-0 and 8 px
# calls, a ragged HW (two-pass, one element a thread) and HW 36 (two-pass
# in bf16 only)
CUDA_CASES = [
    ("pixel", (2, 64, 256, 256), False, 8),
    ("pixel", (2, 512, 32, 32), False, 8),
    ("channel", (2, 128, 256, 256), True, 8),
    ("channel", (2, 256, 256, 256), True, 32),
    ("channel", (2, 2048, 8, 8), True, 32),
    ("pixel", (3, 48, 7, 9), False, 8),
    ("channel", (3, 48, 7, 9), True, 8),
    ("pixel", (2, 64, 6, 6), True, 8),
]


def cuda_want(args, groups, dtype):
    """The plain version in f32, rounded once to x's type."""
    f32 = [None if t is None else t.float() for t in args]
    return group_norm_modulated_silu_reference(*f32, groups, EPS[groups]).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode, shape, affine, groups", CUDA_CASES)
def test_cuda_modulated_matches_plain(cuda, mode, shape, affine, groups, dtype):
    """Both modes on both routes against the plain version: f32 at the
    unmodulated forward's tolerance, bf16 within one rounding; y keeps x's
    layout and type, and each call counts one launch."""
    args = case(mode, shape, affine, seed=3, dtype=dtype, device=cuda)
    before = group_norm_modulated_silu.launches
    with torch.no_grad():
        got = group_norm_modulated_silu(*args, groups, EPS[groups])
    torch.cuda.synchronize()
    assert group_norm_modulated_silu.launches == before + 1
    assert got.dtype == dtype and got.stride() == args[0].stride()
    want = cuda_want(args, groups, dtype)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **FWD_TOL)
    else:
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("mode", ["pixel", "channel"])
def test_cuda_modulated_is_deterministic_on_either_route(cuda, mode, offset):
    """The same bits from run to run on the cluster route and, with scale
    one element off 16 bytes (per pixel) or x (per channel), on the two-pass
    route."""
    x, gamma, beta, scale, shift = case(mode, (2, 64, 64, 64), True, seed=4, device=cuda)
    if offset:
        moved = scale if mode == "pixel" else x
        moved = torch.cat([moved.new_zeros(1), moved.flatten()])[1:].view(moved.shape)
        scale, x = (moved, x) if mode == "pixel" else (scale, moved)
    address = x.data_ptr() | scale.data_ptr() | shift.data_ptr() if mode == "pixel" else None
    assert forward_plan(x, 8, address).route == ("two_pass" if offset else "cluster")
    with torch.no_grad():
        first = group_norm_modulated_silu(x, gamma, beta, scale, shift, 8, 1e-6)
        for _ in range(3):
            again = group_norm_modulated_silu(x, gamma, beta, scale, shift, 8, 1e-6)
            torch.cuda.synchronize()
            assert torch.equal(first, again)
    torch.testing.assert_close(first, cuda_want((x, gamma, beta, scale, shift), 8, x.dtype),
                               **FWD_TOL)


@pytest.mark.gpu
def test_cuda_counts_under_graph_capture_and_replay(cuda):
    """Calls recorded in a CUDA graph count nothing while recorded and one
    each at every replay; the replays give the eager call's bits."""
    args = case("pixel", (2, 64, 32, 32), False, seed=5, device=cuda)
    per_channel = case("channel", (2, 64, 32, 32), True, seed=6, device=cuda)

    def fn():
        with torch.no_grad():
            return (group_norm_modulated_silu(*args, 8, 1e-6),
                    group_norm_modulated_silu(*per_channel, 8, 1e-6))

    eager = fn()
    before = group_norm_modulated_silu.launches
    block = graphs.capture(fn, fn, cuda)
    try:
        assert group_norm_modulated_silu.launches == before + 2  # the warm-up's
        for i in range(3):
            block.replay()
            assert group_norm_modulated_silu.launches == before + 4 + 2 * i
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(block.output, eager))
    finally:
        block.close()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 256, 256), (2, 512, 32, 32), (3, 48, 7, 9)])
def test_cuda_unmodulated_forward_unchanged(cuda, shape, dtype):
    """`group_norm_silu` keeps its counter and its bits: the modulated
    forward with scale and shift 0 multiplies by 1 and adds 0, so it gives
    the unmodulated forward's y exactly, in both modes."""
    x, gamma, beta, scale, shift = case("pixel", shape, True, seed=7, dtype=dtype, device=cuda)
    zeros = torch.zeros_like(scale)
    before = (group_norm_silu.launches_fwd, group_norm_modulated_silu.launches)
    with torch.no_grad():
        y = group_norm_silu(x, gamma, beta, 8)
        pixel = group_norm_modulated_silu(x, gamma, beta, zeros, zeros, 8, 1e-6)
        z = torch.zeros((shape[0], 2 * shape[1], 1, 1), device=cuda, dtype=dtype)
        channel = group_norm_modulated_silu(x, gamma, beta, *z.chunk(2, dim=1), 8, 1e-6)
    torch.cuda.synchronize()
    assert (group_norm_silu.launches_fwd, group_norm_modulated_silu.launches) == (
        before[0] + 1, before[1] + 2)
    assert torch.equal(pixel, y) and torch.equal(channel, y)


@pytest.mark.gpu
def test_cuda_modulated_raises_on_bad_input(cuda):
    x, gamma, beta, scale, shift = case("pixel", (2, 16, 8, 8), True, device=cuda)
    with pytest.raises(ValueError):  # per-channel scale at channel stride 2
        wide = torch.zeros((2, 32, 1, 1), device=cuda)[:, ::2]
        group_norm_modulated_silu(x, gamma, beta, wide, wide, 8, 1e-6)
    with pytest.raises(ValueError):  # scale on the CPU
        group_norm_modulated_silu(x, gamma, beta, scale.cpu(), shift, 8, 1e-6)
    with pytest.raises(TypeError):
        group_norm_modulated_silu(x.half(), gamma, beta, scale.half(), shift.half(), 8, 1e-6)
    with pytest.raises(ValueError):  # 16 channels in 3 groups
        group_norm_modulated_silu(x, gamma, beta, scale, shift, 3, 1e-6)
    with pytest.raises(RuntimeError):  # a gradient is needed
        group_norm_modulated_silu(x.requires_grad_(), gamma, beta, scale, shift, 8, 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["pixel", "channel"])
def test_cuda_copies_channels_last_operands(cuda, mode):
    """Channels-last x (and per-pixel scale and shift), as the FDN's first
    stage hands them over: copied to contiguous NCHW, so that y comes back
    contiguous NCHW, as PyTorch's chain gives it on the card, and equal to
    the plain version."""
    x, gamma, beta, scale, shift = case(mode, (2, 64, 32, 32), False, seed=8, device=cuda)
    x = x.contiguous(memory_format=torch.channels_last)
    if mode == "pixel":
        scale, shift = (t.contiguous(memory_format=torch.channels_last) for t in (scale, shift))
    with torch.no_grad():
        got = group_norm_modulated_silu(x, gamma, beta, scale, shift, 8, 1e-6)
        chain = group_norm_modulated_silu_reference(x, gamma, beta, scale, shift, 8, 1e-6)
    torch.cuda.synchronize()
    assert got.is_contiguous() and chain.is_contiguous()
    torch.testing.assert_close(got, cuda_want((x, gamma, beta, scale, shift), 8, x.dtype),
                               **FWD_TOL)
