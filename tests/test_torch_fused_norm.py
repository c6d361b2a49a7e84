"""The port's fused GroupNorm + affine + SiLU (fea_tpu_torch.ops.fused_norm)
against fea_tpu's Pallas kernel, run in interpret mode on the CPU, and
against flax's GroupNorm -> affine -> silu chain.

On CPU tensors the port's `group_norm_silu` takes its plain PyTorch version;
the CUDA kernels are compared with that plain version by the tests marked
`gpu`, which skip where there is no CUDA device. JAX is imported inside the
helpers, so that the `gpu` tests also run on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_fused_norm.py
"""

import numpy as np
import pytest
import torch

from fea_tpu_torch.ops import group_norm_silu
from fea_tpu_torch.ops.fused_norm import (
    ForwardPlan, _backward, _dy_strides, _forward, _layout, _vector_width, forward_plan,
    forward_route, group_norm_silu_reference,
)

torch.set_num_threads(1)

G = 8
# fea_tpu's own bounds (tests/test_models.py:195-233): forward atol 5e-5 /
# rtol 1e-4, each VJP output within 1e-4 of its largest magnitude
FWD_TOL = dict(atol=5e-5, rtol=1e-4)
VJP_REL = 1e-4


def inputs(shape, seed=0):
    """x and the output cotangent (B, H, W, C), gamma and beta (C,), f32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    gamma, beta = (rng.normal(size=shape[-1:]).astype(np.float32) for _ in range(2))
    ct = rng.normal(size=shape).astype(np.float32)
    return x, gamma, beta, ct


def jax_outputs(fn_name, x, gamma, beta, ct):
    """y and (dx, dgamma, dbeta) of sum(y * ct), NHWC f32 numpy, from
    fea_tpu's Pallas kernel ("pallas", interpret mode) or flax's chain
    ("flax")."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from fea_tpu.ops.fused_norm import group_norm_silu as pallas_gn

    with jax.enable_x64(False):
        xj, gj, bj, cj = (jnp.asarray(a) for a in (x, gamma, beta, ct))
        if fn_name == "pallas":
            def fn(x, gamma, beta):
                return pallas_gn(x, gamma, beta, G, 1e-6, True)
        else:
            gn = nn.GroupNorm(num_groups=G, use_bias=False, use_scale=False)
            variables = gn.init(jax.random.PRNGKey(0), xj)

            def fn(x, gamma, beta):
                return nn.silu(gn.apply(variables, x) * gamma + beta)
        y = fn(xj, gj, bj)
        grads = jax.grad(lambda *a: jnp.sum(fn(*a) * cj), argnums=(0, 1, 2))(xj, gj, bj)
        return np.asarray(y), [np.asarray(g) for g in grads]


def port_outputs(fn, x, gamma, beta, ct):
    """The same from the port, fed an NCHW view of the NHWC arrays (the
    plain version takes any layout)."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    gt, bt = (torch.from_numpy(a).requires_grad_() for a in (gamma, beta))
    y = fn(xt, gt, bt, G)
    (y * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    to_nhwc = lambda t: t.detach().permute(0, 2, 3, 1).numpy()  # noqa: E731
    return to_nhwc(y), [to_nhwc(xt.grad), gt.grad.numpy(), bt.grad.numpy()]


def assert_vjp_close(got, want):
    for g, w in zip(got, want):
        scale = max(float(np.abs(w).max()), 1e-6)
        assert float(np.abs(g - w).max()) / scale < VJP_REL


@pytest.fixture(scope="module")
def stage_case():
    """(2, 32, 32, 64), fea_tpu's own test shape, and both JAX outputs."""
    args = inputs((2, 32, 32, 64))
    return args, {name: jax_outputs(name, *args) for name in ("pallas", "flax")}


@pytest.mark.parametrize("want", ["pallas", "flax"])
@pytest.mark.parametrize("fn", [group_norm_silu, group_norm_silu_reference])
def test_matches_fea_tpu(stage_case, fn, want):
    """Forward atol 5e-5 / rtol 1e-4, VJP relative 1e-4 (f32): only the
    order of summation differs."""
    args, outputs = stage_case
    y, grads = port_outputs(fn, *args)
    y_want, grads_want = outputs[want]
    np.testing.assert_allclose(y, y_want, **FWD_TOL)
    assert_vjp_close(grads, grads_want)


def test_plain_version_at_ragged_hw():
    """HW 35, C/G 2: the Pallas kernel asserts HW % 1024 == 0, the port
    takes any HW; held against flax's chain at fea_tpu's tolerances."""
    args = inputs((2, 5, 7, 16), seed=1)
    y, grads = port_outputs(group_norm_silu_reference, *args)
    y_want, grads_want = jax_outputs("flax", *args)
    np.testing.assert_allclose(y, y_want, **FWD_TOL)
    assert_vjp_close(grads, grads_want)


def test_cpu_wrapper_does_not_count_launches():
    x, gamma, beta, _ = (torch.from_numpy(a) for a in inputs((1, 4, 4, 16)))
    before = (group_norm_silu.launches_fwd, group_norm_silu.launches_bwd)
    group_norm_silu(x.permute(0, 3, 1, 2), gamma, beta, G)
    assert (group_norm_silu.launches_fwd, group_norm_silu.launches_bwd) == before


def nchw_view(shape, dtype=torch.float32):
    """A (B, C, H, W) view of channels-last memory of NHWC `shape`."""
    return torch.zeros(shape, dtype=dtype).permute(0, 3, 1, 2)


def channel_slice(shape, offset, dtype=torch.float32):
    """Channels offset .. offset + C of a contiguous NCHW gradient twice as
    wide, as autograd hands a concatenation's gradient over."""
    b, h, w, c = shape
    return torch.zeros((b, 2 * c, h, w), dtype=dtype)[:, offset:offset + c]


@pytest.mark.parametrize("dtype, shape, dy, want", [
    (torch.float32, (2, 4, 4, 64), None, 4),  # vectors along HW 16
    (torch.bfloat16, (2, 4, 4, 64), None, 8),
    (torch.bfloat16, (2, 2, 3, 64), None, 2),  # HW 6
    (torch.float32, (3, 7, 9, 48), None, 1),  # HW 63
    (torch.float32, (2, 5, 5, 16), 1, 1),  # HW 25: every offset
    (torch.float32, (2, 4, 4, 64), 1, 4),  # a channel is 64 bytes
    (torch.float32, (2, 4, 4, 64), "channels_last", 1),  # dy's position stride
    (torch.bfloat16, (2, 4, 4, 64), "channels_last", 1),
    (torch.bfloat16, (2, 4, 4, 64), 1, 8),  # a channel is 32 bytes
    (torch.bfloat16, (2, 2, 3, 64), 1, 2),  # 12 bytes in
    (torch.float32, (2, 2, 2, 64), 1, 4),  # HW 4, 16 bytes in
    (torch.float32, (2, 1, 2, 64), None, 2),  # HW 2
    (torch.bfloat16, (2, 2, 2, 64), None, 4),  # HW 4: 8 bytes
    (torch.float32, (2, 2, 3, 64), 1, 2),  # HW 6, 24 bytes in
    (torch.float32, (2, 1, 1, 64), None, 1),  # HW 1
    (torch.bfloat16, (2, 1, 3, 64), None, 1),  # HW 3
])
def test_backward_vector_width(dtype, shape, dy, want):
    """The backward's vector: the widest of 16 bytes, 2 and 1 elements that
    HW, dy's strides and every pointer's alignment allow."""
    x = nchw_view(shape, dtype).contiguous()
    if dy is None:
        dyt = torch.zeros_like(x)
    elif dy == "channels_last":
        dyt = nchw_view(shape, dtype)
    else:
        dyt = channel_slice(shape, dy, dtype)
    dx = torch.empty_like(x)
    _layout(x)
    assert _vector_width(x, dyt, dx, _dy_strides(dyt, x.shape)) == want


# an H100 as plain numbers: SMs, and the shared memory one block may ask for
H100 = (132, 232448)
KIB = 1024
# the decoder's stages (HW, C) at 256 px with, per element size, the cluster
# the forward takes there and the bytes of x each of its blocks takes and
# keeps in shared memory
STAGE_ROUTES = {
    (65536, 64): {4: (16, 128 * KIB, 96 * KIB), 2: (16, 64 * KIB, 64 * KIB)},
    (16384, 128): {4: (16, 64 * KIB, 64 * KIB), 2: (8, 64 * KIB, 64 * KIB)},
    (4096, 256): {4: (8, 64 * KIB, 64 * KIB), 2: (4, 64 * KIB, 64 * KIB)},
    (1024, 512): {4: (4, 64 * KIB, 64 * KIB), 2: (2, 64 * KIB, 64 * KIB)},
}


@pytest.mark.parametrize("size", [4, 2])
@pytest.mark.parametrize("batch", [2, 4, 16])
@pytest.mark.parametrize("stage", list(STAGE_ROUTES))
def test_forward_route(stage, batch, size):
    """At every stage shape and batch of the main path, f32 and bf16, a
    (b, group) slab goes to one cluster on an H100: the smallest cluster
    whose blocks take at most 64 KiB of x, and 16 blocks of 128 KiB, of
    which each keeps 96 KiB, for the 2 MiB f32 slabs of the first stage;
    16-byte vectors; the shared memory asked for is what a block keeps plus
    the (a, b) table of C/G channels, under the limit."""
    hw, c = stage
    cluster, share, held = STAGE_ROUTES[stage][size]
    plan = forward_route(batch, c, hw, G, size, 0, *H100)
    assert plan == ForwardPlan("cluster", 16 // size, cluster, held + c // G * 8, 0, 0)
    assert c // G * hw * size == cluster * share
    assert plan.smem_bytes <= H100[1]


def offset_view(shape, dtype, offset):
    """Contiguous NCHW x of NHWC `shape` that starts `offset` elements into
    its (64-byte aligned) storage."""
    b, h, w, c = shape
    return torch.zeros(b * c * h * w + offset, dtype=dtype)[offset:].view(b, c, h, w)


@pytest.mark.parametrize("shape, dtype, offset, sms_smem, want", [
    # HW 63, C/G 6: no vector divides HW
    ((3, 7, 9, 48), torch.float32, 0, H100, ForwardPlan("two_pass", 1, 0, 0, 1, 63)),
    ((3, 7, 9, 48), torch.bfloat16, 0, H100, ForwardPlan("two_pass", 1, 0, 0, 1, 63)),
    # views that start 4, 8 and 16 bytes into aligned memory
    ((2, 16, 16, 64), torch.float32, 1, H100, ForwardPlan("two_pass", 1, 0, 0, 1, 256)),
    ((2, 16, 16, 64), torch.float32, 2, H100, ForwardPlan("two_pass", 2, 0, 0, 1, 256)),
    ((2, 16, 16, 64), torch.bfloat16, 2, H100, ForwardPlan("two_pass", 2, 0, 0, 1, 256)),
    ((2, 16, 16, 64), torch.bfloat16, 4, H100, ForwardPlan("two_pass", 4, 0, 0, 1, 256)),
    ((2, 16, 16, 64), torch.float32, 4, H100, ForwardPlan("cluster", 4, 1, 64 + 8 * KIB, 0, 0)),
    # a slab of 8 MiB: a block of the largest cluster would keep under half
    # of its 512 KiB; two passes over 16-byte vectors, 16 vectors a thread
    ((1, 512, 512, 64), torch.float32, 0, H100, ForwardPlan("two_pass", 4, 0, 0, 16, 16384)),
    # a slab of 3 MiB: blocks take 192 KiB and keep 96 KiB
    ((1, 256, 384, 64), torch.float32, 0, H100,
     ForwardPlan("cluster", 4, 16, 64 + 96 * KIB, 0, 0)),
    # blocks that may have 64 KiB cannot keep 96 KiB of a 128 KiB share
    ((2, 256, 256, 64), torch.float32, 0, (84, 65536),
     ForwardPlan("two_pass", 4, 0, 0, 4, 16384)),
    ((2, 256, 256, 64), torch.bfloat16, 0, (84, 101376),
     ForwardPlan("cluster", 8, 16, 64 + 64 * KIB, 0, 0)),
    # HW 36 is a multiple of 4 but not of 8; the slab of 8 x 36 bf16 does
    # not split into two shares of whole 16-byte vectors
    ((2, 6, 6, 64), torch.bfloat16, 0, H100, ForwardPlan("two_pass", 4, 0, 0, 1, 36)),
    ((2, 6, 6, 64), torch.float32, 0, H100, ForwardPlan("cluster", 4, 1, 64 + 1152, 0, 0)),
])
def test_forward_route_elsewhere(shape, dtype, offset, sms_smem, want):
    """Ragged HW, unaligned views, slabs too large for a cluster and a
    device with too little shared memory take the two-pass route, at the
    widest vector HW and x's address allow; no plan asks for more shared
    memory than the device's limit."""
    x = offset_view(shape, dtype, offset)
    _layout(x)
    b, c, h, w = x.shape
    plan = forward_route(b, c, h * w, G, x.element_size(), x.data_ptr(), *sms_smem)
    assert plan == want
    assert plan.smem_bytes <= sms_smem[1]


def test_other_layouts_raise():
    """The kernels take contiguous NCHW and copy nothing: a channels-last
    view or any other stride pattern raises."""
    x = nchw_view((2, 4, 4, 16))
    _layout(x.contiguous())
    for other in (x, x.contiguous().transpose(2, 3)):
        with pytest.raises(ValueError):
            _layout(other)


def test_model_paths_give_the_kernels_their_layouts(monkeypatch):
    """Every GroupNorm+SiLU call on the model paths (the DDPM's FDNUNet with
    flash attention, its training loss and backward, and the regression
    predictor) gets x in the layout the kernels take: contiguous NCHW, as
    the attention and space-to-depth steps leave it."""
    import fea_tpu_torch.models.blocks as blocks
    from fea_tpu_torch.models import create_models, make_diffusion_model, predict

    seen = []

    def recorder(x, gamma, beta, num_groups, eps):
        seen.append(x.is_contiguous())
        return group_norm_silu_reference(x, gamma, beta, num_groups, eps)

    monkeypatch.setattr(blocks, "group_norm_silu", recorder)
    size = 16
    rng = np.random.default_rng(0)
    cond, x0 = (torch.from_numpy(rng.normal(size=(2, size, size, c)).astype(np.float32))
                for c in (5, 2))
    gen = torch.Generator().manual_seed(0)
    diffusion = make_diffusion_model(image_size=size, input_dim=8, num_stages=3, device="cpu",
                                     generator=gen, use_flash_attention=True)
    with torch.no_grad():
        diffusion.model(x0, cond, time=torch.tensor([3.0, 9.0]))
    flash_calls = len(seen)
    diffusion.model.use_flash_attention = False
    for module in diffusion.model.modules():
        if hasattr(module, "use_flash"):
            module.use_flash = False
    diffusion.loss(x0, cond, generator=gen).backward()
    encoder, decoder, _ = create_models(
        input_dim=8, image_height=size, image_width=size, num_channels=2,
        num_auxiliary_condition_channels=3, num_stages=3, device="cpu", generator=gen)
    geometry = torch.where(torch.from_numpy(rng.random((2, size, size, 1))) > 0.5, 1.0, -1.0)
    predict(encoder, decoder, x0, cond[..., :3], geometry.float())
    assert flash_calls > 0 and len(seen) > 2 * flash_calls
    assert all(seen)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# the decoder's stage shapes at batch 2, a ragged HW with C/G 6, and C/G 2
CUDA_SHAPES = [(2, 256, 256, 64), (2, 32, 32, 512), (3, 7, 9, 48), (2, 5, 7, 16)]
BF16_TOL = dict(atol=1e-2, rtol=1e-2)  # y, dx: one bf16 rounding (2^-8 relative)
# the decoder's stages (H, W, C) at 256 px
STAGES = [(256, 256, 64), (128, 128, 128), (64, 64, 256), (32, 32, 512)]


def cuda_case(cuda, shape, dtype, seed=2):
    """x and the cotangent contiguous NCHW, gamma and beta f32."""
    x, gamma, beta, ct = (torch.from_numpy(a).to(cuda) for a in inputs(shape, seed))
    x, ct = (t.permute(0, 3, 1, 2).to(dtype).contiguous() for t in (x, ct))
    return x, gamma, beta, ct


def vjp(fn, x, gamma, beta, ct):
    x, gamma, beta = (t.detach().clone().requires_grad_() for t in (x, gamma, beta))
    y = fn(x, gamma, beta, G)
    y.backward(ct)
    return y.detach(), x.grad, gamma.grad, beta.grad


def assert_matches_plain(got, want, dtype):
    """f32: forward atol 5e-5 / rtol 1e-4, VJP relative 1e-4; bf16: y and
    dx within one bf16 rounding (atol 1e-2, rtol 1e-2), dgamma and dbeta
    (f32 sums) relative 1e-3."""
    if dtype == torch.float32:
        torch.testing.assert_close(got[0], want[0], **FWD_TOL)
        rel = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got[1:], want[1:])]
        assert max(rel) < VJP_REL, rel
    else:
        for g, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(g.float(), w.float(), **BF16_TOL)
        for g, w in zip(got[2:], want[2:]):
            assert float((g - w).abs().max() / w.abs().max()) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_kernels_match_plain(cuda, shape, dtype):
    """Tolerances of assert_matches_plain. y and dx keep x's layout; each
    call counts one launch."""
    x, gamma, beta, ct = cuda_case(cuda, shape, dtype)
    before = (group_norm_silu.launches_fwd, group_norm_silu.launches_bwd)
    got = vjp(group_norm_silu, x, gamma, beta, ct)
    torch.cuda.synchronize()
    assert (group_norm_silu.launches_fwd, group_norm_silu.launches_bwd) == (
        before[0] + 1, before[1] + 1)
    want = vjp(group_norm_silu_reference, x, gamma, beta, ct)
    assert got[0].stride() == x.stride() and got[1].stride() == x.stride()
    assert got[0].dtype == got[1].dtype == dtype
    assert_matches_plain(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("batch", [2, 4, 16])
def test_cuda_autograd_at_main_path_batches(cuda, batch, stage, dtype):
    """The autograd path at every batch the sampler, predictor, diffusion
    step and regression step give it, at the decoder's stage shapes, where
    the backward's vector is 16 bytes wide; called twice."""
    x, gamma, beta, ct = cuda_case(cuda, (batch, *stage), dtype, seed=batch)
    want = vjp(group_norm_silu_reference, x, gamma, beta, ct)
    for _ in range(2):
        got = vjp(group_norm_silu, x, gamma, beta, ct)
        torch.cuda.synchronize()
        assert_matches_plain(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_at_six_channels_a_group(cuda, dtype):
    """C/G 6 and HW 63: no vector wider than 1 divides HW; the kernel takes
    one element a thread."""
    x, gamma, beta, ct = cuda_case(cuda, (3, 7, 9, 48), dtype, seed=5)
    assert _vector_width(x, ct, torch.empty_like(x), _dy_strides(ct, x.shape)) == 1
    assert_matches_plain(vjp(group_norm_silu, x, gamma, beta, ct),
                         vjp(group_norm_silu_reference, x, gamma, beta, ct), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_kernels_take_bf16_params(cuda, shape):
    """bf16 x with bf16 gamma and beta, as the bf16 trainer passes them:
    y and dx as in the bf16 case above; dgamma and dbeta come back bf16,
    one bf16 rounding of f32 sums (at most 2^-7 of an element) off."""
    x, gamma, beta, ct = cuda_case(cuda, shape, torch.bfloat16)
    gamma, beta = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
    got = vjp(group_norm_silu, x, gamma, beta, ct)
    want = vjp(group_norm_silu_reference, x, gamma, beta, ct)
    assert [t.dtype for t in got] == [torch.bfloat16] * 4
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g.float(), w.float(), **BF16_TOL)
    for g, w in zip(got[2:], want[2:]):
        assert float((g.float() - w.float()).abs().max() / w.float().abs().max()) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_takes_dy_in_the_other_layout(cuda, dtype):
    """NCHW x with a channels-last dy: the kernel reads dy through its
    strides, one element at a time."""
    x, gamma, beta, ct = cuda_case(cuda, (2, 16, 16, 64), dtype)
    ct = ct.contiguous(memory_format=torch.channels_last)
    assert_matches_plain(vjp(group_norm_silu, x, gamma, beta, ct),
                         vjp(group_norm_silu_reference, x, gamma, beta, ct), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 2, 32])
@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (2, 5, 5, 64)])
def test_cuda_backward_takes_a_channel_slice_of_dy(cuda, shape, offset, dtype):
    """dy as autograd hands it over from a concatenation: a channel slice of
    a contiguous gradient, starting `offset` channels in. At HW 25 every
    offset puts its pointer off a vector's alignment."""
    x, gamma, beta, ct = cuda_case(cuda, shape, dtype)
    wide = torch.cat([ct, ct], dim=1)[:, offset:offset + 64]
    assert not wide.is_contiguous()
    got = vjp(group_norm_silu, x, gamma, beta, wide)
    want = vjp(group_norm_silu_reference, x, gamma, beta, wide)
    assert_matches_plain(got, want, dtype)


def plain_mean_rstd(x):
    xg = x.float().reshape(x.shape[0], G, -1)
    mean = xg.mean(-1)
    var = (xg.square().mean(-1) - mean.square()).clamp_min(0.0)
    return mean, torch.rsqrt(var + 1e-6)


# NHWC shape, elements x starts into aligned memory, and the route and
# vector that this forces on the forward: a stage shape (one cluster per
# slab), a slab of 3 MiB (f32: its blocks keep half of their share), a
# single block per slab, slabs of 8 MiB, a ragged HW, and views 4 and 8
# bytes off
ROUTE_CASES = [
    ((4, 64, 64, 256), 0, "cluster", None),
    ((1, 256, 384, 64), 0, "cluster", None),
    ((2, 16, 16, 64), 0, "cluster", None),
    ((1, 512, 512, 64), 0, "two_pass", None),
    ((3, 7, 9, 48), 0, "two_pass", 1),
    ((2, 16, 16, 64), 1, "two_pass", 1),
    ((2, 16, 16, 64), 2, "two_pass", 2),
]


def route_case(cuda, shape, offset, dtype):
    x, gamma, beta, _ = cuda_case(cuda, shape, dtype, seed=3)
    if offset:
        x = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(x.shape)
    return x, gamma, beta


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, offset, route, vec", ROUTE_CASES)
def test_cuda_forward_routes_match_plain(cuda, shape, offset, route, vec, dtype):
    """Each route of the forward at a shape that forces it: y against the
    plain version (f32 atol 5e-5 / rtol 1e-4, bf16 one rounding), and the
    coefficients it saves for the backward against the plain version's mean
    and rstd (rtol 1e-5: f32 sums in another order) and gamma, beta."""
    x, gamma, beta = route_case(cuda, shape, offset, dtype)
    plan = forward_plan(x, G)
    assert plan.route == route and (vec is None or plan.vec == vec)
    y, coef = _forward(x, gamma, beta, G, 1e-6)
    torch.cuda.synchronize()
    want = group_norm_silu_reference(x, gamma, beta, G)
    tol = FWD_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(y.float(), want.float(), **tol)
    cg = x.shape[1] // G
    mean, rstd = plain_mean_rstd(x)
    for ch in range(cg):  # every channel of a group carries the group's
        torch.testing.assert_close(coef[:, ch::cg, 2], mean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(coef[:, ch::cg, 3], rstd, rtol=1e-5, atol=0)
    a = rstd.repeat_interleave(cg, 1) * gamma
    torch.testing.assert_close(coef[..., 0], a, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(coef[..., 1], beta - mean.repeat_interleave(cg, 1) * a,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, offset, route, vec", ROUTE_CASES)
def test_cuda_forward_is_deterministic(cuda, shape, offset, route, vec, dtype):
    """Two runs on the same input give the same bits, y and coef, on either
    route: the sums are taken in a fixed order, whichever block ends last."""
    x, gamma, beta = route_case(cuda, shape, offset, dtype)
    assert forward_plan(x, G).route == route
    first = _forward(x, gamma, beta, G, 1e-6)
    for _ in range(3):
        again = _forward(x, gamma, beta, G, 1e-6)
        torch.cuda.synchronize()
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.gpu
def test_cuda_wrapper_raises_on_bad_input(cuda):
    x, gamma, beta, _ = cuda_case(cuda, (2, 8, 8, 16), torch.float32)
    for other in (x.transpose(2, 3), x.contiguous(memory_format=torch.channels_last)):
        with pytest.raises(ValueError):  # not contiguous NCHW
            group_norm_silu(other, gamma, beta, G)
    with pytest.raises(ValueError):  # 16 channels in 3 groups
        group_norm_silu(x, gamma, beta, 3)
    with pytest.raises(TypeError):
        group_norm_silu(x.half(), gamma, beta, G)
    with pytest.raises(ValueError):  # gamma on the CPU
        group_norm_silu(x, gamma.cpu(), beta, G)


@pytest.mark.gpu
def test_cuda_backward_on_two_streams(cuda):
    """Backward calls in flight at once on two streams: each call takes its
    own last-block tickets, so each matches the plain version."""
    cases = [cuda_case(cuda, (4, 64, 64, 256), torch.float32, seed=s) for s in (6, 7)]
    want = [vjp(group_norm_silu_reference, *case) for case in cases]
    coefs = [_forward(x, gamma, beta, G, 1e-6)[1] for x, gamma, beta, _ in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in cases]
    got = []
    for _ in range(3):
        for stream, (x, gamma, _, ct), coef in zip(streams, cases, coefs):
            with torch.cuda.stream(stream):
                got.append(_backward(x, gamma, coef, ct, G))
    torch.cuda.synchronize()
    for i, grads in enumerate(got):
        assert_matches_plain((want[i % 2][0], *grads), want[i % 2], torch.float32)
