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
from fea_tpu_torch.ops.fused_norm import group_norm_silu_reference

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
    channels-last layout of the port's convolution outputs)."""
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# the decoder's stage shapes at batch 2, a ragged HW, and C/G = 2
CUDA_SHAPES = [(2, 256, 256, 64), (2, 32, 32, 512), (3, 7, 9, 48), (2, 5, 7, 16)]
BF16_TOL = dict(atol=1e-2, rtol=1e-2)  # y, dx: one bf16 rounding (2^-8 relative)


def cuda_case(cuda, shape, layout, dtype, seed=2):
    x, gamma, beta, ct = (torch.from_numpy(a).to(cuda) for a in inputs(shape, seed))
    x, ct = (t.permute(0, 3, 1, 2).to(dtype) for t in (x, ct))
    if layout == "nchw":
        x = x.contiguous()
    return x, gamma, beta, ct


def vjp(fn, x, gamma, beta, ct):
    x, gamma, beta = (t.detach().clone().requires_grad_() for t in (x, gamma, beta))
    y = fn(x, gamma, beta, G)
    y.backward(ct)
    return y.detach(), x.grad, gamma.grad, beta.grad


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_kernels_match_plain(cuda, shape, layout, dtype):
    """f32: forward atol 5e-5 / rtol 1e-4, VJP relative 1e-4; bf16: y and
    dx within one bf16 rounding (atol 1e-2, rtol 1e-2), dgamma and dbeta
    (f32 sums) relative 1e-3. y and dx keep x's layout; each call counts
    one launch."""
    x, gamma, beta, ct = cuda_case(cuda, shape, layout, dtype)
    before = (group_norm_silu.launches_fwd, group_norm_silu.launches_bwd)
    got = vjp(group_norm_silu, x, gamma, beta, ct)
    torch.cuda.synchronize()
    assert (group_norm_silu.launches_fwd, group_norm_silu.launches_bwd) == (
        before[0] + 1, before[1] + 1)
    want = vjp(group_norm_silu_reference, x, gamma, beta, ct)
    assert got[0].stride() == x.stride() and got[1].stride() == x.stride()
    assert got[0].dtype == got[1].dtype == dtype
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
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_kernels_take_bf16_params(cuda, shape):
    """bf16 x with bf16 gamma and beta, as the bf16 trainer passes them:
    y and dx as in the bf16 case above; dgamma and dbeta come back bf16,
    one bf16 rounding of f32 sums (at most 2^-7 of an element) off."""
    x, gamma, beta, ct = cuda_case(cuda, shape, "channels_last", torch.bfloat16)
    gamma, beta = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
    got = vjp(group_norm_silu, x, gamma, beta, ct)
    want = vjp(group_norm_silu_reference, x, gamma, beta, ct)
    assert [t.dtype for t in got] == [torch.bfloat16] * 4
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g.float(), w.float(), **BF16_TOL)
    for g, w in zip(got[2:], want[2:]):
        assert float((g.float() - w.float()).abs().max() / w.float().abs().max()) < 1e-2


@pytest.mark.gpu
def test_cuda_backward_takes_a_channel_slice_of_dy(cuda):
    """dy as autograd hands it over from a concatenation: a channel slice of
    a channels-last gradient, neither layout; the kernel reads its strides."""
    x, gamma, beta, ct = cuda_case(cuda, (2, 16, 16, 64), "channels_last", torch.float32)
    wide = torch.cat([ct, ct], dim=1)[:, 32:96]
    assert not wide.is_contiguous() and not wide.is_contiguous(memory_format=torch.channels_last)
    got = vjp(group_norm_silu, x, gamma, beta, wide)
    want = vjp(group_norm_silu_reference, x, gamma, beta, wide)
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w).abs().max() / w.abs().max()) < VJP_REL


@pytest.mark.gpu
def test_cuda_wrapper_raises_on_bad_input(cuda):
    x, gamma, beta, _ = cuda_case(cuda, (2, 8, 8, 16), "channels_last", torch.float32)
    with pytest.raises(ValueError):  # neither layout
        group_norm_silu(x.transpose(2, 3), gamma, beta, G)
    with pytest.raises(ValueError):  # 16 channels in 3 groups
        group_norm_silu(x, gamma, beta, 3)
    with pytest.raises(TypeError):
        group_norm_silu(x.half(), gamma, beta, G)
    with pytest.raises(ValueError):  # gamma on the CPU
        group_norm_silu(x, gamma.cpu(), beta, G)
