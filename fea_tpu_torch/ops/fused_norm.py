"""Fused GroupNorm + affine + SiLU: y = silu(GroupNorm_G(x) * gamma + beta).

The port of fea_tpu/ops/fused_norm.py. `group_norm_silu` is a
torch.autograd.Function whose forward and backward are the hand-written
CUDA kernels of `csrc/group_norm_silu.cu` for CUDA tensors; CPU tensors take
the plain PyTorch version `group_norm_silu_reference`, through which
autograd runs. There is no fallback: a CUDA tensor the kernels do not take
raises.

x is (B, C, H, W), as the port's blocks hold activations: an NCHW view of
channels-last memory (what the convolutions return) or a contiguous NCHW
tensor; y comes back in x's layout. Statistics are f32 whatever x's type,
with var = max(E[x^2] - mean^2, 0) and flax's eps 1e-6. As in fea_tpu the
forward keeps only x, gamma and beta, and the backward recomputes the
statistics; it returns dx in x's type and dgamma, dbeta in gamma's type.
"""

import ctypes
import functools
import math
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ._build import build_library

DTYPES = (torch.float32, torch.bfloat16)
# blocks to aim for per SM in the partial-sum pass, and the fewest rows of
# HW a block reduces (channels-last blocks walk them in 8 lanes)
BLOCKS_PER_SM = 8
MIN_ROWS = {True: 64, False: 1024}


def group_norm_silu_reference(x, gamma, beta, num_groups: int = 8, eps: float = 1e-6):
    """The plain version: statistics over (B, G, C/G * HW) in f32 from sums
    and sums of squares, normalise, affine, SiLU, cast to x's type."""
    b, c = x.shape[:2]
    xg = x.float().reshape(b, num_groups, -1)
    n = xg.shape[-1]
    mean = xg.sum(-1, keepdim=True) / n
    var = (xg.square().sum(-1, keepdim=True) / n - mean.square()).clamp_min(0.0)
    xh = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    z = xh * gamma.float().reshape(shape) + beta.float().reshape(shape)
    return F.silu(z).to(x.dtype)


def build() -> Path:
    """Compile the kernels' library (at first use); its path."""
    return build_library("fea_group_norm_silu", ["group_norm_silu.cu"])


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build()))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.fea_group_norm_silu_fwd.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, p,
    ]
    lib.fea_group_norm_silu_fwd.restype = i
    lib.fea_group_norm_silu_bwd.argtypes = [
        p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, ll, ll, ll, i, f, p,
    ]
    lib.fea_group_norm_silu_bwd.restype = i
    lib.fea_cuda_error_string.argtypes = [i]
    lib.fea_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _layout(x) -> bool:
    """True for channels-last memory, False for contiguous NCHW; any other
    stride pattern raises (the kernels copy nothing)."""
    if x.is_contiguous(memory_format=torch.channels_last):
        return True
    if x.is_contiguous():
        return False
    raise ValueError(
        f"group_norm_silu takes channels-last or contiguous NCHW x; got strides "
        f"{x.stride()} for shape {tuple(x.shape)}"
    )


def _check_cuda_inputs(x, gamma, beta, num_groups):
    if not (x.device == gamma.device == beta.device) or x.device.type != "cuda":
        raise ValueError(
            f"group_norm_silu takes x, gamma, beta on one CUDA device or all on "
            f"the CPU; got {x.device}, {gamma.device}, {beta.device}"
        )
    if x.dtype not in DTYPES or gamma.dtype not in DTYPES or beta.dtype not in DTYPES:
        raise TypeError(
            f"group_norm_silu takes float32 or bfloat16; got {x.dtype}, "
            f"{gamma.dtype}, {beta.dtype}"
        )
    if x.ndim != 4 or min(x.shape) < 1:
        raise ValueError(f"group_norm_silu takes non-empty (B, C, H, W); got {tuple(x.shape)}")
    c = x.shape[1]
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(
            f"gamma {tuple(gamma.shape)} and beta {tuple(beta.shape)} are not ({c},)"
        )
    if num_groups < 1 or c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if x.shape[0] > 65535:
        raise ValueError(f"batch {x.shape[0]} exceeds the grid's 65535")


def _partition(x, channels_last: bool):
    """Chunks of HW for the partial-sum pass and the rows in each: enough
    blocks for BLOCKS_PER_SM per SM, each over at least MIN_ROWS rows."""
    b, c, h, w = x.shape
    hw = h * w
    blocks_per_chunk = b * (math.ceil(c / 32) if channels_last else c)
    target = BLOCKS_PER_SM * _sm_count(x.device.index or 0)
    chunks = max(1, min(math.ceil(target / blocks_per_chunk),
                        math.ceil(hw / MIN_ROWS[channels_last])))
    rows = math.ceil(hw / chunks)
    return math.ceil(hw / rows), rows


def _dy_strides(dy, shape):
    """dy's (batch, channel, flattened position) strides; its spatial dims
    must flatten (stride_h == W * stride_w)."""
    _, _, h, w = shape
    sb, sc, sh, sw = dy.stride()
    if w == 1:
        return sb, sc, sh
    if h == 1 or sh == w * sw:
        return sb, sc, sw
    raise ValueError(f"dy strides {dy.stride()} do not flatten H and W of {tuple(shape)}")


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(
            f"group_norm_silu {what} kernel launch failed: "
            + _library().fea_cuda_error_string(err).decode()
        )


def _scratch(x, chunks):
    b, c = x.shape[:2]
    partial = torch.empty((b, chunks, c, 2), device=x.device, dtype=torch.float32)
    coef = torch.empty((b, c, 4), device=x.device, dtype=torch.float32)
    return partial, coef


def _forward(x, gamma, beta, num_groups, eps):
    channels_last = _layout(x)
    b, c, h, w = x.shape
    chunks, rows = _partition(x, channels_last)
    partial, coef = _scratch(x, chunks)
    gamma32, beta32 = gamma.float().contiguous(), beta.float().contiguous()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _library().fea_group_norm_silu_fwd(
            x.data_ptr(), gamma32.data_ptr(), beta32.data_ptr(), y.data_ptr(),
            partial.data_ptr(), coef.data_ptr(), b, c, h * w, num_groups, chunks, rows,
            int(channels_last), int(x.dtype == torch.bfloat16), eps,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(err, "forward")
    group_norm_silu.launches_fwd += 1
    return y


def _backward(x, gamma, beta, dy, num_groups, eps):
    if dy.dtype != x.dtype or dy.shape != x.shape or dy.device != x.device:
        raise ValueError(
            f"dy {dy.dtype} {tuple(dy.shape)} on {dy.device} does not match x "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )
    channels_last = _layout(x)
    dy_sb, dy_sc, dy_sp = _dy_strides(dy, x.shape)
    b, c, h, w = x.shape
    chunks, rows = _partition(x, channels_last)
    partial, coef = _scratch(x, chunks)
    group_means = torch.empty((b, num_groups, 2), device=x.device, dtype=torch.float32)
    dgamma_b = torch.empty((b, c), device=x.device, dtype=torch.float32)
    dbeta_b = torch.empty((b, c), device=x.device, dtype=torch.float32)
    gamma32, beta32 = gamma.float().contiguous(), beta.float().contiguous()
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _library().fea_group_norm_silu_bwd(
            x.data_ptr(), gamma32.data_ptr(), beta32.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), dgamma_b.data_ptr(), dbeta_b.data_ptr(), partial.data_ptr(),
            coef.data_ptr(), group_means.data_ptr(), b, c, h * w, num_groups, chunks,
            rows, int(channels_last), dy_sb, dy_sc, dy_sp,
            int(x.dtype == torch.bfloat16), eps,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(err, "backward")
    group_norm_silu.launches_bwd += 1
    # per-batch partials summed outside the kernel, as fea_tpu does
    return dx, dgamma_b.sum(0).to(gamma.dtype), dbeta_b.sum(0).to(beta.dtype)


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps):
        ctx.save_for_backward(x, gamma, beta)
        ctx.num_groups, ctx.eps = num_groups, eps
        return _forward(x, gamma, beta, num_groups, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, gamma, beta = ctx.saved_tensors
        dx, dgamma, dbeta = _backward(x, gamma, beta, dy, ctx.num_groups, ctx.eps)
        return dx, dgamma, dbeta, None, None


def group_norm_silu(x, gamma, beta, num_groups: int = 8, eps: float = 1e-6):
    """silu(GroupNorm(x) * gamma + beta) for x (B, C, H, W) and gamma,
    beta (C,). CUDA tensors go through the CUDA kernels, and
    `group_norm_silu.launches_fwd` / `.launches_bwd` count their calls; CPU
    tensors go through the plain version."""
    if x.device.type == gamma.device.type == beta.device.type == "cpu":
        return group_norm_silu_reference(x, gamma, beta, num_groups, eps)
    _check_cuda_inputs(x, gamma, beta, num_groups)
    return _GroupNormSiLU.apply(x, gamma, beta, num_groups, eps)


group_norm_silu.launches_fwd = 0
group_norm_silu.launches_bwd = 0
