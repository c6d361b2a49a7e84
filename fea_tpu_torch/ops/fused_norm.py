"""Fused GroupNorm + affine + SiLU: y = silu(GroupNorm_G(x) * gamma + beta).

The port of fea_tpu/ops/fused_norm.py. `group_norm_silu` is a
torch.autograd.Function whose forward and backward are the hand-written
CUDA kernels of `csrc/group_norm_silu.cu` for CUDA tensors; CPU tensors take
the plain PyTorch version `group_norm_silu_reference`, through which
autograd runs. There is no fallback: a CUDA tensor the kernels do not take
raises.

x is contiguous (B, C, H, W), the layout every model path gives it (the
attention and space-to-depth steps return contiguous NCHW, and the
convolutions keep their input's layout); y and dx come back the same. dy
may have any strides for which H and W flatten. Statistics are f32
whatever x's type, with
var = max(E[x^2] - mean^2, 0) and flax's eps 1e-6.

The forward has two routes, which `forward_route` chooses on the host from
the shape, the type, x's address and the device's limits. On the cluster
route one thread-block cluster per (b, group) keeps the group's slab of x
in shared memory across its blocks, so x comes from device memory once (one
launch). The two-pass route (statistics with a last-block finalize, then a
dependent apply launch) takes what the first cannot: slabs too large for a
cluster, HW that is no multiple of 16 bytes of elements, unaligned views.
Both give the same bits from run to run. Unlike
fea_tpu, whose backward recomputes the statistics from x, the forward saves
its per-channel coefficients (a, b, mean, rstd) beside x and gamma (B * C *
16 bytes a call), and the backward reads them: the same numbers, from the
same kernel, and one pass over x fewer. The backward returns dx in x's type
and dgamma, dbeta in gamma's type.
"""

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import graphs
from ._build import build_library

DTYPES = (torch.float32, torch.bfloat16)
# blocks to aim for per SM in the partial-sum passes, and the fewest vectors
# each of their threads walks
BLOCKS_PER_SM = 8
MIN_VECTORS_PER_THREAD = 16
THREADS = 256  # a block of the two-pass kernels
# the forward's cluster route: blocks per cluster the kernel takes; the
# share of a slab to aim for in each block (three such blocks fit an SM's
# shared memory, so one's copy overlaps another's store); the most of a
# larger share that a block keeps in shared memory (two such blocks fit an
# SM), reading the rest twice; and the room left for the kernel's static
# shared memory
CLUSTER_SIZES = (1, 2, 4, 8, 16)
CLUSTER_SHARE_BYTES = 64 * 1024
CLUSTER_HELD_BYTES = 96 * 1024
STATIC_SHARED_BYTES = 512


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
        p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, f, p,
    ]
    lib.fea_group_norm_silu_fwd.restype = i
    lib.fea_group_norm_silu_fwd_resident_clusters.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.fea_group_norm_silu_fwd_resident_clusters.restype = i
    lib.fea_group_norm_silu_bwd.argtypes = [
        p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, ll, ll, ll, i, p,
    ]
    lib.fea_group_norm_silu_bwd.restype = i
    lib.fea_cuda_error_string.argtypes = [i]
    lib.fea_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _device_limits(index: int):
    """The device's SMs and the shared memory one block may ask for."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def _layout(x):
    """Raises unless x is contiguous NCHW (the kernels copy nothing)."""
    if not x.is_contiguous():
        raise ValueError(
            f"group_norm_silu takes contiguous NCHW x; got strides {x.stride()} "
            f"for shape {tuple(x.shape)}"
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


def _partition(batch, channels, hw, vec, sms):
    """Chunks of HW for a partial-sum pass (a block per channel, chunk and
    batch element) and the positions in each, a multiple of the vector:
    enough blocks for BLOCKS_PER_SM per SM, each thread over at least
    MIN_VECTORS_PER_THREAD vectors."""
    target = BLOCKS_PER_SM * sms
    min_rows = MIN_VECTORS_PER_THREAD * THREADS * vec
    chunks = max(1, min(math.ceil(target / (batch * channels)), math.ceil(hw / min_rows)))
    rows = math.ceil(math.ceil(hw / chunks) / vec) * vec  # chunks start on a vector
    return math.ceil(hw / rows), rows


def _widest_vector(size, hw, fits) -> int:
    """The widest of 16 bytes (4 f32 or 8 bf16), 2 and 1 positions that
    divides HW and that `fits` (strides and alignment) allows."""
    for vec in (8, 4, 2):
        if vec * size <= 16 and hw % vec == 0 and fits(vec):
            return vec
    return 1


def _vector_width(x, dy, dx, dy_strides) -> int:
    """Positions each backward thread loads at once: dy's position stride
    1, its other strides multiples of the vector, and x, dy and dx aligned
    to it."""
    size = x.element_size()
    sb, sc, sp = dy_strides
    return _widest_vector(size, x.shape[2] * x.shape[3], lambda vec: (
        sp == 1 and sb % vec == 0 and sc % vec == 0
        and all(t.data_ptr() % (vec * size) == 0 for t in (x, dy, dx))
    ))


class ForwardPlan(NamedTuple):
    """How one forward call runs; what a route does not use is 0."""

    route: str  # "cluster" or "two_pass"
    vec: int  # positions per load and store
    cluster: int  # cluster route: blocks per (b, group) slab
    smem_bytes: int  # and the dynamic shared memory of each
    chunks: int  # two-pass route: chunks of HW
    rows: int  # and the positions in each


def cluster_plans(channels, hw, groups, size, smem_limit, held_bytes=CLUSTER_HELD_BYTES):
    """Every cluster-route plan, by cluster size, that the kernel takes for
    16-byte-aligned x (channels, HW a multiple of 16 bytes) on a device
    whose blocks may ask for `smem_limit` bytes of shared memory: the
    (b, group) slab splits evenly, in whole 16-byte vectors, over the
    cluster, and a block keeps its share, or `held_bytes` of a larger one,
    beside the (a, b) table of C/G channels."""
    cg = channels // groups
    slab = cg * hw * size
    table = -(-cg * 8 // 16) * 16
    room = smem_limit - STATIC_SHARED_BYTES - table
    plans = []
    for k in CLUSTER_SIZES:
        held = min(slab // k, held_bytes)
        if slab % (k * 16) == 0 and held <= room:
            plans.append(ForwardPlan("cluster", 16 // size, k, table + held, 0, 0))
    return plans


def forward_route(batch, channels, hw, groups, size, address, sms, smem_limit) -> ForwardPlan:
    """The forward's route for x (batch, channels, HW) of `size`-byte
    elements at `address`, on a device of `sms` SMs whose blocks may ask for
    `smem_limit` bytes of shared memory.

    The cluster route reads x once, or little more. It takes x where
    16-byte vectors do (HW a multiple of 16 bytes of elements, x aligned to
    16 bytes) and one of `cluster_plans` fits: the smallest cluster whose
    blocks take at most CLUSTER_SHARE_BYTES of x or, for a larger slab, the
    largest cluster, if its blocks keep at least half of their share in
    shared memory. Everything else takes the two-pass route, at the widest
    vector that HW and x's alignment allow."""
    vec = _widest_vector(size, hw, lambda vec: address % (vec * size) == 0)
    fit = cluster_plans(channels, hw, groups, size, smem_limit) if vec * size == 16 else []
    slab = channels // groups * hw * size
    small = [plan for plan in fit if slab // plan.cluster <= CLUSTER_SHARE_BYTES]
    if small:
        return small[0]
    if fit and slab // fit[-1].cluster <= 2 * CLUSTER_HELD_BYTES:
        return fit[-1]
    chunks, rows = _partition(batch, channels, hw, vec, sms)
    return ForwardPlan("two_pass", vec, 0, 0, chunks, rows)


def forward_plan(x, num_groups) -> ForwardPlan:
    """`forward_route` of a CUDA tensor x (B, C, H, W) on its device."""
    b, c, h, w = x.shape
    return forward_route(b, c, h * w, num_groups, x.element_size(), x.data_ptr(),
                         *_device_limits(x.device.index or 0))


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


def resident_clusters(plan, x) -> int:
    """The clusters of `plan`'s size and shared memory, for x's type, that
    x's device holds at once, as the CUDA runtime counts them."""
    count = ctypes.c_int()
    with torch.cuda.device(x.device):
        err = _library().fea_group_norm_silu_fwd_resident_clusters(
            plan.cluster, plan.smem_bytes, int(x.dtype == torch.bfloat16), ctypes.byref(count))
    _raise_on(err, "forward (cluster occupancy)")
    return count.value


def _launch_forward(x, gamma, beta, num_groups, eps, plan):
    """y, and coef (B, C, 4) f32: (a, b, mean, rstd) with z = x a + b, by
    the route and sizes of `plan`."""
    b, c, h, w = x.shape
    coef = torch.empty((b, c, 4), device=x.device, dtype=torch.float32)
    gamma32, beta32 = gamma.float().contiguous(), beta.float().contiguous()
    y = torch.empty_like(x)
    partial = tickets = None
    if plan.route == "two_pass":
        partial = torch.empty((b, plan.chunks, c, 2), device=x.device, dtype=torch.float32)
        # this call's last-block tickets, as the backward takes its own
        tickets = torch.zeros(b, device=x.device, dtype=torch.int32)
    with torch.cuda.device(x.device):
        err = _library().fea_group_norm_silu_fwd(
            x.data_ptr(), gamma32.data_ptr(), beta32.data_ptr(), y.data_ptr(), coef.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if tickets is None else tickets.data_ptr(),
            b, c, h * w, num_groups, plan.cluster, plan.smem_bytes, plan.chunks, plan.rows,
            plan.vec, int(x.dtype == torch.bfloat16), eps,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(err, f"forward ({plan.route})")
    return y, coef


def _forward(x, gamma, beta, num_groups, eps):
    """y and coef of `_launch_forward`, by the route that `forward_route`
    picks for x; counts the call."""
    _layout(x)
    out = _launch_forward(x, gamma, beta, num_groups, eps, forward_plan(x, num_groups))
    graphs.count(group_norm_silu, "launches_fwd")
    return out


def _backward(x, gamma, coef, dy, num_groups):
    """dx in x's type, and dgamma, dbeta in f32, from x, gamma, the
    forward's coef and dy."""
    if dy.dtype != x.dtype or dy.shape != x.shape or dy.device != x.device:
        raise ValueError(
            f"dy {dy.dtype} {tuple(dy.shape)} on {dy.device} does not match x "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )
    _layout(x)
    b, c, h, w = x.shape
    if coef.shape != (b, c, 4) or coef.dtype != torch.float32 or not coef.is_contiguous():
        raise ValueError(f"coef {coef.dtype} {tuple(coef.shape)} is not the forward's ({b}, {c}, 4)")
    dy_strides = _dy_strides(dy, x.shape)
    dx = torch.empty_like(x)
    vec = _vector_width(x, dy, dx, dy_strides)
    chunks, rows = _partition(b, c, h * w, vec, _device_limits(x.device.index or 0)[0])
    partial = torch.empty((b, chunks, c, 2), device=x.device, dtype=torch.float32)
    group_means = torch.empty((b, num_groups, 2), device=x.device, dtype=torch.float32)
    # dgamma, dbeta and their per-batch partials, f32
    grads = torch.empty((2 + 2 * b, c), device=x.device, dtype=torch.float32)
    gamma32 = gamma.float().contiguous()
    # this call's last-block tickets: zeroed words from the stream's own
    # allocations, so calls on other streams cannot share them
    tickets = torch.zeros(b + 1, device=x.device, dtype=torch.int32)
    with torch.cuda.device(x.device):
        err = _library().fea_group_norm_silu_bwd(
            x.data_ptr(), gamma32.data_ptr(), coef.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), grads[0].data_ptr(), grads[1].data_ptr(), grads[2].data_ptr(),
            grads[2 + b].data_ptr(), partial.data_ptr(),
            group_means.data_ptr(), tickets.data_ptr(), b, c, h * w,
            num_groups, chunks, rows, vec, *dy_strides,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(err, "backward")
    graphs.count(group_norm_silu, "launches_bwd")
    return dx, grads[0], grads[1]


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps):
        y, coef = _forward(x, gamma, beta, num_groups, eps)
        ctx.save_for_backward(x, gamma, coef)
        ctx.num_groups, ctx.beta_dtype = num_groups, beta.dtype
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, gamma, coef = ctx.saved_tensors
        dx, dgamma, dbeta = _backward(x, gamma, coef, dy, ctx.num_groups)
        return dx, dgamma.to(gamma.dtype), dbeta.to(ctx.beta_dtype), None, None


def group_norm_silu(x, gamma, beta, num_groups: int = 8, eps: float = 1e-6):
    """silu(GroupNorm(x) * gamma + beta) for x (B, C, H, W) and gamma,
    beta (C,). CUDA tensors go through the CUDA kernels, and
    `group_norm_silu.launches_fwd` / `.launches_bwd` count their calls (a
    call recorded in a CUDA graph at each replay); CPU tensors go through
    the plain version."""
    if x.device.type == gamma.device.type == beta.device.type == "cpu":
        return group_norm_silu_reference(x, gamma, beta, num_groups, eps)
    _check_cuda_inputs(x, gamma, beta, num_groups)
    return _GroupNormSiLU.apply(x, gamma, beta, num_groups, eps)


group_norm_silu.launches_fwd = 0
group_norm_silu.launches_bwd = 0
