"""LinearAttention's attention, from Conv_0's output qkv to Conv_1's input:
softmax_d(q) * head_dim^-1/2 applied to the context softmax_n([mem_k, k]) .
[mem_v, v]^T, per head.

`linear_attention` launches the hand-written CUDA kernels of
`csrc/linear_attention.cu` for CUDA tensors and takes the plain PyTorch
version `linear_attention_reference` (the einsum chain of fea_tpu's
LinearAttention) for CPU tensors. There is no fallback: a CUDA tensor the
kernels do not take raises (bf16, a head dim other than 32, a pixel count
that is not a multiple of 4, an unaligned qkv). The kernels read q, k and v in place in qkv
(B, 3 heads head_dim, H, W) at their channel offsets and the memory slots
from memory_kv (2, heads, head_dim, slots): no chunk or concatenation is
copied. A call is three launches (the context's partials over chunks of
pixels, their combination with the memory slots, the output), in strict
f32, with no float atomics: the same inputs give the same bits. They are
forward only: on tensors that require grad, with grad enabled, they raise.
"""

import ctypes
import functools
import math

import torch

from . import graphs
from ._build import bind, check_aligned, check_tensors

HEAD_DIM = 32
TILE = 64  # pixels a partial block stages at a time (csrc/linear_attention.cu)
MIN_CHUNK = 4 * TILE  # the fewest pixels a partial block takes

_p, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
LIBRARY = bind("fea_linear_attention", ["linear_attention.cu"], {
    "fea_linear_attention_fwd": ([_p] * 4 + [_i] * 6 + [_f, _p], _i),
    "fea_linear_attention_scratch_floats": ([_i, _i], _ll),
    "fea_linear_attention_resident_blocks": ([ctypes.POINTER(_i)], _i),
}, load_symbol="fea_linear_attention_load")


def linear_attention_reference(qkv, memory_kv, num_heads: int, head_dim: int):
    """The plain version: fea_tpu's LinearAttention chain from qkv (B, 3
    heads head_dim, H, W) to (B, heads head_dim, H, W), in qkv's type."""
    b, _, h, w = qkv.shape
    # (b, heads, d, n)
    q, k, v = (t.reshape(b, num_heads, head_dim, h * w) for t in qkv.chunk(3, dim=1))
    k = torch.cat([memory_kv[0].expand(b, -1, -1, -1), k], dim=-1)
    v = torch.cat([memory_kv[1].expand(b, -1, -1, -1), v], dim=-1)

    q = torch.softmax(q, dim=-2) * (head_dim**-0.5)
    k = torch.softmax(k, dim=-1)

    context = torch.einsum("bhdn,bhen->bhde", k, v)
    out = torch.einsum("bhde,bhdn->bhen", context, q)
    return out.reshape(b, num_heads * head_dim, h, w)


def chunking(n: int, bh: int, sms: int, resident: int):
    """(chunks, pixels a chunk) of the partial kernel's grid (chunks, bh)
    over n pixels: about one wave of `resident` blocks on each of `sms`
    SMs, each chunk a multiple of TILE pixels and at least MIN_CHUNK."""
    chunks = max(1, min(resident * sms // bh, math.ceil(n / MIN_CHUNK)))
    chunk = math.ceil(math.ceil(n / chunks) / TILE) * TILE
    return math.ceil(n / chunk), chunk


@functools.cache
def _resident(index: int):
    """The device's SMs, and the partial blocks one SM holds at once."""
    blocks = ctypes.c_int()
    with torch.cuda.device(index):
        err = LIBRARY.loaded(index).fea_linear_attention_resident_blocks(ctypes.byref(blocks))
    LIBRARY.check(err, "linear_attention partial kernel's occupancy")
    return torch.cuda.get_device_properties(index).multi_processor_count, blocks.value


def _check_cuda_inputs(qkv, memory_kv, num_heads, head_dim):
    if head_dim != HEAD_DIM:
        raise ValueError(f"linear_attention takes head_dim {HEAD_DIM}; got {head_dim}")
    if qkv.ndim != 4 or memory_kv.ndim != 4 or min(qkv.shape) < 1 or num_heads < 1:
        raise ValueError(f"linear_attention takes qkv (B, 3 heads {HEAD_DIM}, H, W) and "
                         f"memory_kv (2, heads, {HEAD_DIM}, slots); got {tuple(qkv.shape)}, "
                         f"{tuple(memory_kv.shape)}")
    b, _, h, w = qkv.shape
    if b * num_heads > 65535:
        raise ValueError(f"batch {b} x {num_heads} heads exceeds the grid's 65535")
    if h * w % 4:
        # the kernels copy and store rows 16 bytes at a time; every stage of
        # the FDN-UNet has an even height and width
        raise ValueError(f"linear_attention takes a pixel count that is a multiple of 4; "
                         f"got {h} x {w}")
    check_tensors("linear_attention", qkv.device, qkv.dtype, (torch.float32,), {
        "qkv": (qkv, None, (b, 3 * num_heads * HEAD_DIM, h, w)),
        "memory_kv": (memory_kv, None, (2, num_heads, HEAD_DIM, memory_kv.shape[-1]))})
    check_aligned("linear_attention", {"qkv": qkv})
    if torch.is_grad_enabled() and (qkv.requires_grad or memory_kv.requires_grad):
        # the kernels' output has no grad_fn: training would lose the
        # attention's gradients without a word
        raise RuntimeError("the CUDA linear-attention kernels have no backward; call them "
                           "under torch.no_grad() or on tensors that do not require grad")


def _launch(qkv, memory_kv, num_heads):
    """The three launches on checked CUDA tensors; the output."""
    b, _, h, w = qkv.shape
    n, bh, slots = h * w, b * num_heads, memory_kv.shape[-1]
    device = qkv.device
    chunks, chunk = chunking(n, bh, *_resident(device.index or 0))
    lib = LIBRARY.loaded(device.index or 0)
    out = torch.empty((b, num_heads * HEAD_DIM, h, w), device=device, dtype=torch.float32)
    scratch = torch.empty(lib.fea_linear_attention_scratch_floats(bh, chunks),
                          device=device, dtype=torch.float32)
    with torch.cuda.device(device):
        err = lib.fea_linear_attention_fwd(
            qkv.data_ptr(), memory_kv.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            b, num_heads, n, slots, chunks, chunk, HEAD_DIM**-0.5,
            torch.cuda.current_stream(device).cuda_stream)
    LIBRARY.check(err, "linear_attention launch")
    return out


def linear_attention(qkv, memory_kv, num_heads: int, head_dim: int):
    """(B, heads head_dim, H, W), LinearAttention's output before Conv_1,
    from Conv_0's output qkv and the memory slots memory_kv (2, heads,
    head_dim, slots). CUDA tensors go through the CUDA kernels (f32, head
    dim 32, pixels a multiple of 4, qkv 16-byte aligned, no grad), and `linear_attention.launches` counts the calls (a
    call recorded in a CUDA graph at each replay); CPU tensors go through
    the plain version."""
    if qkv.device.type == memory_kv.device.type == "cpu":
        return linear_attention_reference(qkv, memory_kv, num_heads, head_dim)
    _check_cuda_inputs(qkv, memory_kv, num_heads, head_dim)
    out = _launch(qkv, memory_kv, num_heads)
    graphs.count(linear_attention)
    return out


linear_attention.launches = 0
