"""Flash attention: softmax(q k^T * scale) v for (BH, N, D) tensors.

The port of fea_tpu/ops/flash_attention.py. `flash_attention` launches the
hand-written CUDA kernel `csrc/flash_attention.cu` for CUDA tensors and
takes the plain PyTorch version `flash_attention_reference` for CPU
tensors, which is how the CPU tests reach it. There is no fallback: a CUDA
tensor the kernel does not take raises.

The kernel runs both products on the tensor cores: f32 inputs in 3xTF32
(each operand split into TF32 hi and lo parts, hi*lo + lo*hi + hi*hi summed
in f32), bf16 inputs as bf16 products with P split into bf16 hi and lo.
"""

import ctypes
import functools
from pathlib import Path

import torch

from . import graphs
from ._build import build_library

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_reference(q, k, v, scale: float = None):
    """The plain version: the FullAttention einsum chain in f32, with q
    scaled in its own dtype first, as the TPU kernel does; the output has
    q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = (q * scale).float() @ k.float().transpose(-1, -2)
    weights = torch.softmax(scores, dim=-1)
    return (weights @ v.float()).to(q.dtype)


def build() -> Path:
    """Compile the kernel's library (at first use); its path."""
    return build_library("fea_flash_attention", ["flash_attention.cu"])


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build()))
    lib.fea_flash_attention_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,
    ]
    lib.fea_flash_attention_fwd.restype = ctypes.c_int
    lib.fea_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fea_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_inputs(q, k, v):
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(
            f"flash_attention takes q, k, v on one CUDA device or all on the "
            f"CPU; got {q.device}, {k.device}, {v.device}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(
            f"flash_attention takes float32 or bfloat16 q, k, v of one dtype; "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention takes q (BH, Nq, D) and k, v (BH, Nk, D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    bh, nq, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in BH or D"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if min(bh, nq, k.shape[1]) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        # the kernel copies K/V rows in 16-byte pieces
        raise ValueError("flash_attention takes q, k, v that start on 16-byte boundaries")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        # the kernel's output has no grad_fn: training would lose the
        # attention's gradients without a word
        raise RuntimeError(
            "the CUDA flash-attention kernel has no backward; call it under "
            "torch.no_grad() or on tensors that do not require grad"
        )


def flash_attention(q, k, v, scale: float = None):
    """softmax(q k^T * scale) v for q (BH, Nq, D), k/v (BH, Nk, D); Nk may
    differ from Nq (memory-KV slots). CUDA tensors go through the CUDA
    kernel, and `flash_attention.launches` counts its launches (a launch
    recorded in a CUDA graph at each replay); CPU tensors go through the
    plain version. The kernel is forward only: on CUDA tensors that
    require grad, with grad enabled, it raises."""
    if q.device.type == k.device.type == v.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    _check_cuda_inputs(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    bh, nq, d = q.shape
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.fea_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, nq, k.shape[1], d, int(q.dtype == torch.bfloat16), scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "flash attention kernel launch failed: "
            + lib.fea_cuda_error_string(err).decode()
        )
    graphs.count(flash_attention)
    return out


flash_attention.launches = 0
