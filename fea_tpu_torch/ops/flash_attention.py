"""Flash attention: softmax(q k^T * scale) v for (BH, N, D) tensors.

The port of fea_tpu/ops/flash_attention.py. `flash_attention` launches the
hand-written CUDA kernel `csrc/flash_attention.cu` for CUDA tensors and
takes the plain PyTorch version `flash_attention_reference` for CPU
tensors, which is how the CPU tests reach it. There is no fallback: a CUDA
tensor the kernel does not take raises.

The kernel runs both products on the tensor cores: f32 inputs in 3xTF32
(each operand split into TF32 hi and lo parts, hi*lo + lo*hi + hi*hi summed
in f32), bf16 inputs as bf16 products with P split into bf16 hi and lo.
`route` picks one of two kernels per call from its dtype and head dim:
"wgmma" for f32 at D 32, which splits K and V into TF32 once per call (into
scratch memory) and runs both products with Hopper's wgmma, and "mma_sync"
for bf16 and for D 64, 72 and 128. D 72 (DiT-XL's heads) is f32 only: the
bf16 product steps through D 16 at a time.
"""

import ctypes

import torch

from . import graphs
from ._build import bind, check_aligned, check_contiguous, check_device

HEAD_DIMS = (32, 64, 72, 128)
F32_ONLY_HEAD_DIMS = (72,)
DTYPES = (torch.float32, torch.bfloat16)

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = bind("fea_flash_attention", ["flash_attention.cu"], {
    "fea_flash_attention_fwd": ([_p, _p, _p, _p, _i, _i, _i, _i, _i, _f, _p], _i),
    "fea_flash_attention_fwd_wgmma": ([_p, _p, _p, _p, _p, _i, _i, _i, _f, _p], _i),
    "fea_flash_attention_wgmma_image_floats": ([_i, _i], ctypes.c_longlong),
})


def flash_attention_reference(q, k, v, scale: float = None):
    """The plain version: the FullAttention einsum chain in f32, with q
    scaled in its own dtype first, as the TPU kernel does; the output has
    q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = (q * scale).float() @ k.float().transpose(-1, -2)
    weights = torch.softmax(scores, dim=-1)
    return (weights @ v.float()).to(q.dtype)


def route(dtype, d: int) -> str:
    """The kernel a CUDA call takes: "wgmma" for f32 at head dim 32,
    "mma_sync" for bf16 and for D 64, 72 and 128."""
    return "wgmma" if dtype == torch.float32 and d == 32 else "mma_sync"


def _check_cuda_inputs(q, k, v):
    named = {"q": q, "k": k, "v": v}
    check_device("flash_attention", named)
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
    if d in F32_ONLY_HEAD_DIMS and q.dtype != torch.float32:
        raise TypeError(f"flash_attention takes head dim {d} in float32 only (the bf16 "
                        f"product steps through D 16 at a time); got {q.dtype}")
    if min(bh, nq, k.shape[1]) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    check_contiguous("flash_attention", named)
    check_aligned("flash_attention", named)  # the kernel copies K/V rows in 16-byte pieces
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        # the kernel's output has no grad_fn: training would lose the
        # attention's gradients without a word
        raise RuntimeError(
            "the CUDA flash-attention kernel has no backward; call it under "
            "torch.no_grad() or on tensors that do not require grad"
        )


def _launch(q, k, v, scale: float, wgmma: bool):
    """One launch of the wgmma kernel (f32 at D 32 only) or of the mma.sync
    kernel on checked CUDA tensors; the output."""
    bh, nq, d = q.shape
    nk = k.shape[1]
    out = torch.empty_like(q)
    lib = LIBRARY.lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if wgmma:
            # K and V as TF32 hi and lo tiles, in the layout wgmma reads
            image = torch.empty(lib.fea_flash_attention_wgmma_image_floats(bh, nk),
                                dtype=torch.float32, device=q.device)
            err = lib.fea_flash_attention_fwd_wgmma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), image.data_ptr(),
                bh, nq, nk, scale, stream,
            )
        else:
            err = lib.fea_flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bh, nq, nk, d, int(q.dtype == torch.bfloat16), scale, stream,
            )
    LIBRARY.check(err, "flash_attention wgmma launch" if wgmma else "flash_attention launch")
    return out


def flash_attention(q, k, v, scale: float = None):
    """softmax(q k^T * scale) v for q (BH, Nq, D), k/v (BH, Nk, D); Nk may
    differ from Nq (memory-KV slots). CUDA tensors go through the CUDA
    kernel that `route` picks; `flash_attention.launches` counts the
    launches (a launch recorded in a CUDA graph at each replay),
    `launches_wgmma` those of the "wgmma" kernel and `launches_d72` the f32
    calls at head dim 72. CPU tensors go through the plain version. The
    kernel is forward only: on CUDA tensors that require grad, with grad
    enabled, it raises."""
    if q.device.type == k.device.type == v.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    _check_cuda_inputs(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    wgmma = route(q.dtype, q.shape[-1]) == "wgmma"
    out = _launch(q, k, v, scale, wgmma)
    graphs.count(flash_attention)
    if wgmma:
        graphs.count(flash_attention, "launches_wgmma")
    elif q.shape[-1] == 72:
        graphs.count(flash_attention, "launches_d72")
    return out


flash_attention.launches = 0
flash_attention.launches_wgmma = 0
flash_attention.launches_d72 = 0
