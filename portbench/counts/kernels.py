"""Peaks of the card and the least time of a kernel's work from its call
shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W power
limit. A kernel's bound is the larger of its operations over the peak
rate and its bytes over HBM's rate, each input read once and each output
written once.

The call shapes come from the reference on meta tensors: each full
attention (the program's flash kernel) and each GroupNorm with affine,
then SiLU, without a time scale-shift (the program's fused GroupNorm+SiLU
kernels, forward and backward).
"""

import torch

from ..reference.fdnunet import FullAttention, ResnetSubBlock, build

TF32_FLOPS = 495e12  # dense TF32 on the tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def bound_s(ops: float, nbytes: float, flops: float = TF32_FLOPS) -> float:
    return max(ops / flops, nbytes / HBM_BYTES_PER_S)


def flash_call(bh: int, nq: int, nk: int, d: int) -> tuple:
    """(operations, bytes) of softmax(q k^T) v: two matmuls of 2 nq nk d
    operations a head; q, k, v read and o written once, f32."""
    return 4 * bh * nq * nk * d, F32 * d * bh * (2 * nq + 2 * nk)


def gn_silu_bwd_call(b: int, c: int, hw: int) -> int:
    """Bytes of the fused GroupNorm+SiLU backward: x and dy read, dx
    written (B C HW each), the saved coefficients (B, C, 4) and gamma,
    beta read, dgamma and dbeta written."""
    return F32 * (3 * b * c * hw + 4 * b * c + 4 * c)


def _shapes(config: dict, batch: int, run):
    """Call shapes of full attention and of the fused GroupNorm+SiLU in one
    pass of the reference at `batch`."""
    flash, gn = [], []

    def on_attention(module, args, output):
        b, _, h, w = args[0].shape
        n = h * w
        mem = module.memory_kv.shape[2]
        flash.append((b * module.heads, n, n + mem, module.head_dim))

    def on_subblock(module, args, output):
        if len(args) < 2 or args[1] is None:  # no time scale-shift: fused
            b, c, h, w = output.shape
            gn.append((b, c, h * w))

    modules = build(config)
    handles = []
    for m in modules.values():
        for sub in m.modules():
            if isinstance(sub, FullAttention):
                handles.append(sub.register_forward_hook(on_attention))
            elif isinstance(sub, ResnetSubBlock):
                handles.append(sub.register_forward_hook(on_subblock))
    with torch.no_grad():
        run(modules, batch)
    for h in handles:
        h.remove()
    return flash, gn


def _run_regression(modules, batch, config):
    from .flops import meta_batch
    from ..reference.fdnunet import regression_prediction

    regression_prediction(modules["encoder"], modules["decoder"], meta_batch(config, batch))


def _run_denoiser(modules, batch, config):
    model = config["model"]
    s = model["image_size"]
    modules["model"](
        torch.empty((batch, s, s, model["num_channels"]), device="meta"),
        torch.empty((batch, s, s, model["num_auxiliary_condition_channels"]), device="meta"),
        torch.empty((batch,), device="meta"),
    )


def call_shapes(config: dict, batch: int) -> tuple:
    """([flash (BH, Nq, Nk, D)], [GroupNorm+SiLU (B, C, HW)]) of one
    forward of the configuration's model at `batch`."""
    kind = config["model"]["kind"]
    run = _run_regression if kind == "regression" else _run_denoiser
    return _shapes(config, batch, lambda modules, b: run(modules, b, config))
