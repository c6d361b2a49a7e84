"""Operations and flash-attention call shapes of the full-attention,
self-conditioned denoiser (`reference/fdnunet_fullattn.py`), counted over
that reference on meta tensors at a cell's shapes, as flops.py and
kernels.py count the other configurations: the blocked attention's
matmuls sum to the unblocked ones', and each attention module is one call
of the program's flash kernel."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.fdnunet_fullattn import BlockedFullAttention, build
from . import kernels


def _forward(net, config: dict, batch: int):
    model = config["model"]
    s = model["image_size"]
    x = torch.empty((batch, s, s, model["num_channels"]), device="meta")
    cond = torch.empty((batch, s, s, model["num_auxiliary_condition_channels"]), device="meta")
    net(x, cond, torch.empty((batch,), device="meta"), torch.empty_like(x))


def forward_flops(config: dict, batch: int) -> int:
    """One denoiser forward at `batch`, an x0 estimate given."""
    net = build(config)["model"]
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        _forward(net, config, batch)
    return int(counter.get_total_flops())


def flash_shapes(config: dict, batch: int) -> list:
    """[(BH, Nq, Nk, D)] of one forward at `batch`, a flash call each."""
    net = build(config)["model"]
    shapes = []

    def on_attention(module, args, output):
        b, _, h, w = args[0].shape
        n = h * w
        shapes.append((b * module.heads, n, n + module.memory_kv.shape[2], module.head_dim))

    handles = [m.register_forward_hook(on_attention) for m in net.modules()
               if isinstance(m, BlockedFullAttention)]
    try:
        with torch.no_grad():
            _forward(net, config, batch)
    finally:
        for h in handles:
            h.remove()
    return shapes


def flash_bound_s(config: dict, batch: int) -> float:
    """The least time of one forward's flash calls (kernels.bound_s)."""
    return sum(kernels.bound_s(*kernels.flash_call(*s)) for s in flash_shapes(config, batch))
