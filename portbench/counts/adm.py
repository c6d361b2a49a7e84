"""Operations and flash-attention call shapes of ADM's forward
(`reference/adm.py`), counted over that reference on meta tensors at a
cell's shapes, as flops.py and kernels.py count the other configurations:
each attention block is one call of the program's flash kernel, the
einsums' operations those of its two products."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.adm import AttentionBlock, build


def _forward(net, config: dict, batch: int):
    model = config["model"]
    s = model["image_size"]
    net(torch.empty((batch, s, s, model["num_channels"]), device="meta"),
        torch.empty((batch, s, s, model["num_auxiliary_condition_channels"]), device="meta"),
        torch.empty((batch,), device="meta"))


def forward_flops(config: dict, batch: int) -> int:
    """One forward at `batch`."""
    net = build(config)["model"]
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        _forward(net, config, batch)
    return int(counter.get_total_flops())


def flash_shapes(config: dict, batch: int) -> list:
    """[(BH, Nq, Nk, D)] of one forward at `batch`, a flash call each."""
    net = build(config)["model"]
    shapes = []

    def on_attention(module, args, output):
        b, c, h, w = args[0].shape
        shapes.append((b * module.num_heads, h * w, h * w, c // module.num_heads))

    handles = [m.register_forward_hook(on_attention) for m in net.modules()
               if isinstance(m, AttentionBlock)]
    try:
        with torch.no_grad():
            _forward(net, config, batch)
    finally:
        for h in handles:
            h.remove()
    return shapes
