"""Operations and flash-attention call shapes of DiT's forward
(`reference/dit.py`), counted over that reference on meta tensors at a
cell's shapes, as adm.py counts ADM's: each attention is one call of the
program's flash kernel; the linear layers' operations, the matmuls that
cuBLAS runs in the program, apart."""

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from ..reference.dit import Attention, build


def _forward(net, config: dict, batch: int):
    model = config["model"]
    s = model["image_size"]
    net(torch.empty((batch, s, s, model["num_channels"]), device="meta"),
        torch.empty((batch, s, s, model["num_auxiliary_condition_channels"]), device="meta"),
        torch.empty((batch,), device="meta"))


def _hooked(config: dict, batch: int, kind, on_call) -> None:
    """One forward of the reference at `batch`, `on_call(module, input)`
    at each module of `kind`."""
    net = build(config)["model"]
    handles = [m.register_forward_hook(lambda m, args, out: on_call(m, args[0]))
               for m in net.modules() if isinstance(m, kind)]
    try:
        with torch.no_grad():
            _forward(net, config, batch)
    finally:
        for h in handles:
            h.remove()


def forward_flops(config: dict, batch: int) -> int:
    """One forward at `batch`: the linears, the attention's two products
    and the patch convolution."""
    net = build(config)["model"]
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        _forward(net, config, batch)
    return int(counter.get_total_flops())


def linear_flops(config: dict, batch: int) -> int:
    """The operations of one forward's linear layers (144 at depth 28: the
    time embedding's 2, 5 a block, the final layer's 2), 2 rows in out
    each."""
    total = []
    _hooked(config, batch, nn.Linear,
            lambda m, x: total.append(2 * x.numel() // m.in_features * m.in_features
                                      * m.out_features))
    return sum(total)


def flash_shapes(config: dict, batch: int) -> list:
    """[(BH, Nq, Nk, D)] of one forward at `batch`, a flash call each."""
    shapes = []
    _hooked(config, batch, Attention,
            lambda m, x: shapes.append((x.shape[0] * m.num_heads, x.shape[1], x.shape[1],
                                        m.head_dim)))
    return shapes
