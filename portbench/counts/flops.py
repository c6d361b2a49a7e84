"""Floating-point operations of the model's work, counted by PyTorch's
FlopCounterMode over the benchmark's plain reference on meta tensors, at a
cell's shapes. The count is of the algorithm (convolutions and matmuls,
forward and, for a train step, backward), whatever implements it: a
flash kernel and two matmuls count the same."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.fdnunet import build


def meta_batch(config, batch):
    model = config["model"]
    s = model["image_size"]
    shape = (batch, s, s)
    return {
        "materials": torch.empty(shape + (model["num_channels"],), device="meta"),
        "forces": torch.empty(shape + (2,), device="meta"),
        "constraints": torch.empty(shape + (1,), device="meta"),
        "geometry": torch.empty(shape + (1,), device="meta"),
        "displacement": torch.empty(shape + (model["num_channels"],), device="meta"),
    }


def train_step_flops(config: dict, batch: int) -> int:
    """One regression train step: forward, L1 loss and backward through
    the encoder and decoder."""
    from ..reference.train import l1_loss

    modules = build(config)
    params = [p for m in modules.values() for p in m.parameters()]
    with FlopCounterMode(display=False) as counter:
        loss = l1_loss(modules["encoder"], modules["decoder"], meta_batch(config, batch))
        torch.autograd.grad(loss, params)
    return int(counter.get_total_flops())


def forward_flops(config: dict, batch: int) -> int:
    """One denoiser forward at `batch`."""
    model = config["model"]
    s = model["image_size"]
    denoiser = build(config)["model"]
    x = torch.empty((batch, s, s, model["num_channels"]), device="meta")
    cond = torch.empty((batch, s, s, model["num_auxiliary_condition_channels"]), device="meta")
    t = torch.empty((batch,), device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        denoiser(x, cond, t)
    return int(counter.get_total_flops())
