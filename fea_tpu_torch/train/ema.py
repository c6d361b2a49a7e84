"""Exponential moving average of parameters, the port of fea_tpu/train/ema.py."""

from typing import List, Union

import torch


@torch.no_grad()
def ema_update(
    ema_params: List[torch.Tensor],
    params: List[torch.Tensor],
    decay: Union[float, torch.Tensor],
) -> None:
    """In place over two lists of tensors: e <- e * decay + p * (1 - decay).
    `decay` is a float or a 0-dim tensor on the tensors' device (a value
    the device chooses, without a sync); a decay of 1 leaves e as it is."""
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, torch._foreach_mul(params, 1.0 - decay))
