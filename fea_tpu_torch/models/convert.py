"""Flax params of fea_tpu's models -> state dicts of the port's modules.

The port's submodules carry fea_tpu's flax names, so a leaf's path maps to
its state-dict key by joining with "."; only the leaf name and layout
change:
    Conv kernel  (kh, kw, in, out) -> weight (out, in, kh, kw)
    Dense kernel (in, out)         -> weight (out, in)
    GroupNorm scale                -> weight
    RMSNorm g    (1, 1, 1, C)      -> g (1, C, 1, 1)
    bias, memory_kv                -> as they are
"""

from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device


def _flatten(tree: Mapping, prefix: str = ""):
    for name, value in tree.items():
        path = f"{prefix}.{name}" if prefix else str(name)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _convert_leaf(path: str, value: np.ndarray):
    parent, _, leaf = path.rpartition(".")
    key = f"{parent}.{{}}" if parent else "{}"
    if leaf == "kernel" and value.ndim == 4:
        return key.format("weight"), value.transpose(3, 2, 0, 1)
    if leaf == "kernel" and value.ndim == 2:
        return key.format("weight"), value.T
    if leaf == "scale" and value.ndim == 1:
        return key.format("weight"), value
    if leaf == "g" and value.ndim == 4:
        return key.format("g"), value.transpose(0, 3, 1, 2)
    if leaf in ("bias", "memory_kv"):
        return key.format(leaf), value
    raise ValueError(f"no conversion for flax leaf {path} {value.shape}")


def from_flax(params: Mapping) -> dict:
    """State dict (float32 CPU tensors) for a flax param tree of numpy
    arrays: the encoder / decoder / aux trio, FDNUNet or UNet. Every leaf becomes
    exactly one entry; a leaf the conversion does not know raises."""
    state = {}
    for path, value in _flatten(params):
        key, tensor = _convert_leaf(path, value)
        if key in state:
            raise ValueError(f"two flax leaves map to {key}")
        state[key] = torch.tensor(tensor, dtype=torch.float32)
    return state


def load_flax(module: nn.Module, params: Mapping, device=None) -> nn.Module:
    """Allocate `module` (built on any device, meta included) on `device`
    (the CUDA device unless the caller names another) and load `params`
    into it. The strict load raises unless every parameter is matched by
    one flax leaf of the same shape and every leaf is used."""
    module.to_empty(device=resolve_device(device))
    module.load_state_dict(from_flax(params))
    return module
