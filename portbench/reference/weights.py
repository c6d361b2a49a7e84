"""Weights made by the benchmark from the run's seed, on the device.

One normal draw of every parameter's elements at once, from a generator
on the device, in the type the model is served in (f32); each leaf then
takes its slice at its scale: kernels N(0, 1/fan_in) (flax's lecun
scale), biases N(0, 0.02^2), gains 1 + N(0, 0.1^2), memory key-value
slots N(0, 1). Biases and gains are drawn, not zero and one, so that a
bias or a gain that the program drops shows in the comparison.
"""

import math

import numpy as np
import torch


def stream_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of the run's seed (weights, data, a
    request), so that the streams do not overlap."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, *tags]
    state = np.random.SeedSequence(words).generate_state(2, dtype=np.uint32)
    return int(state[0]) | (int(state[1] & 0x7FFFFFFF) << 32)


def _scale(name: str, shape) -> tuple:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "memory_kv":
        return 1.0, 0.0
    if leaf == "weight" and len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    if leaf in ("weight", "g"):  # GroupNorm and RMSNorm gains
        return 0.1, 1.0
    if leaf == "bias":
        return 0.02, 0.0
    raise ValueError(f"no scale for parameter {name}")


@torch.no_grad()
def make_weights(modules: dict, seed: int, device) -> dict:
    """{module key: {parameter name: tensor}} for the reference `modules`
    (built on the meta device), drawn on `device` from `seed`."""
    leaves = [(key, name, tuple(p.shape)) for key, m in modules.items()
              for name, p in m.named_parameters()]
    total = sum(math.prod(shape) for _, _, shape in leaves)
    generator = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
    flat = torch.randn(total, generator=generator, device=device, dtype=torch.float32)
    out = {key: {} for key in modules}
    start = 0
    for key, name, shape in leaves:
        n = math.prod(shape)
        std, mean = _scale(name, shape)
        out[key][name] = flat[start:start + n].view(shape).mul_(std).add_(mean)
        start += n
    return out

