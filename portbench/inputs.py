"""The general generator of the benchmark's inputs: what a traffic file's
parameters ask for, drawn from the run's seed on the device in a few
large calls, then handed to the program from the host.

Training samples follow the FEADataset contract (fea-diffusion's dataset
layout, NHWC float32): +-1 geometry and constraint masks, forces and
materials on the plate, displacement in (-1, 1), and the range targets.
Serving requests are condition stacks (forces 2, constraints 1,
materials 2), one batch a request, each from its own stream of the seed,
so that request k is the same whatever the run's length.
"""

import numpy as np
import torch

from .reference.weights import stream_seed

DATA_STREAM, REQUEST_STREAM, NOISE_STREAM, CHECK_STREAM = 2, 4, 5, 6


class FEASamples:
    """`n` samples at `size` px, made from `seed`; `reads` records every
    index the program asks for, in order."""

    conditions_per_plate_geometry = 1

    def __init__(self, n: int, size: int, seed: int, device):
        g = torch.Generator(device=device).manual_seed(stream_seed(seed, DATA_STREAM))

        def draw(*shape, uniform=False):
            shape = (n, size, size) + shape
            if uniform:
                return torch.rand(shape, generator=g, device=device)
            return torch.randn(shape, generator=g, device=device)

        geometry = torch.where(draw(1, uniform=True) < 0.7, 1.0, -1.0)
        plate = (geometry + 1.0) / 2.0
        ranges = torch.randn((n, 4), generator=g, device=device)
        fields = {
            "geometry": geometry,
            "displacement": torch.tanh(draw(2)),
            "constraints": torch.where(draw(1, uniform=True) < 0.05, 1.0, -1.0),
            "forces": draw(2) * plate,
            "materials": draw(2) * plate,
            "displacement_range": ranges,
            "log_displacement_range": torch.log1p(ranges.abs()),
            "sign_displacement_range": (ranges >= 0).float(),
        }
        self.fields = {k: v.float().cpu().numpy() for k, v in fields.items()}
        self.num_steps = n
        self.reads = []

    def __len__(self):
        return self.num_steps

    def __getitem__(self, index):
        self.reads.append(int(index))
        sample = {k: v[index] for k, v in self.fields.items()}
        sample["plate_index"] = np.int32(1)
        sample["condition_index"] = np.int32(1)
        sample["iteration_index"] = np.int32(index + 1)
        return sample

    def batch(self, indices, device) -> dict:
        """The model's inputs and target of the rows `indices`, f32 on
        `device`, for the reference."""
        keys = ("materials", "forces", "constraints", "geometry", "displacement")
        return {k: torch.from_numpy(self.fields[k][list(indices)]).to(device) for k in keys}


def request_condition(seed: int, k: int, batch: int, size: int, channels: int, device):
    """Request k's condition stack (batch, size, size, channels), on the
    host."""
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, REQUEST_STREAM, k))
    return torch.randn((batch, size, size, channels), generator=g, device=device).cpu()


def request_generator(seed: int, k: int, device) -> torch.Generator:
    """The generator of request k's noise: the initial image and each
    step's fresh draw, in the order the sampler asks for them."""
    return torch.Generator(device=device).manual_seed(stream_seed(seed, NOISE_STREAM, k))
