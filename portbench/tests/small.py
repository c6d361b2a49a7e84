"""Small copies of the cells for CPU tests: the same files, cut to 32 px
and narrow widths so that a CPU runs a cell in seconds."""

import torch

from portbench import harness
from portbench.run import run_cell

SEED = 2**31 + 977  # past 32 signed bits, as the driver's seeds are


def small_cell(name: str, **model):
    cell = harness.find_cell(name, harness.benchmark_spec())
    cell.config["model"].update(image_size=32, input_dim=8, **model)
    if "samples" in cell.traffic:
        cell.traffic["samples"] = 100
    return cell


def run_small(name: str, seed: int = SEED, seconds: float = 1.0, trace=False, control=False):
    torch.set_num_threads(2)
    return run_cell(small_cell(name), seed, seconds, trace, torch.device("cpu"), control=control)
