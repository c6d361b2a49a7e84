"""Device policy of the port: an explicit device, never a silent fallback."""

import torch


def cuda_device() -> torch.device:
    """The CUDA device, or raise: code that asks for the card never runs on
    the CPU instead. CPU callers (the tests) pass device="cpu" themselves."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; None means the CUDA device (and raises
    without one)."""
    return torch.device(device) if device is not None else cuda_device()
