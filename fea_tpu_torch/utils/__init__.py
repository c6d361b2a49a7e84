from .device import cuda_device, resolve_device

__all__ = ["cuda_device", "resolve_device"]
