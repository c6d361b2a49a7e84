"""roofline_pct.flash.sample

The flash-attention kernel's share of its roofline: the least time of
the traced window's calls, the larger of their operations at the TF32
peak and their bytes at HBM's rate (portbench/counts/kernels.py), over
the device time of `flash_fwd_kernel`.
"""

LAYER = "Kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "denoise_step_ms"


def read(outcome):
    if outcome.trace is None:
        return None
    seconds, _ = outcome.trace.seconds_by_kernel(lambda name: "flash_fwd_kernel" in name)
    if seconds <= 0:
        return None
    return 100.0 * outcome.facts["flash_bound_s"] / seconds
