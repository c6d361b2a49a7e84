"""roofline_pct.gn_bwd.train

The fused GroupNorm+SiLU backward's share of its roofline: the least
time of the traced window's calls, their bytes (portbench/counts/
kernels.py, from the call shapes) at HBM's rate, over the device time
of the kernels `bwd_partials` and `bwd_apply`.
"""

from portbench.counts import kernels

LAYER = "Kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_step_ms"


def read(outcome):
    if outcome.trace is None:
        return None
    seconds, _ = outcome.trace.seconds_by_kernel(
        lambda name: "bwd_partials" in name or "bwd_apply" in name)
    if seconds <= 0:
        return None
    return 100.0 * outcome.facts["gn_bwd_bytes"] / kernels.HBM_BYTES_PER_S / seconds
