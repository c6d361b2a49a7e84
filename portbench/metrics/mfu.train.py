"""mfu.train

The whole train step's share of the card's dense TF32 peak: the
operations of the traced window's steps (portbench/counts/flops.py,
counted on the reference) over the window, over 495 TFLOP/s.
"""

from portbench.counts import kernels

LAYER = "Model step"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_step_ms"


def read(outcome):
    if outcome.trace is None or outcome.trace.window_s <= 0:
        return None
    return 100.0 * outcome.facts["flops"] / outcome.trace.window_s / kernels.TF32_FLOPS
