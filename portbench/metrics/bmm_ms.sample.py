"""bmm_ms.sample

Device ms a denoising step in the kernels that aten::bmm launched (the
attention einsums, strict f32), in the traced window that records the
host.
"""

LAYER = "Blocks"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "denoise_step_ms"


def read(outcome):
    if outcome.host_trace is None:
        return None
    seconds = outcome.host_trace.seconds_by_op(lambda op: op == "aten::bmm")
    if seconds <= 0:
        return None
    return 1e3 * seconds / outcome.facts["host_forwards"]
