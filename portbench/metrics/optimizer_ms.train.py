"""optimizer_ms.train

Device ms a train step in the clip, Adam and the non-finite guard: the
kernels that aten::_foreach_*, aten::linalg_vector_norm, aten::stack and
aten::where launched in the traced window that records the host, over
its steps. (The model's own aten::where, in the output's normalization,
is a few small kernels a step.)
"""

LAYER = "Train step"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_step_ms"
OPS = frozenset({"aten::linalg_vector_norm", "aten::stack", "aten::where"})


def read(outcome):
    if outcome.host_trace is None:
        return None
    seconds = outcome.host_trace.seconds_by_op(
        lambda op: op.startswith("aten::_foreach_") or op in OPS)
    if seconds <= 0:
        return None
    return 1e3 * seconds / outcome.facts["host_steps"]
