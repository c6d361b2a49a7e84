"""idle_pct.train

The share of the traced window (the device alone) in which no kernel,
copy or set ran on the card: 100 (window - busy) / window.
"""

LAYER = "Device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_step_ms"


def read(outcome):
    return outcome.trace.idle_pct() if outcome.trace is not None else None
