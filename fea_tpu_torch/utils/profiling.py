"""Tracing and profiling, the port of fea_tpu/utils/profiling.py.

The reference's only observability is wall-clock prints around each solve
(datagen/generate.py:109-127). Here: a per-stage timing registry usable as
a context manager (the datagen scheduler charges each of its stages to
one), and a torch.profiler trace of the host and the device written to a
log directory.
"""

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class StageTimer:
    """Accumulates wall-clock per named stage.

    with timer.stage("solve"): ...
    print(timer.summary())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:24s} {t:9.3f}s  x{n:<5d} ({t / n * 1e3:8.2f} ms avg)")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """A torch.profiler trace of the host's operators and, where CUDA is
    available, the device's kernels, written to `log_dir` as a Chrome
    trace (`*.pt.trace.json`, which TensorBoard's profiler plugin and
    Perfetto read). No-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield
