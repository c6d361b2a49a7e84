"""Per-stage wall-clock timing (the port of fea_tpu/utils/profiling.py's
StageTimer).

The reference's only observability is wall-clock prints around each solve
(datagen/generate.py:109-127). Here: a per-stage timing registry usable as
a context manager; the datagen scheduler charges each of its stages to one.
"""

import contextlib
import time
from collections import defaultdict
from typing import Dict


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
