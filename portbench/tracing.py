"""The device trace of a traced run's windows, from torch.profiler, and
the reductions that per-layer metrics read from it.

A traced run traces two windows one after the other. The first records
the device alone (kernels, copies, sets): recording every host operation
as well slows the host by some microseconds an operation, which leaves a
host-bound loop (the sampler dispatches some thousand operations a
denoising step) idle for longer than it is untraced. The device's busy
time, idle share and kernel times come from that window. The second also
records the host's operations, and ties each device event to the host
operation that launched it by the profiler's correlation id, so that a
kernel's time can be read by the operation that launched it (aten::bmm,
aten::native_group_norm, ...). The raw events are read once, without
building the profiler's own event tree.
"""

import time
from collections import defaultdict

import torch


class Trace:
    """Use as a context manager around a window; then read `window_s`,
    `busy_s` and the sums. `host_ops` records the host's operations too."""

    def __init__(self, host_ops: bool):
        self.host_ops = host_ops
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernels = []  # (start ns, end ns, kernel name, launching host op)
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] if self.host_ops else []
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        activities = activities or [ProfilerActivity.CPU]  # no device to record
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read(self._prof.profiler.kineto_results.events())
        self._prof = None
        return False

    def _read(self, events):
        ops = {}
        device = []
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CPU:
                if e.linked_correlation_id() == 0:
                    ops[e.correlation_id()] = e.name()
            elif not getattr(e, "is_user_annotation", lambda: False)():
                device.append(e)
        self.kernels = sorted(
            (e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
             ops.get(e.linked_correlation_id(), "?"))
            for e in device
        )
        self.busy_s = sum(end - start for start, end in self._merged()) / 1e9

    def _merged(self):
        out = []
        for start, end, _, _ in self.kernels:
            if out and start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([start, end])
        return out

    def idle_pct(self):
        if self.window_s <= 0 or not self.kernels:
            return None
        return 100.0 * (self.window_s - self.busy_s) / self.window_s

    def seconds_by_op(self, match) -> float:
        """Device seconds of the events whose launching host operation's
        name satisfies `match`."""
        return sum(end - start for start, end, _, op in self.kernels if match(op)) / 1e9

    def seconds_by_kernel(self, match) -> tuple:
        """(device seconds, count) of the events whose own name satisfies
        `match`."""
        hits = [end - start for start, end, name, _ in self.kernels if match(name)]
        return sum(hits) / 1e9, len(hits)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by the host operation that launched the work ending
        each gap."""
        by_name = defaultdict(float)
        for start, end, name, _ in self.kernels:
            by_name[name[:160]] += (end - start) / 1e9
        gaps = defaultdict(float)
        last_end = None
        for start, end, _, op in self.kernels:
            if last_end is not None and start > last_end:
                gaps[op] += (start - last_end) / 1e9
            last_end = end if last_end is None else max(last_end, end)
        return {
            "device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:top],
        }
