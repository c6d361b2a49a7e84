"""Tracing and profiling, the port of fea_tpu/utils/profiling.py.

The reference's only observability is wall-clock prints around each solve
(datagen/generate.py:109-127). Here:

- spans: `span(name, step=, request=)` marks an interval of the host's
  work (a train step, its batch fetch, its dispatch, a sampler request and
  its steps, a garbage collection, a datagen stage). Nothing is recorded
  unless a `recording()` (or a `device_trace`) is active: then one
  `Recorder` keeps every span in memory, with its parent and its place on
  the clock of torch.profiler's events, so that what the host was doing
  can be read beside the device's kernels;
- a per-stage timing registry usable as a context manager (the datagen
  scheduler charges each of its stages to one); its stages are spans too;
- a torch.profiler trace of the host and the device written to a log
  directory, with the program's spans on a track of their own.
"""

import contextlib
import gc
import itertools
import json
import os
import socket
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import torch

# the Recorder that spans go to; None when nothing records (the default)
_active = None


class _Off:
    """What `span` returns when nothing records: one shared object that
    does nothing, so that an unrecorded span costs a call and a test."""

    __slots__ = ()
    request = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One interval of the host's work: `name`, `start_ns` and `end_ns`
    on `time.perf_counter_ns`'s clock, `parent` (the index in
    `Recorder.spans` of the span open on the same thread when this one
    began, or None), `thread` (the native thread id) and the identifiers
    `step` and `request` shared by the spans of one step or one request."""

    __slots__ = ("recorder", "index", "name", "start_ns", "end_ns", "parent", "thread",
                 "step", "request")

    def __init__(self, recorder, name, step=None, request=None):
        self.recorder = recorder
        self.name = name
        self.step = step
        self.request = request
        self.index = self.parent = self.end_ns = None

    def __enter__(self):
        self.recorder._open(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        self.recorder._stack().pop()
        return False


class Recorder:
    """The spans of one recording, in the order they began. `anchors`
    pairs the profiler's clock (Unix time in ns, which torch.profiler's
    kineto events and Chrome traces use) with `perf_counter_ns`, read
    together at the start and at the end of the recording."""

    def __init__(self):
        self.spans: List[Span] = []
        self.anchors = [_anchor()]
        self._lock = threading.Lock()
        self._local = threading.local()
        self._requests = itertools.count()

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, s: Span):
        stack = self._stack()
        s.parent = stack[-1].index if stack else None
        s.thread = threading.get_native_id()
        with self._lock:
            s.index = len(self.spans)
            self.spans.append(s)
        stack.append(s)

    def new_request(self) -> int:
        return next(self._requests)

    def profiler_ns(self, perf_ns: int) -> int:
        """`perf_ns` on the profiler's clock, by the line through the
        recording's anchors (the offset of the first while it runs)."""
        (wall0, perf0), (wall1, perf1) = self.anchors[0], self.anchors[-1]
        rate = (wall1 - wall0) / (perf1 - perf0) if perf1 > perf0 else 1.0
        return wall0 + round((perf_ns - perf0) * rate)

    def on_profiler_clock(self) -> List[tuple]:
        """(start ns, end ns, name, parent index, step, request) of every
        finished span, start and end on the profiler's clock, in the
        order of `spans` (parents keep their indices; an unfinished span
        ends at the recording's last anchor)."""
        last = self.anchors[-1][1]
        return [(self.profiler_ns(s.start_ns), self.profiler_ns(s.end_ns or last), s.name,
                 s.parent, s.step, s.request) for s in self.spans]

    def _gc_callback(self, phase, info):
        local = self._local
        if phase == "start":
            local.gc = Span(self, f"gc.gen{info['generation']}").__enter__()
        elif getattr(local, "gc", None) is not None:
            local.gc.__exit__(None, None, None)
            local.gc = None


def _anchor():
    """(Unix ns, perf_counter ns) read together: the perf counter is read
    on both sides of the wall clock and the two reads averaged."""
    p0 = time.perf_counter_ns()
    wall = time.time_ns()
    p1 = time.perf_counter_ns()
    return wall, (p0 + p1) // 2


def span(name: str, step: Optional[int] = None, request: Optional[int] = None):
    """A context manager that records the interval it encloses as a span
    named `name` while a recording is active; otherwise the shared no-op
    object (no allocation, no torch call)."""
    if _active is None:
        return _OFF
    return Span(_active, name, step, request)


def request_span(name: str):
    """`span(name)` with a new request identifier from the active
    recorder, read back as `.request` to tag the request's own spans
    (None when nothing records)."""
    if _active is None:
        return _OFF
    return Span(_active, name, request=_active.new_request())


@contextlib.contextmanager
def recording():
    """Record spans, and a `gc.gen{0,1,2}` span for each collection of
    Python's garbage collector, until the block ends; yields the
    Recorder. One recording at a time."""
    global _active
    if _active is not None:
        raise RuntimeError("a span recording is already active")
    recorder = Recorder()
    _active = recorder
    gc.callbacks.append(recorder._gc_callback)
    try:
        yield recorder
    finally:
        gc.callbacks.remove(recorder._gc_callback)
        _active = None
        recorder.anchors.append(_anchor())


class StageTimer:
    """Accumulates wall-clock per named stage.

    with timer.stage("solve"): ...
    print(timer.summary())

    While a recording is active each stage is also a span named
    `datagen.<stage>` (the datagen scheduler is the program's timer).
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            with span("datagen." + name):
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


# the Chrome trace's process (a track of its own) that holds the spans
SPAN_TRACK = "fea_tpu_torch spans"


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """A torch.profiler trace of the host's operators and, where CUDA is
    available, the device's kernels, with the program's spans recorded
    over the same window; yields the Recorder. Written to `log_dir` as
    one Chrome trace (`<host>_<pid>.<ms>.pt.trace.json`, which
    TensorBoard's profiler plugin and Perfetto read) that holds the
    spans as complete events on the profiler's clock, one track per
    thread under the process `SPAN_TRACK`. No-op when log_dir is None."""
    if log_dir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with recording() as recorder:
        with torch.profiler.profile(activities=activities) as prof:
            yield recorder
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 10**6}.pt.trace.json"
    path = Path(log_dir) / name
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(span_events(recorder, trace.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(trace, f)


def span_events(recorder: Recorder, base_ns: int = 0) -> List[dict]:
    """The recorder's spans as Chrome trace events: complete events
    ("ph": "X", microseconds from `base_ns` on the profiler's clock), each
    with its index, parent, step and request in `args`, under the process
    `SPAN_TRACK`, a track per recording thread."""
    threads = {s.thread for s in recorder.spans}
    events = [{"ph": "M", "name": "process_name", "pid": SPAN_TRACK, "tid": 0,
               "args": {"name": SPAN_TRACK}}]
    events += [{"ph": "M", "name": "thread_name", "pid": SPAN_TRACK, "tid": t,
                "args": {"name": f"thread {t}"}} for t in sorted(threads)]
    for s, (start, end, name, parent, step, request) in zip(recorder.spans,
                                                           recorder.on_profiler_clock()):
        args = {"index": s.index, "parent": parent}
        args.update({k: v for k, v in (("step", step), ("request", request)) if v is not None})
        events.append({"ph": "X", "cat": "span", "name": name, "pid": SPAN_TRACK,
                       "tid": s.thread, "ts": (start - base_ns) / 1e3,
                       "dur": (end - start) / 1e3, "args": args})
    return events
