"""The device's idle time put down to what the host was doing: the idle
gaps of a device trace's window, each part of a gap charged to the
program's innermost span open on the host at that moment
(`fea_tpu_torch.utils.profiling`'s spans, on the profiler's clock).

`kernels` are device events (start ns, end ns, ...) as `Trace.kernels`
holds them; `spans` are (start ns, end ns, name, parent index, ...) as
`Recorder.on_profiler_clock()` gives them, the parent an index into the
same list; `window` is (start ns, end ns). All on one clock. Where spans
of several threads are open at once the innermost is the one that began
last.
"""

import heapq
from collections import defaultdict


def idle_gaps(kernels, window) -> list:
    """The window's intervals with no device event, in order."""
    w0, w1 = window
    gaps, t = [], w0
    for start, end, *_ in sorted(kernels):
        if start > t:
            gaps.append((t, min(start, w1)))
        t = max(t, end)
        if t >= w1:
            break
    if t < w1:
        gaps.append((t, w1))
    return [(a, b) for a, b in gaps if b > a]


def idle_by_innermost(kernels, spans, window) -> dict:
    """{index of the innermost open span, or None for no span: idle ns}."""
    gaps = idle_gaps(kernels, window)
    edges = sorted([(s[0], 1, i) for i, s in enumerate(spans)]
                   + [(s[1], 0, i) for i, s in enumerate(spans)])
    edges.append((window[1], 2, None))
    out = defaultdict(int)
    heap, closed, g, t = [], set(), 0, window[0]
    for time, kind, i in edges:
        if time > t:
            while heap and heap[0][2] in closed:
                heapq.heappop(heap)
            label = heap[0][2] if heap else None
            # the gaps' overlap with [t, time)
            while g < len(gaps) and gaps[g][1] <= t:
                g += 1
            k = g
            while k < len(gaps) and gaps[k][0] < time:
                out[label] += min(gaps[k][1], time) - max(gaps[k][0], t)
                k += 1
            t = time
        if kind == 1:
            heapq.heappush(heap, (-spans[i][0], -i, i))
        elif kind == 0:
            closed.add(i)
        if t >= window[1]:
            break
    return dict(out)


def _within(spans, i, names) -> bool:
    while i is not None:
        if spans[i][2] in names:
            return True
        i = spans[i][3]
    return False


def idle_by_span(kernels, spans, window, names) -> tuple:
    """(idle ns while the innermost open span was one of `names` or a
    descendant of one, idle ns with no span open)."""
    by = idle_by_innermost(kernels, spans, window)
    inside = sum(ns for i, ns in by.items() if i is not None and _within(spans, i, names))
    return inside, by.get(None, 0)


def idle_by_name(kernels, spans, window) -> dict:
    """{name of the innermost open span, or None: idle ns}."""
    out = defaultdict(int)
    for i, ns in idle_by_innermost(kernels, spans, window).items():
        out[None if i is None else spans[i][2]] += ns
    return dict(out)
