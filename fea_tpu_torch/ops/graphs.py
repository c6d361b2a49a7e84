"""CUDA graphs of the port's device work: `capture` records what a function
launches as one graph that the host replays, and `count` keeps the
hand-written kernels' launch counters true across replays.

Two loops replay graphs: the chunk's CG loop a block of bodies at a time
(`ops.cg.capture`, `fem/solver.py`) and the sampler one FDN-UNet forward a
denoising step (`models/graphed.py`). A kernel wrapper counts each launch
with `count(wrapper)` (or `count(wrapper, "launches_fwd")`): a launch made
from the host adds one to the counter at once; a launch recorded while
this thread captures a graph adds nothing then, and one at each replay of
that graph.
"""

import threading

import torch

_capture = threading.local()  # this thread's tally while it records a graph
_side_streams = threading.local()


def count(wrapper, name: str = "launches"):
    """One launch of `wrapper`'s kernel, in its counter `name`: now, or
    at each replay where this thread is recording a graph."""
    tally = getattr(_capture, "tally", None)
    if tally is None:
        setattr(wrapper, name, getattr(wrapper, name) + 1)
    else:  # recorded, not launched: counted at each replay
        tally[wrapper, name] = tally.get((wrapper, name), 0) + 1


class CapturedBlock:
    """A CUDA graph, replayed on the caller's stream; each replay adds the
    kernels it launches to their wrappers' counters and rewrites `output`,
    what the captured function returned. `close` frees the graph and its
    private memory pool."""

    def __init__(self, graph, tally, output=None):
        self.graph, self.tally, self.output = graph, tally, output

    def replay(self):
        self.graph.replay()
        for (wrapper, name), n in self.tally.items():
            setattr(wrapper, name, getattr(wrapper, name) + n)

    def close(self):
        self.graph.reset()
        self.graph = None


def capture(fn, warmup, device) -> CapturedBlock:
    """Record `fn`'s device work on `device` as a CUDA graph (the block's
    `output` is what `fn` returned while it was recorded). It is
    captured on a side stream of this thread's own, after that stream
    waited for the caller's, and after `warmup` ran there once (so that
    libraries such as cuBLAS and cuDNN set up their per-stream state, and
    every kernel is loaded, outside the capture); the capture mode is
    thread-local, so other threads may allocate and launch meanwhile. The
    caller's stream then waits for the side stream, also when the capture
    fails. A failed capture raises."""
    streams = getattr(_side_streams, "streams", None)
    if streams is None:
        streams = _side_streams.streams = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    side, current = streams[device], torch.cuda.current_stream(device)
    side.wait_stream(current)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.device(device), torch.cuda.stream(side):
            warmup()
            _capture.tally = {}
            try:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    output = fn()
                finally:
                    graph.capture_end()
                tally = _capture.tally
            finally:
                _capture.tally = None
    finally:
        current.wait_stream(side)
    return CapturedBlock(graph, tally, output)
