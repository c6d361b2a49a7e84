"""A module's forward replayed from one CUDA graph, for loops that call the
same forward many times at one shape: the sampler's denoising steps.

On the card a full-width FDN-UNet forward is about a thousand small
launches, and the host takes longer to make them than the card takes to
run them. `GraphedForward` records the forward once as a CUDA graph
(`ops.graphs.capture`) and afterwards, at each call, copies the inputs into
the graph's own input tensors, replays it and hands back a copy of its
output: the same kernels, one launch from the host.

A caller makes a `GraphedForward` and enters `scope(runner)` around its
loop; a model whose forward asks `active()` (`FDNUNet.forward`) then runs
through the runner. That happens inside `nn.Module.__call__`, so the
model's forward hooks still fire at every call, and see the caller's own
arguments and an output tensor of its own (a copy of the graph's).

Nothing switches the graphs on or off. A call runs eagerly where it
cannot be replayed safely (on the CPU, with grad on, inside another
capture, with an argument that is not a tensor), and a graph is captured
once per key:
  the module; each argument's shape, dtype and device (or None); the
  convolutions' and matmuls' precision (`utils.precision.conv_precision`,
  `matmul_precision`); whether
  inference mode is on; the current stream; and the addresses of the
  module's parameters and buffers.
Each thread keeps graphs of its own. A key whose capture raised runs
eagerly from then on (logged once). Weights
updated in place keep their addresses, so a replay reads their new values;
weights replaced (`load_state_dict(..., assign=True)`, `.to()`) change the
key and a new graph is captured. Each graph holds a private pool of about
one forward's activations, so a module keeps at most GRAPHS_PER_MODULE of
them, freeing the least recently used.

`GraphedForward.captures`, `.replays` and `.eager` count, process-wide,
the forwards that went through a runner, as the kernels' `launches` do.
"""

import contextvars
import logging
import threading
import weakref
from collections import OrderedDict
from contextlib import contextmanager
from typing import Iterator, Optional

import torch

from ..ops import graphs
from ..utils.precision import conv_precision, matmul_precision
from ..utils.profiling import span

GRAPHS_PER_MODULE = 2
CAPTURE_SPAN = "sample.capture"  # the span around each capture

_log = logging.getLogger(__name__)
_active: contextvars.ContextVar[Optional["GraphedForward"]] = contextvars.ContextVar(
    "fea_tpu_torch_graphed_forward", default=None
)


class _ModuleGraphs:
    """One module's graphs on one thread, least recently used first, each
    (its input tensors, its block, whose `output` each replay rewrites),
    and the keys whose capture failed."""

    def __init__(self):
        self.graphs: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.failed = set()


class GraphedForward:
    """Runs `forward(*args)` of a module from a CUDA graph where it can
    (module docstring). `capture` is `ops.graphs.capture` and
    `device_type` "cuda"; the CPU tests hand in a stand-in and "cpu"."""

    captures = 0
    replays = 0
    eager = 0

    def __init__(self, capture=graphs.capture, device_type: str = "cuda"):
        self._capture = capture
        self.device_type = device_type
        self._local = threading.local()

    def _modules(self) -> "weakref.WeakKeyDictionary":
        modules = getattr(self._local, "modules", None)
        if modules is None:
            modules = self._local.modules = weakref.WeakKeyDictionary()
        return modules

    def _device(self, args) -> Optional[torch.device]:
        """The device of a call that can be replayed, else None."""
        if torch.is_grad_enabled():
            return None
        device = None
        for a in args:
            if a is None:
                continue
            if not isinstance(a, torch.Tensor) or a.device.type != self.device_type:
                return None
            device = device or a.device
        if device is not None and device.type == "cuda":
            with torch.cuda.device(device):
                if torch.cuda.is_current_stream_capturing():
                    return None
        return device

    def __call__(self, module, forward, *args):
        """forward(*args), `module`'s forward on tensors (or None): from
        the graph of this call's key, captured now if there is none, or
        eagerly; always a tensor of its own."""
        device = self._device(args)
        if device is None:
            GraphedForward.eager += 1
            return forward(*args)
        key = (
            tuple(None if a is None else (a.shape, a.dtype, a.device) for a in args),
            conv_precision(), matmul_precision(), torch.is_inference_mode_enabled(),
            torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else None,
            _addresses(module),
        )
        modules = self._modules()
        state = modules.get(module)
        if state is None:
            state = modules[module] = _ModuleGraphs()
        graph = state.graphs.get(key)
        if graph is None:
            if key in state.failed:
                GraphedForward.eager += 1
                return forward(*args)
            return self._capture_forward(forward, args, device, key, state)
        state.graphs.move_to_end(key)
        inputs, block = graph
        for static, a in zip(inputs, args):
            if a is not None:
                static.copy_(a)
        block.replay()
        GraphedForward.replays += 1
        return block.output.clone()

    def _capture_forward(self, forward, args, device, key, state):
        """Captures the forward of `key` on copies of `args`; returns the
        output of the eager warm-up that precedes the capture (on the same
        copies), so that this call launches each kernel once, as a replay
        does. A capture that raises is logged, its key runs eagerly from
        then on, and so does this call."""
        inputs = tuple(None if a is None else
                       torch.empty_like(a, memory_format=torch.contiguous_format).copy_(a)
                       for a in args)
        warm = []
        try:
            with span(CAPTURE_SPAN):
                block = self._capture(lambda: forward(*inputs),
                                      lambda: warm.append(forward(*inputs)), device)
        except Exception:  # noqa: BLE001 -- an uncapturable forward still runs, eagerly
            state.failed.add(key)
            _log.warning("a forward on %s could not be captured as a CUDA graph; it runs "
                         "eagerly", [None if a is None else tuple(a.shape) for a in args],
                         exc_info=True)
            GraphedForward.eager += 1
            return forward(*args)
        state.graphs[key] = inputs, block
        while len(state.graphs) > GRAPHS_PER_MODULE:
            state.graphs.popitem(last=False)[1][1].close()
        GraphedForward.captures += 1
        return warm[0]


def _addresses(module) -> tuple:
    """The data addresses of `module`'s parameters and buffers, walking
    its submodules (a module replaced since the last call is walked too)."""
    out, stack = [], [module]
    while stack:
        m = stack.pop()
        out.extend(t.data_ptr() for t in m._parameters.values() if t is not None)
        out.extend(t.data_ptr() for t in m._buffers.values() if t is not None)
        stack.extend(c for c in m._modules.values() if c is not None)
    return tuple(out)


def active() -> Optional[GraphedForward]:
    """The runner of the innermost `scope` on this thread (or context), or
    None."""
    return _active.get()


@contextmanager
def scope(runner: GraphedForward) -> Iterator[GraphedForward]:
    """Forwards that ask `active()` run through `runner` until the block
    ends."""
    token = _active.set(runner)
    try:
        yield runner
    finally:
        _active.reset(token)
