"""The segmented PCG loop body and the flat chunk's default preconditioner
as hand-written CUDA kernels (`csrc/cg_segmented.cu`), with their plain
PyTorch versions.

fea_tpu runs the chunk's CG loop as a `lax.while_loop` that XLA fuses into
one device program (fea_tpu/fem/solver.py:270-302, the body; the
preconditioner fea_tpu/fem/flatgroup.py:329-343). Here a loop body is five
kernels around the operator and the coarse matvec:

    cg_alpha        pAp per (lane, segment); alpha, and the run / lane flags
    cg_update_xr    x += alpha p, r -= alpha Ap on the lanes that run
    jacobi_restrict the 2x2 block-Jacobi term and the coarse restriction
    prolong_dots    z = free (zj + P zc); rz, r2, beta, stall, k
    cg_update_p     p = z + beta p

and `capture` records a block of bodies as one CUDA graph that the host
replays. The state lives in `SegmentedState`'s tensors, allocated once and
updated in place, so a captured block replays on the same memory.

Each wrapper launches its kernel for CUDA tensors and raises on what the
kernel does not take (a dtype other than float32 / float64, another device,
a non-contiguous tensor; for `prolong_dots` where its node count takes
16-byte loads, a vector that does not start on a 16-byte boundary); it takes its plain version (`*_reference`, with
the same signature: the arithmetic of the torch ops the loop ran before,
written into the state in place) only where the tensors lie on the CPU. Every kernel launch adds one to its wrapper's
`launches`; a launch recorded in a CUDA graph counts at each replay of it.
"""

import copy
import ctypes
import functools
import threading
from pathlib import Path

import torch

from ._build import build_library

DTYPES = (torch.float32, torch.float64)
THREADS = 256  # a block of every kernel (csrc/cg_segmented.cu)
# nodes of a segment that one block of cg_alpha's reduction sums: a
# segment's dot products are summed in an order set by its node count
# alone, the same in every chunk (16 blocks a segment at the production
# bucket, 256 over its 16 segments)
NODES_PER_BLOCK = 512
# prolong_dots: a thread-block cluster per segment, a block per
# PROLONG_NODES nodes (a 16-byte load of 4 f32 nodes a thread) up to
# PROLONG_CLUSTER blocks (over 8, the portable size, by the non-portable
# attribute): 8 at the production bucket, 16 from 16,384 nodes, where a
# chunk of few segments at 8 would leave most of the card idle
# (tools/sweep_prolong_dots.py)
PROLONG_CLUSTER = 16
PROLONG_NODES = 4 * THREADS
ALIGN = 16  # bytes: the alignment of every vector prolong_dots and band_matvec load


def build() -> Path:
    """Compile the kernels' library (at first use); its path."""
    return build_library("fea_cg_segmented", ["cg_segmented.cu"])


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    signatures = {
        "fea_cg_alpha": [i] + [p] * 13 + [i] * 6 + [p],
        "fea_cg_update_xr": [i] + [p] * 6 + [i] * 3 + [p],
        "fea_cg_jacobi_restrict": [i] + [p] * 6 + [i, ll, i, i, p],
        "fea_cg_prolong_dots": [i] + [p] * 7 + [i] + [p] * 8 + [i] * 7 + [p],
        "fea_cg_update_p": [i] + [p] * 5 + [i] * 3 + [p],
    }
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = i
    lib.fea_cg_load.argtypes = []
    lib.fea_cg_load.restype = i
    lib.fea_cuda_error_string.argtypes = [i]
    lib.fea_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load(index: int):
    """Build the library and load every kernel into device `index`'s
    context (before a capture: a kernel that loaded lazily at its first
    launch would load while the graph is recorded)."""
    lib = _library()
    with torch.cuda.device(index):
        _raise_on(lib.fea_cg_load(), "loading the kernels")
    return lib


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"CG kernel {what} failed: " + _library().fea_cuda_error_string(err).decode())


def _groups(seg_nodes: int) -> int:
    """Blocks per segment of cg_alpha's reduction."""
    return -(-seg_nodes // NODES_PER_BLOCK)


def prolong_plan(seg_nodes: int):
    """(cluster, span) of `prolong_dots` over segments of `seg_nodes`
    nodes: the cluster's block of rank b takes the nodes [b span, min(Ns,
    (b + 1) span)), span a multiple of 4 (a 16-byte load of f32, two of
    f64). Every rank gets nodes; the ranges tile the segment once."""
    cluster = min(PROLONG_CLUSTER, -(-seg_nodes // PROLONG_NODES))
    span = -(-seg_nodes // cluster)
    return cluster, -(-span // 4) * 4


def prolong_vector(seg_nodes: int, dtype) -> int:
    """Values of `prolong_dots`' loads: 16 bytes where every segment
    starts on a multiple of them, else one (a ragged node count)."""
    vec = ALIGN // (torch.finfo(dtype).bits // 8)
    return vec if seg_nodes % vec == 0 else 1


def _check_aligned(kernel, named):
    """Raises unless every tensor of `named` ({name: tensor or None})
    starts on a 16-byte boundary (the kernel's vector loads)."""
    for name, t in named.items():
        if t is not None and t.data_ptr() % ALIGN:
            raise ValueError(f"{name}: {kernel} takes tensors that start on a {ALIGN}-byte "
                             f"boundary; got an offset of {t.data_ptr() % ALIGN} bytes")


# ---- the loop's state ---------------------------------------------------


class SegmentedState:
    """The state of `pcg_solve_segmented`'s loop for L lanes of P segments
    of Ns nodes, in tensors allocated once and updated in place: vectors x,
    r, p, z (L, 2 * P * Ns); per segment rz, r2, best (best_r2), atol2,
    stall, active, and the body's alpha, beta and run flags (L, P); per lane
    k and the lane flag (L,); cg_alpha's partial sums and tickets (the
    kernel resets each ticket it uses)."""

    def __init__(self, lanes: int, n_seg: int, seg_nodes: int, dtype, device,
                 max_iters: int, stall_limit: int):
        if dtype not in DTYPES:
            raise TypeError(f"the CG state takes float32 or float64, not {dtype}")
        device = torch.device(device)
        self.P, self.Ns = n_seg, seg_nodes
        self.max_iters, self.stall_limit = max_iters, stall_limit
        self.groups = _groups(seg_nodes)

        def zeros(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        vec, seg = (lanes, 2 * n_seg * seg_nodes), (lanes, n_seg)
        self.x, self.r, self.p, self.z = (zeros(vec) for _ in range(4))
        self.rz, self.r2, self.best, self.atol2, self.alpha, self.beta = (zeros(seg) for _ in range(6))
        self.stall = zeros(seg, torch.int32)
        self.active, self.run = zeros(seg, torch.bool), zeros(seg, torch.bool)
        self.k = zeros(lanes, torch.int32)
        self.lane = zeros(lanes, torch.bool)
        self.partials = zeros(lanes * n_seg * self.groups * 2)
        self.tickets = zeros(lanes * n_seg, torch.int32)

    TENSORS = ("x", "r", "p", "z", "rz", "r2", "best", "atol2", "alpha", "beta", "stall",
               "active", "run", "k", "lane", "partials", "tickets")

    def clone(self):
        """A state with copies of every tensor (to hold one launch of the
        kernel and of the plain version against each other)."""
        other = copy.copy(self)
        for name in self.TENSORS:
            setattr(other, name, getattr(self, name).clone())
        return other

    def start(self, x, r, p, rz, r2, active):
        """A restart: the vectors and per-segment values given, best_r2 =
        r2, stall and k 0."""
        for dst, src in ((self.x, x), (self.r, r), (self.p, p), (self.rz, rz), (self.r2, r2),
                         (self.best, r2), (self.active, active)):
            dst.copy_(src.reshape(dst.shape))
        self.stall.zero_()
        self.k.zero_()

    def running(self):
        """(L, P) segments whose loop condition holds."""
        return ((self.r2 > self.atol2) & torch.isfinite(self.r2)
                & (self.stall < self.stall_limit) & self.active)

    def lanes_running(self):
        """(L,) lanes whose loop condition holds: a segment runs and k is
        under the budget."""
        return self.running().any(dim=-1) & (self.k < self.max_iters)

    def segments(self, u):
        """(L, 2 * P * Ns) -> (L, 2, P, Ns), the segments' view."""
        return u.reshape(u.shape[0], 2, self.P, self.Ns)

    def expand(self, s):
        """(L, P) -> (L, 2 * P * Ns), each segment's value on its nodes."""
        L = s.shape[0]
        return s[:, None, :, None].expand(L, 2, self.P, self.Ns).reshape(L, -1)

    def sdot(self, u, v):
        """(L, P) per-segment dot products, as the torch ops sum them."""
        return self.segments(u * v).sum(dim=(-3, -1))


# ---- checks of the CUDA route -------------------------------------------


def _check(device, dtype, named):
    """Raises unless every tensor of `named` ({name: (tensor, dtype or
    None for `dtype`, shape)}; a None tensor is skipped) lies on `device`,
    contiguous, of its dtype and shape."""
    if device.type != "cuda":
        raise ValueError(f"the CG loop's kernels take CUDA tensors; got {device}")
    if dtype not in DTYPES:
        raise TypeError(f"the CG loop's kernels take float32 or float64; got {dtype}")
    for name, (t, dt, shape) in named.items():
        if t is None:
            continue
        want = dtype if dt is None else dt
        if t.device != device or t.dtype != want or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: the CG loop's kernels take a contiguous {want} {tuple(shape)} on {device}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
                + ("" if t.is_contiguous() else " (not contiguous)"))


def _state_tensors(state, *names):
    L, P = state.k.shape[0], state.P
    shapes = {"x": (L, 2 * P * state.Ns), "r": (L, 2 * P * state.Ns), "p": (L, 2 * P * state.Ns),
              "z": (L, 2 * P * state.Ns), "rz": (L, P), "r2": (L, P), "best": (L, P),
              "atol2": (L, P), "alpha": (L, P), "beta": (L, P), "stall": (L, P),
              "active": (L, P), "run": (L, P), "k": (L,), "lane": (L,),
              "partials": (L * P * state.groups * 2,), "tickets": (L * P,)}
    types = {"stall": torch.int32, "k": torch.int32, "tickets": torch.int32,
             "active": torch.bool, "run": torch.bool, "lane": torch.bool}
    return {f"state.{n}": (getattr(state, n), types.get(n), shapes[n]) for n in names}


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


# ---- capture: a block of bodies as one CUDA graph -----------------------

_capture = threading.local()  # this thread's tally while it records a graph
_side_streams = threading.local()


def _count(wrapper):
    tally = getattr(_capture, "tally", None)
    if tally is None:
        wrapper.launches += 1
    else:  # recorded, not launched: counted at each replay
        tally[wrapper] = tally.get(wrapper, 0) + 1


class CapturedBlock:
    """A CUDA graph of some loop bodies, replayed on the caller's stream;
    each replay adds the kernels it launches to their wrappers' counts.
    `close` frees the graph and its private memory pool."""

    def __init__(self, graph, tally):
        self.graph, self.tally = graph, tally

    def replay(self):
        self.graph.replay()
        for wrapper, n in self.tally.items():
            wrapper.launches += n

    def close(self):
        self.graph.reset()
        self.graph = None


def capture(fn, warmup, device) -> CapturedBlock:
    """Record `fn`'s device work on `device` as a CUDA graph. It is
    captured on a side stream of this thread's own, after that stream
    waited for the caller's, and after `warmup` ran there once (so that
    libraries such as cuBLAS set up their per-stream state outside the
    capture); the capture mode is thread-local, so other threads may
    allocate and launch meanwhile. A failed capture raises."""
    load(device.index or 0)
    streams = getattr(_side_streams, "streams", None)
    if streams is None:
        streams = _side_streams.streams = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    side, current = streams[device], torch.cuda.current_stream(device)
    side.wait_stream(current)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.stream(side):
        warmup()
        _capture.tally = {}
        try:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                fn()
            finally:
                graph.capture_end()
            tally = _capture.tally
        finally:
            _capture.tally = None
    current.wait_stream(side)
    return CapturedBlock(graph, tally)


# ---- launch 1: alpha ----------------------------------------------------


def cg_alpha_reference(state, Ap):
    """pAp per segment; alpha = rz / pAp on the segments whose condition
    holds (0 elsewhere), their run flags, and the lane flags (a segment
    runs and k is under the budget), all from the state at the start of
    the body."""
    run = state.running()
    pAp = state.sdot(state.p, Ap)
    state.alpha.copy_(torch.where(run, state.rz / torch.where(pAp != 0, pAp, 1.0), 0.0))
    state.run.copy_(run)
    state.lane.copy_(run.any(dim=-1) & (state.k < state.max_iters))


def cg_alpha(state, Ap):
    if state.x.device.type == "cpu":
        return cg_alpha_reference(state, Ap)
    _check(state.x.device, state.x.dtype, {
        "Ap": (Ap, None, state.p.shape),
        **_state_tensors(state, "p", "rz", "r2", "atol2", "stall", "active", "k", "alpha", "run",
                         "lane", "partials", "tickets")})
    L = state.k.shape[0]
    lib = load(state.x.device.index or 0)
    with torch.cuda.device(state.x.device):
        err = lib.fea_cg_alpha(
            int(state.x.dtype == torch.float64), *map(_ptr, (
                state.p, Ap, state.rz, state.r2, state.atol2, state.stall, state.active, state.k,
                state.alpha, state.run, state.lane, state.partials, state.tickets)),
            L, state.P, state.Ns, state.groups, state.max_iters, state.stall_limit,
            _stream(state.x.device))
    _raise_on(err, "cg_alpha launch")
    _count(cg_alpha)


cg_alpha.launches = 0


# ---- launch 2: x and r --------------------------------------------------


def cg_update_xr_reference(state, Ap):
    """x += alpha p and r -= alpha Ap on the lanes that run."""
    alpha = state.expand(state.alpha)
    keep = state.lane[:, None]
    state.x.copy_(torch.where(keep, state.x + alpha * state.p, state.x))
    state.r.copy_(torch.where(keep, state.r - alpha * Ap, state.r))


def cg_update_xr(state, Ap):
    if state.x.device.type == "cpu":
        return cg_update_xr_reference(state, Ap)
    _check(state.x.device, state.x.dtype, {
        "Ap": (Ap, None, state.p.shape), **_state_tensors(state, "x", "r", "p", "alpha", "lane")})
    lib = load(state.x.device.index or 0)
    with torch.cuda.device(state.x.device):
        err = lib.fea_cg_update_xr(
            int(state.x.dtype == torch.float64),
            *map(_ptr, (state.x, state.r, state.p, Ap, state.alpha, state.lane)),
            state.k.shape[0], state.P, state.Ns, _stream(state.x.device))
    _raise_on(err, "cg_update_xr launch")
    _count(cg_update_xr)


cg_update_xr.launches = 0


# ---- launch 3: the block-Jacobi term and the coarse restriction ---------


def jacobi_restrict_reference(r, block_inv, arms, members, zj, rc):
    """zj = the 2x2 block inverse (L, 2, 2, PN) applied to r (L, 2 * PN)
    node by node, where `block_inv` is given; rc (L, NA, 3) = per
    aggregate, the sum over its row of `members` (NA, W; PN pads) of (rx,
    ry, -arm_y rx + arm_x ry), where `members` is given."""
    L, PN = r.shape[0], r.shape[1] // 2
    if block_inv is not None:
        zj.copy_((block_inv * r.reshape(L, 1, 2, PN)).sum(dim=-2).reshape(L, -1))
    if members is not None:
        rx, ry = r[:, :PN], r[:, PN:]
        armx, army = arms[:, 0], arms[:, 1]
        moments = torch.stack([rx, ry, -army * rx + armx * ry], dim=-2)  # (L, 3, PN)
        moments = torch.cat([moments, moments.new_zeros((L, 3, 1))], dim=-1)
        rc.copy_(moments[..., members].sum(dim=-1).transpose(-1, -2))


def jacobi_restrict(r, block_inv, arms, members, zj, rc):
    if r.device.type == "cpu":
        return jacobi_restrict_reference(r, block_inv, arms, members, zj, rc)
    L, PN = r.shape[0], r.shape[1] // 2
    NA, W = (0, 0) if members is None else tuple(members.shape)
    _check(r.device, r.dtype, {
        "r": (r, None, (L, 2 * PN)), "block_inv": (block_inv, None, (L, 2, 2, PN)),
        "zj": (zj if block_inv is not None else None, None, (L, 2 * PN)),
        "arms": (arms if members is not None else None, None, (PN, 2)),
        "members": (members, torch.int32, (NA, W)),
        "rc": (rc if members is not None else None, None, (L, NA, 3))})
    if (block_inv is None) != (zj is None) or (members is None) != (rc is None):
        raise ValueError("jacobi_restrict: block_inv goes with zj, members with arms and rc")
    lib = load(r.device.index or 0)
    with torch.cuda.device(r.device):
        err = lib.fea_cg_jacobi_restrict(
            int(r.dtype == torch.float64), *map(_ptr, (r, block_inv, arms, members, zj, rc)),
            L, PN, NA, W, _stream(r.device))
    _raise_on(err, "jacobi_restrict launch")
    _count(jacobi_restrict)


jacobi_restrict.launches = 0


# ---- launch 4: the prolongation, the mask and the rz / r2 dots ----------


def prolong_dots_reference(zj, zc, agg, arms, free, z, n_seg, state=None):
    """z = (zj + P zc) * free, with P zc the coarse solution zc (L, NA, 3)
    prolonged by aggregate id `agg` (PN,): (zc_x - arm_y zc_rot, zc_y +
    arm_x zc_rot). zj None is 0, zc None no coarse term, free None no mask.
    With the state (z is then state.z, zj's vectors state.r's shape): rz =
    r.z and r2 = r.r per segment, beta = rz / rz_old where a segment runs,
    and on the lanes that run rz, r2, best_r2, stall and k as the loop body
    updates them."""
    L = z.shape[0]
    PN = z.shape[1] // 2
    out = zj
    if zc is not None:
        zc3 = zc.reshape(L, -1, 3)[:, agg, :]  # (L, PN, 3)
        armx, army = arms[:, 0], arms[:, 1]
        zx = zc3[..., 0] - army * zc3[..., 2]
        zy = zc3[..., 1] + armx * zc3[..., 2]
        coarse = torch.cat([zx, zy], dim=-1)
        out = coarse if out is None else out + coarse
    if free is not None:
        out = out * free
    z.copy_(out.reshape(L, 2 * PN))
    if state is None:
        return
    s = state
    rz_new = s.sdot(s.r, s.z)
    r2_new = s.sdot(s.r, s.r)
    run = s.run
    s.beta.copy_(torch.where(run, rz_new / torch.where(s.rz != 0, s.rz, 1.0), 0.0))
    improved = run & (r2_new < 0.9 * s.best)
    rz_next = torch.where(run, rz_new, s.rz)
    best_new = torch.where(improved, r2_new, s.best)
    stall_new = torch.where(improved, 0, torch.where(run, s.stall + 1, s.stall))
    keep = s.lane[:, None]
    s.rz.copy_(torch.where(keep, rz_next, s.rz))
    s.r2.copy_(torch.where(keep, r2_new, s.r2))
    s.best.copy_(torch.where(keep, best_new, s.best))
    s.stall.copy_(torch.where(keep, stall_new, s.stall))
    s.k.add_(s.lane.to(s.k.dtype))


def prolong_dots(zj, zc, agg, arms, free, z, n_seg, state=None):
    if z.device.type == "cpu":
        return prolong_dots_reference(zj, zc, agg, arms, free, z, n_seg, state)
    L, ndof = z.shape
    PN = ndof // 2
    NA = 0 if zc is None else zc.numel() // (3 * L)
    if zc is not None and not zc.is_contiguous():
        raise ValueError("prolong_dots takes a contiguous zc")
    zc = None if zc is None else zc.reshape(L, NA, 3)
    agg, arms = (agg, arms) if zc is not None else (None, None)
    named = {"z": (z, None, (L, ndof)), "zj": (zj, None, (L, ndof)), "zc": (zc, None, (L, NA, 3)),
             "agg": (agg, torch.int32, (PN,)), "arms": (arms, None, (PN, 2)),
             "free": (free, None, (L, ndof))}
    if state is not None:
        if z is not state.z or state.P != n_seg:
            raise ValueError("prolong_dots with the state writes state.z, over the state's segments")
        named.update(_state_tensors(state, "r", "rz", "r2", "best", "stall", "k", "beta", "run",
                                    "lane"))
    _check(z.device, z.dtype, named)
    if ndof % (2 * n_seg):
        raise ValueError(f"{ndof} dofs do not split into {n_seg} segments of two components")
    s = state
    Ns = ndof // (2 * n_seg)
    vec = prolong_vector(Ns, z.dtype)
    if vec > 1:
        _check_aligned("prolong_dots", {"z": z, "zj": zj, "agg": agg, "arms": arms,
                                        "free": free, "state.r": None if s is None else s.r})
    cluster, span = prolong_plan(Ns)
    lib = load(z.device.index or 0)
    with torch.cuda.device(z.device):
        err = lib.fea_cg_prolong_dots(
            int(z.dtype == torch.float64),
            *map(_ptr, (zj, zc, agg, arms, free, z, None if s is None else s.r)),
            int(s is not None),
            *map(_ptr, (None,) * 8 if s is None
                 else (s.rz, s.r2, s.best, s.stall, s.k, s.beta, s.run, s.lane)),
            L, n_seg, Ns, cluster, span, vec, NA, _stream(z.device))
    _raise_on(err, "prolong_dots launch")
    _count(prolong_dots)


prolong_dots.launches = 0


# ---- launch 5: p --------------------------------------------------------


def cg_update_p_reference(state):
    """p = z + beta p on the segments that run, in the lanes that run."""
    p_new = torch.where(state.expand(state.run), state.z + state.expand(state.beta) * state.p,
                        state.p)
    state.p.copy_(torch.where(state.lane[:, None], p_new, state.p))


def cg_update_p(state):
    if state.x.device.type == "cpu":
        return cg_update_p_reference(state)
    _check(state.x.device, state.x.dtype, _state_tensors(state, "p", "z", "beta", "run", "lane"))
    lib = load(state.x.device.index or 0)
    with torch.cuda.device(state.x.device):
        err = lib.fea_cg_update_p(
            int(state.x.dtype == torch.float64),
            *map(_ptr, (state.p, state.z, state.beta, state.run, state.lane)),
            state.k.shape[0], state.P, state.Ns, _stream(state.x.device))
    _raise_on(err, "cg_update_p launch")
    _count(cg_update_p)


cg_update_p.launches = 0

WRAPPERS = (cg_alpha, cg_update_xr, jacobi_restrict, prolong_dots, cg_update_p)
