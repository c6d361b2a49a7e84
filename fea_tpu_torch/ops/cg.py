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
a non-contiguous tensor; where the node count takes 16-byte loads, a
vector that does not start on a 16-byte boundary); it takes its plain
version (`*_reference`, with the same signature: the arithmetic of the
torch ops the loop ran before, written into the state in place) only where
the tensors lie on the CPU. Every kernel launch adds one to its wrapper's
`launches`; a launch recorded in a CUDA graph counts at each replay of it.
"""

import copy
import ctypes
from typing import NamedTuple

import torch

from . import graphs
from ._build import ALIGN, bind, check_aligned, check_tensors

DTYPES = (torch.float32, torch.float64)
THREADS = 256  # a block of every kernel (csrc/cg_segmented.cu)
# prolong_dots and cg_alpha: a thread-block cluster per segment, a block
# per PROLONG_NODES nodes (a 16-byte load of 4 f32 nodes a thread) up to
# PROLONG_CLUSTER blocks for prolong_dots (over 8, the portable size, by
# the non-portable attribute): 8 at the production bucket, 16 from 16,384
# nodes, where a chunk of few segments at 8 would leave most of the card
# idle; up to ALPHA_CLUSTER for cg_alpha, which reads 2 vectors a node
# where prolong_dots reads 4-5: at 16 segments of 32,768 or 131,072 nodes
# 8 blocks a segment beat 16 (tools/sweep_prolong_dots.py, PERF.md). A
# segment's sums are taken in an order set by its node count alone, the
# same in every chunk.
PROLONG_CLUSTER = 16
ALPHA_CLUSTER = 8
PROLONG_NODES = 4 * THREADS
# cg_update_p: a block per UPDATE_P_NODES nodes of a segment (a 16-byte
# load of 4 f32 nodes a thread), 128 blocks over phase 9's chunk (16
# segments of 8,192 nodes) on the card's 132 SMs
UPDATE_P_NODES = 4 * THREADS
# cg_update_xr: the same grid, a block per UPDATE_XR_NODES nodes of a segment
UPDATE_XR_NODES = 4 * THREADS
# jacobi_restrict: blocks of RESTRICT_WARPS warps; a warp per aggregate for
# up to RESTRICT_LANES lanes a pass (the 3 sums of each kept in
# registers), the restriction's blocks first in the grid (its chain of
# dependent loads is the longer); Jacobi blocks of JACOBI_NODES nodes of a
# lane. Over phase 9's chunk (4 lanes of 32,768 nodes, 2,048 aggregates):
# 1,024 restriction blocks and 256 Jacobi blocks of 64 threads, the plan
# that tools/sweep_prolong_dots.py chose (PERF.md)
JACOBI_NODES = 512
RESTRICT_WARPS = 2
RESTRICT_LANES = 8
JACOBI_FIRST = False

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = bind("fea_cg_segmented", ["cg_segmented.cu"], {
    "fea_cg_alpha": ([_i] + [_p] * 11 + [_i] * 8 + [_p], _i),
    "fea_cg_update_xr": ([_i] + [_p] * 6 + [_i] * 6 + [_p], _i),
    "fea_cg_jacobi_restrict": ([_i] + [_p] * 6 + [_i, _ll] + [_i] * 7 + [_p], _i),
    "fea_cg_prolong_dots": ([_i] + [_p] * 7 + [_i] + [_p] * 8 + [_i] * 7 + [_p], _i),
    "fea_cg_update_p": ([_i] + [_p] * 5 + [_i] * 6 + [_p], _i),
}, load_symbol="fea_cg_load")


def prolong_plan(seg_nodes: int, max_cluster: int = PROLONG_CLUSTER):
    """(cluster, span) of `prolong_dots` over segments of `seg_nodes`
    nodes: the cluster's block of rank b takes the nodes [b span, min(Ns,
    (b + 1) span)), span a multiple of 4 (a 16-byte load of f32, two of
    f64). Every rank gets nodes; the ranges tile the segment once."""
    cluster = min(max_cluster, -(-seg_nodes // PROLONG_NODES))
    span = -(-seg_nodes // cluster)
    return cluster, -(-span // 4) * 4


def alpha_plan(seg_nodes: int):
    """(cluster, span) of `cg_alpha`: `prolong_plan`'s layout, clusters of
    at most ALPHA_CLUSTER blocks."""
    return prolong_plan(seg_nodes, ALPHA_CLUSTER)


def update_p_plan(seg_nodes: int):
    """(blocks, span) of `cg_update_p` per segment of `seg_nodes` nodes:
    block b takes the nodes [b span, min(Ns, (b + 1) span)), span a
    multiple of 4; the ranges tile the segment once."""
    return -(-seg_nodes // UPDATE_P_NODES), UPDATE_P_NODES


def update_xr_plan(seg_nodes: int):
    """(blocks, span) of `cg_update_xr` per segment, laid out as
    `update_p_plan`'s."""
    return -(-seg_nodes // UPDATE_XR_NODES), UPDATE_XR_NODES


class RestrictPlan(NamedTuple):
    """The grid of `jacobi_restrict`: Jacobi blocks of `span` nodes of a
    lane (a multiple of 4) and restriction blocks of `warps` warps, a warp
    per (pass, aggregate), each pass `lanes` lanes (1, 2, 4 or 8); the
    Jacobi blocks first in the grid where `jacobi_first`."""
    span: int
    warps: int
    lanes: int
    jacobi_first: bool

    def grid(self, lanes: int, lane_nodes: int, aggregates: int):
        """(Jacobi blocks a lane, passes, restriction blocks) over `lanes`
        lanes of `lane_nodes` nodes and `aggregates` aggregates (both
        roles), as the kernel's launch takes them."""
        passes = -(-lanes // self.lanes)
        return -(-lane_nodes // self.span), passes, -(-passes * aggregates // self.warps)


def restrict_plan(lanes: int) -> RestrictPlan:
    """The plan of `jacobi_restrict` over `lanes` lanes: passes of the
    fewest lanes (a power of two) that take all the lanes in one pass, up
    to RESTRICT_LANES."""
    per_pass = 1
    while per_pass < min(lanes, RESTRICT_LANES):
        per_pass *= 2
    return RestrictPlan(JACOBI_NODES, RESTRICT_WARPS, per_pass, JACOBI_FIRST)


def vector_width(seg_nodes: int, dtype) -> int:
    """Values of the CG kernels' vector loads: 16 bytes where every
    segment (for the Jacobi term: every lane) starts on a multiple of them,
    else one (a ragged node count)."""
    vec = ALIGN // (torch.finfo(dtype).bits // 8)
    return vec if seg_nodes % vec == 0 else 1


# ---- the loop's state ---------------------------------------------------


class SegmentedState:
    """The state of `pcg_solve_segmented`'s loop for L lanes of P segments
    of Ns nodes, in tensors allocated once and updated in place: vectors x,
    r, p, z (L, 2 * P * Ns); per segment rz, r2, best (best_r2), atol2,
    stall, active, and the body's alpha, beta and run flags (L, P); per lane
    k and the lane flag (L,). The kernels keep no scratch in device
    memory."""

    def __init__(self, lanes: int, n_seg: int, seg_nodes: int, dtype, device,
                 max_iters: int, stall_limit: int):
        if dtype not in DTYPES:
            raise TypeError(f"the CG state takes float32 or float64, not {dtype}")
        device = torch.device(device)
        self.P, self.Ns = n_seg, seg_nodes
        self.max_iters, self.stall_limit = max_iters, stall_limit

        def zeros(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        vec, seg = (lanes, 2 * n_seg * seg_nodes), (lanes, n_seg)
        self.x, self.r, self.p, self.z = (zeros(vec) for _ in range(4))
        self.rz, self.r2, self.best, self.atol2, self.alpha, self.beta = (zeros(seg) for _ in range(6))
        self.stall = zeros(seg, torch.int32)
        self.active, self.run = zeros(seg, torch.bool), zeros(seg, torch.bool)
        self.k = zeros(lanes, torch.int32)
        self.lane = zeros(lanes, torch.bool)

    TENSORS = ("x", "r", "p", "z", "rz", "r2", "best", "atol2", "alpha", "beta", "stall",
               "active", "run", "k", "lane")

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


def _state_tensors(state, *names):
    L, P = state.k.shape[0], state.P
    shapes = {"x": (L, 2 * P * state.Ns), "r": (L, 2 * P * state.Ns), "p": (L, 2 * P * state.Ns),
              "z": (L, 2 * P * state.Ns), "rz": (L, P), "r2": (L, P), "best": (L, P),
              "atol2": (L, P), "alpha": (L, P), "beta": (L, P), "stall": (L, P),
              "active": (L, P), "run": (L, P), "k": (L,), "lane": (L,)}
    types = {"stall": torch.int32, "k": torch.int32, "active": torch.bool, "run": torch.bool,
             "lane": torch.bool}
    return {f"state.{n}": (getattr(state, n), types.get(n), shapes[n]) for n in names}


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


# ---- capture: a block of bodies as one CUDA graph -----------------------


def capture(fn, warmup, device) -> graphs.CapturedBlock:
    """`graphs.capture` of a block of loop bodies, after the CG kernels
    were loaded into `device`'s context (a kernel that loaded lazily at its
    first launch would load while the graph is recorded)."""
    LIBRARY.loaded(device.index or 0)
    return graphs.capture(fn, warmup, device)


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
    check_tensors("cg_alpha", state.x.device, state.x.dtype, DTYPES, {
        "Ap": (Ap, None, state.p.shape),
        **_state_tensors(state, "p", "rz", "r2", "atol2", "stall", "active", "k", "alpha", "run",
                         "lane")})
    vec = vector_width(state.Ns, state.x.dtype)
    if vec > 1:
        check_aligned("cg_alpha", {"state.p": state.p, "Ap": Ap})
    cluster, span = alpha_plan(state.Ns)
    lib = LIBRARY.loaded(state.x.device.index or 0)
    with torch.cuda.device(state.x.device):
        err = lib.fea_cg_alpha(
            int(state.x.dtype == torch.float64), *map(_ptr, (
                state.p, Ap, state.rz, state.r2, state.atol2, state.stall, state.active, state.k,
                state.alpha, state.run, state.lane)),
            state.k.shape[0], state.P, state.Ns, cluster, span, vec, state.max_iters,
            state.stall_limit, _stream(state.x.device))
    LIBRARY.check(err, "cg_alpha launch")
    graphs.count(cg_alpha)


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
    check_tensors("cg_update_xr", state.x.device, state.x.dtype, DTYPES, {
        "Ap": (Ap, None, state.p.shape), **_state_tensors(state, "x", "r", "p", "alpha", "lane")})
    vec = vector_width(state.Ns, state.x.dtype)
    if vec > 1:
        check_aligned("cg_update_xr", {"state.x": state.x, "state.r": state.r,
                                        "state.p": state.p, "Ap": Ap})
    blocks, span = update_xr_plan(state.Ns)
    lib = LIBRARY.loaded(state.x.device.index or 0)
    with torch.cuda.device(state.x.device):
        err = lib.fea_cg_update_xr(
            int(state.x.dtype == torch.float64),
            *map(_ptr, (state.x, state.r, state.p, Ap, state.alpha, state.lane)),
            state.k.shape[0], state.P, state.Ns, blocks, span, vec, _stream(state.x.device))
    LIBRARY.check(err, "cg_update_xr launch")
    graphs.count(cg_update_xr)


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
    check_tensors("jacobi_restrict", r.device, r.dtype, DTYPES, {
        "r": (r, None, (L, 2 * PN)), "block_inv": (block_inv, None, (L, 2, 2, PN)),
        "zj": (zj if block_inv is not None else None, None, (L, 2 * PN)),
        "arms": (arms if members is not None else None, None, (PN, 2)),
        "members": (members, torch.int32, (NA, W)),
        "rc": (rc if members is not None else None, None, (L, NA, 3))})
    if (block_inv is None) != (zj is None) or (members is None) != (rc is None):
        raise ValueError("jacobi_restrict: block_inv goes with zj, members with arms and rc")
    vec = vector_width(PN, r.dtype) if block_inv is not None else 1
    if vec > 1:
        check_aligned("jacobi_restrict", {"r": r, "block_inv": block_inv, "zj": zj})
    plan = restrict_plan(L)
    lib = LIBRARY.loaded(r.device.index or 0)
    with torch.cuda.device(r.device):
        err = lib.fea_cg_jacobi_restrict(
            int(r.dtype == torch.float64), *map(_ptr, (r, block_inv, arms, members, zj, rc)),
            L, PN, NA, W, plan.span, vec, plan.warps, plan.lanes, int(plan.jacobi_first),
            _stream(r.device))
    LIBRARY.check(err, "jacobi_restrict launch")
    graphs.count(jacobi_restrict)


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
    check_tensors("prolong_dots", z.device, z.dtype, DTYPES, named)
    if ndof % (2 * n_seg):
        raise ValueError(f"{ndof} dofs do not split into {n_seg} segments of two components")
    s = state
    Ns = ndof // (2 * n_seg)
    vec = vector_width(Ns, z.dtype)
    if vec > 1:
        check_aligned("prolong_dots", {"z": z, "zj": zj, "agg": agg, "arms": arms,
                                        "free": free, "state.r": None if s is None else s.r})
    cluster, span = prolong_plan(Ns)
    lib = LIBRARY.loaded(z.device.index or 0)
    with torch.cuda.device(z.device):
        err = lib.fea_cg_prolong_dots(
            int(z.dtype == torch.float64),
            *map(_ptr, (zj, zc, agg, arms, free, z, None if s is None else s.r)),
            int(s is not None),
            *map(_ptr, (None,) * 8 if s is None
                 else (s.rz, s.r2, s.best, s.stall, s.k, s.beta, s.run, s.lane)),
            L, n_seg, Ns, cluster, span, vec, NA, _stream(z.device))
    LIBRARY.check(err, "prolong_dots launch")
    graphs.count(prolong_dots)


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
    check_tensors("cg_update_p", state.x.device, state.x.dtype, DTYPES,
                  _state_tensors(state, "p", "z", "beta", "run", "lane"))
    vec = vector_width(state.Ns, state.x.dtype)
    if vec > 1:
        check_aligned("cg_update_p", {"state.p": state.p, "state.z": state.z})
    blocks, span = update_p_plan(state.Ns)
    lib = LIBRARY.loaded(state.x.device.index or 0)
    with torch.cuda.device(state.x.device):
        err = lib.fea_cg_update_p(
            int(state.x.dtype == torch.float64),
            *map(_ptr, (state.p, state.z, state.beta, state.run, state.lane)),
            state.k.shape[0], state.P, state.Ns, blocks, span, vec, _stream(state.x.device))
    LIBRARY.check(err, "cg_update_p launch")
    graphs.count(cg_update_p)


cg_update_p.launches = 0

WRAPPERS = (cg_alpha, cg_update_xr, jacobi_restrict, prolong_dots, cg_update_p)
