"""Preconditioned conjugate-gradient solvers, the port of
fea_tpu/fem/solver.py: `pcg_solve` on one mesh, and `pcg_solve_segmented`
on a block-diagonal system of plates for a batch of lanes (conditions).

The replacement for the reference's ScipyDirect (SuperLU) sparse LU
(fea_analysis.py:371-375). Matrix-free, reports convergence + NaN flags
that feed the host-side condition-resampling loop (reference
datagen/generate.py:110-124).

fea_tpu runs the iteration as a `lax.while_loop` inside one compiled
program. Here every scalar of the recurrence (alpha, beta, rz, the
tolerances, the stall counter, the flags) stays a tensor on the device, and
the body is a masked update: the loop condition is computed on the device
and the state takes its new values only where the condition holds, so
iterations past the exit change nothing. The host reads the condition once
before each block of `check_every` iterations; the result and the
iteration count are those of the while_loop whatever the block length.
`pcg_solve` queues a body as torch operations; `pcg_solve_segmented`, the
flat chunk's loop, runs a body as the hand-written kernels of `ops.cg`
and replays a block of bodies as one CUDA graph on the card.
"""

import math
from typing import NamedTuple

import torch

from ..ops import cg
from .assembly import scatter_sum


# Iterations queued between two host reads of the loop's condition. Bodies
# queued past an exit cost as much as real ones, so blocks are short;
# chip_smoke.py phase 16 times 8, 16 and 32 on the captured block.
CHECK_EVERY = 8


class CGResult(NamedTuple):
    x: torch.Tensor
    residual_norm: torch.Tensor  # final |r| / |b|
    iterations: torch.Tensor
    converged: torch.Tensor
    failed: torch.Tensor  # NaN/Inf detected (singular or blow-up)
    host_reads: int = 0  # times the host waited for a flag from the device


def block_diagonal(Ke, triangles, n_nodes):
    """Per-node 2x2 diagonal blocks of K (block-Jacobi preconditioner —
    markedly more robust than scalar Jacobi for elasticity, especially with
    the zero-stiffness straddling cells the region semantics produce).

    Ke: (..., 6,6,M) element-minor. Returns (..., 2,2,N), node axis minor."""
    # Ke dof order (x0,y0,x1,y1,x2,y2): node-a self block = Ke[2a:2a+2, 2a:2a+2]
    index = torch.cat([triangles[:, a] for a in range(3)])
    return torch.stack([
        torch.stack([
            scatter_sum(
                n_nodes, index,
                torch.cat([Ke[..., 2 * a + i, 2 * a + j, :] for a in range(3)], dim=-1),
            )
            for j in range(2)
        ], dim=-2)
        for i in range(2)
    ], dim=-3)


def invert_blocks(blocks):
    """Inverse of 2x2 SPD blocks (2,2,N); identity on fixed/empty nodes
    (fixed-dof masking is the CG loop's job — it zeroes r at fixed dofs
    before every preconditioner apply). Leading axes are lanes."""
    a = blocks[..., 0, 0, :]
    b = blocks[..., 0, 1, :]
    c = blocks[..., 1, 0, :]
    d = blocks[..., 1, 1, :]
    det = a * d - b * c
    ok = det.abs() > 1e-30
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    one = torch.ones_like(a)
    zero = torch.zeros_like(a)
    return torch.stack(
        [
            torch.stack(
                [torch.where(ok, d * inv_det, one), torch.where(ok, -b * inv_det, zero)],
                dim=-2,
            ),
            torch.stack(
                [torch.where(ok, -c * inv_det, zero), torch.where(ok, a * inv_det, one)],
                dim=-2,
            ),
        ],
        dim=-3,
    )  # (..., 2,2,N)


def pcg_solve(
    operator,
    b,
    diag,
    free_mask,
    x0=None,
    tol: float = 1e-10,
    max_iters: int = 2000,
    accept_tol: float = None,
    precondition=None,
    restarts: int = 1,
    check_every: int = CHECK_EVERY,
) -> CGResult:
    """Solve A x = b on the free dofs with Jacobi preconditioning.

    operator: callable u -> K u on full dof vectors.
    b: RHS, same shape; entries at constrained dofs are ignored.
    diag: diagonal of K (for the Jacobi preconditioner), same shape.
    free_mask: 1.0 for free dofs, 0.0 for Dirichlet-constrained dofs.
    Constrained dofs are held at zero (reference uses u.all = 0 EBCs only,
    fea_analysis.py:363-369).
    precondition: optional callable r -> M^-1 r (must zero constrained
    dofs); defaults to scalar Jacobi from `diag`.

    `tol` drives the iteration; `converged` reports whether the recomputed
    true residual met `accept_tol` (default 100x tol — CG recurrence can
    stagnate slightly above the target at the dtype's roundoff floor).

    Stagnation early-exit: a solve that hits its f32 roundoff floor stops
    iterating (no 10% residual reduction within `stall_limit` iterations)
    and skips its remaining restarts (no 10% reduction across a whole
    restart), so a hopeless condition (a hinge mechanism) does not burn
    restarts * max_iters iterations on a solve the caller will resample.

    `check_every`: iterations queued between two host reads of the loop
    condition. It changes neither the result nor the iteration count.
    """
    if accept_tol is None:
        accept_tol = tol * 100.0
    stall_limit = 180
    dtype = b.dtype
    free = free_mask.to(dtype)
    bm = b * free
    inv_diag = free / torch.where(diag.abs() > 1e-30, diag, 1.0)

    def A(u):
        return operator(u * free) * free

    if precondition is None:

        def precondition(r):
            return inv_diag * r

    b_norm = torch.sqrt(torch.dot(bm, bm))
    b_norm = torch.where(b_norm > 0, b_norm, 1.0)
    atol2 = (tol * b_norm) ** 2

    def cond(state):
        x, r, p, rz, r2, k, best_r2, stall, active = state
        not_done = (r2 > atol2) & (k < max_iters)
        return not_done & torch.isfinite(r2) & (stall < stall_limit) & active

    def body(state):
        """One iteration where `cond` holds, no change where it does not."""
        x, r, p, rz, r2, k, best_r2, stall, active = state
        running = cond(state)
        Ap = A(p)
        pAp = torch.dot(p, Ap)
        alpha = rz / torch.where(pAp != 0, pAp, 1.0)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = precondition(r_new)
        rz_new = torch.dot(r_new, z)
        beta = rz_new / torch.where(rz != 0, rz, 1.0)
        p_new = z + beta * p
        r2_new = torch.dot(r_new, r_new)
        improved = r2_new < 0.9 * best_r2
        best_new = torch.where(improved, r2_new, best_r2)
        stall_new = torch.where(improved, 0, stall + 1)
        return (
            torch.where(running, x_new, x),
            torch.where(running, r_new, r),
            torch.where(running, p_new, p),
            torch.where(running, rz_new, rz),
            torch.where(running, r2_new, r2),
            k + running,
            torch.where(running, best_new, best_r2),
            torch.where(running, stall_new, stall),
            active,
        )

    # Restarted CG (iterative refinement): each restart recomputes the true
    # residual, killing the conjugacy/residual drift that stalls or diverges
    # single-sweep CG in float32 on ill-conditioned plates.
    x = torch.zeros_like(bm) if x0 is None else x0 * free
    zero = torch.zeros((), dtype=torch.int64, device=b.device)
    total_iters = zero
    active = torch.ones((), dtype=torch.bool, device=b.device)
    host_reads = 0
    for _ in range(max(restarts, 1)):
        r = bm - A(x)
        z = precondition(r)
        rz = torch.dot(r, z)
        # a NaN-poisoned x would propagate: reset instead (on the device:
        # no host read, and nothing happens in the healthy path)
        healthy = torch.isfinite(rz)
        x = torch.where(healthy, x, 0.0)
        r = torch.where(healthy, r, bm)
        z = torch.where(healthy, z, precondition(bm))
        rz = torch.where(healthy, rz, torch.dot(r, precondition(r)))
        r2_start = torch.dot(r, r)
        state = (x, r, z, rz, r2_start, zero, r2_start, zero, active)
        while True:
            host_reads += 1
            if not bool(cond(state)):  # the one host read per block
                break
            for _ in range(check_every):
                state = body(state)
        x, r, _, _, r2_end, k, _, _, _ = state
        total_iters = total_iters + k
        # Give up remaining restarts once a full restart stops helping
        # (a converged solve exits at once through the r2 > atol2 cond).
        active = active & (r2_end < 0.9 * r2_start)

    # Recompute true residual for reporting.
    rtrue = bm - A(x)
    rnorm = torch.sqrt(torch.dot(rtrue, rtrue)) / b_norm
    failed = ~torch.isfinite(rnorm) | ~torch.isfinite(x).all()
    converged = (rnorm <= accept_tol) & ~failed
    return CGResult(
        x=x * free,
        residual_norm=rnorm,
        iterations=total_iters,
        converged=converged,
        failed=failed,
        host_reads=host_reads,
    )


class ScalarJacobi:
    """The segmented loop's default preconditioner, M^-1 r = inv_diag * r
    on (L, ndof) vectors, in the interface the loop takes from every
    preconditioner (the flat chunk's is `flatgroup.ChunkPreconditioner`):
    `parts(r)` gives (zj, zc), the term before the prolongation and the
    coarse solution (here None), and `finish` the tables (agg, arms, free)
    of the prolongation and the free mask (here none)."""

    finish = (None, None, None)

    def __init__(self, inv_diag):
        self.inv_diag = inv_diag

    def parts(self, r):
        return self.inv_diag * r, None

    def __call__(self, r):
        return self.inv_diag * r


def masked_operator(operator, free):
    """The CG loop's operator, u -> free * K (free * u): `operator` as it
    is where it applies the free masks itself (`masks_free`, as the flat
    chunk's band operator on the card does), else between the two masks."""
    if getattr(operator, "masks_free", False):
        return operator
    return lambda u: operator(u * free) * free


def segmented_body(state, A, precondition):
    """One body of the segmented loop on `state` (an `ops.cg.SegmentedState`)
    in place: one iteration of every lane whose condition holds, the other
    lanes keep every leaf. `A` maps (L, 2 * P * Ns) vectors; `precondition`
    has `parts` and `finish` (`ScalarJacobi`'s interface): the loop applies
    its prolongation and free mask in the dot-product launch. The launches
    are `ops.cg`'s: the kernels for CUDA tensors, the plain versions for
    CPU tensors."""
    Ap = A(state.p)
    cg.cg_alpha(state, Ap)
    cg.cg_update_xr(state, Ap)
    zj, zc = precondition.parts(state.r)
    agg, arms, free = precondition.finish
    cg.prolong_dots(zj, zc, agg, arms, free, state.z, state.P, state)
    cg.cg_update_p(state)


def pcg_solve_segmented(
    operator,
    b,
    diag,
    free_mask,
    n_seg: int,
    x0=None,
    tol: float = 1e-10,
    max_iters: int = 2000,
    accept_tol: float = None,
    precondition=None,
    restarts: int = 1,
    check_every: int = CHECK_EVERY,
) -> CGResult:
    """PCG on a block-diagonal super-system of `n_seg` independent
    segments (plates) with PER-SEGMENT alpha/beta/convergence, for every
    lane of a leading batch at once.

    Vectors are (..., 2 * n_seg * Ns): any leading axes are lanes
    (conditions) that share nothing but the loop; the last axis is planar
    over the concatenated node axis, component-major, segments contiguous
    within each component block — so every segment reduction is a reshape
    to (L, 2, n_seg, Ns) and a sum, and every scalar broadcast is the
    inverse reshape. `operator` takes and returns vectors of the callers'
    shape; the loop masks its input and output with `free_mask` unless it
    applies the masks itself (`masked_operator`). The loop runs on the
    lanes flattened to one axis L, so a given `precondition` takes (L,
    ndof) vectors, is callable, and has
    `ScalarJacobi`'s `parts` and `finish` (the flat chunk's
    `flatgroup.ChunkPreconditioner`); the default is scalar Jacobi on
    `diag`.

    Mathematically identical to running `pcg_solve` per segment (the
    scalars decouple exactly on a block-diagonal operator). Segments that
    converge freeze (their updates are masked) while the remaining
    segments iterate. A lane runs while any of its segments runs and its
    own counter k is under `max_iters` — fea_tpu's while_loop under
    jax.vmap over lanes: every state leaf of a lane, k included, keeps its
    value once that lane's condition fails, so the result and the
    iteration counts are the while_loop's for any `check_every`. The host
    reads whether any lane runs once per block of `check_every` bodies.

    A body is the five launches of `ops.cg` around the operator (and the
    preconditioner's coarse matvec), on the state's tensors in place (the
    operator's own kernel, where it has one, loads at the residual before
    the loop, outside any capture). On a CUDA device they are the
    hand-written kernels, and a block of
    `check_every` bodies is captured once per solve as a CUDA graph and
    replayed; on the CPU they are the plain torch versions, run eagerly.

    Returns CGResult with (..., n_seg) residual_norm / iterations /
    converged / failed; each restart adds its lane's k to every segment
    that was active in it (the lockstep cost the lane paid)."""
    if accept_tol is None:
        accept_tol = tol * 100.0
    stall_limit = 180
    dtype = b.dtype
    device = b.device
    free = free_mask.to(dtype)
    lead = tuple(torch.broadcast_shapes(b.shape, free.shape)[:-1])
    ndof = b.shape[-1]
    Ns = ndof // (2 * n_seg)
    L = math.prod(lead)
    state = cg.SegmentedState(L, n_seg, Ns, dtype, device, max_iters, stall_limit)
    sdot = state.sdot

    def lanes(u):  # (L, ndof) -> the callers' (..., ndof)
        return u.reshape(lead + (ndof,))

    def flat(u):  # the callers' (..., ndof), or one vector for every lane -> (L, ndof)
        return u.expand(lead + (ndof,)).reshape(L, ndof)

    masked = masked_operator(operator, free)

    def A(u):
        return flat(masked(lanes(u)))

    if precondition is None:
        precondition = ScalarJacobi(flat(free / torch.where(diag.abs() > 1e-30, diag, 1.0)))

    bm = flat(b * free)
    b_norm = torch.sqrt(sdot(bm, bm))
    b_norm = torch.where(b_norm > 0, b_norm, 1.0)
    state.atol2.copy_((tol * b_norm) ** 2)

    def block():
        for _ in range(check_every):
            segmented_body(state, A, precondition)

    def warmup():  # the body's library calls, on the capture stream
        A(state.p)
        precondition.parts(state.r)

    x = torch.zeros_like(bm) if x0 is None else flat(x0 * free)
    total_iters = torch.zeros((L, n_seg), dtype=torch.int32, device=device)
    active = torch.ones((L, n_seg), dtype=torch.bool, device=device)
    host_reads = 0
    graph = None
    try:
        for _ in range(max(restarts, 1)):
            r = bm - A(x)
            z = precondition(r)
            rz = sdot(r, z)
            healthy = torch.isfinite(rz)
            hm = state.expand(healthy)
            x = torch.where(hm, x, 0.0)
            r = torch.where(hm, r, bm)
            z = torch.where(hm, z, precondition(bm))
            rz = torch.where(healthy, rz, sdot(r, precondition(r)))
            r2_start = sdot(r, r)
            state.start(x, r, z, rz, r2_start, active)
            while True:
                host_reads += 1
                if not bool(state.lanes_running().any()):  # one host read per block
                    break
                if device.type == "cpu":
                    block()
                else:
                    if graph is None:
                        graph = cg.capture(block, warmup, device)
                    graph.replay()
            x = state.x
            total_iters = total_iters + torch.where(active, state.k[:, None], 0).to(torch.int32)
            active = active & (state.r2 < 0.9 * r2_start)
    finally:
        if graph is not None:  # its memory pool is freed with it
            graph.close()

    rtrue = bm - A(x)
    rnorm = torch.sqrt(sdot(rtrue, rtrue)) / b_norm
    failed = ~torch.isfinite(rnorm) | ~torch.isfinite(state.segments(x)).all(dim=-1).all(dim=-2)
    converged = (rnorm <= accept_tol) & ~failed
    seg_lead = lead + (n_seg,)
    return CGResult(
        x=lanes(x) * free,
        residual_norm=rnorm.reshape(seg_lead),
        iterations=total_iters.reshape(seg_lead),
        converged=converged.reshape(seg_lead),
        failed=failed.reshape(seg_lead),
        host_reads=host_reads,
    )


def extract_diagonal(Ke, triangles, n_nodes):
    """Diagonal of assembled K from element blocks (for Jacobi).

    Ke: (..., 6,6,M) element-minor. Returns (..., N,2)."""
    index = torch.cat([triangles[:, a] for a in range(3)])
    return torch.stack(
        [
            scatter_sum(
                n_nodes, index, torch.cat([Ke[..., 2 * a + c, 2 * a + c, :] for a in range(3)], dim=-1)
            )
            for c in range(2)
        ],
        dim=-1,
    )
