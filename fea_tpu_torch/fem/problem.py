"""High-level static linear-elasticity problem on a single mesh, the port
of fea_tpu/fem/problem.py.

Faithfully reproduces the reference FEAnalysis semantics
(datagen/fea_analysis.py):
  * P1 vector field on the whole domain (:61-69)
  * per-material-region dw_lin_elastic with plane-strain D (:140-161);
    a cell belongs to a region iff ALL its vertices are in the region's
    node set (sfepy cell-region-from-vertices rule) — straddling cells
    contribute no stiffness, exactly as in the reference
  * point loads at force vertices; edge forces divided by the number of
    region vertices and applied at each (:93-124)
  * homogeneous Dirichlet (u.all = 0) on constraint regions (:126-138)
  * incremental loading force(t) = -t * magnitude with t in
    linspace(0, 1, num_steps) (:314-322, 425-432). The problem is linear,
    so u(t) = t * u(1): one solve, scaled per step.

The problem is host data (NumPy); `solve` uploads it to a device, the
CUDA device unless the caller names another, and returns tensors there.
FEM arithmetic is true f32 or f64: the entry points refuse to run with
TF32 matmuls switched on.
"""

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import cuda_device
from .assembly import (
    apply_element_stiffness_planar,
    assemble_scipy_csr,
    build_incidence,
    element_dof_indices,
)
from .coarse import (
    build_aggregates,
    build_coarse_matrix,
    coarse_apply,
    coarse_inverse,
    n_coarse_for_bucket,
)
from .elasticity import element_stiffness, element_stiffness_np, plane_strain_stiffness_em
from .solver import CHECK_EVERY, block_diagonal, extract_diagonal, invert_blocks, pcg_solve


class SolveResult(NamedTuple):
    """Tensors on the solve's device (NumPy arrays from the host solvers)."""

    displacements: torch.Tensor  # (num_steps, N, 2) — step 0 is zero load
    strain: torch.Tensor  # (num_steps, M, 3) el_avg Voigt (exx, eyy, 2exy)
    stress: torch.Tensor  # (num_steps, M, 3)
    converged: torch.Tensor  # scalar bool
    failed: torch.Tensor  # scalar bool (NaN path -> caller resamples)
    residual_norm: torch.Tensor
    iterations: torch.Tensor
    host_reads: int = 0  # times the host waited on the device inside the CG loops

    @property
    def success(self):
        return bool(self.converged) and not bool(self.failed)


def _require_true_f32() -> None:
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "FEM solves need true f32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )


def _device(device) -> torch.device:
    return torch.device(device) if device is not None else cuda_device()


def element_materials(
    triangles: np.ndarray,
    n_nodes: int,
    regions: Sequence[Tuple[Tuple[float, float], np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-element (E, nu) from node-set material regions.

    regions: sequence of ((young, poisson), node_indices). An element takes
    a region's material iff all 3 vertices lie in that region (first match
    wins, mirroring sfepy's per-region equations); uncovered elements get
    E = 0 (no stiffness contribution — the straddling-cell quirk).
    """
    triangles = np.asarray(triangles)
    young = np.zeros(len(triangles))
    poisson = np.zeros(len(triangles))
    assigned = np.zeros(len(triangles), dtype=bool)
    for (E, nu), node_ids in regions:
        member = np.zeros(n_nodes, dtype=bool)
        member[np.asarray(node_ids, dtype=np.int64)] = True
        covered = member[triangles].all(axis=1) & ~assigned
        young[covered] = E
        poisson[covered] = nu
        assigned |= covered
    return young, poisson


@dataclass
class StaticProblem:
    """Single-mesh problem."""

    coords: np.ndarray  # (N, 2)
    triangles: np.ndarray  # (M, 3)
    young: np.ndarray  # (M,) per-element Young's modulus (0 = uncovered)
    poisson: np.ndarray  # (M,)
    fixed_nodes: np.ndarray  # (N,) bool — u.all = 0
    loads: np.ndarray  # (N, 2) final-step force (already sign-flipped)
    num_steps: int = 11
    n_real: Optional[int] = None  # real node count when bucket-padded

    @classmethod
    def from_condition(
        cls,
        mesh,
        material_regions: Sequence[Tuple[Tuple[float, float], np.ndarray]],
        point_constraints: Sequence[int],
        edge_constraints: Sequence[Tuple[int, int]],
        point_forces: Sequence[Tuple[int, Tuple[float, float]]],
        edge_forces: Sequence[Tuple[Tuple[int, int], Tuple[float, float]]],
        num_steps: int = 11,
    ) -> "StaticProblem":
        """Build from a sampled condition on a mesh.Mesh."""
        n = mesh.num_nodes
        fixed = np.zeros(n, dtype=bool)
        for v in point_constraints:
            fixed[int(v)] = True
        for edge in edge_constraints:
            fixed[mesh.nodes_on_edge(edge)] = True

        loads = np.zeros((n, 2))
        for v, (fx, fy) in point_forces:
            loads[int(v)] += (-fx, -fy)  # force(t=1) = -magnitude
        for edge, (fx, fy) in edge_forces:
            nodes = mesh.nodes_on_edge(edge)
            k = max(len(nodes), 1)
            loads[nodes] += (-fx / k, -fy / k)

        young, poisson = element_materials(mesh.triangles, n, material_regions)
        return cls(
            coords=np.asarray(mesh.coords),
            triangles=np.asarray(mesh.triangles),
            young=young,
            poisson=poisson,
            fixed_nodes=fixed,
            loads=loads,
            num_steps=num_steps,
        )

    def structurally_singular(self) -> bool:
        """Host-side detector for the singular systems the reference's LU
        NaNs on (fea_analysis.py:455-461): a free node with an all-zero row
        (covered by no stiff element), a stiff connected component with no
        Dirichlet-fixed node (floating island — a by-product of the
        straddling-cell region semantics), or a hinge mechanism — a
        component pinned at exactly one node, which leaves a zero-energy
        rigid rotation about that node. Two distinct pinned nodes kill all
        2D rigid modes, so >=2 fixed nodes per stiff component is the
        structural requirement. Hinges previously fell through to the
        solver, burning thousands of PCG iterations before the resample
        loop discarded them; this check costs microseconds."""
        import scipy.sparse as sp
        from scipy.sparse.csgraph import connected_components

        n = len(self.coords)
        stiff = self.triangles[self.young > 0]
        covered = np.zeros(n, dtype=bool)
        covered[stiff.reshape(-1)] = True
        if (~covered & ~self.fixed_nodes).any():
            return True
        if len(stiff) == 0:
            return True
        rows = np.concatenate([stiff[:, 0], stiff[:, 1], stiff[:, 2]])
        cols = np.concatenate([stiff[:, 1], stiff[:, 2], stiff[:, 0]])
        adj = sp.coo_matrix(
            (np.ones(len(rows), dtype=np.int8), (rows, cols)), shape=(n, n)
        )
        n_comp, labels = connected_components(adj, directed=False)
        fixed_per_comp = np.bincount(
            labels[self.fixed_nodes], minlength=n_comp
        )
        stiff_components = np.unique(labels[covered])
        if bool((fixed_per_comp[stiff_components] < 2).any()):
            return True
        # >=2 fixed nodes per component is necessary but NOT sufficient:
        # an internal hinge (cut vertex of the stiff graph whose split
        # leaves one side with no fixed node) still has a zero-energy
        # rotation. O(V+E) native articulation check (mesh/cdt).
        from ..mesh.mesher import hinge_singular

        return hinge_singular(stiff, self.fixed_nodes)

    def padded(self, node_bucket: int, tri_bucket: int) -> "StaticProblem":
        """Pad to static bucket shapes so solves share shapes.

        Ghost nodes: three of them form a valid far-away triangle; all
        padded triangles reference it with E=0 (zero stiffness) and ghost
        nodes are Dirichlet-fixed, so results are bit-identical to the
        unpadded solve on the real nodes."""
        n, m = len(self.coords), len(self.triangles)
        assert node_bucket >= n + 3 and tri_bucket >= m, (
            f"bucket ({node_bucket},{tri_bucket}) too small for ({n},{m})"
        )
        # Ghost nodes on three concentric rings far from the domain; each
        # padded triangle takes one node per ring at the same angle, giving
        # O(1)-area triangles that stay robustly non-degenerate in float32
        # (near-collinear triples would produce inf/NaN in the B-matrix even
        # with E=0). Cycling through k angles bounds any ghost's incidence
        # degree.
        p = node_bucket - n
        k = max(p // 3, 1)
        ring = np.minimum(np.arange(p) // k, 3).astype(np.float64)
        # per-ring angular offset: a same-angle triple across rings would be
        # radially collinear without it
        theta = 2.0 * np.pi * (np.arange(p) % k) / k + 0.7 * ring
        radius = 1.0 + ring
        ghosts = np.stack(
            [100.0 + radius * np.cos(theta), 100.0 + radius * np.sin(theta)],
            axis=1,
        )
        coords = np.concatenate([self.coords, ghosts])
        pad_m = tri_bucket - m
        j = np.arange(pad_m)
        if p >= 3 * k and k >= 1 and p >= 3:
            pad_tris = np.stack(
                [n + j % k, n + k + j % k, n + 2 * k + j % k], axis=1
            ).astype(self.triangles.dtype)
        else:  # minimal padding: a single ghost triple
            pad_tris = np.tile(
                np.array([[n, n + 1, n + 2]], dtype=self.triangles.dtype),
                (pad_m, 1),
            )
        triangles = np.concatenate([self.triangles, pad_tris])
        return StaticProblem(
            coords=coords,
            triangles=triangles,
            young=np.concatenate([self.young, np.zeros(pad_m)]),
            poisson=np.concatenate([self.poisson, np.zeros(pad_m)]),
            fixed_nodes=np.concatenate(
                [self.fixed_nodes, np.ones(node_bucket - n, dtype=bool)]
            ),
            loads=np.concatenate([self.loads, np.zeros((node_bucket - n, 2))]),
            num_steps=self.num_steps,
            n_real=self.n_real if self.n_real is not None else n,
        )

    def _device_inputs(self, dtype, device):
        """The arrays `_solve_core` takes, on `device`: (coords, triangles,
        young, poisson, incidence slots, free nodes, loads), then the
        coarse space's (agg_ids, arms, members) and n_coarse."""
        n = len(self.coords)
        incidence = build_incidence(self.triangles, n, device=device)
        n_coarse = n_coarse_for_bucket(n)
        space = build_aggregates(self.coords, n_coarse, n_real=self.n_real)

        def dev(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

        return (
            dev(self.coords), dev(self.triangles, torch.int32), dev(self.young),
            dev(self.poisson), incidence.slots, dev(~self.fixed_nodes), dev(self.loads),
        ), (
            dev(space.agg_ids, torch.int32), dev(space.arms), dev(space.members, torch.int32),
        ), n_coarse

    def solve(
        self,
        tol: Optional[float] = None,
        max_iters: int = 20000,
        dtype=torch.float64,
        accept_tol: float = 1e-4,
        restarts: Optional[int] = None,
        packed: bool = False,
        per_step_solves: bool = False,
        device=None,
        check_every: int = CHECK_EVERY,
    ):
        """`tol` defaults by dtype: 1e-10 (f64) / 1e-6 (f32, the dtype's
        attainable floor). `accept_tol` is the success threshold on the true
        relative residual — looser than `tol`, because the reference only
        rejects solves that go NaN (fea_analysis.py:455-461), not ones that
        merely stop short of machine precision.

        `per_step_solves=True` runs one CG solve per load step with the
        ramped RHS force(t_k) = t_k * loads — the reference's
        SimpleTimeSteppingSolver behavior (fea_analysis.py:425-432) kept
        for parity testing; the default exploits linearity (u(t) = t*u(1),
        one solve). `packed=True` returns `_solve_kernel_packed`'s flat f32
        vector instead of a SolveResult (see `unpack_solve`).

        Runs on the CUDA device unless `device` names another. The host
        reads the CG loop's condition once per `check_every` iterations
        (solver.pcg_solve); the result does not depend on it."""
        device = _device(device)
        if per_step_solves:
            return self._solve_per_step(
                tol=tol, max_iters=max_iters, dtype=dtype, accept_tol=accept_tol,
                restarts=restarts, device=device, check_every=check_every,
            )
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"FEM solves run in float32 or float64, not {dtype}")
        if tol is None:
            tol = 1e-10 if dtype == torch.float64 else 1e-6
        if restarts is None:
            restarts = 1 if dtype == torch.float64 else 6
        arrays, space, n_coarse = self._device_inputs(dtype, device)
        kw = dict(
            tol=tol, max_iters=max_iters, accept_tol=accept_tol, restarts=restarts,
            n_coarse=n_coarse, check_every=check_every,
        )
        if packed:
            return _solve_kernel_packed(*arrays, *space, **kw)
        return _solve_kernel(*arrays, *space, num_steps=self.num_steps, **kw)

    def _solve_per_step(self, **solve_kw) -> SolveResult:
        """Independent solve per ramp step (parity mode)."""
        steps = []
        t_values = np.linspace(0.0, 1.0, self.num_steps)
        base_loads = self.loads
        for t in t_values:
            stepped = StaticProblem(
                coords=self.coords,
                triangles=self.triangles,
                young=self.young,
                poisson=self.poisson,
                fixed_nodes=self.fixed_nodes,
                loads=base_loads * t,
                num_steps=2,
            )
            steps.append(stepped.solve(**solve_kw))
        return SolveResult(
            displacements=torch.stack([s.displacements[-1] for s in steps]),
            strain=torch.stack([s.strain[-1] for s in steps]),
            stress=torch.stack([s.stress[-1] for s in steps]),
            converged=torch.stack([s.converged for s in steps]).all(),
            failed=torch.stack([s.failed for s in steps]).any(),
            residual_norm=torch.stack([s.residual_norm for s in steps[1:]]).max(),
            iterations=torch.stack([s.iterations for s in steps]).sum(),
            host_reads=sum(s.host_reads for s in steps),
        )


def _solve_core(
    coords,
    triangles,
    young,
    poisson,
    incidence_slots,
    free_nodes,
    loads,
    tol,
    max_iters,
    accept_tol,
    restarts,
    agg_ids=None,
    arms=None,
    members=None,
    n_coarse: int = 0,
    x0=None,
    check_every: int = CHECK_EVERY,
):
    """Element-minor / planar-dof solve core (fea_tpu's layouts: every
    per-element array keeps the long axis minor). Returns (CGResult with x
    (N,2), eps1 (M,3), sig1 (M,3)).

    When `n_coarse > 0` (with agg_ids/arms/members from build_aggregates)
    the preconditioner is two-level: block-Jacobi + a dense rigid-body-mode
    coarse correction (see fem/coarse.py) — the difference between f32 CG
    stalling at 1e-3 on hard plates and converging to 1e-6 in tens of
    iterations."""
    _require_true_f32()
    n_nodes = coords.shape[0]
    D = plane_strain_stiffness_em(young, poisson)  # (3,3,M)
    Ke, B, _area = element_stiffness(coords, triangles, D)  # (6,6,M),(3,6,M)
    diag = extract_diagonal(Ke, triangles, n_nodes)  # (N,2)
    blocks = block_diagonal(Ke, triangles, n_nodes)  # (2,2,N)
    block_inv = invert_blocks(blocks)

    free_planar = torch.cat([free_nodes, free_nodes])  # (2N,)
    dof_idx = element_dof_indices(triangles, n_nodes)  # (6,M)
    op = partial(
        apply_element_stiffness_planar, Ke, dof_idx, incidence_slots
    )

    Kc_inv = None
    if n_coarse > 0:
        Kc = build_coarse_matrix(
            Ke, triangles, agg_ids, arms, free_nodes, n_coarse
        )
        Kc_inv = coarse_inverse(Kc)

    def precondition(r):  # r (2N,) planar
        # the 2x2 block apply: a broadcast multiply and a sum over 2
        z = (block_inv * r.reshape(1, 2, n_nodes)).sum(dim=1).reshape(-1)
        if Kc_inv is not None:
            z = z + coarse_apply(Kc_inv, agg_ids, arms, members, r)
        return z * free_planar

    res = pcg_solve(
        op,
        loads.T.reshape(-1),  # (N,2) -> planar (2N,)
        diag.T.reshape(-1),
        free_planar,
        x0=None if x0 is None else x0.T.reshape(-1),  # (N,2) -> planar
        tol=tol,
        max_iters=max_iters // max(restarts, 1),
        accept_tol=accept_tol,
        precondition=precondition,
        restarts=restarts,
        check_every=check_every,
    )
    xe = res.x[dof_idx]  # (6,M)
    eps1 = torch.einsum("ijm,jm->im", B, xe)  # (3,M)
    sig1 = torch.einsum("ijm,jm->im", D, eps1)
    res = res._replace(x=res.x.reshape(2, n_nodes).T)  # back to (N,2)
    return res, eps1.T, sig1.T


def _solve_kernel(
    coords,
    triangles,
    young,
    poisson,
    incidence_slots,
    free_nodes,
    loads,
    agg_ids=None,
    arms=None,
    members=None,
    *,
    num_steps: int,
    tol: float,
    max_iters: int,
    accept_tol: float = 1e-4,
    restarts: int = 1,
    n_coarse: int = 0,
    check_every: int = CHECK_EVERY,
) -> SolveResult:
    dtype = coords.dtype
    res, eps1, sig1 = _solve_core(
        coords, triangles, young, poisson, incidence_slots, free_nodes, loads,
        tol, max_iters, accept_tol, restarts,
        agg_ids=agg_ids, arms=arms, members=members, n_coarse=n_coarse,
        check_every=check_every,
    )
    t = torch.linspace(0.0, 1.0, num_steps, dtype=torch.float64, device=coords.device).to(dtype)
    return SolveResult(
        displacements=t[:, None, None] * res.x[None],
        strain=t[:, None, None] * eps1[None],
        stress=t[:, None, None] * sig1[None],
        converged=res.converged,
        failed=res.failed,
        residual_norm=res.residual_norm,
        iterations=res.iterations,
        host_reads=res.host_reads,
    )


def _solve_kernel_packed(
    coords,
    triangles,
    young,
    poisson,
    incidence_slots,
    free_nodes,
    loads,
    agg_ids=None,
    arms=None,
    members=None,
    *,
    tol: float,
    max_iters: int,
    accept_tol: float = 1e-4,
    restarts: int = 1,
    include_cell_fields: bool = True,
    n_coarse: int = 0,
    check_every: int = CHECK_EVERY,
):
    """Single-step solve packed into one flat f32 vector:
    [u1 (2N), eps1 (3M), sig1 (3M), converged, failed, rnorm, iters].
    One device->host fetch instead of one per field.
    include_cell_fields=False drops strain/stress from the payload
    (datagen without --save_strain/--save_stress: ~4x less traffic)."""
    res, eps1, sig1 = _solve_core(
        coords, triangles, young, poisson, incidence_slots, free_nodes, loads,
        tol, max_iters, accept_tol, restarts,
        agg_ids=agg_ids, arms=arms, members=members, n_coarse=n_coarse,
        check_every=check_every,
    )
    f32 = torch.float32
    parts = [res.x.reshape(-1).to(f32)]
    if include_cell_fields:
        parts += [eps1.reshape(-1).to(f32), sig1.reshape(-1).to(f32)]
    parts.append(
        torch.stack(
            [
                res.converged.to(f32),
                res.failed.to(f32),
                res.residual_norm.to(f32),
                res.iterations.to(f32),
            ]
        )
    )
    return torch.cat(parts)


def solve_refined(
    problem: StaticProblem,
    outer_iters: int = 12,
    outer_tol: float = 1e-9,
    inner_tol: float = 1e-6,
    inner_max_iters: int = 8000,
    pad_buckets=None,
    verbose: bool = False,
    device=None,
    check_every: int = CHECK_EVERY,
) -> SolveResult:
    """Mixed-precision iterative refinement: float64 residuals on the host,
    float32 PCG correction solves on the device (the CUDA device unless
    `device` names another).

    Restores direct-solver-grade accuracy (the reference's SuperLU,
    fea_analysis.py:371-375) on ill-conditioned problems — e.g. slender
    cantilevers — where single-sweep f32 CG stalls at ~1e-3 relative. Used
    by the application runner and parity benchmarks; bulk datagen keeps the
    cheap single-shot f32 path (8-bit image outputs don't resolve beyond
    ~4e-3 anyway)."""
    device = _device(device)
    n = len(problem.coords)
    Ke, B, D, _area = element_stiffness_np(
        problem.coords, problem.triangles, problem.young, problem.poisson
    )
    K = assemble_scipy_csr(Ke, problem.triangles, n)
    free = ~np.repeat(problem.fixed_nodes, 2)
    b = problem.loads.reshape(-1).astype(np.float64) * free
    b_norm = max(float(np.linalg.norm(b)), 1e-300)

    padded = problem
    if pad_buckets is not None:
        padded = problem.padded(*pad_buckets)

    # The correction solves' tables are built and uploaded once: only the
    # RHS changes between refinements. `_device_inputs` passes
    # padded.n_real on, which keeps the ghost nodes (parked near (100,
    # 100)) out of the aggregation's bounding box.
    n_pad = len(padded.coords)
    f32 = torch.float32
    arrays, space, n_coarse = padded._device_inputs(f32, device)
    pad_tail = np.zeros((n_pad - n, 2))

    x = np.zeros(2 * n)
    rnorm = np.inf
    iters = 0
    host_reads = 0
    diverged = False
    for outer in range(outer_iters):
        r = (b - K @ x) * free
        rnorm = float(np.linalg.norm(r)) / b_norm
        if verbose:
            print(f"refine[{outer}] rel resid {rnorm:.3e}")
        if rnorm <= outer_tol or not np.isfinite(rnorm):
            break
        res = _solve_kernel(
            *arrays[:-1],
            torch.as_tensor(np.concatenate([r.reshape(n, 2), pad_tail]), dtype=f32, device=device),
            *space,
            num_steps=2,
            tol=inner_tol,
            max_iters=inner_max_iters,
            accept_tol=1e-4,
            restarts=6,
            n_coarse=n_coarse,
            check_every=check_every,
        )
        host_reads += res.host_reads + 1  # the iteration count, read below
        iters += int(res.iterations)
        delta = res.displacements[-1][:n].cpu().numpy().astype(np.float64).reshape(-1)
        if not np.isfinite(delta).all():
            diverged = True
            break
        x = x + delta

    # the loop can exit AFTER applying a correction rnorm never saw
    # (outer_iters exhausted, or the non-finite break): report the
    # residual of the x actually returned
    r = (b - K @ x) * free
    rnorm = float(np.linalg.norm(r)) / b_norm

    u1 = (x * free).reshape(n, 2)
    tvec = np.linspace(0.0, 1.0, problem.num_steps)
    eps1 = np.einsum("mij,mj->mi", B, u1[problem.triangles].reshape(-1, 6))
    sig1 = np.einsum("mij,mj->mi", D, eps1)
    failed = (
        diverged or not np.isfinite(rnorm) or not np.isfinite(x).all()
    )
    return SolveResult(
        displacements=tvec[:, None, None] * u1[None],
        strain=tvec[:, None, None] * eps1[None],
        stress=tvec[:, None, None] * sig1[None],
        converged=np.asarray(rnorm <= outer_tol * 100 and not failed),
        failed=np.asarray(failed),
        residual_norm=np.asarray(rnorm),
        iterations=np.asarray(iters),
        host_reads=host_reads,
    )


def unpack_solve(packed: np.ndarray, n: int, m: int, num_steps: int) -> SolveResult:
    """Host-side expansion of the packed single-step solution into the
    per-step SolveResult (linear problem: u(t_k) = t_k * u1)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    u1 = packed[: 2 * n].reshape(n, 2)
    if len(packed) >= 2 * n + 6 * m + 4:
        eps1 = packed[2 * n : 2 * n + 3 * m].reshape(m, 3)
        sig1 = packed[2 * n + 3 * m : 2 * n + 6 * m].reshape(m, 3)
        tail = packed[2 * n + 6 * m :]
    else:  # cell fields omitted from the payload
        eps1 = np.zeros((m, 3))
        sig1 = np.zeros((m, 3))
        tail = packed[2 * n :]
    converged, failed, rnorm, iters = tail
    t = np.linspace(0.0, 1.0, num_steps)
    return SolveResult(
        displacements=t[:, None, None] * u1[None],
        strain=t[:, None, None] * eps1[None],
        stress=t[:, None, None] * sig1[None],
        converged=np.asarray(bool(converged)),
        failed=np.asarray(bool(failed)),
        residual_norm=np.asarray(rnorm),
        iterations=np.asarray(int(iters)),
    )
