"""Flat (super-mesh) plate-group solve, the port of fea_tpu/fem/flatgroup.py.

A chunk of P same-bucket plates x C conditions is solved as one system:
the P plates are concatenated into ONE disconnected super-mesh (pure
offsets of the per-plate tables the solvers already hold on the device):

  * node axis: plate p's nodes live at [p*Nb, (p+1)*Nb); planar dofs keep
    the component-major layout (x block then y block) over all P*Nb nodes;
  * element axis: plate p's triangles live at [p*Mb, (p+1)*Mb);
  * conditions are an explicit leading lane axis C on every per-solve
    array — vectors (C, 2*P*Nb), per-plate scalars (C, P), Ke
    (C, 6, 6, P*Mb), the band (C, n_blocks, 128, W), Kc^-1
    (C, P, 3nc, 3nc) — where fea_tpu vmaps a lane over conditions; every
    gather and sum in the CG loop uses the flat shared tables;
  * CG runs SEGMENTED (solver.pcg_solve_segmented): alpha/beta/convergence
    are per-plate scalars, identical to independent CG per plate because
    the super-system is block-diagonal; one loop serves the whole chunk;
  * the coarse preconditioner is P batched dense (3nc, 3nc) matvecs per
    lane, with the restriction summed over a flat member table (each
    aggregate's real nodes, a fixed order) where fea_tpu uses segment_sum.

The operator is the incidence gather-sum (fem/assembly.py) or, for
RCM-permuted plates, the band (fem/banded.py): on the card its non-zeros
through the kernel of `ops.band` (`BandOperator`), on the CPU the dense
band's batched product. Every sum of the
set-up goes through `assembly.scatter_sum`, so a chunk repeats bit for
bit on the card. fea_tpu's band-block Jacobi smoother is an argument
here, off by default (`chunk_system`'s `band_block`).

Replaces the reference's per-condition SuperLU factorizations
(datagen/fea_analysis.py:418-461) as the datagen throughput core.
"""

import time
from functools import partial
from typing import Callable, NamedTuple, Optional

import torch

from ..ops import band, cg
from .assembly import apply_element_stiffness_planar, element_dof_indices, scatter_sum
from .banded import (
    BAND_R,
    assemble_band,
    band_assembly_indices_dev,
    band_block_diagonal,
    band_tables,
    banded_matvec,
    gram_apply,
    interleaved_to_planar,
    planar_to_interleaved,
    spd_block_inv_factor,
    window_index,
)
from .coarse import coarse_inverse
from .elasticity import plane_strain_stiffness_em, triangle_geometry
from .problem import _require_true_f32
from .solver import (
    CHECK_EVERY,
    block_diagonal,
    extract_diagonal,
    invert_blocks,
    pcg_solve_segmented,
)


def flatten_tables(coords_p, triangles_p, slots_p, agg_p, arms_p, n_coarse):
    """Batched per-plate tables -> flat super-mesh tables.

    slots values are per-plate k*Mb + e (k in [0,6), sentinel 6*Mb) into
    the plate's (6*Mb+1,) fe vector; flat values are k*(P*Mb) + p*Mb + e
    with the single shared sentinel 6*P*Mb."""
    P, Nb, _ = coords_p.shape
    Mb = triangles_p.shape[1]
    p_ids = torch.arange(P, dtype=triangles_p.dtype, device=coords_p.device)

    coords = coords_p.reshape(P * Nb, 2)
    tris = (triangles_p + (p_ids * Nb)[:, None, None]).reshape(P * Mb, 3)
    v = slots_p  # (P, 2*Nb, W)
    k = torch.div(v, Mb, rounding_mode="floor")
    e = v - k * Mb
    flat = k * (P * Mb) + p_ids.to(v.dtype)[:, None, None] * Mb + e
    slots = torch.where(v == 6 * Mb, 6 * P * Mb, flat)
    # rows of slots_p are per-plate planar (comp*Nb + n); flat planar rows
    # are comp*(P*Nb) + p*Nb + n -> regroup the component axis outermost
    slots = slots.reshape(P, 2, Nb, -1).transpose(0, 1).reshape(2 * P * Nb, -1)
    agg = (agg_p + (p_ids.to(agg_p.dtype) * n_coarse)[:, None]).reshape(P * Nb)
    arms = arms_p.reshape(P * Nb, 2)
    return coords, tris, slots, agg, arms


def flatten_members(members_p, n_nodes: int):
    """(P, nc, w) per-plate member tables, padded with the plate's node
    count `n_nodes` -> one (P*nc, w) table over the flat node axis, padded
    with P*n_nodes (a padding entry the coarse restriction skips)."""
    P = members_p.shape[0]
    offsets = torch.arange(P, device=members_p.device)[:, None, None] * n_nodes
    flat = torch.where(members_p == n_nodes, P * n_nodes, members_p.to(torch.int64) + offsets)
    return flat.reshape(-1, members_p.shape[-1])


def build_coarse_matrix_flat(
    Ke: torch.Tensor,  # (..., 6,6,P*Mb) element-minor
    triangles: torch.Tensor,  # (P*Mb,3) flat node ids
    agg_ids: torch.Tensor,  # (P*Nb,) flat (p*nc + local)
    arms: torch.Tensor,  # (P*Nb,2)
    free_nodes: torch.Tensor,  # (..., P*Nb) 1.0 free / 0.0 fixed
    P: int,
    n_coarse: int,
) -> torch.Tensor:
    """Per-plate Kc = P^T K P, returned batched (..., P, 3nc, 3nc).

    Same element-wise assembly as coarse.build_coarse_matrix, with flat
    shared indices: element e belongs to plate e // Mb and its 9x9 coarse
    block lands in that plate's dense Kc."""
    dtype = Ke.dtype
    lead = Ke.shape[:-3]
    tri = triangles.to(torch.int64)
    PM = tri.shape[0]
    Mb = PM // P
    arm_e = arms[tri].to(dtype)  # (PM,3,2)
    free_e = free_nodes[..., tri].to(dtype)  # (...,PM,3)

    Le = Ke.new_zeros(lead + (6, 9, PM))
    for a in range(3):
        f = free_e[..., a]
        Le[..., 2 * a + 0, 3 * a + 0, :] = f
        Le[..., 2 * a + 0, 3 * a + 2, :] = -arm_e[:, a, 1] * f
        Le[..., 2 * a + 1, 3 * a + 1, :] = f
        Le[..., 2 * a + 1, 3 * a + 2, :] = arm_e[:, a, 0] * f

    T1 = torch.einsum("...klm,...ljm->...kjm", Ke, Le)  # (...,6,9,PM)
    Kce = torch.einsum("...kim,...kjm->...ijm", Le, T1)  # (...,9,9,PM)

    plate_of_e = torch.arange(PM, device=tri.device) // Mb  # (PM,)
    # local coarse dof of slot (s, m): 3*(agg - plate*nc) + m
    agg_local = agg_ids.to(torch.int64)[tri] - plate_of_e[:, None] * n_coarse  # (PM,3)
    cdof = (3 * agg_local).T  # (3, PM)
    modes = torch.arange(3, device=tri.device)[:, None]
    cdof = torch.cat([cdof[s][None] + modes for s in range(3)])  # (9, PM)
    nc3 = 3 * n_coarse
    flat = (
        plate_of_e[None, None, :] * (nc3 * nc3)
        + cdof[:, None, :] * nc3
        + cdof[None, :, :]
    ).reshape(-1)
    Kc = scatter_sum(P * nc3 * nc3, flat, Kce.flatten(-3)).reshape(lead + (P, nc3, nc3))
    d = torch.diagonal(Kc, dim1=-2, dim2=-1)  # (..., P, nc3)
    ridge = 1e-6 * d.max(dim=-1, keepdim=True).values + torch.where(d <= 0.0, 1.0, 0.0).to(dtype)
    return Kc + torch.diag_embed(ridge)


def coarse_apply_flat(
    Kc_inv: torch.Tensor,  # (..., P, 3nc, 3nc)
    agg_ids: torch.Tensor,  # (P*Nb,) flat
    arms: torch.Tensor,  # (P*Nb, 2)
    members: torch.Tensor,  # (P*nc, w) flat, flatten_members
    r_planar: torch.Tensor,  # (..., 2*P*Nb) comp-major
    P: int,
    n_coarse: int,
) -> torch.Tensor:
    """z = P Kc^-1 P^T r: the restriction sums (rx, ry, -arm_y rx +
    arm_x ry) over each aggregate's member row, one batched dense matvec
    per plate, the prolongation gathers by aggregate id: the coarse term
    of `ChunkPreconditioner`, alone.

    This is the arithmetic of fea_tpu's `fused` path (one (N, 3) segment
    sum and one (N, 3) gather in place of three of each): the stacked
    (3, N) moments are restricted through one gather of the member table
    and one sum, and prolonged by one (N, 3) gather, so the switch has no
    counterpart here."""
    coarse = ChunkPreconditioner(None, P, Kc_inv=Kc_inv, agg_ids=agg_ids, arms=arms,
                                 members=members, n_coarse=n_coarse)
    return coarse(r_planar)


class ChunkPreconditioner:
    """The chunk's preconditioner (fea_tpu/fem/flatgroup.py:329-343), z =
    free * (Dblk^-1 r + P Kc^-1 P^T r) on planar (C, 2*P*Nb) vectors, with
    the 2x2 block-Jacobi term (`block_inv`, (C, 2, 2, P*Nb)) or, under
    band-block Jacobi, the Gram term of the f32 copy of the bf16 factor
    (`gram_factor`), or neither; the coarse term where `Kc_inv` is given;
    no mask where `free` is None.

    `parts(r)` gives (zj, zc): the smoother's term, and the coarse solution
    (C, P, 3nc) or None. The block-Jacobi term and the restriction are one
    launch of `ops.cg.jacobi_restrict`, the Gram term torch ops, the coarse
    matvec a batched product. What is left, the prolongation of zc by
    aggregate id, the sum and the free mask, is `ops.cg.prolong_dots` over
    the tables of `finish` (agg, arms, free): the CG loop runs it with its
    dot products in one launch, and calling the object runs it alone."""

    def __init__(self, free, P, block_inv=None, gram_factor=None, Kc_inv=None, agg_ids=None,
                 arms=None, members=None, n_coarse=0):
        self.free, self.P, self.n_coarse = free, P, n_coarse
        self.block_inv, self.gram_factor, self.Kc_inv = block_inv, gram_factor, Kc_inv
        coarse = Kc_inv is not None
        self.arms = arms.to(Kc_inv.dtype).contiguous() if coarse else None
        self.agg = agg_ids.to(torch.int32).contiguous() if coarse else None
        self.members = members.to(torch.int32).contiguous() if coarse else None
        self.finish = (self.agg, self.arms, free)

    def parts(self, r):
        C, ndof = r.shape
        PN = ndof // 2
        zj = rc = None
        if self.gram_factor is not None:
            zi = gram_apply(self.gram_factor, planar_to_interleaved(r, PN), storage=torch.bfloat16)
            zj = interleaved_to_planar(zi, PN)
        if self.Kc_inv is not None:
            rc = r.new_empty((C, self.P * self.n_coarse, 3))
        if self.block_inv is not None:
            zj = torch.empty_like(r)
            cg.jacobi_restrict(r, self.block_inv, self.arms, self.members, zj, rc)
        elif rc is not None:
            cg.jacobi_restrict(r, None, self.arms, self.members, None, rc)
        zc = None
        if rc is not None:
            zc = torch.einsum("...pij,...pj->...pi", self.Kc_inv,
                              rc.reshape(C, self.P, 3 * self.n_coarse))
        return zj, zc

    def __call__(self, r):
        zj, zc = self.parts(r)
        z = torch.empty_like(r)
        cg.prolong_dots(zj, zc, self.agg, self.arms, self.free, z, self.P)
        return z


class BandOperator:
    """The chunk's band operator on the card, y = free * K (free * u) on
    planar (C, 2*P*Nb) vectors, through the band's non-zeros (`vals`,
    `cols` and their width table `widths`: `banded.band_tables`, the free
    masks folded into the values) and
    `ops.band.band_matvec`. It applies the free masks itself
    (`masks_free`), so the CG loop does not mask again. y is one buffer,
    allocated here and written by each call (a captured block replays on
    the same memory): the result of a call lasts until the next call."""

    masks_free = True

    def __init__(self, vals, cols, widths, n_dofs: int):
        self.vals, self.cols, self.widths = vals.contiguous(), cols.contiguous(), widths
        self.y = vals.new_empty((vals.shape[0], n_dofs))

    def __call__(self, u):
        band.band_matvec(self.vals, self.cols, u, self.y, self.widths)
        return self.y


def chunk_stiffness(coords, triangles, young, poisson):
    """The lanes' element stiffness: D (3, 3, C, PM), the shared B (3, 6,
    PM) and Ke (C, 6, 6, PM), element-minor, from the flat tables and the
    (C, PM) materials."""
    D = plane_strain_stiffness_em(young, poisson)  # (3,3,C,PM)
    B, area = triangle_geometry(coords, triangles)  # shared (3,6,PM), (PM,)
    DB = torch.einsum("ijcm,jkm->ikcm", D, B)
    return D, B, torch.einsum("jim,jkcm->cikm", B, DB) * area


def flat_band_indices(triangles_p, m_real_p, n_nodes: int, band_hb: int):
    """The chunk's band plan (36, P*Mb): each plate's (band_assembly_indices_dev)
    offset by its row block. Rows are plate-contiguous in the interleaved
    flat dof order, so the flat system's band is the block-diagonal stack
    of the per-plate bands."""
    P, Mb = triangles_p.shape[:2]
    w_band = 2 * band_hb + BAND_R
    band_idx_p = band_assembly_indices_dev(triangles_p, m_real_p, band_hb)  # (P,36,Mb)
    offsets = torch.arange(P, device=triangles_p.device)[:, None, None] * (2 * n_nodes * w_band)
    return (band_idx_p + offsets).transpose(0, 1).reshape(36, P * Mb)


def dense_band_operator(S, band_hb: int):
    """K u on planar (C, 2*PN) vectors through the dense band S (C, nblk,
    R, W): the window gather and the batched product of
    `banded.banded_matvec` between the planar / interleaved transposes."""
    PN = S.shape[-3] * S.shape[-2] // 2
    win_idx = window_index(2 * PN, band_hb, device=S.device)

    def op(u):
        yi = banded_matvec(S, planar_to_interleaved(u, PN), win_idx, band_hb)
        return interleaved_to_planar(yi, PN)

    return op


def band_operator(S, band_idx, band_hb: int, free):
    """The chunk's band operator: on the card `BandOperator` over S's
    non-zeros (free * K (free * u)); on the CPU the dense band's product
    (K u, the loop masks it), fea_tpu's route bit for bit as before."""
    if S.is_cuda:
        return BandOperator(*band_tables(S, band_idx, band_hb, free), free.shape[-1])
    return dense_band_operator(S, band_hb)


def _synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class ChunkSystem(NamedTuple):
    """A chunk's CG system after set-up, every per-solve array with the
    leading lane axis C: `op` (K u; on the card's band route free * K
    (free * u), `BandOperator`) and `precondition` (M^-1 r) on planar
    (C, 2*P*Nb) vectors, the right-hand side `b`, the diagonal `diag`, the
    free-dof mask `free` and the warm start `x0` in that layout, and what
    the packed rows need (B, D, the element dofs)."""

    op: Callable
    precondition: Callable
    b: torch.Tensor
    diag: torch.Tensor
    free: torch.Tensor
    x0: torch.Tensor
    B: torch.Tensor  # (3, 6, P*Mb) shared
    D: torch.Tensor  # (3, 3, C, P*Mb)
    dof_idx: torch.Tensor  # (6, P*Mb) shared


def chunk_system(
    coords_p,  # (P, Nb, 2)
    triangles_p,  # (P, Mb, 3)
    slots_p,  # (P, 2*Nb, W)
    agg_p,  # (P, Nb)
    arms_p,  # (P, Nb, 2)
    members_p,  # (P, nc, w) real-node member tables, padded with Nb
    young_pc,  # (P, C, Mb)
    poisson_pc,  # (P, C, Mb)
    free_pc,  # (P, C, Nb)
    loads_pc,  # (P, C, Nb, 2)
    x0_pc,  # (P, C, Nb, 2)
    m_real_p=None,  # (P,) real-triangle counts (banded solvers)
    *,
    n_coarse: int,
    band_hb: int = 0,
    band_block: int = 0,
) -> ChunkSystem:
    """The per-solve set-up of a chunk: element stiffness, the operator
    (band or incidence; the band's route by device, `band_operator`), the
    block-Jacobi and coarse preconditioner.

    With the band (`band_hb` > 0), `band_block` > 0 takes K's diagonal
    blocks of that many dofs from the band for the smoother (band-block
    Jacobi, banded.spd_block_inv_factor) in place of the per-node 2x2
    blocks; without the band it is ignored, as in fea_tpu. `band_block` is
    degraded as fea_tpu's is: at least 128, less 128 at a time until it
    divides 2*P*Nb, else off."""
    P, Nb, _ = coords_p.shape
    Mb = triangles_p.shape[1]
    C = young_pc.shape[1]
    PN = P * Nb
    PM = P * Mb
    coords, triangles, slots, agg_ids, arms = flatten_tables(
        coords_p, triangles_p, slots_p, agg_p, arms_p, n_coarse
    )
    members = flatten_members(members_p, Nb)
    dof_idx = element_dof_indices(triangles, PN)  # (6, PM) shared

    # condition-major dense data: (P, C, ...) -> (C, flat ...)
    young = young_pc.transpose(0, 1).reshape(C, PM)
    poisson = poisson_pc.transpose(0, 1).reshape(C, PM)
    free = free_pc.transpose(0, 1).reshape(C, PN)
    loads = loads_pc.transpose(0, 1).reshape(C, PN, 2)
    x0 = x0_pc.transpose(0, 1).reshape(C, PN, 2)

    D, B, Ke = chunk_stiffness(coords, triangles, young, poisson)
    diag = extract_diagonal(Ke, triangles, PN)  # (C,PN,2)
    free_planar = torch.cat([free, free], dim=-1)  # (C, 2PN)
    if band_block > 0:
        band_block = max(band_block, 128)
        while band_block > 128 and (2 * PN) % band_block:
            band_block -= 128
        if (2 * PN) % band_block:
            band_block = 0
    gram_factor = None
    if band_hb > 0:
        band_idx = flat_band_indices(triangles_p, m_real_p, Nb, band_hb)
        S = assemble_band(Ke, band_idx, 2 * PN, band_hb)  # (C, nblk, R, W)
        if band_block > 0:
            # Band-block Jacobi: blocks may straddle plates, harmlessly
            # (plates share no elements, so such a block is itself block
            # diagonal). The factor is stored in bf16 as fea_tpu's is; its
            # f32 copy (exact) is made once here, not at every iteration.
            free_i = planar_to_interleaved(free_planar, PN).reshape(C, -1, band_block)
            blocks = band_block_diagonal(S, band_hb, band_block)
            gram_factor = spd_block_inv_factor(blocks, free_i).to(torch.float32)
        op = band_operator(S, band_idx, band_hb, free_planar)  # S is freed with this frame on the card
    else:
        op = partial(apply_element_stiffness_planar, Ke, dof_idx, slots)
    block_inv = None
    if gram_factor is None:
        block_inv = invert_blocks(block_diagonal(Ke, triangles, PN))  # (C,2,2,PN)

    Kc_inv = None
    if n_coarse > 0:
        Kc = build_coarse_matrix_flat(Ke, triangles, agg_ids, arms, free, P, n_coarse)
        Kc_inv = coarse_inverse(Kc)  # (C,P,3nc,3nc)
    precondition = ChunkPreconditioner(
        free_planar, P, block_inv=block_inv, gram_factor=gram_factor, Kc_inv=Kc_inv,
        agg_ids=agg_ids, arms=arms, members=members, n_coarse=n_coarse)

    return ChunkSystem(
        op=op,
        precondition=precondition,
        b=loads.transpose(-1, -2).reshape(C, -1),
        diag=diag.transpose(-1, -2).reshape(C, -1),
        free=free_planar,
        x0=x0.transpose(-1, -2).reshape(C, -1),
        B=B,
        D=D,
        dof_idx=dof_idx,
    )


def flat_group_body(
    *tables,
    n_coarse: int,
    tol: float,
    max_iters: int,
    accept_tol: float,
    restarts: int,
    include_cell_fields: bool = True,
    band_hb: int = 0,
    band_block: int = 0,
    check_every: int = CHECK_EVERY,
    info: Optional[dict] = None,
    m_real_p=None,
):
    """The whole chunk's solve on the tables' device: `tables` are
    `chunk_system`'s (coords_p ... x0_pc, and m_real_p for a band; the
    band switches are its too).
    Returns (P, C, K) packed f32 rows [u (Nb*2), (eps1 (Mb*3), sig1 (Mb*3)
    when include_cell_fields), converged, failed, rnorm, iters] — the
    layout `unpack_solve` expects. `info`, when given, receives the CG
    loop's `host_reads`, and the seconds of the set-up (`setup_s`) and of
    the loop with its final residual (`loop_s`), each ended by a
    synchronization of the device."""
    _require_true_f32()
    t_start = time.perf_counter()
    coords_p, triangles_p = tables[0], tables[1]
    P, Nb, _ = coords_p.shape
    Mb = triangles_p.shape[1]
    C = tables[6].shape[1]
    device = coords_p.device
    system = chunk_system(*tables, m_real_p=m_real_p, n_coarse=n_coarse, band_hb=band_hb,
                          band_block=band_block)
    if info is not None:
        _synchronize(device)
        t_loop = time.perf_counter()
        info["setup_s"] = t_loop - t_start
    res = pcg_solve_segmented(
        system.op,
        system.b,
        system.diag,
        system.free,
        n_seg=P,
        x0=system.x0,
        tol=tol,
        max_iters=max_iters // max(restarts, 1),
        accept_tol=accept_tol,
        precondition=system.precondition,
        restarts=restarts,
        check_every=check_every,
    )
    if info is not None:
        _synchronize(device)
        info["loop_s"] = time.perf_counter() - t_loop
        info["host_reads"] = res.host_reads
    f32 = torch.float32
    x = res.x.reshape(C, 2, P, Nb)  # planar -> per-plate
    parts = [x.permute(2, 0, 3, 1).reshape(P, C, Nb * 2).to(f32)]
    if include_cell_fields:
        xe = res.x[:, system.dof_idx]  # (C,6,PM)
        eps1 = torch.einsum("ijm,cjm->cim", system.B, xe)  # (C,3,PM)
        sig1 = torch.einsum("ijcm,cjm->cim", system.D, eps1)
        for cell in (eps1, sig1):
            parts.append(cell.reshape(C, 3, P, Mb).permute(2, 0, 3, 1).reshape(P, C, Mb * 3).to(f32))
    tail = torch.stack(
        [
            res.converged.to(f32),
            res.failed.to(f32),
            res.residual_norm.to(f32),
            res.iterations.to(f32),
        ],
        dim=-1,
    )  # (C, P, 4)
    parts.append(tail.transpose(0, 1))
    return torch.cat(parts, dim=-1)  # (P, C, K)
