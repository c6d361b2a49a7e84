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
RCM-permuted plates, the dense band (fem/banded.py). Every sum of the
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

from .assembly import apply_element_stiffness_planar, element_dof_indices, scatter_sum
from .banded import (
    BAND_R,
    assemble_band,
    band_assembly_indices_dev,
    band_block_diagonal,
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
    with P*n_nodes (the index of the zero `coarse_apply_flat` appends)."""
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
    per plate, the prolongation gathers by aggregate id.

    This is the arithmetic of fea_tpu's `fused` path (one (N, 3) segment
    sum and one (N, 3) gather in place of three of each): the stacked
    (3, N) moments are restricted through one gather of the member table
    and one sum, and prolonged by one (N, 3) gather, so the switch has no
    counterpart here."""
    n = agg_ids.shape[0]
    dtype = r_planar.dtype
    lead = r_planar.shape[:-1]
    rx = r_planar[..., :n]
    ry = r_planar[..., n:]
    armx = arms[:, 0].to(dtype)
    army = arms[:, 1].to(dtype)
    moments = torch.stack([rx, ry, -army * rx + armx * ry], dim=-2)  # (..., 3, n)
    moments = torch.cat([moments, moments.new_zeros(lead + (3, 1))], dim=-1)
    rc = moments[..., members].sum(dim=-1)  # (..., 3, P*nc)
    rc = rc.transpose(-1, -2).reshape(lead + (P, 3 * n_coarse))  # rows [3a+m]
    # a matvec in the working dtype (see coarse.coarse_apply)
    zc = torch.einsum("...pij,...pj->...pi", Kc_inv, rc)
    zc3 = zc.reshape(lead + (P * n_coarse, 3))[..., agg_ids, :]  # (..., n, 3)
    zx = zc3[..., 0] - army * zc3[..., 2]
    zy = zc3[..., 1] + armx * zc3[..., 2]
    return torch.cat([zx, zy], dim=-1)


def _synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class ChunkSystem(NamedTuple):
    """A chunk's CG system after set-up, every per-solve array with the
    leading lane axis C: `op` (K u) and `precondition` (M^-1 r) on planar
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
    (band or incidence), the block-Jacobi and coarse preconditioner.

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
    device = coords_p.device
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

    D = plane_strain_stiffness_em(young, poisson)  # (3,3,C,PM)
    B, area = triangle_geometry(coords, triangles)  # shared (3,6,PM), (PM,)
    DB = torch.einsum("ijcm,jkm->ikcm", D, B)
    Ke = torch.einsum("jim,jkcm->cikm", B, DB) * area  # (C,6,6,PM)
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
        # per-plate band indices address a (2*Nb*W,) plate-local buffer;
        # offset by each plate's row block (rows are plate-contiguous in
        # the interleaved flat dof order, so the flat system's band is the
        # block-diagonal stack of the per-plate bands)
        w_band = 2 * band_hb + BAND_R
        band_idx_p = band_assembly_indices_dev(triangles_p, m_real_p, band_hb)  # (P,36,Mb)
        offsets = torch.arange(P, device=device)[:, None, None] * (2 * Nb * w_band)
        band_idx = (band_idx_p + offsets).transpose(0, 1).reshape(36, PM)
        win_idx = window_index(2 * PN, band_hb, device=device)
        S = assemble_band(Ke, band_idx, 2 * PN, band_hb)  # (C, nblk, R, W)

        def op(u):
            yi = banded_matvec(S, planar_to_interleaved(u, PN), win_idx, band_hb)
            return interleaved_to_planar(yi, PN)

        if band_block > 0:
            # Band-block Jacobi: blocks may straddle plates, harmlessly
            # (plates share no elements, so such a block is itself block
            # diagonal). The factor is stored in bf16 as fea_tpu's is; its
            # f32 copy (exact) is made once here, not at every iteration.
            free_i = planar_to_interleaved(free_planar, PN).reshape(C, -1, band_block)
            blocks = band_block_diagonal(S, band_hb, band_block)
            gram_factor = spd_block_inv_factor(blocks, free_i).to(torch.float32)
    else:
        op = partial(apply_element_stiffness_planar, Ke, dof_idx, slots)
    if gram_factor is None:
        block_inv = invert_blocks(block_diagonal(Ke, triangles, PN))  # (C,2,2,PN)

    Kc_inv = None
    if n_coarse > 0:
        Kc = build_coarse_matrix_flat(Ke, triangles, agg_ids, arms, free, P, n_coarse)
        Kc_inv = coarse_inverse(Kc)  # (C,P,3nc,3nc)

    def precondition(r):
        if gram_factor is not None:
            zi = gram_apply(gram_factor, planar_to_interleaved(r, PN), storage=torch.bfloat16)
            z = interleaved_to_planar(zi, PN)
        else:
            z = (block_inv * r.reshape(C, 1, 2, PN)).sum(dim=-2).reshape(C, -1)
        if Kc_inv is not None:
            z = z + coarse_apply_flat(Kc_inv, agg_ids, arms, members, r, P, n_coarse)
        return z * free_planar

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
