"""Matrix-free stiffness application, the port of fea_tpu/fem/assembly.py.

Instead of materializing a sparse K (the reference hands a SciPy CSR to
SuperLU — fea_analysis.py:371-375), we keep per-element 6x6 blocks and
apply K via gather -> per-element 6x6 product -> incidence gather-sum. The
incidence form (node dof <- fixed-width list of (element, local-dof)
slots) sums in a fixed order: it is deterministic on the card, where a
scatter-add (`index_add_`) of f32 values through atomics is not.
"""

from typing import NamedTuple

import numpy as np
import torch


class IncidenceOp(NamedTuple):
    """Static gather plan: for each global dof, the flat indices into the
    (6*M,) element-result vector that accumulate into it, padded with a
    sentinel slot pointing at a zeroed entry.

    Layout contract (element-minor, see elasticity.py): element results are
    (6, M) flattened as k*M + e (k = local dof 2a+comp), and global dof
    vectors are planar (2N,) ordered comp*N + node."""

    slots: torch.Tensor  # (ndof, max_deg) int32 indices into padded (6*M+1,)
    n_nodes: int
    n_elements: int


def build_incidence(
    triangles: np.ndarray, n_nodes: int, pad_degree: int = 0, device="cpu"
) -> IncidenceOp:
    """Host-side construction of the incidence plan (once per mesh/bucket),
    uploaded to `device`.

    Vectorized NumPy group-by (no Python loop over elements). `pad_degree`
    forces a fixed table width so bucketed meshes share shapes."""
    triangles = np.asarray(triangles, dtype=np.int64)
    M = len(triangles)
    ndof = 2 * n_nodes
    sentinel = M * 6  # extra zero slot

    # Per element slot (e, a, comp): planar dof = comp*N + node,
    # element-minor value = (2a + comp)*M + e.
    nodes = np.repeat(triangles.reshape(-1), 2)  # (M*3*2,)
    comp = np.tile(np.array([0, 1]), M * 3)
    dof = comp * n_nodes + nodes
    ea = np.arange(M * 3)
    vals = (2 * np.repeat(ea % 3, 2) + comp) * M + np.repeat(ea // 3, 2)

    order = np.argsort(dof, kind="stable")
    dof_s = dof[order]
    vals_s = vals[order]
    counts = np.bincount(dof, minlength=ndof)
    max_deg = int(counts.max()) if M else 1
    # Quantize table width (multiple of 8) so meshes with similar max
    # degree share shapes.
    width = max(max_deg, pad_degree)
    width = ((width + 7) // 8) * 8
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(len(dof_s)) - np.repeat(starts, counts)

    slots = np.full((ndof, width), sentinel, dtype=np.int32)
    slots[dof_s, within] = vals_s
    return IncidenceOp(
        slots=torch.from_numpy(slots).to(device), n_nodes=n_nodes, n_elements=M
    )


def element_dof_indices(triangles, n_nodes):
    """(6, M) planar dof index of each element's local dofs: row k = 2a+c
    maps to c*N + triangles[:, a]."""
    tri_t = triangles.T  # (3, M)
    return torch.stack(
        [(k % 2) * n_nodes + tri_t[k // 2] for k in range(6)], dim=0
    )


def apply_element_stiffness_planar(Ke, dof_idx, incidence_slots, u):
    """y = K u on planar (2N,) dof vectors — the CG-loop hot path.

    Ke: (6,6,M) element-minor; dof_idx: (6,M) from element_dof_indices;
    incidence_slots: (2N, max_deg). The per-element product contracts over
    6: a broadcast multiply and a sum in the working dtype, which no
    tensor-core path touches."""
    ue = u[dof_idx]  # (6, M)
    fe = (Ke * ue[None]).sum(dim=1)  # (6, M)
    fe_flat = torch.cat([fe.reshape(-1), fe.new_zeros(1)])
    return fe_flat[incidence_slots].sum(dim=1)  # (2N,) planar


def apply_element_stiffness(Ke, triangles, incidence_slots, u):
    """y = K u for u of shape (n_nodes, 2).

    Ke: (6,6,M) element-minor; triangles: (M,3) int; incidence_slots:
    (2*n_nodes, max_deg). Convenience wrapper over the planar form."""
    n_nodes = u.shape[0]
    dof_idx = element_dof_indices(triangles, n_nodes)
    y = apply_element_stiffness_planar(
        Ke, dof_idx, incidence_slots, u.T.reshape(-1)
    )
    return y.reshape(2, n_nodes).T


def scatter_sum(size: int, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """zeros(size) with values[i] added at index[i], for the per-solve
    set-up sums, in an order that is the same from run to run. On the card
    `index_put_(accumulate=True)` sorts by index and sums each run of equal
    indices in order (`index_add_` there adds through atomics in any
    order); on the CPU `index_add_` walks the indices in order (there it is
    `index_put_` that adds from several threads at once)."""
    out = values.new_zeros(size)
    index = index.to(torch.int64)
    if values.is_cuda:
        return out.index_put_((index,), values, accumulate=True)
    return out.index_add_(0, index, values)


def assemble_dense(Ke, triangles, n_nodes):
    """Dense K for small test meshes only. Ke: (6,6,M) element-minor."""
    Ke = Ke.permute(2, 0, 1)  # (M,6,6) for per-element flattening
    triangles = triangles.to(torch.int64)
    dofs = torch.stack(
        [triangles * 2 + 0, triangles * 2 + 1], dim=-1
    ).reshape(-1, 6)  # (M,6): interleaved (x0,y0,x1,y1,x2,y2)
    rows = dofs[:, :, None].expand(-1, 6, 6)
    cols = dofs[:, None, :].expand(-1, 6, 6)
    ndof = 2 * n_nodes
    flat = (rows * ndof + cols).reshape(-1)
    return scatter_sum(ndof * ndof, flat, Ke.reshape(-1)).reshape(ndof, ndof)


def assemble_scipy_csr(Ke, triangles, n_nodes):
    """SciPy CSR assembly — host-side reference/direct-solve path.
    Ke: (M,6,6) NumPy, as element_stiffness_np returns it."""
    import scipy.sparse as sp

    Ke = np.asarray(Ke)
    triangles = np.asarray(triangles)
    dofs = np.stack([triangles * 2, triangles * 2 + 1], axis=-1).reshape(-1, 6)
    rows = np.repeat(dofs, 6, axis=1).reshape(-1)
    cols = np.tile(dofs, (1, 6)).reshape(-1)
    return sp.coo_matrix(
        (Ke.reshape(-1), (rows, cols)), shape=(2 * n_nodes, 2 * n_nodes)
    ).tocsr()
