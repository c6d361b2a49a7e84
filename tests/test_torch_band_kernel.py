"""The chunk's band operator over K's non-zeros: `fem.banded.band_tables`
(the compacted band), `ops.band.band_matvec_reference` (its plain version) and
`ops.band.band_matvec` (the hand-written CUDA kernel,
`csrc/band_matvec.cu`), against fea_tpu's dense band product.

On the CPU, on the 3-plate chunk of tests/test_torch_flatgroup.py (plates
of 0.14 / 0.145 / 0.15 in one bucket, 2 conditions each, RCM-permuted):
- the tables hold every entry of the dense band S, bit for bit, and no
  (row, column) outside K's structure as the real triangles give it; a
  row's columns ascend, its pads follow them;
- the plain version with the free masks folded in against fea_tpu's
  `banded_matvec` between the masks and the transposes: within 1e-6 of
  y's span in f32 and 1e-12 in f64 (the sums run in another order: over a
  row's non-zeros here, over the band's window there);
- on the CPU the chunk's operator is the dense route, bit for bit what
  it was; `BandOperator` on CPU tensors is the plain version;
- a lane with a NaN in one element's Young modulus ends `failed` on that
  plate, the other lane as without it. On the card the lane's other
  plates end as without it too: the kernel reads K's non-zeros, and K is
  block-diagonal by plate, where the dense band's window reaches over a
  plate's edge (0 x NaN there spreads the NaN to a neighbouring plate).

The tests marked `gpu` skip without a CUDA device. JAX is imported inside
the CPU tests only, so on the card they run with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_band_kernel.py

They hold the kernel against both plain versions (the compacted
reference, and the dense band's product or a dense matrix's), f32 and
f64, within 1e-5 of y's span in f32 and 1e-12 in f64: at a ragged shape (5
lanes, 1,000 rows, rows of 0 to 7 random columns) and at the production
chunk's (4 plates of 8192 nodes, 4 lanes, 65,536 dofs a lane); the chunk's
rows through the CUDA graph equal the kernels' run without one bit for bit,
with the launch counts; the wrapper raises on CPU, bf16 and non-contiguous
tensors given with CUDA ones.
"""

import numpy as np
import pytest
import torch

import test_torch_cg_kernels as tc
import test_torch_flatgroup as tf
from fea_tpu_torch.datagen import batched
from fea_tpu_torch.fem import banded, flatgroup, solver
from fea_tpu_torch.mesh import mesher
from fea_tpu_torch.ops import band, cg

torch.set_num_threads(1)

TOL = {torch.float32: 1e-6, torch.float64: 1e-12}  # plain version vs fea_tpu, of y's span
KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # kernel vs the plain versions


@pytest.fixture(scope="module")
def plates():
    return tf.payload_problems()


def chunk_band(tables, m_real_p, band_hb):
    """The chunk's dense band S (C, nblk, 128, W), its plan and the planar
    free mask (C, 2 PN), as `chunk_system` makes them."""
    P, Nb = tables[0].shape[:2]
    C, Mb = tables[6].shape[1:]
    coords, tris = flatgroup.flatten_tables(*tables[:5], 1)[:2]
    young, poisson, free = (t.transpose(0, 1).reshape(C, -1) for t in tables[6:9])
    Ke = flatgroup.chunk_stiffness(coords, tris, young, poisson)[2]
    band_idx = flatgroup.flat_band_indices(tables[1], m_real_p, Nb, band_hb)
    S = banded.assemble_band(Ke, band_idx, 2 * P * Nb, band_hb)
    return S, band_idx, torch.cat([free, free], dim=-1)


def cpu_chunk(plates):
    solvers, host, m_real, band_hb = batched.chunk_inputs(tf.port_payloads(plates))
    assert band_hb > 0
    tables, m_real_p = batched.chunk_tables(solvers, host, m_real, torch.device("cpu"))
    return solvers, tables, m_real_p, band_hb


def dense_from_band(S, hb):
    """(C, 2 PN, 2 PN) planar K from the block-shifted band."""
    C, nblk, R, W = S.shape
    n_dofs = nblk * R
    i = torch.arange(n_dofs)[:, None].expand(n_dofs, W)
    j = (i // R) * R + torch.arange(W)[None, :] - hb
    keep = (j >= 0) & (j < n_dofs)
    K = S.new_zeros((C, n_dofs, n_dofs))
    planar = lambda d: (d & 1) * (n_dofs // 2) + (d >> 1)  # noqa: E731
    K[:, planar(i[keep]), planar(j[keep])] = S.reshape(C, n_dofs, W)[:, keep]
    return K


def dense_from_tables(vals, cols, n_dofs):
    """(C, n_dofs, n_dofs) from the compacted band, and the (row, column)
    pairs it holds."""
    n_slices, slots, rows = cols.shape
    row = (torch.arange(n_slices)[:, None, None] * rows + torch.arange(rows)[None, None, :])
    row = row.expand(cols.shape)
    real = cols >= 0
    K = vals.new_zeros((vals.shape[0], n_dofs, n_dofs))
    K[:, row[real], cols[real].long()] = vals[:, real]
    return K, set(zip(row[real].tolist(), cols[real].tolist()))


def test_tables_hold_the_band_and_nothing_outside_ks_structure(plates):
    solvers, tables, m_real_p, hb = cpu_chunk(plates)
    P, Nb = tables[0].shape[:2]
    S, band_idx, _ = chunk_band(tables, m_real_p, hb)
    vals, cols, _ = banded.band_tables(S, band_idx, hb)
    n_dofs = 2 * P * Nb
    assert vals.shape == (S.shape[0],) + tuple(cols.shape) and cols.dtype == torch.int32
    got, pairs = dense_from_tables(vals, cols, n_dofs)
    assert torch.equal(got, dense_from_band(S, hb))
    # K's structure from each plate's real triangles, in flat planar dofs
    want = set()
    for p, s in enumerate(solvers):
        tri = s.triangles_dev.numpy()[:s.m].astype(np.int64) + p * Nb
        dof = np.concatenate([tri, tri + P * Nb], axis=1)  # (m, 6) planar
        want |= set(zip(np.repeat(dof, 6, axis=1).ravel().tolist(), np.tile(dof, 6).ravel().tolist()))
    assert pairs == want
    # a row's columns ascend in interleaved order, then its pads; the
    # widest row sets the slots
    inter = torch.where(cols >= P * Nb, 2 * (cols - P * Nb) + 1, 2 * cols)
    inter = torch.where(cols < 0, torch.iinfo(torch.int32).max, inter)
    assert (inter[:, 1:] > inter[:, :-1]).logical_or(cols[:, 1:] < 0).all()
    assert int((cols[:, -1] >= 0).sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_plain_version_matches_fea_tpus_banded_matvec(plates, dtype):
    import jax
    import jax.numpy as jnp

    from fea_tpu.fem import banded as jbanded

    _, tables, m_real_p, hb = cpu_chunk(plates)
    P, Nb = tables[0].shape[:2]
    PN = P * Nb
    S, band_idx, free = chunk_band(tables, m_real_p, hb)
    S, free = S.to(dtype), free.to(dtype)
    vals, cols, widths = banded.band_tables(S, band_idx, hb, free)
    C = S.shape[0]
    u = torch.from_numpy(np.random.default_rng(3).normal(size=(C, 2 * PN))).to(dtype)
    y = torch.empty_like(u)
    band.band_matvec_reference(vals, cols, u, y)
    through_wrapper = torch.empty_like(u)
    band.band_matvec(vals, cols, u, through_wrapper, widths)  # CPU tensors: the plain version
    assert torch.equal(through_wrapper, y)

    def jax_lane(c):
        x = jnp.asarray((u[c] * free[c]).numpy())
        win = jbanded.window_index(2 * PN, hb)
        yi = jbanded.banded_matvec(jnp.asarray(S[c].numpy()), jbanded.planar_to_interleaved(x, PN),
                                   win, hb)
        return np.asarray(jbanded.interleaved_to_planar(yi, PN)) * free[c].numpy()

    if dtype == torch.float32:
        with jax.enable_x64(False):
            want = np.stack([jax_lane(c) for c in range(C)])
    else:
        want = np.stack([jax_lane(c) for c in range(C)])
    assert want.dtype == y.numpy().dtype
    span = want.max() - want.min()
    assert np.abs(y.numpy() - want).max() <= TOL[dtype] * span


def test_cpu_chunk_operator_is_the_dense_route(plates):
    _, tables, m_real_p, hb = cpu_chunk(plates)
    system = flatgroup.chunk_system(*tables, m_real_p=m_real_p, n_coarse=tables[5].shape[1],
                                    band_hb=hb)
    assert not isinstance(system.op, flatgroup.BandOperator)
    S, band_idx, free = chunk_band(tables, m_real_p, hb)
    u = torch.from_numpy(np.random.default_rng(4).normal(size=system.b.shape).astype(np.float32))
    PN = u.shape[1] // 2
    win = banded.window_index(2 * PN, hb)
    want = banded.interleaved_to_planar(
        banded.banded_matvec(S, banded.planar_to_interleaved(u, PN), win, hb), PN)
    assert torch.equal(system.op(u), want)
    # the card's operator, on CPU tensors: the plain version of the kernel
    A = solver.masked_operator(system.op, system.free)
    compact = flatgroup.BandOperator(*banded.band_tables(S, band_idx, hb, free), u.shape[1])
    assert solver.masked_operator(compact, system.free) is compact
    got = compact(u)
    span = float(A(u).max() - A(u).min())
    assert float((got - A(u)).abs().max()) <= TOL[torch.float32] * span


def nan_lane_rows(plates, device):
    """The chunk's packed rows without and with a NaN Young modulus in one
    element of plate 1, lane 0."""
    payloads = [(batched.PlateSolver(mesh, 2, device=device), problems)
                for mesh, problems in plates]
    solvers, host, m_real, band_hb = batched.chunk_inputs(payloads)
    kw = batched.chunk_keywords(solvers, band_hb)
    rows = []
    for poison in (False, True):
        tables, m_real_p = batched.chunk_tables(solvers, host, m_real, device)
        if poison:
            tables[6][1, 0, 3] = float("nan")
        rows.append(flatgroup.flat_group_body(*tables, m_real_p=m_real_p, **kw).cpu())
    return rows


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_a_lane_with_a_nan_element_ends_failed(plates, device):
    if device == "cuda":
        tc.cuda_or_skip()
    clean, poisoned = nan_lane_rows(plates, torch.device(device))
    flags = [-4, -3]  # converged, failed
    assert (clean[..., flags[1]] == 0).all()
    assert poisoned[1, 0, flags].tolist() == [0, 1]
    assert torch.equal(poisoned[:, 1, flags], clean[:, 1, flags])  # the other lane
    if device == "cuda":  # the kernel reads plate 1's non-zeros only
        assert torch.equal(poisoned[[0, 2], 0][:, flags], clean[[0, 2], 0][:, flags])


# ---- the card -----------------------------------------------------------


def ragged_tables(device, dtype, C=5, n_dofs=1000, slots=7, seed=0):
    """Tables of rows with 0 to `slots` random ascending columns."""
    rng = np.random.default_rng(seed)
    n_slices = -(-n_dofs // band.ELL_ROWS)
    cols = np.full((n_slices * band.ELL_ROWS, slots), -1, np.int64)
    for r in range(n_dofs):
        k = rng.integers(0, slots + 1)
        cols[r, :k] = np.sort(rng.choice(n_dofs, k, replace=False))
    cols = cols.reshape(n_slices, band.ELL_ROWS, slots).transpose(0, 2, 1)
    vals = rng.normal(size=(C,) + cols.shape) * (cols >= 0)
    return (torch.from_numpy(vals).to(device, dtype),
            torch.from_numpy(np.ascontiguousarray(cols)).to(device, torch.int32))


def production_chunk(device, lanes=4):
    """4 unit-square plates of 8192-node buckets (mesh 0.0125 to 0.014)
    with seeded materials and the left edge fixed, `lanes` lanes: S, the
    plan, hb and the planar free mask."""
    meshes = [mesher.triangulate(tf.SQUARE, mesh_size=h) for h in (0.0125, 0.013, 0.0135, 0.014)]
    first = [batched.PlateSolver(m, 2, device=device) for m in meshes]
    kw = dict(node_bucket=max(s.node_bucket for s in first),
              tri_bucket=max(s.tri_bucket for s in first), band_hb=max(s.band_hb for s in first))
    solvers = [batched.PlateSolver(m, 2, device=device, **kw) for m in meshes]
    P, Nb, Mb = len(solvers), kw["node_bucket"], kw["tri_bucket"]
    assert Nb == 8192 and all(s.band_hb == kw["band_hb"] > 0 for s in solvers)
    rng = np.random.default_rng(5)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    real = np.concatenate([np.arange(Mb) < s.m for s in solvers])  # ghost elements: no stiffness
    young = t(rng.uniform(1e3, 1e5, (lanes, P * Mb)) * real)
    poisson = t(rng.uniform(0.2, 0.4, (lanes, P * Mb)))
    coords = torch.stack([s.coords_dev for s in solvers])
    tris_p = torch.stack([s.triangles_dev for s in solvers])
    free = np.zeros((lanes, P, Nb), np.float32)
    for p, s in enumerate(solvers):
        x = s.coords_dev[:s.n, 0].cpu().numpy()
        free[:, p, :s.n] = x > 1e-9
        free[1:, p, :s.n] *= rng.uniform(size=(lanes - 1, s.n)) > 0.05
    free = t(free).reshape(lanes, -1)
    flat_coords = coords.reshape(-1, 2)
    flat_tris = (tris_p + (torch.arange(P, device=device) * Nb)[:, None, None].to(tris_p.dtype))
    Ke = flatgroup.chunk_stiffness(flat_coords, flat_tris.reshape(-1, 3), young, poisson)[2]
    m_real = torch.tensor([s.m for s in solvers], device=device)
    band_idx = flatgroup.flat_band_indices(tris_p, m_real, Nb, kw["band_hb"])
    S = banded.assemble_band(Ke, band_idx, 2 * P * Nb, kw["band_hb"])
    return S, band_idx, kw["band_hb"], torch.cat([free, free], dim=-1)


def span_error(got, want):
    return float((got - want).abs().max()) / float(want.max() - want.min())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", ["ragged", "chunk"])
def test_kernel_matches_both_plain_versions(shape, dtype):
    device = tc.cuda_or_skip()
    if shape == "ragged":
        vals, cols = ragged_tables(device, dtype)
        widths = banded.slice_widths(cols)
        C, n_dofs = vals.shape[0], 1000
        K = dense_from_tables(vals.cpu(), cols.cpu(), n_dofs)[0].to(device)

        def dense(u):
            return torch.einsum("cij,cj->ci", K, u)
    else:
        S, band_idx, hb, free = production_chunk(device)
        S, free = S.to(dtype), free.to(dtype)
        vals, cols, widths = banded.band_tables(S, band_idx, hb, free)
        C, n_dofs = free.shape
        A = solver.masked_operator(flatgroup.dense_band_operator(S, hb), free)

        def dense(u):
            return A(u)
    u = torch.from_numpy(np.random.default_rng(6).normal(size=(C, n_dofs))).to(device, dtype)
    y, plain = torch.empty_like(u), torch.empty_like(u)
    before = band.band_matvec.launches
    band.band_matvec(vals, cols, u, y, widths)
    again = torch.empty_like(u)
    band.band_matvec(vals, cols, u, again, widths)
    band.band_matvec_reference(vals, cols, u, plain)
    torch.cuda.synchronize()
    assert band.band_matvec.launches == before + 2
    assert torch.equal(y, again)  # the same bits
    assert span_error(y, plain) <= KERNEL_TOL[dtype]
    assert span_error(y, dense(u)) <= KERNEL_TOL[dtype]


@pytest.mark.gpu
def test_graph_route_equals_the_kernels_route(plates, monkeypatch):
    tc.cuda_or_skip()
    payloads = [(batched.PlateSolver(mesh, 2), problems) for mesh, problems in plates]
    wrappers = cg.WRAPPERS + (band.band_matvec,)
    runs = {}
    for route in ("graph", "kernels"):
        with monkeypatch.context() as m:
            if route == "kernels":
                m.setattr(cg, "capture", tc.Eager)
            counts = [w.launches for w in wrappers]
            rows = batched.dispatch_plate_group(payloads).result()
            runs[route] = (rows, [w.launches - c for w, c in zip(wrappers, counts)])
    assert torch.equal(runs["graph"][0], runs["kernels"][0])
    # the capture's warm-up: one operator and one jacobi_restrict launch
    warmup = [int(w in (cg.jacobi_restrict, band.band_matvec)) for w in wrappers]
    assert runs["graph"][1] == [n + w for n, w in zip(runs["kernels"][1], warmup)]
    assert min(runs["kernels"][1]) > 0


@pytest.mark.gpu
def test_wrapper_raises_on_cpu_bf16_or_strided_tensors():
    device = tc.cuda_or_skip()
    vals, cols = ragged_tables(device, torch.float32, C=2, n_dofs=256)
    widths = banded.slice_widths(cols)
    u = torch.ones((2, 256), device=device)
    y = torch.empty_like(u)
    with pytest.raises(ValueError):
        band.band_matvec(vals, cols, u.cpu(), y, widths)
    with pytest.raises(ValueError):
        band.band_matvec(vals.cpu(), cols, u, y, widths)
    with pytest.raises(TypeError):
        band.band_matvec(vals.bfloat16(), cols, u.bfloat16(), y.bfloat16(), widths)
    with pytest.raises(ValueError):
        band.band_matvec(vals, cols, torch.ones((256, 2), device=device).T, y, widths)
    with pytest.raises(ValueError):
        band.band_matvec(vals.double(), cols, u, y, widths)
