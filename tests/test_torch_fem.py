"""The port's single-mesh FEM core (fea_tpu_torch.fem) and the host modules
under it (materials, geometry.polygon, mesh) against fea_tpu's, on the CPU.

The same NumPy inputs go through both packages. JAX runs in x64, as
tests/conftest.py sets it, so that float64 cases are float64 on both sides;
float32 cases pass float32 arrays. Two problems, both meshed by the CDT
library at mesh_size 0.08: a unit square with per-element materials drawn
from a seed, clamped on the left and loaded on the right; and an L-shaped
plate split into two material regions by node sets, whose straddling cells
get zero stiffness (the reference's region rule), clamped along the bottom.

Tolerances: float64 functions rtol 1e-12 of the largest element, float32
1e-5; float64 solves within 1e-9 of the largest displacement with
iteration counts within 2; float32 solves within 1e-4. JAX is imported
inside the helpers, so that the `gpu` test also runs on a machine without
JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_fem.py
"""

import numpy as np
import pytest
import torch

from fea_tpu_torch import materials
from fea_tpu_torch.fem import assembly, coarse, direct, elasticity, problem, solver
from fea_tpu_torch.geometry import polygon
from fea_tpu_torch.mesh import mesh_io, mesher
from fea_tpu_torch.ops import _build

torch.set_num_threads(1)

SQUARE = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
L_SHAPE = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 0.5], [0.5, 0.5], [0.5, 1.0], [0.0, 1.0]])
DTYPES = {"f64": (np.float64, torch.float64, 1e-12), "f32": (np.float32, torch.float32, 1e-5)}


def make_problem(name, cls=problem.StaticProblem, mesh_size=0.08, num_steps=3):
    """The square or the L-shaped plate as a StaticProblem of either
    package (the class is the argument; the arrays are the same)."""
    ring = SQUARE if name == "square" else L_SHAPE
    mesh = mesher.triangulate(ring, mesh_size=mesh_size)
    c, n = mesh.coords, mesh.num_nodes
    rng = np.random.default_rng(7)
    loads = np.zeros((n, 2))
    if name == "square":
        young = rng.uniform(1e3, 1e5, mesh.num_triangles)
        poisson = rng.uniform(0.2, 0.4, mesh.num_triangles)
        fixed = c[:, 0] < 1e-9
        right = c[:, 0] > 1 - 1e-9
        loads[right] = (30.0 / right.sum(), -50.0 / right.sum())
    else:
        regions = [((2.1e5, 0.3), np.where(c[:, 0] < 0.27)[0]),
                   ((6.89e4, 0.33), np.where(c[:, 0] >= 0.27)[0])]
        young, poisson = problem.element_materials(mesh.triangles, n, regions)
        assert (young == 0).sum() > 5  # the straddling cells
        fixed = c[:, 1] < 1e-9
        top = c[:, 1] > 1 - 1e-9
        loads[top] = (40.0 / top.sum(), -20.0 / top.sum())
        loads[int(np.argmax(c[:, 0] + c[:, 1] * (c[:, 0] > 0.9)))] += (0.0, -25.0)
    made = cls(coords=c, triangles=mesh.triangles, young=young, poisson=poisson,
               fixed_nodes=fixed, loads=loads, num_steps=num_steps)
    assert not made.structurally_singular()
    return made


def jax_problem(name, **kw):
    from fea_tpu.fem.problem import StaticProblem

    return make_problem(name, cls=StaticProblem, **kw)


def close(got, want, rtol):
    """Within rtol of the largest element of `want`."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= rtol * scale, float(np.abs(got - want).max()) / scale


# ------------------------------------------------------------- host copies
def test_materials_and_polygon_copies_match():
    from fea_tpu import materials as jmaterials
    from fea_tpu.geometry import polygon as jpolygon

    assert [m.as_tuple() + (m.name,) for m in materials.MATERIALS] == \
        [m.as_tuple() + (m.name,) for m in jmaterials.MATERIALS]

    rng = np.random.default_rng(3)
    pts = rng.random((40, 2))
    hull, jhull = polygon.convex_hull(pts), jpolygon.convex_hull(pts)
    np.testing.assert_array_equal(hull, jhull)
    assert polygon.polygon_area(hull) == jpolygon.polygon_area(jhull)
    rings = [polygon.convex_hull(rng.random((8, 2)) * 0.6 + off) for off in (0.0, 0.25, 0.4)]
    np.testing.assert_array_equal(polygon.union_exterior(rings), jpolygon.union_exterior(rings))
    probe = rng.random((200, 2)) * 1.2 - 0.1
    hole = (polygon.convex_hull(rng.random((6, 2))) - 0.5) * 0.2 + hull.mean(axis=0)
    ours = polygon.Polygon(exterior=hull, holes=[hole[::-1]])
    theirs = jpolygon.Polygon(exterior=hull, holes=[hole[::-1]])
    np.testing.assert_array_equal(ours.contains_points(probe), theirs.contains_points(probe))
    assert ours.contains_points(probe).any() and not ours.contains_points(probe).all()
    assert ours.contains_properly(hole) == theirs.contains_properly(hole)
    np.testing.assert_array_equal(ours.normalized().exterior, theirs.normalized().exterior)
    a, b = rng.random((2, 2)), rng.random((2, 2))
    assert polygon.segments_intersect(a[0], a[1], b[0], b[1]) == \
        jpolygon.segments_intersect(a[0], a[1], b[0], b[1])
    with pytest.raises(polygon.GeometryError):
        polygon.convex_hull(np.zeros((5, 2)))


def test_triangulate_and_mesh_io_match(tmp_path):
    """The two CDT libraries are built from the same code: coords and
    triangles equal exactly, with and without a hole; the mesh files are
    the same bytes and read back the same."""
    from fea_tpu.mesh import mesh_io as jmesh_io
    from fea_tpu.mesh import mesher as jmesher

    hole = np.array([[0.3, 0.3], [0.3, 0.6], [0.6, 0.6], [0.6, 0.3]])  # CW
    for ring, holes, size in ((SQUARE, None, 0.08), (L_SHAPE, None, 0.05), (SQUARE, [hole], 0.1)):
        ours = mesher.triangulate(ring, holes, mesh_size=size)
        theirs = jmesher.triangulate(ring, holes, mesh_size=size)
        np.testing.assert_array_equal(ours.coords, theirs.coords)
        np.testing.assert_array_equal(ours.triangles, theirs.triangles)
        assert ours.all_edges() == theirs.all_edges()
        assert ours.all_corner_ids() == theirs.all_corner_ids()
        np.testing.assert_array_equal(ours.nodes_on_edge(ours.all_edges()[1]),
                                      theirs.nodes_on_edge(theirs.all_edges()[1]))
    via_polygon = mesher.triangulate_polygon(polygon.Polygon(SQUARE, [hole]), mesh_size=0.1)
    np.testing.assert_array_equal(via_polygon.triangles, ours.triangles)
    with pytest.raises(mesher.MeshError):
        mesher.triangulate(SQUARE, mesh_size=0.01, max_nodes=100)

    u = np.random.default_rng(0).normal(size=(ours.num_nodes, 2))
    s = np.random.default_rng(1).normal(size=(ours.num_triangles, 3))
    for module, tag in ((mesh_io, "ours"), (jmesh_io, "theirs")):
        module.write_medit_mesh(str(tmp_path / f"{tag}.mesh"), ours.coords, ours.triangles)
        module.write_vtk(str(tmp_path / f"{tag}.vtk"), ours.coords, ours.triangles,
                         point_data={"u": u}, cell_data={"stress": s})
    for ext in ("mesh", "vtk"):
        assert (tmp_path / f"ours.{ext}").read_bytes() == (tmp_path / f"theirs.{ext}").read_bytes()
    coords, tris = mesh_io.read_medit_mesh(str(tmp_path / "theirs.mesh"))
    np.testing.assert_allclose(coords[:, :2], ours.coords, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tris, ours.triangles)
    got, want = mesh_io.read_vtk(str(tmp_path / "ours.vtk")), jmesh_io.read_vtk(str(tmp_path / "ours.vtk"))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_native_library_builds_or_raises(monkeypatch):
    """No second mesher and no skipped hinge check: without a compiler the
    build raises; bad input to the hinge check raises."""
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setattr(_build, "GXX_FLAGS", _build.GXX_FLAGS + ("-DUNBUILT",))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build_host_library("fea_cdt", ["cdt.cpp"])
    monkeypatch.undo()
    monkeypatch.setattr(_build, "GXX_FLAGS", ("-std=no-such-standard",))
    with pytest.raises(RuntimeError, match="failed .* building fea_cdt"):
        _build.build_host_library("fea_cdt", ["cdt.cpp"])
    monkeypatch.undo()
    assert not hasattr(mesher, "_triangulate_fallback")
    with pytest.raises(ValueError, match="rejected"):
        mesher.hinge_singular(np.array([[0, 1, 7]]), np.zeros(3, bool))
    assert mesher.hinge_singular(np.zeros((0, 3), int), np.zeros(3, bool)) is True


# ------------------------------------------------------- device functions
def both_arrays(p, np_dtype, t_dtype):
    """(torch tensors, numpy arrays) of a problem's coords, triangles,
    young, poisson, free nodes."""
    arrays = [p.coords.astype(np_dtype), p.triangles.astype(np.int32), p.young.astype(np_dtype),
              p.poisson.astype(np_dtype), (~p.fixed_nodes).astype(np_dtype)]
    return [torch.from_numpy(a) for a in arrays], arrays


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["square", "lshape"])
def test_element_and_operator_functions_match(name, dtype):
    """plane-strain D, element_stiffness, the matrix-free operator against
    the dense matrix, the diagonal and its 2x2 blocks: each against
    fea_tpu's function on the same arrays."""
    import jax.numpy as jnp

    from fea_tpu.fem import assembly as jassembly
    from fea_tpu.fem import elasticity as jelasticity
    from fea_tpu.fem import solver as jsolver

    np_dtype, t_dtype, rtol = DTYPES[dtype]
    p = make_problem(name)
    n = len(p.coords)
    (coords, tris, young, poisson, _), (jc, jt, jy, jp, _) = both_arrays(p, np_dtype, t_dtype)

    D = elasticity.plane_strain_stiffness_em(young, poisson)
    jD = jelasticity.plane_strain_stiffness_em(jnp.asarray(jy), jnp.asarray(jp))
    assert D.dtype == t_dtype and jD.dtype == np_dtype
    close(D, jD, rtol)
    Ke, B, area = elasticity.element_stiffness(coords, tris, D)
    jKe, jB, jarea = jelasticity.element_stiffness(jnp.asarray(jc), jnp.asarray(jt), jD)
    for got, want in ((Ke, jKe), (B, jB), (area, jarea)):
        assert got.dtype == t_dtype
        close(got, want, rtol)
    shared = elasticity.plane_strain_stiffness(2.0e5, 0.3).to(t_dtype)
    close(shared, jelasticity.plane_strain_stiffness(2.0e5, 0.3), rtol)
    close(elasticity.plane_stress_stiffness(young, poisson),
          jelasticity.plane_stress_stiffness(jnp.asarray(jy), jnp.asarray(jp)), rtol)
    close(elasticity.element_stiffness(coords, tris, shared)[0],
          jelasticity.element_stiffness(jnp.asarray(jc), jnp.asarray(jt), jnp.asarray(shared.numpy()))[0],
          rtol)
    host = elasticity.element_stiffness_np(p.coords, p.triangles, p.young, p.poisson)
    jhost = jelasticity.element_stiffness_np(p.coords, p.triangles, p.young, p.poisson)
    for got, want in zip(host, jhost):
        np.testing.assert_array_equal(got, want)
    if dtype == "f64":
        close(Ke.permute(2, 0, 1), host[0], 1e-12)

    inc = assembly.build_incidence(p.triangles, n)
    jinc = jassembly.build_incidence(p.triangles, n)
    np.testing.assert_array_equal(inc.slots.numpy(), np.asarray(jinc.slots))
    assert inc.slots.dtype == torch.int32 and inc.n_elements == len(p.triangles)
    dof_idx = assembly.element_dof_indices(tris, n)
    np.testing.assert_array_equal(dof_idx.numpy(), np.asarray(jassembly.element_dof_indices(jnp.asarray(jt), n)))

    u = np.random.default_rng(1).normal(size=(n, 2)).astype(np_dtype)
    y = assembly.apply_element_stiffness(Ke, tris, inc.slots, torch.from_numpy(u))
    close(y, jassembly.apply_element_stiffness(jKe, jnp.asarray(jt), jinc.slots, jnp.asarray(u)), rtol)
    K = assembly.assemble_dense(Ke, tris, n)
    close(K, jassembly.assemble_dense(jKe, jnp.asarray(jt), n), rtol)
    close(y.reshape(-1), K @ torch.from_numpy(u).reshape(-1), 10 * rtol)
    planar = assembly.apply_element_stiffness_planar(
        Ke, dof_idx, inc.slots, torch.from_numpy(u).T.reshape(-1))
    assert torch.equal(planar.reshape(2, n).T, y)
    csr = assembly.assemble_scipy_csr(host[0], p.triangles, n)
    if dtype == "f64":
        close(K, csr.toarray(), 1e-12)

    diag = solver.extract_diagonal(Ke, tris, n)
    close(diag, jsolver.extract_diagonal(jKe, jnp.asarray(jt), n), rtol)
    close(diag.reshape(-1), torch.diagonal(K), rtol)
    blocks = solver.block_diagonal(Ke, tris, n)
    jblocks = jsolver.block_diagonal(jKe, jnp.asarray(jt), n)
    assert blocks.shape == (2, 2, n)
    close(blocks, jblocks, rtol)
    close(solver.invert_blocks(blocks), jsolver.invert_blocks(jblocks), 100 * rtol)
    empty = torch.zeros(2, 2, 3, dtype=t_dtype)  # no stiffness: the identity
    assert torch.equal(solver.invert_blocks(empty), torch.eye(2, dtype=t_dtype)[:, :, None].expand(2, 2, 3))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["square", "lshape"])
def test_coarse_space_matches(name, dtype):
    """Aggregates (host), the coarse matrix, its inverse and the coarse
    apply against fea_tpu's; the member table sums what segment_sum sums."""
    import jax.numpy as jnp

    from fea_tpu.fem import coarse as jcoarse
    from fea_tpu.fem import elasticity as jelasticity

    np_dtype, t_dtype, rtol = DTYPES[dtype]
    p = make_problem(name).padded(400, 700) if name == "lshape" else make_problem(name)
    n = len(p.coords)
    n_coarse = coarse.n_coarse_for_bucket(n)
    assert n_coarse == jcoarse.n_coarse_for_bucket(n)
    assert [coarse.n_coarse_for_bucket(b) for b in (10, 4096, 10**6)] == [8, 256, 1024]
    space = coarse.build_aggregates(p.coords, n_coarse, n_real=p.n_real)
    jspace = jcoarse.build_aggregates(p.coords, n_coarse, n_real=p.n_real)
    np.testing.assert_array_equal(space.agg_ids, jspace.agg_ids)
    np.testing.assert_array_equal(space.arms, jspace.arms)
    assert space.members.shape[0] == n_coarse and space.members.shape[1] % 8 == 0
    n_real = n if p.n_real is None else p.n_real
    for a in range(n_coarse):  # each aggregate's real nodes, once, in node order
        row = space.members[a][space.members[a] < n]
        np.testing.assert_array_equal(row, np.where(space.agg_ids[:n_real] == a)[0])

    (coords, tris, young, poisson, free), (jc, jt, jy, jp, jfree) = both_arrays(p, np_dtype, t_dtype)
    Ke = elasticity.element_stiffness(coords, tris, elasticity.plane_strain_stiffness_em(young, poisson))[0]
    jKe = jelasticity.element_stiffness(
        jnp.asarray(jc), jnp.asarray(jt), jelasticity.plane_strain_stiffness_em(jnp.asarray(jy), jnp.asarray(jp)))[0]
    agg, arms = torch.from_numpy(space.agg_ids), torch.from_numpy(space.arms)
    Kc = coarse.build_coarse_matrix(Ke, tris, agg, arms, free, n_coarse)
    jKc = jcoarse.build_coarse_matrix(
        jKe, jnp.asarray(jt), jnp.asarray(space.agg_ids), jnp.asarray(space.arms), jnp.asarray(jfree), n_coarse)
    assert Kc.dtype == t_dtype and Kc.shape == (3 * n_coarse, 3 * n_coarse)
    close(Kc, jKc, rtol)
    Kc_inv = coarse.coarse_inverse(Kc)
    jKc_inv = jcoarse.coarse_inverse(jKc)
    # the inverse amplifies rounding by the condition number of Kc
    cond = float(np.linalg.cond(np.asarray(jKc, np.float64)))
    close(Kc_inv, jKc_inv, rtol * cond)
    close(Kc_inv @ Kc, np.eye(3 * n_coarse), 10 * rtol * cond)

    r = np.random.default_rng(2).normal(size=2 * n).astype(np_dtype)
    r *= np.concatenate([jfree, jfree])
    z = coarse.coarse_apply(Kc_inv, agg, arms, torch.from_numpy(space.members), torch.from_numpy(r))
    jz = jcoarse.coarse_apply(jKc_inv, jnp.asarray(space.agg_ids), jnp.asarray(space.arms), jnp.asarray(r), n_coarse)
    assert z.dtype == t_dtype
    close(z, jz, rtol * cond)
    # the same inverse on both sides: only the restriction's order differs
    close(coarse.coarse_apply(torch.from_numpy(np.array(jKc_inv)), agg, arms,
                              torch.from_numpy(space.members), torch.from_numpy(r)), jz, 100 * rtol)


def test_coarse_inverse_of_a_failed_factorization_is_zero():
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)  # indefinite
    assert torch.equal(coarse.coarse_inverse(bad), torch.zeros(2, 2, dtype=torch.float64))
    nan = torch.full((3, 3), float("nan"))
    assert torch.equal(coarse.coarse_inverse(nan), torch.zeros(3, 3))
    good = torch.tensor([[4.0, 1.0], [1.0, 3.0]], dtype=torch.float64)
    close(coarse.coarse_inverse(good), np.linalg.inv(good.numpy()), 1e-14)


# ------------------------------------------------------------------ solves
def test_solve_refuses_tf32_and_needs_a_device(monkeypatch):
    p = make_problem("square", mesh_size=0.3)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        p.solve(device="cpu")
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p.solve()
    with pytest.raises(ValueError, match="float32 or float64"):
        p.solve(device="cpu", dtype=torch.bfloat16)


@pytest.mark.parametrize("name", ["square", "lshape"])
def test_solve_f64_matches_fea_tpu(name):
    """f64: u, strain and stress within 1e-9 of the largest element, the
    same converged / failed, the iteration counts within 2."""
    import jax.numpy as jnp

    res = make_problem(name).solve(device="cpu")
    jres = jax_problem(name).solve(dtype=jnp.float64)
    assert res.displacements.dtype == torch.float64 and jres.displacements.dtype == np.float64
    assert res.displacements.shape == jres.displacements.shape
    assert torch.equal(res.displacements[0], torch.zeros_like(res.displacements[0]))
    for got, want in ((res.displacements, jres.displacements), (res.strain, jres.strain),
                      (res.stress, jres.stress)):
        close(got, want, 1e-9)
    assert bool(res.converged) == bool(jres.converged) is True
    assert bool(res.failed) == bool(jres.failed) is False
    assert res.success
    assert abs(int(res.iterations) - int(jres.iterations)) <= 2, (int(res.iterations), int(jres.iterations))
    assert float(res.residual_norm) < 1e-8
    want = direct.direct_solve(make_problem(name))
    close(res.displacements, want.displacements, 1e-8)


@pytest.mark.parametrize("name", ["square", "lshape"])
def test_solve_f32_matches_fea_tpu(name, record_property):
    """f32 (6 restarts, tol 1e-6): u within 1e-4 of the largest
    displacement of fea_tpu's f32 solve and of the f64 direct solve, and
    the same converged / failed. The square converges in both packages
    (145 iterations here, 138 in fea_tpu); the L-shaped plate, with its
    zero-stiffness cells, stalls at a residual of 4e-4 to 5e-4 in both
    (570 and 594 iterations) and is reported unconverged by both: it is
    what solve_refined is for. The iteration counts differ by rounding:
    they are recorded, and held to within a quarter of each other."""
    import jax.numpy as jnp

    res = make_problem(name).solve(device="cpu", dtype=torch.float32)
    jres = jax_problem(name).solve(dtype=jnp.float32)
    assert res.displacements.dtype == torch.float32 and jres.displacements.dtype == np.float32
    close(res.displacements, jres.displacements, 1e-4)
    close(res.displacements, direct.direct_solve(make_problem(name)).displacements, 1e-4)
    assert bool(res.converged) == bool(jres.converged) == (name == "square")
    assert not bool(res.failed) and not bool(jres.failed)
    ours, theirs = int(res.iterations), int(jres.iterations)
    record_property("iterations", (ours, theirs))
    assert abs(ours - theirs) <= 0.25 * theirs, (ours, theirs)


def test_check_every_changes_nothing():
    """Blocks of 1 and of 32 iterations between host reads: the same
    displacements, residual and iteration count, bit for bit; fewer reads."""
    p = make_problem("lshape")
    for dtype in (torch.float32, torch.float64):
        one = p.solve(device="cpu", dtype=dtype, check_every=1)
        many = p.solve(device="cpu", dtype=dtype, check_every=32)
        odd = p.solve(device="cpu", dtype=dtype, check_every=7)
        for other in (many, odd):
            assert torch.equal(one.displacements, other.displacements)
            assert torch.equal(one.stress, other.stress)
            assert torch.equal(one.residual_norm, other.residual_norm)
            assert int(one.iterations) == int(other.iterations)
        restarts = 6 if dtype == torch.float32 else 1
        assert one.host_reads >= int(one.iterations)
        assert many.host_reads <= int(many.iterations) // 32 + 2 * restarts
    # the budget ends a solve as the while_loop's k < max_iters does
    short = p.solve(device="cpu", max_iters=10, check_every=32)
    assert int(short.iterations) == 10 and not short.success


def test_ramp_factors_match_jnp_linspace():
    """The f32 ramp factors are bit-equal to fea_tpu's `jnp.linspace` with
    x64 off (its f32 solves on the chip) for 2 to 32 steps, and the f64
    ones to `jnp.linspace` in x64."""
    import jax
    import jax.numpy as jnp

    for n in range(2, 33):
        with jax.enable_x64(False):
            want32 = np.asarray(jnp.linspace(0.0, 1.0, n).astype(jnp.float32))
        got32 = problem.ramp_factors(n, torch.float32, "cpu").numpy()
        assert got32.dtype == want32.dtype == np.float32
        np.testing.assert_array_equal(got32, want32)
        want64 = np.asarray(jnp.linspace(0.0, 1.0, n, dtype=jnp.float64))
        np.testing.assert_array_equal(problem.ramp_factors(n, torch.float64, "cpu").numpy(), want64)
    p = make_problem("square", mesh_size=0.3, num_steps=11)
    res = p.solve(device="cpu", dtype=torch.float32)
    t = problem.ramp_factors(11, torch.float32, "cpu")
    assert torch.equal(res.displacements, t[:, None, None] * res.displacements[-1][None])


def test_padded_matches_unpadded():
    p = make_problem("lshape")
    n, m = len(p.coords), len(p.triangles)
    padded = p.padded(n + 40, m + 50)
    assert padded.n_real == n and padded.fixed_nodes[n:].all() and (padded.young[m:] == 0).all()
    jpadded = jax_problem("lshape").padded(n + 40, m + 50)
    np.testing.assert_array_equal(padded.coords, jpadded.coords)
    np.testing.assert_array_equal(padded.triangles, jpadded.triangles)
    a, b = p.solve(device="cpu"), padded.solve(device="cpu")
    close(b.displacements[:, :n], a.displacements.numpy(), 1e-9)
    assert torch.equal(b.displacements[:, n:], torch.zeros_like(b.displacements[:, n:]))
    close(b.stress[:, :m], a.stress.numpy(), 1e-9)
    assert b.success
    with pytest.raises(AssertionError, match="too small"):
        p.padded(n + 1, m)


def test_per_step_solves_match_the_linear_ramp():
    p = make_problem("square", mesh_size=0.15, num_steps=4)
    fast, per_step = p.solve(device="cpu"), p.solve(device="cpu", per_step_solves=True)
    assert per_step.success and per_step.displacements.shape == fast.displacements.shape
    close(per_step.displacements, fast.displacements.numpy(), 1e-8)
    assert int(per_step.iterations) > int(fast.iterations)


def test_packed_solve_unpacks_to_the_solve():
    p = make_problem("square", mesh_size=0.15, num_steps=4)
    n, m = len(p.coords), len(p.triangles)
    res = p.solve(device="cpu", dtype=torch.float32)
    packed = p.solve(device="cpu", dtype=torch.float32, packed=True)
    assert packed.dtype == torch.float32 and packed.shape == (2 * n + 6 * m + 4,)
    got = problem.unpack_solve(packed, n, m, p.num_steps)
    for field in ("displacements", "strain", "stress"):
        close(getattr(got, field), getattr(res, field).numpy(), 1e-6)
    assert bool(got.converged) and not bool(got.failed)
    assert int(got.iterations) == int(res.iterations)
    from fea_tpu.fem.problem import unpack_solve as junpack

    want = junpack(packed.numpy(), n, m, p.num_steps)
    for field in ("displacements", "strain", "stress", "residual_norm"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_solve_refined_and_direct_match_fea_tpu():
    """Both end in f64 on the host: within 1e-9 of fea_tpu's."""
    from fea_tpu.fem import direct as jdirect
    from fea_tpu.fem.problem import solve_refined as jsolve_refined

    p, jp = make_problem("lshape"), jax_problem("lshape")
    want = jdirect.direct_solve(jp)
    got = direct.direct_solve(p)
    for field in ("displacements", "strain", "stress"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    u1, finite, bounded = direct.direct_solve_u1(p)
    assert finite and bounded and u1.shape == (len(p.coords), 2)

    refined = problem.solve_refined(p, device="cpu")
    jrefined = jsolve_refined(jp)
    assert refined.success and bool(jrefined.converged)
    close(refined.displacements, jrefined.displacements, 1e-9)
    close(refined.displacements, want.displacements, 1e-8)
    close(refined.stress, want.stress, 1e-7)
    assert float(refined.residual_norm) <= 1e-9
    n, m = len(p.coords), len(p.triangles)
    bucketed = problem.solve_refined(p, pad_buckets=(n + 30, m + 30), device="cpu")
    close(bucketed.displacements, want.displacements, 1e-8)


def test_structurally_singular_cases():
    """The hinge cases of tests/test_fem.py: one pin, two pins, none; a
    bowtie's cut vertex; a free node under no stiff element."""
    from fea_tpu.fem.problem import StaticProblem as JProblem

    mesh = mesher.triangulate(SQUARE, mesh_size=0.3)
    loads = np.zeros((mesh.num_nodes, 2))

    def square(fixed_ids, cls=problem.StaticProblem, young=1000.0):
        fixed = np.zeros(mesh.num_nodes, bool)
        fixed[list(fixed_ids)] = True
        return cls(coords=mesh.coords, triangles=mesh.triangles,
                   young=np.full(mesh.num_triangles, young), poisson=np.full(mesh.num_triangles, 0.3),
                   fixed_nodes=fixed, loads=loads, num_steps=2)

    coords = np.array([[0.0, 0.0], [1.0, 0.0], [0.5, 1.0], [1.5, 2.0], [0.0, 2.0]])
    bowtie = np.array([[0, 1, 2], [2, 3, 4]])

    def wings(fixed_ids, cls=problem.StaticProblem):
        fixed = np.zeros(5, bool)
        fixed[list(fixed_ids)] = True
        return cls(coords=coords, triangles=bowtie, young=np.full(2, 1000.0),
                   poisson=np.full(2, 0.3), fixed_nodes=fixed, loads=np.zeros((5, 2)), num_steps=2)

    cases = [(square, {0}, True), (square, {0, 1}, False), (square, set(), True),
             (wings, {0, 1}, True), (wings, {0, 1, 3}, False)]
    for make, fixed_ids, singular in cases:
        assert make(fixed_ids).structurally_singular() is singular, (make.__name__, fixed_ids)
        assert make(fixed_ids, cls=JProblem).structurally_singular() is singular
    assert square({0, 1}, young=0.0).structurally_singular()  # no stiff element at all
    condition = problem.StaticProblem.from_condition(
        mesh, [((1000.0, 0.3), np.arange(mesh.num_nodes))], point_constraints=[0],
        edge_constraints=[mesh.all_edges()[3]], point_forces=[(2, (0.0, 10.0))],
        edge_forces=[(mesh.all_edges()[1], (5.0, 0.0))], num_steps=2)
    jcondition = JProblem.from_condition(
        mesh, [((1000.0, 0.3), np.arange(mesh.num_nodes))], point_constraints=[0],
        edge_constraints=[mesh.all_edges()[3]], point_forces=[(2, (0.0, 10.0))],
        edge_forces=[(mesh.all_edges()[1], (5.0, 0.0))], num_steps=2)
    for field in ("young", "poisson", "fixed_nodes", "loads"):
        np.testing.assert_array_equal(getattr(condition, field), getattr(jcondition, field))
    assert not condition.structurally_singular() and condition.loads[2, 1] == -10.0


@pytest.mark.gpu
def test_card_f32_solve_matches_direct_solve():
    """On the card: the f32 solve agrees with the host's f64 direct solve
    within 1e-3 of the largest displacement (these two plates stall at a
    residual of 1e-4 to 1e-3 in f32, on the CPU too, so `converged` is not
    asked of them) and is the same bit for bit when run again; the f64
    solve converges within 1e-8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in ("square", "lshape"):
        p = make_problem(name, mesh_size=0.03)
        want = direct.direct_solve(p).displacements
        res = p.solve(dtype=torch.float32)
        assert res.displacements.is_cuda and not bool(res.failed)
        close(res.displacements, want, 1e-3)
        again = p.solve(dtype=torch.float32, check_every=5)
        assert torch.equal(res.displacements, again.displacements)
        assert int(res.iterations) == int(again.iterations)
        f64 = p.solve()
        assert f64.success
        close(f64.displacements, want, 1e-8)
