"""The port's banded operator (fea_tpu_torch.fem.banded) and segmented PCG
(solver.pcg_solve_segmented) against fea_tpu's, on the CPU.

The same NumPy inputs go through both packages. JAX runs float32 cases
with x64 off (`jax.enable_x64(False)`, as fea_tpu runs on the chip) and
float64 cases in x64 (tests/conftest.py turns it on). Meshes come from the
CDT library on the unit square.

Tolerances: the RCM permutation, the quantized half-bandwidth and both
band index plans are equal; the band and its product within 1e-6 of the
largest element (f32), and the band product within 1e-6 of the incidence
operator's inside the port. The segmented PCG on a block-diagonal system
of 3 plates: f64 within 1e-9 of the largest element with equal iteration
counts and flags, f32 within 1e-4 with equal flags and counts within 25%;
block lengths 1, 7 and 32 bit for bit; one segment as `pcg_solve`.
"""

import numpy as np
import pytest
import torch

from fea_tpu_torch.fem import assembly, banded, elasticity, problem, solver
from fea_tpu_torch.mesh import mesher

torch.set_num_threads(1)

SQUARE = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
HOLE = np.array([[0.35, 0.35], [0.35, 0.6], [0.6, 0.6], [0.6, 0.35]])  # CW


def close(got, want, rtol):
    """Within rtol of the largest element of `want`."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, err


def permuted_plate(mesh_size=0.08, holes=None, seed=0, n_pad=None):
    """A plate in RCM order, padded with isolated nodes to `n_pad` (a
    multiple of 64), with per-element materials from a seed."""
    mesh = mesher.triangulate(SQUARE, holes, mesh_size=mesh_size)
    n = mesh.num_nodes
    perm, hb_nat = banded.rcm_permutation(mesh.triangles, n)
    inv = np.argsort(perm)
    n_pad = n_pad or ((n + 63) // 64) * 64
    coords = np.concatenate([mesh.coords[perm], np.zeros((n_pad - n, 2))])
    tris = inv[mesh.triangles].astype(np.int64)
    rng = np.random.default_rng(seed)
    young = rng.uniform(1e3, 1e5, len(tris))
    poisson = rng.uniform(0.2, 0.4, len(tris))
    return mesh, coords, tris, young, poisson, banded.quantize_hb(hb_nat), n_pad


def test_rcm_quantize_and_band_plans_match():
    from fea_tpu.fem import banded as jbanded

    assert [banded.quantize_hb(h) for h in (1, 64, 65, 200, 385)] == \
        [jbanded.quantize_hb(h) for h in (1, 64, 65, 200, 385)] == [64, 64, 128, 256, 448]
    assert banded.BAND_R == jbanded.BAND_R == 128
    for size, holes in ((0.08, None), (0.06, [HOLE])):
        mesh = mesher.triangulate(SQUARE, holes, mesh_size=size)
        perm, hb = banded.rcm_permutation(mesh.triangles, mesh.num_nodes)
        jperm, jhb = jbanded.rcm_permutation(mesh.triangles, mesh.num_nodes)
        np.testing.assert_array_equal(perm, jperm)
        assert hb == jhb

    _, coords, tris, *_, hb, n_pad = permuted_plate(holes=[HOLE])
    plan = banded.band_assembly_indices(tris, n_pad, hb)
    np.testing.assert_array_equal(plan, jbanded.band_assembly_indices(tris, n_pad, hb))
    assert plan.dtype == np.int32 and plan.shape == (36, len(tris))
    with pytest.raises(ValueError, match="too small"):
        banded.band_assembly_indices(tris, n_pad, 2)

    # the device plan: ghost triangles (past m_real) are routed to node 0,
    # and the plan of a batch of plates is each plate's own
    m = len(tris)
    ghosts = np.concatenate([tris, np.tile(tris[:1] + 5, (9, 1))])
    import jax.numpy as jnp

    want = np.asarray(jbanded.band_assembly_indices_dev(jnp.asarray(ghosts, jnp.int32), m, hb))
    got = banded.band_assembly_indices_dev(torch.from_numpy(ghosts.astype(np.int32)), m, hb)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, :m].numpy(), plan)
    both = banded.band_assembly_indices_dev(
        torch.from_numpy(np.stack([ghosts, ghosts]).astype(np.int32)), torch.tensor([m, m + 9]), hb)
    assert torch.equal(both[0], got) and torch.equal(both[1, :, :m], got[:, :m])


def test_band_and_matvec_match_fea_tpu_and_the_incidence_operator():
    import jax
    import jax.numpy as jnp

    from fea_tpu.fem import banded as jbanded
    from fea_tpu.fem import elasticity as jelasticity

    _, coords, tris, young, poisson, hb, n_pad = permuted_plate(holes=[HOLE])
    f32 = np.float32
    tri_t = torch.from_numpy(tris.astype(np.int32))
    D = elasticity.plane_strain_stiffness_em(torch.from_numpy(young.astype(f32)),
                                             torch.from_numpy(poisson.astype(f32)))
    Ke = elasticity.element_stiffness(torch.from_numpy(coords.astype(f32)), tri_t, D)[0]
    plan = torch.from_numpy(banded.band_assembly_indices(tris, n_pad, hb))
    S = banded.assemble_band(Ke, plan, 2 * n_pad, hb)
    win = banded.window_index(2 * n_pad, hb)
    x = np.random.default_rng(1).normal(size=(2, 2 * n_pad)).astype(f32)
    y = banded.banded_matvec(S, torch.from_numpy(x), win, hb)  # two lanes at once
    assert S.shape == (2 * n_pad // 128, 128, 2 * hb + 128) and y.dtype == torch.float32
    with jax.enable_x64(False):
        jKe = jelasticity.element_stiffness(
            jnp.asarray(coords, jnp.float32), jnp.asarray(tris, jnp.int32),
            jelasticity.plane_strain_stiffness_em(jnp.asarray(young, jnp.float32),
                                                  jnp.asarray(poisson, jnp.float32)))[0]
        jS = jbanded.assemble_band(jKe, jnp.asarray(plan.numpy()), 2 * n_pad, hb)
        jwin = jbanded.window_index(2 * n_pad, hb)
        jy = [np.asarray(jbanded.banded_matvec(jS, jnp.asarray(x[c]), jwin, hb)) for c in range(2)]
    close(Ke, jKe, 1e-6)
    close(S, jS, 1e-6)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    close(y, np.stack(jy), 1e-6)

    # the band product is K u: the incidence operator's, in planar order
    n = n_pad
    inc = assembly.build_incidence(tris, n)
    dof_idx = assembly.element_dof_indices(tri_t, n)
    planar = banded.interleaved_to_planar(torch.from_numpy(x), n)
    assert torch.equal(banded.planar_to_interleaved(planar, n), torch.from_numpy(x))
    np.testing.assert_array_equal(
        planar.numpy(), np.stack([np.asarray(jbanded.interleaved_to_planar(jnp.asarray(v), n)) for v in x]))
    ref = assembly.apply_element_stiffness_planar(Ke, dof_idx, inc.slots, planar)
    close(banded.interleaved_to_planar(y, n), ref.numpy(), 1e-6)
    # lanes with their own stiffness: each lane's band is its own Ke's
    S2 = banded.assemble_band(torch.stack([Ke, 2 * Ke]), plan, 2 * n_pad, hb)
    assert torch.equal(S2[0], S) and torch.equal(S2[1], banded.assemble_band(2 * Ke, plan, 2 * n_pad, hb))


def block_system(np_dtype, n_plates=3):
    """Three plates (mesh 0.14 / 0.145 / 0.15, clamped on the left, loaded
    on the right) padded to one node and triangle count and stacked into a
    block-diagonal planar system: the arrays both packages take."""
    plates = []
    for i, size in enumerate((0.14, 0.145, 0.15)[:n_plates]):
        mesh = mesher.triangulate(SQUARE, mesh_size=size)
        c = mesh.coords
        rng = np.random.default_rng(i)
        loads = np.zeros((mesh.num_nodes, 2))
        right = c[:, 0] > 1 - 1e-9
        loads[right] = (30.0 / right.sum(), -50.0 / right.sum())
        plates.append(problem.StaticProblem(
            coords=c, triangles=mesh.triangles,
            young=rng.uniform(1e3, 1e5, mesh.num_triangles),
            poisson=rng.uniform(0.2, 0.4, mesh.num_triangles),
            fixed_nodes=c[:, 0] < 1e-9, loads=loads, num_steps=2))
    nb = max(len(p.coords) for p in plates) + 3
    mb = max(len(p.triangles) for p in plates)
    plates = [p.padded(nb, mb) for p in plates]
    P = len(plates)
    coords = np.concatenate([p.coords for p in plates]).astype(np_dtype)
    tris = np.concatenate([p.triangles + i * nb for i, p in enumerate(plates)]).astype(np.int32)
    young = np.concatenate([p.young for p in plates]).astype(np_dtype)
    poisson = np.concatenate([p.poisson for p in plates]).astype(np_dtype)
    free = np.concatenate([~p.fixed_nodes for p in plates]).astype(np_dtype)
    loads = np.concatenate([p.loads for p in plates]).astype(np_dtype)
    return P, P * nb, coords, tris, young, poisson, free, loads


def port_system(np_dtype, lanes=1):
    """The port's operator and arrays for `block_system`, with `lanes`
    copies of the right-hand side (lane c loaded (c + 1) times)."""
    P, n, coords, tris, young, poisson, free, loads = block_system(np_dtype)
    t = torch.from_numpy
    D = elasticity.plane_strain_stiffness_em(t(young), t(poisson))
    Ke = elasticity.element_stiffness(t(coords), t(tris), D)[0]
    inc = assembly.build_incidence(tris, n)
    dof_idx = assembly.element_dof_indices(t(tris), n)

    def op(u):
        return assembly.apply_element_stiffness_planar(Ke, dof_idx, inc.slots, u)

    diag = solver.extract_diagonal(Ke, t(tris), n).T.reshape(-1)
    b = t(loads).T.reshape(-1)
    free2 = t(np.concatenate([free, free]))
    if lanes > 1:
        b = torch.stack([(c + 1) * b for c in range(lanes)])
    return P, op, b, diag, free2


def jax_segmented(np_dtype, **kw):
    import jax.numpy as jnp

    from fea_tpu.fem import assembly as jassembly
    from fea_tpu.fem import elasticity as jelasticity
    from fea_tpu.fem import solver as jsolver

    P, n, coords, tris, young, poisson, free, loads = block_system(np_dtype)
    D = jelasticity.plane_strain_stiffness_em(jnp.asarray(young), jnp.asarray(poisson))
    Ke = jelasticity.element_stiffness(jnp.asarray(coords), jnp.asarray(tris), D)[0]
    inc = jassembly.build_incidence(tris, n)
    dof_idx = jassembly.element_dof_indices(jnp.asarray(tris), n)

    def op(u):
        return jassembly.apply_element_stiffness_planar(Ke, dof_idx, inc.slots, u)

    diag = jsolver.extract_diagonal(Ke, jnp.asarray(tris), n).T.reshape(-1)
    res = jsolver.pcg_solve_segmented(
        op, jnp.asarray(loads).T.reshape(-1), diag, jnp.asarray(np.concatenate([free, free])),
        n_seg=P, **kw)
    return {k: np.asarray(getattr(res, k)) for k in
            ("x", "residual_norm", "iterations", "converged", "failed")}


SEGMENTED = {
    "f64": (np.float64, dict(tol=1e-10, max_iters=3000, restarts=1), 1e-9),
    "f32": (np.float32, dict(tol=1e-5, max_iters=3000, restarts=3), 1e-4),
}


@pytest.mark.parametrize("dtype", SEGMENTED)
def test_segmented_pcg_matches_fea_tpu(dtype, record_property):
    """Per plate: x, residual, flags and iterations against fea_tpu's
    `pcg_solve_segmented`, and two lanes at once as two solves."""
    import jax

    np_dtype, kw, rtol = SEGMENTED[dtype]
    P, op, b, diag, free = port_system(np_dtype, lanes=2)
    res = solver.pcg_solve_segmented(op, b, diag, free, n_seg=P, **kw)
    if dtype == "f32":
        with jax.enable_x64(False):
            want = jax_segmented(np_dtype, **kw)
    else:
        want = jax_segmented(np_dtype, **kw)
    assert res.x.shape == b.shape and res.iterations.shape == (2, P)
    assert res.x.dtype == b.dtype
    close(res.x[0], want["x"], rtol)
    np.testing.assert_array_equal(res.converged[0].numpy(), want["converged"])
    np.testing.assert_array_equal(res.failed[0].numpy(), want["failed"])
    assert res.converged.all() and not res.failed.any()
    ours, theirs = res.iterations[0].numpy(), want["iterations"]
    record_property("iterations", (ours.tolist(), theirs.tolist()))
    if dtype == "f64":
        np.testing.assert_array_equal(ours, theirs)
    else:
        assert (np.abs(ours - theirs) <= 0.25 * theirs).all(), (ours, theirs)
    # the true residuals: both under the acceptance bar (100 tol), within
    # a factor of 10 of each other (they are rounding-sized)
    got_r, want_r = res.residual_norm[0].numpy(), want["residual_norm"]
    assert (got_r <= 100 * kw["tol"]).all() and (want_r <= 100 * kw["tol"]).all()
    assert (np.abs(np.log10(got_r / want_r)) <= 1).all(), (got_r, want_r)
    # lane 1 is lane 0 loaded twice: the same iterations, twice the x
    single = solver.pcg_solve_segmented(op, b[1], diag, free, n_seg=P, **kw)
    close(res.x[1], single.x.numpy(), rtol)
    if dtype == "f64":
        assert torch.equal(res.iterations[1], single.iterations)
        close(res.x[1], 2 * res.x[0].numpy(), 1e-9)


def test_segmented_block_lengths_change_nothing():
    """Blocks of 1, 7 and 32 bodies between host reads: the same x,
    residuals, iterations and flags bit for bit (the loop's own condition
    masks every leaf of a lane that has stopped), in f32 and f64, and a
    budget that ends the loop as the while_loop's k < max_iters does."""
    for np_dtype, kw in ((np.float32, SEGMENTED["f32"][1]), (np.float64, SEGMENTED["f64"][1])):
        P, op, b, diag, free = port_system(np_dtype, lanes=2)
        runs = [solver.pcg_solve_segmented(op, b, diag, free, n_seg=P, check_every=n, **kw)
                for n in (1, 7, 32)]
        for other in runs[1:]:
            for field in ("x", "residual_norm", "iterations", "converged", "failed"):
                assert torch.equal(getattr(runs[0], field), getattr(other, field)), field
        assert runs[2].host_reads < runs[0].host_reads
    short = solver.pcg_solve_segmented(op, b, diag, free, n_seg=P, tol=1e-10, max_iters=10,
                                       check_every=32)
    assert (short.iterations == 10).all() and not short.converged.any()


def test_one_segment_is_pcg_solve():
    """P = 1: the port's `pcg_solve` on the same system (f64: the same
    iterations, x within 1e-9; f32 within 1e-4)."""
    mesh = mesher.triangulate(SQUARE, mesh_size=0.1)
    c = mesh.coords
    loads = np.zeros((mesh.num_nodes, 2))
    loads[c[:, 0] > 1 - 1e-9] = (1.0, -2.0)
    for np_dtype, tol, rtol in ((np.float64, 1e-10, 1e-9), (np.float32, 1e-5, 1e-4)):
        t = torch.from_numpy
        n = mesh.num_nodes
        D = elasticity.plane_strain_stiffness_em(t(np.full(mesh.num_triangles, 5e4, np_dtype)),
                                                 t(np.full(mesh.num_triangles, 0.3, np_dtype)))
        tris = t(mesh.triangles.astype(np.int32))
        Ke = elasticity.element_stiffness(t(c.astype(np_dtype)), tris, D)[0]
        inc = assembly.build_incidence(mesh.triangles, n)
        dof_idx = assembly.element_dof_indices(tris, n)

        def op(u):
            return assembly.apply_element_stiffness_planar(Ke, dof_idx, inc.slots, u)

        diag = solver.extract_diagonal(Ke, tris, n).T.reshape(-1)
        free = t(np.tile(c[:, 0] > 1e-9, 2).astype(np_dtype))
        b = t(loads.astype(np_dtype)).T.reshape(-1)
        one = solver.pcg_solve(op, b, diag, free, tol=tol, max_iters=2000)
        seg = solver.pcg_solve_segmented(op, b, diag, free, n_seg=1, tol=tol, max_iters=2000)
        close(seg.x, one.x.numpy(), rtol)
        assert bool(seg.converged[0]) == bool(one.converged) is True
        if np_dtype == np.float64:
            assert int(seg.iterations[0]) == int(one.iterations)
