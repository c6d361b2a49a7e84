"""The port's flat plate-group solve (fea_tpu_torch.fem.flatgroup and the
chunk dispatch of datagen.batched) against fea_tpu's, on the CPU.

The payload is `tests/test_datagen.py:468`'s: three unit-square plates at
mesh 0.14 / 0.145 / 0.15 in one bucket, 2 seeded non-singular conditions
each. Both packages build their `PlateSolver`s from the same meshes and
problems. JAX runs float32 with x64 off (`jax.enable_x64(False)`), as
fea_tpu runs on the chip, and float64 in x64 (tests/conftest.py).

Tolerances: the flat tables equal; the flat coarse matrix within 1e-6 of
its largest element and the coarse apply within 1e-6 (f32, the same Kc^-1
on both sides); the packed (P, C, K) rows of the chunk against fea_tpu's
`solve_flat_group_kernel`, for the band and the incidence operator: u
within 1e-4 of the lane's largest displacement, strain within 1e-3, the
same converged / failed flags, and iterations within 25% — per lane in
f64 (equal there), over the chunk in f32. An f32 lane that ends near the
f32 floor moves by up to 80% when its loads change by 1e-6 relative, in
the port and in fea_tpu alike (measured on this payload: 68 to 122
iterations), so its own count is no fixed target; the chunk's total is.
Inside the port every lane matches `StaticProblem.solve` within 1e-3 of
its largest displacement. The member table of the coarse restriction is
as wide as the fullest aggregate's real nodes, not its ghosts.
"""

import numpy as np
import pytest
import torch

from fea_tpu_torch.datagen import batched
from fea_tpu_torch.datagen.conditions import ConditionSampler
from fea_tpu_torch.fem import coarse, flatgroup, problem
from fea_tpu_torch.mesh import mesher

torch.set_num_threads(1)

SQUARE = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])


def payload_problems():
    """[(mesh, [problem, problem])] of the three plates, 2 non-singular
    conditions each from ConditionSampler(seed 7)."""
    sampler = ConditionSampler(random_seed=7)
    out = []
    for size in (0.14, 0.145, 0.15):
        mesh = mesher.triangulate(SQUARE, mesh_size=size)
        problems = []
        for _ in range(60):
            c = sampler.sample_one(mesh)
            p = problem.StaticProblem.from_condition(
                mesh, c["material_regions"], c["point_constraints"], c["edge_constraints"],
                c["point_forces"], c["edge_forces"], num_steps=2)
            if not p.structurally_singular():
                problems.append(p)
            if len(problems) == 2:
                break
        out.append((mesh, problems))
    return out


def as_jax_problem(p):
    from fea_tpu.fem.problem import StaticProblem

    return StaticProblem(coords=p.coords, triangles=p.triangles, young=p.young, poisson=p.poisson,
                         fixed_nodes=p.fixed_nodes, loads=p.loads, num_steps=p.num_steps)


def port_payloads(plates, **kw):
    return [(batched.PlateSolver(mesh, 2, device="cpu", **kw), problems) for mesh, problems in plates]


def jax_payloads(plates, **kw):
    from fea_tpu.datagen.batched import PlateSolver

    return [(PlateSolver(mesh, 2, **kw), [as_jax_problem(p) for p in problems])
            for mesh, problems in plates]


@pytest.fixture(scope="module")
def plates():
    return payload_problems()


def test_flatten_tables_and_member_table(plates):
    """The flat tables equal fea_tpu's (the same solver tables into both
    functions); the flat member table holds each aggregate's real nodes."""
    import jax.numpy as jnp

    from fea_tpu.fem import flatgroup as jflatgroup

    payloads = port_payloads(plates)
    solvers, host, _, _ = batched.chunk_inputs(payloads)
    tables, _ = batched.chunk_tables(solvers, host, None, torch.device("cpu"))
    nc = solvers[0].n_coarse
    got = flatgroup.flatten_tables(*tables[:5], nc)
    want = jflatgroup.flatten_tables(*(jnp.asarray(t.numpy()) for t in tables[:5]), nc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    P, Nb = tables[0].shape[:2]
    members = flatgroup.flatten_members(tables[5], Nb)
    agg = got[3].numpy()
    for a in range(P * nc):
        row = members[a][members[a] < P * Nb].numpy()
        real = np.where(agg == a)[0]
        real = real[(real % Nb) < solvers[real[0] // Nb].n] if len(real) else real
        np.testing.assert_array_equal(row, real)


def test_member_table_is_bounded_by_the_real_nodes():
    """A small plate in a large bucket: every ghost sits in the outlier
    aggregate, and a table that held them would be as wide as the ghosts
    are many; the table holds the real nodes only, so its width is set by
    the fullest real aggregate, and the coarse apply is unchanged (the
    residual is zero at the Dirichlet-fixed ghosts)."""
    from fea_tpu.fem import coarse as jcoarse

    mesh = mesher.triangulate(SQUARE, mesh_size=0.1)
    solver = batched.PlateSolver(mesh, 2, node_bucket=2048, device="cpu")
    n, nb = solver.n, solver.node_bucket
    space = coarse.build_aggregates(solver.coords_dev.numpy(), solver.n_coarse, n_real=n)
    counts = np.bincount(space.agg_ids[:n], minlength=solver.n_coarse)
    assert solver.members.shape[1] == ((counts.max() + 7) // 8) * 8 < 64
    full = coarse.aggregate_members(space.agg_ids, solver.n_coarse)  # ghosts included
    assert full.shape[1] >= nb - n - 8 > 1000
    assert (solver.members[solver.members < nb] < n).all()
    np.testing.assert_array_equal(np.sort(solver.members[solver.members < nb]), np.arange(n))
    jspace = jcoarse.build_aggregates(solver.coords_dev.numpy(), solver.n_coarse, n_real=n)
    np.testing.assert_array_equal(space.agg_ids, jspace.agg_ids)

    rng = np.random.default_rng(0)
    r = rng.normal(size=2 * nb).astype(np.float32)
    r[np.concatenate([np.arange(n, nb), nb + np.arange(n, nb)])] = 0.0
    Kc_inv = torch.from_numpy(rng.normal(size=(3 * solver.n_coarse,) * 2).astype(np.float32))
    agg, arms = solver.agg_dev, solver.arms_dev
    z_real = coarse.coarse_apply(Kc_inv, agg, arms, solver.members_dev, torch.from_numpy(r))
    z_full = coarse.coarse_apply(Kc_inv, agg, arms, torch.from_numpy(full), torch.from_numpy(r))
    assert torch.equal(z_real, z_full)


def test_coarse_matrix_and_apply_flat_match(plates):
    """build_coarse_matrix_flat and coarse_apply_flat against fea_tpu's,
    f32, on two lanes of the payload's first conditions."""
    import jax
    import jax.numpy as jnp

    from fea_tpu.fem import elasticity as jelasticity
    from fea_tpu.fem import flatgroup as jflatgroup

    payloads = port_payloads(plates)
    solvers, host, m_real, band_hb = batched.chunk_inputs(payloads)
    tables, _ = batched.chunk_tables(solvers, host, m_real, torch.device("cpu"))
    P, Nb = tables[0].shape[:2]
    nc = solvers[0].n_coarse
    coords, tris, _, agg, arms = flatgroup.flatten_tables(*tables[:5], nc)
    members = flatgroup.flatten_members(tables[5], Nb)
    young = tables[6].transpose(0, 1).reshape(2, -1)
    poisson = tables[7].transpose(0, 1).reshape(2, -1)
    free = tables[8].transpose(0, 1).reshape(2, -1)
    from fea_tpu_torch.fem import elasticity

    D = elasticity.plane_strain_stiffness_em(young, poisson)
    Ke = torch.stack([elasticity.element_stiffness(coords, tris, D[:, :, c])[0] for c in range(2)])
    Kc = flatgroup.build_coarse_matrix_flat(Ke, tris, agg, arms, free, P, nc)
    assert Kc.shape == (2, P, 3 * nc, 3 * nc) and Kc.dtype == torch.float32
    r = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 2 * P * Nb)).astype(np.float32))
    r = r * torch.cat([free, free], dim=-1)
    Kc_inv = coarse.coarse_inverse(Kc)
    z = flatgroup.coarse_apply_flat(Kc_inv, agg, arms, members, r, P, nc)
    with jax.enable_x64(False):
        j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
        for c in range(2):
            jD = jelasticity.plane_strain_stiffness_em(j(young[c]), j(poisson[c]))
            jKe = jelasticity.element_stiffness(j(coords), j(tris), jD)[0]
            jKc = jflatgroup.build_coarse_matrix_flat(jKe, j(tris), j(agg), j(arms), j(free[c]), P, nc)
            scale = np.abs(np.asarray(jKc)).max()
            assert np.abs(Kc[c].numpy() - np.asarray(jKc)).max() <= 1e-6 * scale
            jz = jflatgroup.coarse_apply_flat(j(Kc_inv[c]), j(agg), j(arms), j(r[c]), P, nc)
            jz = np.asarray(jz)
            assert np.abs(z[c].numpy() - jz).max() <= 1e-6 * np.abs(jz).max()


def packed_rows(payloads):
    return batched.dispatch_plate_group(payloads).result().numpy()


def jax_rows(payloads, monkeypatch, banded_env):
    from fea_tpu.datagen.batched import dispatch_plate_group

    monkeypatch.setenv("FEA_TPU_BANDED", banded_env)
    return np.asarray(dispatch_plate_group(payloads))


CHUNKS = {"band": (True, "1", torch.float32), "incidence": (False, "0", torch.float32),
          "incidence_f64": (False, "0", torch.float64)}


@pytest.mark.parametrize("case", CHUNKS)
def test_flat_chunk_matches_solve_flat_group_kernel(case, plates, monkeypatch, record_property):
    import jax
    import jax.numpy as jnp

    use_band, env, dtype = CHUNKS[case]
    monkeypatch.setenv("FEA_TPU_BANDED", env)
    ours = port_payloads(plates, banded=use_band, dtype=dtype)
    if dtype == torch.float32:
        with jax.enable_x64(False):
            theirs = jax_payloads(plates)
            want = jax_rows(theirs, monkeypatch, env)
    else:
        theirs = jax_payloads(plates, dtype=jnp.float64)
        want = jax_rows(theirs, monkeypatch, env)
    assert [s.shape_key for s, _ in ours] == [s.shape_key for s, _ in theirs]
    assert (ours[0][0].band_hb > 0) == use_band
    got = packed_rows(ours)
    assert got.shape == want.shape and got.dtype == np.float32
    s0 = ours[0][0]
    nb2, mb3 = 2 * s0.node_bucket, 3 * s0.tri_bucket
    u, ju = got[..., :nb2], want[..., :nb2]
    eps, jeps = got[..., nb2:nb2 + mb3], want[..., nb2:nb2 + mb3]
    tail, jtail = got[..., -4:], want[..., -4:]
    np.testing.assert_array_equal(tail[..., :2], jtail[..., :2])  # converged, failed
    assert tail[..., 0].all() and not tail[..., 1].any()
    rtol_u, rtol_e = (1e-9, 1e-8) if dtype == torch.float64 else (1e-4, 1e-3)
    for p in range(u.shape[0]):
        for c in range(u.shape[1]):
            scale = max(np.abs(ju[p, c]).max(), 1e-30)
            assert np.abs(u[p, c] - ju[p, c]).max() <= rtol_u * scale
            escale = max(np.abs(jeps[p, c]).max(), 1e-30)
            assert np.abs(eps[p, c] - jeps[p, c]).max() <= rtol_e * escale
    iters, jiters = tail[..., 3], jtail[..., 3]
    record_property("iterations", (iters.tolist(), jiters.tolist()))
    if dtype == torch.float64:
        np.testing.assert_array_equal(iters, jiters)
    else:
        assert abs(iters.sum() - jiters.sum()) <= 0.25 * jiters.sum(), (iters, jiters)

    # inside the port: the unpacked lanes against each plate's own solve
    for (solver, problems), results in zip(ours, batched.unpack_plate_group(got, ours)):
        for p, res in zip(problems, results):
            want_u = p.solve(device="cpu", dtype=dtype).displacements.numpy()
            assert res.success and res.displacements.shape == want_u.shape
            scale = max(np.abs(want_u).max(), 1e-30)
            assert np.abs(res.displacements - want_u).max() <= 1e-3 * scale


def test_chunk_repeats_and_dispatch_contract(plates):
    """The same chunk twice: the same rows bit for bit; a chunk padded to
    4 plates gives the 3 plates' rows; warm starts at the solution take
    under half the iterations; a mixed-band group falls back to the
    incidence operator."""
    payloads = port_payloads(plates)
    first = packed_rows(payloads)
    assert np.array_equal(first, packed_rows(payloads))
    padded = batched.dispatch_plate_group(payloads, pad_group_to=4).result().numpy()
    assert padded.shape[0] == 4 and np.array_equal(padded[:3], first)
    results = batched.fetch_plate_group(batched.dispatch_plate_group(payloads), payloads)
    warm = [[r.displacements[-1] for r in plate] for plate in results]
    again = batched.solve_plate_group(payloads, x0s=warm)
    cold_iters = sum(int(r.iterations) for plate in results for r in plate)
    assert sum(int(r.iterations) for plate in again for r in plate) < cold_iters / 2
    for plate, before in zip(again, results):
        for r, b in zip(plate, before):
            assert r.success
            assert np.abs(r.displacements - b.displacements).max() <= 1e-4 * np.abs(b.displacements).max()
    mixed = port_payloads(plates[:1], band_hb=-1) + payloads[1:]
    assert batched.chunk_inputs(mixed)[3] == 0
    info = {}
    batched.dispatch_plate_group(payloads, info=info).result()
    assert info["host_reads"] >= 2 and info["loop_s"] > 0 and info["setup_s"] > 0


@pytest.mark.gpu
def test_card_chunk_matches_the_cpu(plates):
    """On the card: the chunk's rows against the CPU's (u within 1e-4 of
    the largest displacement, the same flags), and bit for bit when solved
    again."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for use_band in (True, False):
        cpu = packed_rows(port_payloads(plates, banded=use_band))
        card_payloads = [(batched.PlateSolver(mesh, 2, banded=use_band), problems)
                         for mesh, problems in plates]
        card = batched.dispatch_plate_group(card_payloads).result()
        assert card.is_cuda
        again = batched.dispatch_plate_group(card_payloads).result()
        assert torch.equal(card, again)
        card = card.cpu().numpy()
        nb2 = 2 * card_payloads[0][0].node_bucket
        np.testing.assert_array_equal(card[..., -4:-2], cpu[..., -4:-2])
        assert np.abs(card[..., :nb2] - cpu[..., :nb2]).max() <= 1e-4 * np.abs(cpu[..., :nb2]).max()
