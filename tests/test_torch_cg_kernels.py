"""The segmented PCG loop body and the chunk's default preconditioner of
`fea_tpu_torch.ops.cg` (hand-written CUDA kernels, `csrc/cg_segmented.cu`,
and their plain versions) against fea_tpu, on the CPU; the kernels against
the plain versions on the card.

On the CPU the loop runs the plain versions:
- `pcg_solve_segmented` after 1, 2 and 5 iterations against fea_tpu's on
  the 3-plate block system of tests/test_torch_banded.py (f64 in x64: x
  within 1e-10 of its largest element, the true residual within 1e-8 of
  itself; f32 with x64 off: 1e-5 and 1e-4; iteration counts equal);
- the chunk's preconditioner against fea_tpu's pieces (`block_diagonal`,
  `invert_blocks`, `coarse_apply_flat`, the free mask) within 1e-6 of the
  largest element of z, f32, on the 3-plate payload of
  tests/test_torch_flatgroup.py;
- the chunk solved in blocks of 1, 8 and 32 bodies: the same rows bit for
  bit; a lane that has stopped keeps every leaf.

The tests marked `gpu` skip without a CUDA device. JAX is imported inside
the CPU tests only, so on the card (which has no JAX) they run with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cg_kernels.py

They hold each kernel against its plain version on the same CUDA tensors,
at a ragged shape and at the production chunk's (4 lanes, 4 plates of
8192 nodes), f32 and f64: the elementwise outputs bit for bit (the kernels
round each product and sum as the torch ops do), what comes of a dot
product within 1e-5 of its span (f32; 1e-12 in f64), the flags and
counters equal. A lane that has stopped keeps every leaf; the chunk's
rows through the CUDA graph equal the kernels' run without a graph bit for
bit, with the same launch counts, and repeat bit for bit; the wrappers
raise on CPU or bf16 tensors given with CUDA ones.
"""

import numpy as np
import pytest
import torch

import test_torch_banded as tb
import test_torch_flatgroup as tf
from fea_tpu_torch.datagen import batched
from fea_tpu_torch.fem import coarse, elasticity, flatgroup, solver
from fea_tpu_torch.ops import cg

torch.set_num_threads(1)


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# ---- the CPU: the plain route against fea_tpu ---------------------------

FEW = {"f64": (np.float64, 1e-10, 1e-8, 1e-10), "f32": (np.float32, 1e-5, 1e-4, 1e-5)}


@pytest.mark.parametrize("iters", [1, 2, 5])
@pytest.mark.parametrize("dtype", FEW)
def test_plain_route_matches_fea_tpu_after_few_iterations(dtype, iters):
    import jax

    np_dtype, x_rtol, r_rtol, tol = FEW[dtype]
    kw = dict(tol=tol, max_iters=iters, restarts=1)
    P, op, b, diag, free = tb.port_system(np_dtype, lanes=2)
    res = solver.pcg_solve_segmented(op, b, diag, free, n_seg=P, **kw)
    if dtype == "f32":
        with jax.enable_x64(False):
            want = tb.jax_segmented(np_dtype, **kw)
    else:
        want = tb.jax_segmented(np_dtype, **kw)
    np.testing.assert_array_equal(res.iterations[0].numpy(), want["iterations"])
    assert (want["iterations"] == iters).all()
    tb.close(res.x[0], want["x"], x_rtol)
    got_r, want_r = res.residual_norm[0].numpy(), want["residual_norm"]
    assert (np.abs(got_r - want_r) <= r_rtol * want_r).all(), (got_r, want_r)


def chunk_pieces(plates):
    """The payload's chunk tables on the CPU, its element stiffness per lane
    (C, 6, 6, PM), free mask and the coarse inverse, as
    tests/test_torch_flatgroup.py builds them."""
    payloads = tf.port_payloads(plates)
    solvers, host, m_real, _ = batched.chunk_inputs(payloads)
    tables, _ = batched.chunk_tables(solvers, host, m_real, torch.device("cpu"))
    P, Nb = tables[0].shape[:2]
    C = tables[6].shape[1]
    nc = solvers[0].n_coarse
    coords, tris, _, agg, arms = flatgroup.flatten_tables(*tables[:5], nc)
    members = flatgroup.flatten_members(tables[5], Nb)
    young = tables[6].transpose(0, 1).reshape(C, -1)
    poisson = tables[7].transpose(0, 1).reshape(C, -1)
    free = tables[8].transpose(0, 1).reshape(C, -1)
    D = elasticity.plane_strain_stiffness_em(young, poisson)
    Ke = torch.stack([elasticity.element_stiffness(coords, tris, D[:, :, c])[0] for c in range(C)])
    Kc_inv = coarse.coarse_inverse(flatgroup.build_coarse_matrix_flat(Ke, tris, agg, arms, free, P, nc))
    return dict(P=P, PN=P * Nb, nc=nc, tris=tris, agg=agg, arms=arms, members=members, Ke=Ke,
                free=torch.cat([free, free], dim=-1), Kc_inv=Kc_inv)


def test_plain_preconditioner_matches_fea_tpu_pieces(plates):
    import jax
    import jax.numpy as jnp

    from fea_tpu.fem import flatgroup as jflatgroup
    from fea_tpu.fem import solver as jsolver

    c = chunk_pieces(plates)
    P, PN, nc = c["P"], c["PN"], c["nc"]
    block_inv = solver.invert_blocks(solver.block_diagonal(c["Ke"], c["tris"], PN))
    pre = flatgroup.ChunkPreconditioner(c["free"], P, block_inv=block_inv, Kc_inv=c["Kc_inv"],
                                        agg_ids=c["agg"], arms=c["arms"], members=c["members"],
                                        n_coarse=nc)
    C = c["free"].shape[0]
    r = torch.from_numpy(np.random.default_rng(5).normal(size=(C, 2 * PN)).astype(np.float32))
    z = pre(r)
    zj, zc = pre.parts(r)
    assert zc.shape == (C, P, 3 * nc)
    with jax.enable_x64(False):
        j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
        for lane in range(C):
            jinv = jsolver.invert_blocks(jsolver.block_diagonal(j(c["Ke"][lane]), j(c["tris"]), PN))
            jz = jnp.einsum("ijn,jn->in", jinv, j(r[lane]).reshape(2, PN),
                            precision=jax.lax.Precision.HIGHEST).reshape(-1)
            jz = jz + jflatgroup.coarse_apply_flat(j(c["Kc_inv"][lane]), j(c["agg"]), j(c["arms"]),
                                                   j(r[lane]), P, nc)
            want = np.asarray(jz * j(c["free"][lane]))
            assert np.abs(z[lane].numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.fixture(scope="module")
def plates():
    return tf.payload_problems()


@pytest.mark.parametrize("banded", [True, False], ids=["band", "incidence"])
def test_block_lengths_change_nothing_on_the_chunk(plates, banded):
    """The chunk in blocks of 1, 8 and 32 bodies between host reads: the
    same packed rows bit for bit, fewer host reads in longer blocks."""
    payloads = tf.port_payloads(plates, banded=banded)
    rows, reads = [], []
    for n in (1, 8, 32):
        info = {}
        rows.append(batched.dispatch_plate_group(payloads, check_every=n, info=info).result())
        reads.append(info["host_reads"])
    assert torch.equal(rows[0], rows[1]) and torch.equal(rows[0], rows[2])
    assert reads[0] > reads[1] > reads[2]


# ---- states for the launches --------------------------------------------


def random_state(device, dtype, L, P, Ns, seed, max_iters=40):
    """A state whose lanes and segments mix every case of the loop's
    condition: running, converged (r2 under atol2), stalled, inactive, a
    lane at its budget; p.Ap and r.z well away from 0."""
    rng = np.random.default_rng(seed)
    st = cg.SegmentedState(L, P, Ns, dtype, device, max_iters, 180)

    def put(t, a):
        t.copy_(torch.from_numpy(np.asarray(a)).to(t.dtype))

    ndof = 2 * P * Ns
    for name in ("x", "r", "p", "z"):
        put(getattr(st, name), rng.normal(size=(L, ndof)))
    r2 = rng.uniform(1.0, 10.0, (L, P))
    put(st.r2, r2)
    put(st.rz, rng.uniform(0.5, 5.0, (L, P)))
    put(st.best, r2 * rng.choice([0.5, 2.0], (L, P)))
    put(st.atol2, r2 * rng.choice([0.1, 10.0], (L, P), p=[0.8, 0.2]))
    put(st.stall, rng.choice([0, 5, 179, 180], (L, P), p=[0.4, 0.3, 0.2, 0.1]))
    put(st.active, rng.uniform(size=(L, P)) < 0.9)
    k = rng.integers(0, max_iters, L)
    k[0] = max_iters
    put(st.k, k)
    put(st.run, rng.uniform(size=(L, P)) < 0.7)
    put(st.lane, rng.uniform(size=L) < 0.8)
    put(st.alpha, rng.uniform(-1.0, 1.0, (L, P)))
    put(st.beta, rng.uniform(0.0, 1.5, (L, P)))
    return st


def coarse_tables(device, dtype, L, PN, NA, W, seed):
    """Random block inverses, arms, a member table (each node in one row,
    rows of at most W real nodes, PN pads) and its aggregate ids."""
    rng = np.random.default_rng(seed)
    t = lambda a, dt=dtype: torch.from_numpy(np.asarray(a)).to(device=device, dtype=dt)  # noqa: E731
    nodes = rng.permutation(PN)
    agg = np.empty(PN, np.int64)
    members = np.full((NA, W), PN, np.int64)
    for a, row in enumerate(np.array_split(nodes, NA)):
        assert len(row) <= W
        members[a, :len(row)] = row
        agg[row] = a
    return dict(block_inv=t(rng.normal(size=(L, 2, 2, PN))), arms=t(rng.normal(size=(PN, 2))),
                members=t(members, torch.int32), agg=t(agg, torch.int32),
                free=t(rng.uniform(size=(L, 2 * PN)) < 0.9),
                zc=t(0.01 * rng.normal(size=(L, NA, 3))))


def launch_cases(st, tables, Ap):
    """(name, fn(state, fn_variant)) for each launch: the kernel wrapper or
    the plain version, on its own copy of every input."""
    L, ndof = st.x.shape
    NA = tables["members"].shape[0]

    def alpha(s, plain):
        (cg.cg_alpha_reference if plain else cg.cg_alpha)(s, Ap)
        return {}

    def update_xr(s, plain):
        (cg.cg_update_xr_reference if plain else cg.cg_update_xr)(s, Ap)
        return {}

    def jacobi(s, plain):
        zj = torch.empty_like(s.r)
        rc = s.r.new_empty((L, NA, 3))
        fn = cg.jacobi_restrict_reference if plain else cg.jacobi_restrict
        fn(s.r, tables["block_inv"], tables["arms"], tables["members"], zj, rc)
        return {"zj": zj, "rc": rc}

    def prolong(s, plain):
        zj = s.r * 1.5 + 0.1 * s.p  # r.z well away from 0
        fn = cg.prolong_dots_reference if plain else cg.prolong_dots
        fn(zj, tables["zc"], tables["agg"], tables["arms"], tables["free"], s.z, s.P, s)
        return {}

    def update_p(s, plain):
        (cg.cg_update_p_reference if plain else cg.cg_update_p)(s)
        return {}

    return {"cg_alpha": alpha, "cg_update_xr": update_xr, "jacobi_restrict": jacobi,
            "prolong_dots": prolong, "cg_update_p": update_p}


# fields that come of a sum over a segment or an aggregate, held within a
# tolerance of their span; every other output is held bit for bit
SUMMED = {"alpha", "rz", "r2", "best", "beta", "rc"}


def compare(name, got, want, tol):
    for field in sorted(got):
        a, b = got[field], want[field]
        if field in SUMMED:
            span = float(b.max() - b.min()) or float(b.abs().max()) or 1.0
            err = float((a.double() - b.double()).abs().max())
            assert err <= tol * span, (name, field, err, span)
        else:
            assert torch.equal(a, b), (name, field, (a != b).sum())


def outputs(st, extra):
    return {**{n: getattr(st, n) for n in cg.SegmentedState.TENSORS
               if n not in ("partials", "tickets")}, **extra}


# ---- the CPU: a lane that has stopped keeps every leaf ------------------

LEAVES = ("x", "r", "p", "rz", "r2", "best", "stall", "active", "k")


def frozen_lane_case(device, dtype):
    """A body through `solver.segmented_body` on a diagonal operator and
    the scalar Jacobi preconditioner: lane 0 is at its budget, lane 1 has
    no segment left running, lane 2 runs."""
    st = random_state(device, dtype, 3, 2, 300, seed=3)
    st.k[1] = 0
    st.stall[1] = 180
    st.k[2] = 0
    st.active[2] = True
    st.stall[2] = 0
    st.atol2[2] = 0.0
    d = torch.linspace(1.0, 3.0, st.x.shape[1], dtype=dtype, device=device)
    before = {n: getattr(st, n).clone() for n in LEAVES}
    solver.segmented_body(st, lambda u: u * d, solver.ScalarJacobi(1.0 / d))
    for n in LEAVES:
        assert torch.equal(getattr(st, n)[:2], before[n][:2]), n
    assert not torch.equal(st.x[2], before["x"][2]) and int(st.k[2]) == 1


def test_plain_body_keeps_a_stopped_lane():
    frozen_lane_case(torch.device("cpu"), torch.float64)


def test_state_takes_float32_and_float64_only():
    with pytest.raises(TypeError):
        cg.SegmentedState(2, 2, 64, torch.bfloat16, "cpu", 10, 180)


# ---- the card -----------------------------------------------------------

SHAPES = {"ragged": (3, 5, 1000, 170, 32), "chunk": (4, 4, 8192, 4 * 320, 32)}  # L, P, Ns, NA, W
KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_their_plain_versions(shape, dtype):
    device = cuda_or_skip()
    L, P, Ns, NA, W = SHAPES[shape]
    st = random_state(device, dtype, L, P, Ns, seed=1)
    tables = coarse_tables(device, dtype, L, P * Ns, NA, W, seed=2)
    Ap = st.p * torch.rand_like(st.p).add_(0.5)
    for name, launch in launch_cases(st, tables, Ap).items():
        mine, plain = st.clone(), st.clone()
        before = getattr(cg, name).launches
        got = outputs(mine, launch(mine, plain=False))
        want = outputs(plain, launch(plain, plain=True))
        torch.cuda.synchronize()
        assert getattr(cg, name).launches == before + 1
        compare(name, got, want, KERNEL_TOL[dtype])
        assert int(mine.tickets.abs().sum()) == 0  # every ticket reset


@pytest.mark.gpu
def test_a_stopped_lane_keeps_every_leaf_on_the_card():
    device = cuda_or_skip()
    for dtype in (torch.float32, torch.float64):
        frozen_lane_case(device, dtype)


class Eager:
    """In place of a captured block: runs the bodies as kernel launches."""

    def __init__(self, fn, warmup, device):
        self.fn = fn

    def replay(self):
        self.fn()

    def close(self):
        pass


@pytest.mark.gpu
def test_graph_route_equals_the_kernels_without_a_graph(plates, monkeypatch):
    cuda_or_skip()
    payloads = [(batched.PlateSolver(mesh, 2, banded=True), problems) for mesh, problems in plates]
    runs = {}
    for route in ("graph", "kernels", "graph again"):
        with monkeypatch.context() as m:
            if route == "kernels":
                m.setattr(cg, "capture", Eager)
            counts = [w.launches for w in cg.WRAPPERS]
            rows = batched.dispatch_plate_group(payloads).result()
            runs[route] = (rows, [w.launches - c for w, c in zip(cg.WRAPPERS, counts)])
    assert torch.equal(runs["graph"][0], runs["kernels"][0])
    assert torch.equal(runs["graph"][0], runs["graph again"][0])
    # the same launches, and the capture's warm-up of the preconditioner
    # (one jacobi_restrict on the capture stream, before the graph)
    warmup = [int(w is cg.jacobi_restrict) for w in cg.WRAPPERS]
    assert runs["graph"][1] == [n + w for n, w in zip(runs["kernels"][1], warmup)]
    assert min(runs["kernels"][1]) > 0


@pytest.mark.gpu
def test_cuda_wrappers_raise_on_cpu_or_bf16_tensors():
    device = cuda_or_skip()
    st = random_state(device, torch.float32, 2, 2, 512, seed=4)
    with pytest.raises(ValueError):
        cg.cg_alpha(st, st.p.cpu())
    with pytest.raises(ValueError):
        cg.cg_update_xr(st, st.p.to(torch.bfloat16))
    tables = coarse_tables(device, torch.float32, 2, 2 * 512, 40, 32, seed=5)
    zj, rc = torch.empty_like(st.r), st.r.new_empty((2, 40, 3))
    with pytest.raises(ValueError):
        cg.jacobi_restrict(st.r, tables["block_inv"].to(torch.bfloat16), tables["arms"],
                           tables["members"], zj, rc)
    with pytest.raises(TypeError):
        cg.jacobi_restrict(st.r.to(torch.bfloat16), None, tables["arms"], tables["members"], None,
                           rc.to(torch.bfloat16))
    with pytest.raises(ValueError):
        cg.prolong_dots(st.r, tables["zc"].cpu(), tables["agg"], tables["arms"], None, st.z, 2, st)
