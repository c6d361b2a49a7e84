"""The solver variant the port takes from fea_tpu's switches, band-block
Jacobi (fea_tpu_torch.fem.{banded,flatgroup}, datagen.batched), against
fea_tpu's on the CPU: the band-block functions, the flat chunk and the
batched datagen with `band_block`; the coarse apply against fea_tpu's
fused one; `device_trace`; and what of fea_tpu is not ported by design.

The same NumPy inputs go through both packages. JAX runs float32 with x64
off (`jax.enable_x64(False)`, as fea_tpu runs on the chip) and float64 in
x64 (tests/conftest.py); fea_tpu's switches are set by environment
variable (monkeypatch), the port's by argument. The chunks are
tests/test_torch_flatgroup.py's three unit-square plates (mesh 0.14 /
0.145 / 0.15, 2 seeded conditions each) and their tolerances: u within
1e-4 of the lane's largest displacement, strain within 1e-3, the same
converged / failed flags, iterations within 25% over the chunk in f32.
The datagen runs at tests/test_torch_datagen.py's config and is held as
that file holds the default run: the same counters and files, PNGs
within 1 gray level.

The band-block functions run on the band of one RCM-permuted plate
(tests/test_torch_banded.py's `permuted_plate`, padded to a multiple of
128 nodes): the diagonal blocks bit for bit (a gather); the inverse and
the factor within 1e-10 (f64) / 1e-5 (f32) of each block's largest entry,
with one block made indefinite on purpose that both packages turn into
the same scalar-Jacobi rows; the applies within 1e-6 of the largest
element, on the same operands.
"""

import json
import time

import numpy as np
import pytest
import torch

from fea_tpu_torch.datagen import batched
from fea_tpu_torch.fem import banded, coarse, flatgroup
from fea_tpu_torch.utils.profiling import SPAN_TRACK, device_trace, span
from test_torch_banded import permuted_plate
from test_torch_flatgroup import jax_payloads, payload_problems, port_payloads

torch.set_num_threads(1)

@pytest.fixture(scope="module")
def plates():
    return payload_problems()


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-300)


@pytest.fixture(scope="module")
def band64():
    """(S, hb) of one RCM-permuted plate in f64, n_pad a multiple of 128."""
    from fea_tpu_torch.fem import elasticity

    mesh, coords, tris, young, poisson, hb, _ = permuted_plate(mesh_size=0.07)
    n_pad = ((mesh.num_nodes + 127) // 128) * 128
    coords = np.concatenate([coords[:mesh.num_nodes], np.zeros((n_pad - mesh.num_nodes, 2))])
    D = elasticity.plane_strain_stiffness_em(torch.from_numpy(young), torch.from_numpy(poisson))
    Ke = elasticity.element_stiffness(torch.from_numpy(coords), torch.from_numpy(tris), D)[0]
    plan = torch.from_numpy(banded.band_assembly_indices(tris, n_pad, hb))
    return banded.assemble_band(Ke, plan, 2 * n_pad, hb), hb


@pytest.mark.parametrize("block", [128, 256])
def test_band_block_diagonal_is_the_same_gather(band64, block):
    import jax.numpy as jnp

    from fea_tpu.fem import banded as jbanded

    S, hb = band64
    for dtype in (torch.float64, torch.float32):
        s = S.to(dtype)
        got = banded.band_block_diagonal(s, hb, block)
        want = np.asarray(jbanded.band_block_diagonal(jnp.asarray(s.numpy()), hb, block))
        np.testing.assert_array_equal(got.numpy(), want)
        # lanes: each lane's blocks are its own band's
        both = banded.band_block_diagonal(torch.stack([s, 2 * s]), hb, block)
        assert torch.equal(both[0], got) and torch.equal(both[1], 2 * got)
    assert got.shape == (S.shape[0] * 128 // block, block, block)


def block_inputs(S, hb, dtype):
    """Diagonal blocks of 128, a free mask with 10% fixed, and block 2 made
    indefinite: a 2x2 leading minor with an off-diagonal 10x the largest
    diagonal entry."""
    D = banded.band_block_diagonal(S, hb, 128).clone()
    m = float(torch.diagonal(D[2]).max())
    D[2, 0, 1] = D[2, 1, 0] = 10 * m
    rng = np.random.default_rng(5)
    free = (rng.random(D.shape[:2]) > 0.1).astype(np.float64)
    free[2, :2] = 1.0
    return D.to(dtype), torch.from_numpy(free).to(dtype)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10), (torch.float32, 1e-5)])
def test_spd_block_inverse_and_factor_match(band64, dtype, rtol):
    import jax
    import jax.numpy as jnp

    from fea_tpu.fem import banded as jbanded

    D, free = block_inputs(*band64, dtype)
    inv = banded.spd_block_inverse(D, free)
    factor = banded.spd_block_inv_factor(D, free, out_dtype=dtype)
    with jax.enable_x64(dtype == torch.float64):
        jD, jfree = jnp.asarray(D.numpy()), jnp.asarray(free.numpy())
        jinv = np.asarray(jbanded.spd_block_inverse(jD, jfree))
        jfactor = np.asarray(jbanded.spd_block_inv_factor(jD, jfree, out_dtype=jD.dtype))
    assert inv.dtype == factor.dtype == dtype
    for got, want in ((inv, jinv), (factor, jfactor)):
        for g in range(D.shape[0]):
            assert rel_err(got[g].numpy(), want[g]) <= rtol, g
    # the indefinite block: cholesky_ex's partial factor is caught, and
    # both packages fall back to scalar Jacobi (diag^-1, diag^-1/2)
    diag = torch.diagonal(D[2] * free[2][:, None] * free[2][None, :])
    jac = torch.where(diag > 0, free[2] / torch.where(diag > 0, diag, 1.0), 0.0)
    assert torch.equal(inv[2], torch.diag(jac))
    jac_half = torch.where(diag > 0, free[2] / torch.sqrt(torch.where(diag > 0, diag, 1.0)), 0.0)
    assert torch.equal(factor[2], torch.diag(jac_half))
    for want, ref in ((jinv[2], jac), (jfactor[2], jac_half)):
        np.testing.assert_array_equal(want - np.diag(np.diag(want)), 0.0)
        assert rel_err(np.diag(want), ref.numpy()) <= rtol
    assert torch.linalg.cholesky_ex(D[2])[1] > 0
    # the bf16 factor of the chunk: fea_tpu's default out_dtype
    bf16 = banded.spd_block_inv_factor(D, free)
    assert bf16.dtype == torch.bfloat16


def test_gram_and_block_jacobi_apply_match(band64):
    import jax
    import jax.numpy as jnp

    from fea_tpu.fem import banded as jbanded

    D, free = block_inputs(*band64, torch.float32)
    factor = banded.spd_block_inv_factor(D, free)  # bf16
    inv = banded.spd_block_inverse(D, free)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, D.shape[0] * 128)).astype(np.float32))
    z = banded.gram_apply(factor, x)  # three lanes at once
    z_copy = banded.gram_apply(factor.float(), x, storage=torch.bfloat16)
    zb = banded.block_jacobi_apply(inv, x)
    assert z.dtype == torch.float32 and torch.equal(z, z_copy)
    with jax.enable_x64(False):
        jfactor = jnp.asarray(factor.float().numpy()).astype(jnp.bfloat16)
        for c in range(3):
            jx = jnp.asarray(x[c].numpy())
            assert rel_err(z[c], jbanded.gram_apply(jfactor, jx)) <= 1e-6
            assert rel_err(zb[c], jbanded.block_jacobi_apply(jnp.asarray(inv.numpy()), jx)) <= 1e-6
    # f64: the Gram apply of the f64 factor is the inverse's apply
    D64, free64 = block_inputs(*band64, torch.float64)
    x64 = x.double()
    assert rel_err(banded.gram_apply(banded.spd_block_inv_factor(D64, free64, out_dtype=torch.float64), x64),
                   banded.block_jacobi_apply(banded.spd_block_inverse(D64, free64), x64)) <= 1e-10


def flat_coarse_inputs(plates):
    """The chunk's flat coarse tables, Kc^-1 of its first two conditions and
    a residual masked at the fixed dofs."""
    from fea_tpu_torch.fem import elasticity

    payloads = port_payloads(plates)
    solvers, host, m_real, _ = batched.chunk_inputs(payloads)
    tables, _ = batched.chunk_tables(solvers, host, m_real, torch.device("cpu"))
    P, Nb = tables[0].shape[:2]
    nc = solvers[0].n_coarse
    coords, tris, _, agg, arms = flatgroup.flatten_tables(*tables[:5], nc)
    members = flatgroup.flatten_members(tables[5], Nb)
    young = tables[6].transpose(0, 1).reshape(2, -1)
    poisson = tables[7].transpose(0, 1).reshape(2, -1)
    free = tables[8].transpose(0, 1).reshape(2, -1)
    D = elasticity.plane_strain_stiffness_em(young, poisson)
    Ke = torch.stack([elasticity.element_stiffness(coords, tris, D[:, :, c])[0] for c in range(2)])
    Kc_inv = coarse.coarse_inverse(flatgroup.build_coarse_matrix_flat(Ke, tris, agg, arms, free, P, nc))
    r = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 2 * P * Nb)).astype(np.float32))
    return Kc_inv, agg, arms, members, r * torch.cat([free, free], dim=-1), P, nc


@pytest.mark.parametrize("fused", [True, False])
def test_coarse_apply_flat_is_fea_tpus_fused_apply(plates, fused):
    """The port's one coarse apply (a stacked (3, N) restriction through
    the member table, one (N, 3) gather back) against fea_tpu's fused
    (FEA_TPU_COARSE_FUSED) and three-payload paths: the same z."""
    import jax
    import jax.numpy as jnp

    from fea_tpu.fem import flatgroup as jflatgroup

    args = flat_coarse_inputs(plates)
    Kc_inv, agg, arms, members, r, P, nc = args
    z = flatgroup.coarse_apply_flat(*args)
    with jax.enable_x64(False):
        j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
        for c in range(2):
            jz = jflatgroup.coarse_apply_flat(j(Kc_inv[c]), j(agg), j(arms), j(r[c]), P, nc,
                                              fused=fused)
            assert rel_err(z[c], jz) <= 1e-6


def chunk_rows(payloads, **kw):
    return batched.dispatch_plate_group(payloads, **kw).result().numpy()


def jax_chunk_rows(payloads, **kw):
    from fea_tpu.datagen.batched import dispatch_plate_group

    return np.asarray(dispatch_plate_group(payloads, **kw))


def assert_rows_match(got, want, node_bucket, tri_bucket):
    """tests/test_torch_flatgroup.py's f32 tolerances on packed (P, C, K)
    rows, the iteration counts summed over the chunk; returns the counts
    (port, fea_tpu)."""
    assert got.shape == want.shape and got.dtype == np.float32
    nb2, mb3 = 2 * node_bucket, 3 * tri_bucket
    tail, jtail = got[..., -4:], want[..., -4:]
    np.testing.assert_array_equal(tail[..., :2], jtail[..., :2])  # converged, failed
    assert tail[..., 0].all() and not tail[..., 1].any()
    for p in range(got.shape[0]):
        for c in range(got.shape[1]):
            assert rel_err(got[p, c, :nb2], want[p, c, :nb2]) <= 1e-4
            assert rel_err(got[p, c, nb2:nb2 + mb3], want[p, c, nb2:nb2 + mb3]) <= 1e-3
    iters, jiters = tail[..., 3], jtail[..., 3]
    assert abs(iters.sum() - jiters.sum()) <= 0.25 * jiters.sum(), (iters, jiters)
    return iters, jiters


def test_band_block_chunk_matches_fea_tpu(plates, monkeypatch, record_property):
    """The flat chunk with band-block Jacobi (blocks of 128) against
    fea_tpu's under FEA_TPU_BAND_BLOCK=128; the stronger smoother takes
    fewer lockstep iterations than the 2x2 blocks, in both packages."""
    import jax

    monkeypatch.setenv("FEA_TPU_FLAT_CHUNK", "1")
    ours = port_payloads(plates)
    with jax.enable_x64(False):
        theirs = jax_payloads(plates)
        base = jax_chunk_rows(theirs)
        monkeypatch.setenv("FEA_TPU_BAND_BLOCK", "128")
        want = jax_chunk_rows(theirs)
    assert [s.shape_key for s, _ in ours] == [s.shape_key for s, _ in theirs]
    assert ours[0][0].band_hb > 0
    got = chunk_rows(ours, band_block=128)
    iters, jiters = assert_rows_match(got, want, ours[0][0].node_bucket, ours[0][0].tri_bucket)
    ours_base = chunk_rows(ours)
    record_property("iterations", dict(port=iters.tolist(), fea_tpu=jiters.tolist(),
                                       port_default=ours_base[..., -1].tolist(),
                                       fea_tpu_default=base[..., -1].tolist()))
    assert iters.sum() < ours_base[..., -1].sum()
    assert jiters.sum() < base[..., -1].sum()


def test_band_block_degrades_as_fea_tpu_does(plates):
    """A block that does not divide 2*P*Nb degrades by 128 at a time (256
    -> 128 here: three plates of a 256-node bucket give 1536 dofs), and an
    incidence chunk ignores the band switches: the rows equal those of the
    degraded block and of the default chunk bit for bit."""
    ours = port_payloads(plates)
    assert (2 * len(ours) * ours[0][0].node_bucket) % 256 == 0
    three = chunk_rows(ours, band_block=128)
    # 3 plates padded to 5: 2560 dofs, 1024 -> 896 -> 768 -> 640
    assert np.array_equal(chunk_rows(ours, band_block=1024, pad_group_to=5)[:3],
                          chunk_rows(ours, band_block=640, pad_group_to=5)[:3])
    assert not np.array_equal(three, chunk_rows(ours))
    plain = port_payloads(plates, banded=False)
    assert np.array_equal(chunk_rows(plain, band_block=128), chunk_rows(plain))


def test_default_arguments_are_the_defaults(plates):
    """Naming every default gives the rows of naming none, bit for bit."""
    payloads = port_payloads(plates)
    assert np.array_equal(chunk_rows(payloads), chunk_rows(payloads, band_block=0))


def test_group_the_shards_do_not_divide_raises_in_both(plates, monkeypatch):
    """3 plates over 2 shards: the port raises before it solves, and so
    does fea_tpu (its device_put of the plate axis onto the 2-device mesh,
    before it picks the flat chunk or the two-level solve)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from fea_tpu.datagen.batched import solve_plate_group as jsolve_plate_group
    from fea_tpu.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="3 plates do not split over 2 shards"):
        batched.dispatch_plate_group(port_payloads(plates), devices=["cpu", "cpu"])
    for flat_chunk in ("0", "1"):
        monkeypatch.setenv("FEA_TPU_FLAT_CHUNK", flat_chunk)
        with jax.enable_x64(False), pytest.raises(ValueError, match="divisible by 2"):
            sharding = NamedSharding(make_mesh(2), PartitionSpec("dp"))
            jsolve_plate_group(jax_payloads(plates), sharding=sharding)


def test_generate_data_batched_band_block_matches_fea_tpu(tmp_path, monkeypatch):
    """The scheduler passes `band_block` to every chunk, continuations and
    padded groups included: the run with blocks of 128 against fea_tpu's
    under FEA_TPU_BAND_BLOCK=128, as tests/test_torch_datagen.py holds the
    default run (the same counters, the same files, PNGs within 1 gray
    level); its lanes' iterations are not the default run's."""
    import jax

    from fea_tpu.datagen.batched import generate_data_batched as jgenerate

    from test_torch_datagen import CONFIG, assert_same_tree

    kw = dict(CONFIG, batch_size=2)
    default = batched.generate_data_batched(data_dir=str(tmp_path / "default"), device="cpu", **kw)
    stats = batched.generate_data_batched(data_dir=str(tmp_path / "ours"), device="cpu",
                                          band_block=128, **kw)
    monkeypatch.setenv("FEA_TPU_BAND_BLOCK", "128")
    with jax.enable_x64(False):
        jstats = jgenerate(data_dir=str(tmp_path / "theirs"), **kw)
    for key in ("plates", "lane_dispatches", "solves", "host_rejections", "cg_failures",
                "direct_fallbacks", "cg_resamples", "continuations", "chunks", "final_buckets"):
        assert stats[key] == jstats[key], key
    assert stats["cg_failures"] == 0
    assert_same_tree(str(tmp_path / "ours"), str(tmp_path / "theirs"))
    iters = [i for *_, i in stats["solved_conditions"]]
    assert iters != [i for *_, i in default["solved_conditions"]]


def test_device_trace_writes_a_trace(tmp_path):
    with device_trace(None):
        torch.ones(4).sum()
    assert not any(tmp_path.iterdir())
    with device_trace(str(tmp_path)):
        with span("probe.span", step=7):
            time.sleep(1e-3)
            torch.ones(4).sum()
            time.sleep(1e-3)
    traces = [p for p in tmp_path.iterdir() if p.name.endswith(".pt.trace.json")]
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    # one file: the host's operators and the program's span, on one clock
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    (probe,) = [e for e in events if e.get("name") == "probe.span"]
    assert probe["ph"] == "X" and probe["pid"] == SPAN_TRACK and probe["args"]["step"] == 7
    ops = [e for e in events if e.get("name") == "aten::sum" and e.get("ph") == "X"]
    assert ops and all(op["pid"] != SPAN_TRACK for op in ops)
    for op in ops:
        assert probe["ts"] <= op["ts"] and op["ts"] + op["dur"] <= probe["ts"] + probe["dur"]


def _no_triangulate_fallback():
    from fea_tpu.mesh import mesher as jmesher
    from fea_tpu_torch.mesh import mesher

    return hasattr(jmesher, "_triangulate_fallback") and not hasattr(mesher, "_triangulate_fallback")


def _raster_by_argument():
    import inspect

    from fea_tpu.utils import device as jdevice
    from fea_tpu_torch.raster import rasterizer
    from fea_tpu_torch.utils import device

    return (hasattr(jdevice, "raster_device") and not hasattr(device, "raster_device")
            and "device" in inspect.signature(rasterizer.field_image).parameters)


def _no_compilation_cache():
    from fea_tpu.utils import device as jdevice
    from fea_tpu_torch.utils import device

    return hasattr(jdevice, "enable_compilation_cache") and not hasattr(device, "enable_compilation_cache")


def _no_dcn_grouping():
    import inspect

    from fea_tpu.parallel import mesh as jmesh
    from fea_tpu_torch.parallel import mesh

    return ("dcn_size" in inspect.signature(jmesh.make_mesh).parameters
            and "dcn_size" not in inspect.signature(mesh.make_mesh).parameters)


def _no_switch(fea_tpu_switch, port_argument, *port_functions):
    """fea_tpu's datagen reads the switch, and no port entry point named
    takes the argument."""
    def check():
        import inspect

        from fea_tpu.datagen import batched as jbatched

        return hasattr(jbatched, fea_tpu_switch) and not any(
            port_argument in inspect.signature(f).parameters for f in port_functions)
    return check


_ENTRY = (batched.generate_data_batched, batched.solve_plate_group, batched.dispatch_plate_group)

BY_DESIGN = {"triangulate_fallback": _no_triangulate_fallback, "raster_device": _raster_by_argument,
             "compilation_cache": _no_compilation_cache, "dcn_grouping": _no_dcn_grouping,
             "coarse_fused": _no_switch("_coarse_fused", "coarse_fused", *_ENTRY,
                                        flatgroup.coarse_apply_flat, flatgroup.chunk_system),
             "coarse_blocked": _no_switch("_coarse_block", "coarse_blocked", *_ENTRY,
                                          batched.PlateSolver, flatgroup.chunk_system),
             "two_level_solve": _no_switch("_solve_multi_plate_kernel", "flat_chunk", *_ENTRY)}


@pytest.mark.parametrize("difference", BY_DESIGN)
def test_what_is_not_ported_is_a_difference_by_design(difference):
    """What of fea_tpu has no counterpart in the port, on purpose: the
    second mesher (the port builds cdt.cpp or raises), the raster device
    switch (`device=` arguments instead), the compilation cache (nothing is
    compiled), the DCN x ICI device grouping (NCCL picks its rings), the
    fused coarse apply (the port's one apply is its arithmetic, held to it
    by test_coarse_apply_flat_is_fea_tpus_fused_apply), and the blocked
    coarse aggregates and the two-level multi-plate solve (slower than the
    default on the H100 and on the v5e; ROADMAP queue 1)."""
    assert BY_DESIGN[difference]()
