"""The CG loop's two costliest kernels as they are laid out for Hopper:
`ops.cg.prolong_dots` (a thread-block cluster per segment,
`csrc/cg_segmented.cu`) and `ops.band.band_matvec` (the tables staged in
shared memory up to each slice's widest row, `csrc/band_matvec.cu`).

On the CPU, what the host decides for the kernels:
- `prolong_plan` at every node bucket of datagen (`SHAPE_BUCKETS`) and at
  ragged node counts: at most 16 blocks a cluster, every block's node range
  non-empty, the ranges tiling the segment exactly once, each starting on
  a multiple of a 16-byte load; `prolong_vector` takes 16-byte loads where
  the node count allows them;
- `band_tables`' width table (`fem.banded.slice_widths`) equals the widest
  row of each slice of the compacted band on the 3-plate chunk of tests/test_torch_flatgroup.py
  (plates of three sizes) and on random ragged tables;
- the card's band operator on CPU tensors, with its width table, is the
  plain version and within 1e-6 of y's span of fea_tpu's `banded_matvec`
  (f32); a block's shared memory holds the production chunk's rows.

The tests marked `gpu` skip without a CUDA device. JAX is imported inside
the CPU tests only, so on the card they run with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cg_hopper.py

They hold both kernels against their plain versions in f32 and f64 at a
ragged node count (the scalar route), at two buckets, at the production
chunk (4 lanes, 4 plates of 8192 nodes) and at 4 segments of the largest
bucket (clusters of 16): `prolong_dots`' z bit for bit, with and without
the state, its rz / r2 / beta / best within 1e-5 of their span in f32
(1e-12 in f64; at the largest bucket, whose random segments' sums lie a
few ulps apart, of each value's size), its flags and counters equal; the
band kernel
within 1e-5 of y's span of its plain version. Each kernel repeats its bits
over 50 launches; both replayed from a CUDA graph give the bits of their
launches, counted at each replay; the wrappers raise on CPU, bf16,
non-contiguous and misaligned inputs (`prolong_dots` on a misaligned
vector only where its node count takes 16-byte loads).
"""

import numpy as np
import pytest
import torch

import test_torch_band_kernel as tbk
import test_torch_cg_kernels as tc
from fea_tpu_torch.datagen.pipeline import SHAPE_BUCKETS
from fea_tpu_torch.fem import banded, flatgroup
from fea_tpu_torch.ops import band, cg

torch.set_num_threads(1)

RAGGED_NODES = [1, 5, 130, 1000, 1001, 1025, 7169, 9999, 140_000]


# ---- the CPU: the launch plans and the width table ----------------------


def ranges(seg_nodes):
    cluster, span = cg.prolong_plan(seg_nodes)
    return cluster, span, [(b * span, min(seg_nodes, (b + 1) * span)) for b in range(cluster)]


@pytest.mark.parametrize("seg_nodes", SHAPE_BUCKETS + RAGGED_NODES)
def test_prolong_plan_tiles_the_segment_once(seg_nodes):
    cluster, span, blocks = ranges(seg_nodes)
    assert 1 <= cluster <= cg.PROLONG_CLUSTER and span % 4 == 0
    assert blocks[0][0] == 0 and blocks[-1][1] == seg_nodes
    for (a0, a1), (b0, _) in zip(blocks, blocks[1:]):
        assert a1 == b0
    assert all(n1 > n0 for n0, n1 in blocks)  # no rank idles
    if seg_nodes >= cg.PROLONG_CLUSTER * cg.PROLONG_NODES:
        assert cluster == cg.PROLONG_CLUSTER


def test_prolong_takes_16_byte_loads_at_every_bucket():
    for n in SHAPE_BUCKETS:
        assert cg.prolong_vector(n, torch.float32) == 4
        assert cg.prolong_vector(n, torch.float64) == 2
    assert cg.prolong_vector(1001, torch.float32) == 1
    assert cg.prolong_vector(1001, torch.float64) == 1
    assert cg.prolong_vector(1002, torch.float32) == 1
    assert cg.prolong_vector(1002, torch.float64) == 2


def widest_rows(cols):
    """Per slice, the widest row's count of real slots (numpy loop)."""
    cols = cols.numpy()
    out = np.zeros(cols.shape[0], np.int32)
    for s in range(cols.shape[0]):
        for r in range(cols.shape[2]):
            real = np.flatnonzero(cols[s, :, r] >= 0)
            if len(real):
                assert (real == np.arange(len(real))).all()  # a row's pads follow its columns
                out[s] = max(out[s], len(real))
    return out


def test_slice_widths_are_the_widest_row_of_each_slice(plates):
    _, tables, m_real_p, hb = tbk.cpu_chunk(plates)
    assert tables[0].shape[0] >= 3
    S, band_idx, free = tbk.chunk_band(tables, m_real_p, hb)
    _, cols, widths = banded.band_tables(S, band_idx, hb, free)
    assert widths.device == cols.device and widths.dtype == torch.int32 and widths.shape == (cols.shape[0],)
    np.testing.assert_array_equal(widths.numpy(), widest_rows(cols))
    assert int(widths.max()) == cols.shape[1]
    assert int(widths.min()) < cols.shape[1]  # the pad nodes' slices are narrower


def test_slice_widths_of_ragged_tables():
    _, cols = tbk.ragged_tables(torch.device("cpu"), torch.float32)
    np.testing.assert_array_equal(banded.slice_widths(cols).numpy(), widest_rows(cols))


def test_band_operator_with_its_widths_matches_fea_tpu(plates):
    import jax
    import jax.numpy as jnp

    from fea_tpu.fem import banded as jbanded

    _, tables, m_real_p, hb = tbk.cpu_chunk(plates)
    S, band_idx, free = tbk.chunk_band(tables, m_real_p, hb)
    op = flatgroup.BandOperator(*banded.band_tables(S, band_idx, hb, free), free.shape[1])
    assert torch.equal(op.widths, banded.slice_widths(op.cols))
    C, n_dofs = free.shape
    PN = n_dofs // 2
    u = torch.from_numpy(np.random.default_rng(8).normal(size=(C, n_dofs)).astype(np.float32))
    y = op(u).clone()
    want_plain = torch.empty_like(u)
    banded.band_matvec_reference(op.vals, op.cols, u, want_plain)
    assert torch.equal(y, want_plain)  # CPU tensors: the plain version
    with jax.enable_x64(False):
        win = jbanded.window_index(2 * PN, hb)
        want = np.stack([
            np.asarray(jbanded.interleaved_to_planar(jbanded.banded_matvec(
                jnp.asarray(S[c].numpy()),
                jbanded.planar_to_interleaved(jnp.asarray((u[c] * free[c]).numpy()), PN),
                win, hb), PN)) * free[c].numpy()
            for c in range(C)])
    assert np.abs(y.numpy() - want).max() <= tbk.TOL[torch.float32] * (want.max() - want.min())


def test_a_block_holds_the_production_rows():
    # phase 9's chunk has rows of 18 slots (PERF.md); a block of either type
    # holds them, and rows too wide for it are refused on the card
    for dtype in (torch.float32, torch.float64):
        assert band.shared_bytes(18, dtype) <= band.MAX_SHARED
    assert band.shared_bytes(18, torch.float32) == 4 * 18 * 32 * (4 * 4 + 4)
    assert band.shared_bytes(100, torch.float64) > band.MAX_SHARED


@pytest.fixture(scope="module")
def plates():
    return tbk.tf.payload_problems()


# ---- the card -----------------------------------------------------------

# L lanes, P plates, Ns nodes a plate, NA aggregates, W members at most
PROLONG_SHAPES = {
    "ragged": (3, 5, 1001, 170, 32),  # the scalar route
    "bucket 2048": (4, 3, 2048, 3 * 80, 32),
    "bucket 12288": (2, 3, 12288, 3 * 480, 32),
    "chunk": (4, 4, 8192, 4 * 320, 32),
    "bucket 131072": (1, 4, 131072, 4 * 131072 // 25, 32),  # the largest, 4 segments
}
# shapes whose random segments' sums are alike, their span a few ulps wide:
# the sums are held to each value's own size instead
ALIKE_SUMS = ("bucket 131072",)
STATE_FIELDS = ("z", "rz", "r2", "best", "beta", "stall", "k", "run", "lane", "x", "r", "p")


def prolong_case(device, dtype, shape, seed=1):
    L, P, Ns, NA, W = PROLONG_SHAPES[shape]
    st = tc.random_state(device, dtype, L, P, Ns, seed=seed)
    tables = tc.coarse_tables(device, dtype, L, P * Ns, NA, W, seed=seed + 1)
    zj = st.r * 1.5 + 0.1 * st.p  # r.z well away from 0
    return st, tables, zj


def run_prolong(fn, st, tables, zj, with_state):
    fn(zj, tables["zc"], tables["agg"], tables["arms"], tables["free"], st.z, st.P,
       st if with_state else None)
    return {n: getattr(st, n) for n in STATE_FIELDS}


@pytest.mark.gpu
@pytest.mark.parametrize("with_state", [True, False], ids=["state", "z0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", PROLONG_SHAPES)
def test_prolong_dots_matches_its_plain_version(shape, dtype, with_state):
    device = tc.cuda_or_skip()
    st, tables, zj = prolong_case(device, dtype, shape)
    mine, plain = st.clone(), st.clone()
    before = cg.prolong_dots.launches
    got = run_prolong(cg.prolong_dots, mine, tables, zj, with_state)
    want = run_prolong(cg.prolong_dots_reference, plain, tables, zj, with_state)
    torch.cuda.synchronize()
    assert cg.prolong_dots.launches == before + 1
    if shape in ALIKE_SUMS:
        for n, a in got.items():
            rel = (a.double() - want[n].double()).abs() / want[n].double().abs().clamp_min(1e-30)
            assert float(rel.max()) <= (tc.KERNEL_TOL[dtype] if n in tc.SUMMED else 0.0), n
    else:
        tc.compare("prolong_dots", got, want, tc.KERNEL_TOL[dtype])  # z and the counters bit for bit
    if with_state:  # the epilogue ran on every lane that runs, and on no other
        assert torch.equal(mine.k, st.k + st.lane.to(st.k.dtype))
    else:
        for n in STATE_FIELDS[1:]:
            assert torch.equal(getattr(mine, n), getattr(st, n)), n


def band_case(device, dtype, shape):
    if shape == "ragged":
        vals, cols = tbk.ragged_tables(device, dtype)
        widths, n_dofs = banded.slice_widths(cols), 1000
    else:
        if shape == "chunk":
            S, band_idx, hb, free = tbk.production_chunk(device)
        else:  # the 3-plate chunk's bucket
            _, tables, m_real_p, hb = tbk.cpu_chunk(tbk.tf.payload_problems())
            S, band_idx, free = (t.to(device) for t in tbk.chunk_band(tables, m_real_p, hb))
        vals, cols, widths = banded.band_tables(S.to(dtype), band_idx, hb, free.to(dtype))
        n_dofs = free.shape[1]
    u = torch.from_numpy(np.random.default_rng(6).normal(size=(vals.shape[0], n_dofs)))
    return vals, cols, widths, u.to(device, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", ["ragged", "three plates", "chunk"])
def test_band_matvec_matches_its_plain_version(shape, dtype):
    device = tc.cuda_or_skip()
    vals, cols, widths, u = band_case(device, dtype, shape)
    y, plain = torch.empty_like(u), torch.empty_like(u)
    before = band.band_matvec.launches
    band.band_matvec(vals, cols, u, y, widths)
    banded.band_matvec_reference(vals, cols, u, plain)
    torch.cuda.synchronize()
    assert band.band_matvec.launches == before + 1
    assert tbk.span_error(y, plain) <= tbk.KERNEL_TOL[dtype]


@pytest.mark.gpu
def test_both_kernels_repeat_their_bits():
    device = tc.cuda_or_skip()
    st, tables, zj = prolong_case(device, torch.float32, "chunk")
    first = {n: t.clone() for n, t in run_prolong(cg.prolong_dots, st.clone(), tables, zj, True).items()}
    vals, cols, widths, u = band_case(device, torch.float32, "chunk")
    y0 = torch.empty_like(u)
    band.band_matvec(vals, cols, u, y0, widths)
    y = torch.empty_like(u)
    for _ in range(50):
        again = run_prolong(cg.prolong_dots, st.clone(), tables, zj, True)
        band.band_matvec(vals, cols, u, y, widths)
        for n in first:
            assert torch.equal(again[n], first[n]), n
        assert torch.equal(y, y0)


@pytest.mark.gpu
def test_a_graph_replays_the_launches_bit_for_bit():
    device = tc.cuda_or_skip()
    st, tables, zj = prolong_case(device, torch.float32, "chunk")
    vals, cols, widths, u = band_case(device, torch.float32, "chunk")
    eager, graphed = st.clone(), st.clone()
    y_eager, y_graph = torch.empty_like(u), torch.empty_like(u)

    def body(s, y):
        band.band_matvec(vals, cols, u, y, widths)
        run_prolong(cg.prolong_dots, s, tables, zj, True)

    for _ in range(3):
        body(eager, y_eager)
    block = cg.capture(lambda: body(graphed, y_graph), lambda: None, device)
    counts = (cg.prolong_dots.launches, band.band_matvec.launches)
    for _ in range(3):
        block.replay()
    torch.cuda.synchronize()
    block.close()
    assert (cg.prolong_dots.launches, band.band_matvec.launches) == (counts[0] + 3, counts[1] + 3)
    assert torch.equal(y_graph, y_eager)
    for n in STATE_FIELDS:
        assert torch.equal(getattr(graphed, n), getattr(eager, n)), n


def misaligned(t):
    """A contiguous copy of t that starts 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
def test_wrappers_raise_on_what_the_kernels_do_not_take():
    device = tc.cuda_or_skip()
    st, tables, zj = prolong_case(device, torch.float32, "ragged")
    args = (tables["zc"], tables["agg"], tables["arms"], tables["free"], st.z, st.P, st)
    with pytest.raises(ValueError):
        cg.prolong_dots(zj.cpu(), *args)
    with pytest.raises(ValueError):
        cg.prolong_dots(zj.to(torch.bfloat16), *args)
    with pytest.raises(ValueError):
        cg.prolong_dots(zj.T.contiguous().T, *args)
    # 16-byte loads take no vector off a 16-byte boundary; the scalar route
    # of a ragged node count takes one
    mine, plain = st.clone(), st.clone()
    cg.prolong_dots(misaligned(zj), tables["zc"], tables["agg"], tables["arms"], tables["free"],
                    mine.z, mine.P, mine)
    cg.prolong_dots_reference(zj, tables["zc"], tables["agg"], tables["arms"], tables["free"],
                              plain.z, plain.P, plain)
    assert torch.equal(mine.z, plain.z)
    st, tables, zj = prolong_case(device, torch.float32, "bucket 2048")
    with pytest.raises(ValueError, match="16-byte"):
        cg.prolong_dots(misaligned(zj), tables["zc"], tables["agg"], tables["arms"],
                        tables["free"], st.z, st.P, st)
    with pytest.raises(ValueError, match="16-byte"):
        cg.prolong_dots(zj, tables["zc"], tables["agg"], tables["arms"], misaligned(tables["free"]),
                        st.z, st.P, st)
    vals, cols, widths, u = band_case(device, torch.float32, "ragged")
    y = torch.empty_like(u)
    with pytest.raises(ValueError):
        band.band_matvec(vals, cols, u, y, widths.cpu())
    with pytest.raises(ValueError):
        band.band_matvec(vals, cols, u, y, widths.long())
    with pytest.raises(TypeError):
        band.band_matvec(vals.bfloat16(), cols, u.bfloat16(), y.bfloat16(), widths)
    with pytest.raises(ValueError):
        band.band_matvec(vals, cols, u.T.contiguous().T, y, widths)
    with pytest.raises(ValueError, match="16-byte"):
        band.band_matvec(misaligned(vals), cols, u, y, widths)
    with pytest.raises(ValueError, match="16-byte"):
        band.band_matvec(vals, misaligned(cols), u, y, widths)
    wide = torch.full((cols.shape[0], 100, cols.shape[2]), -1, dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="shared memory"):
        band.band_matvec(vals.new_zeros((vals.shape[0],) + tuple(wide.shape)).double(), wide,
                         u.double(), y.double(), widths)
