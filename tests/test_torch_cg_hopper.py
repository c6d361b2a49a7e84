"""The CG loop's kernels as they are laid out for Hopper:
`ops.cg.prolong_dots` and `ops.cg.cg_alpha` (a thread-block cluster per
segment), `ops.cg.cg_update_p` and `ops.cg.cg_update_xr` (a grid of
blocks per segment, 16-byte loads), `ops.cg.jacobi_restrict` (the Jacobi
term on a grid of blocks per lane, the restriction a warp per aggregate
for all lanes of a pass; all five in `csrc/cg_segmented.cu`) and
`ops.band.band_matvec` (the tables staged in shared memory up to each
slice's widest row, `csrc/band_matvec.cu`).

On the CPU, what the host decides for the kernels:
- `prolong_plan` and `alpha_plan` at every node bucket of datagen
  (`SHAPE_BUCKETS`) and at ragged node counts: at most 16 blocks a
  cluster, every block's node range non-empty, the ranges tiling the
  segment exactly once, each starting on a multiple of a 16-byte load;
  `update_p_plan` the same with blocks of one grid, and each thread's
  loads (V nodes at a time) covering every node once; at phase 9's chunk
  both fill 128 of the card's 132 SMs; `update_xr_plan` as
  `update_p_plan`; `restrict_plan` taking every (lane, aggregate) once
  for 1, 3, 4 and 12 lanes (two passes) and its Jacobi blocks every node
  of a lane once, at least 128 blocks of each role at phase 9's chunk;
  `vector_width` takes 16-byte loads where the node count allows them;
  `SegmentedState` allocates the loop's tensors and no scratch;
- the restriction's order: the kernel's tree (each lane keeping half of
  its values a step) gives each value the bits of lane 0 of a shuffle-down
  tree (the parent kernel's order), and a numpy emulation of that order
  (`restrict_emulation`) is the plain restriction within 1e-5 of its span;
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
within 1e-5 of y's span of its plain version. `cg_alpha` and `cg_update_p`
against their plain versions at a ragged node count, the production chunk
and 2 lanes of 4 segments of the largest bucket, f32 and f64, with a
stopped segment and a stopped lane: alpha within 1e-5 of its span (1e-12
in f64), the run and lane flags equal, p bit for bit. Each kernel repeats
its bits over 50 launches; replayed from a CUDA graph they give the bits of
their launches, counted at each replay; the wrappers raise on CPU, bf16,
non-contiguous and misaligned inputs (on a misaligned vector only where
the node count takes 16-byte loads). `cg_update_xr` and `jacobi_restrict`
(all three modes: both roles, the Jacobi term alone, the restriction
alone) against their plain versions at a ragged node count, the
production chunk, 2 lanes of 4 segments of the largest bucket and 12
lanes (two passes), f32 and f64: x, r and zj bit for bit (a stopped lane
keeps x and r; a stopped segment of a running lane takes x + 0 p, NaN
under an infinite p and +0.0 from -0.0), rc within 1e-5 of its span (1e-12
in f64) and bit for bit the emulation of the kernel's order, an
all-padding row 0; the same bits over 50 launches and under graph replay;
the wrappers raise on CPU, bf16, non-contiguous and misaligned inputs.
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


def thread_starts(n0, n1, vec):
    """The first nodes of a block's loads over [n0, n1), V = vec at a
    time: a thread t takes n0 + t V, then every THREADS V nodes on."""
    starts = [n0 + t * vec + i * cg.THREADS * vec
              for t in range(cg.THREADS) for i in range(-(-(n1 - n0) // (cg.THREADS * vec)))]
    return [n for n in starts if n < n1]


def assert_loads_cover(seg_nodes, blocks):
    """Every node of the segment loaded exactly once by the blocks' threads,
    at every vector width the node count takes; no load past a block's
    range."""
    for dtype in (torch.float32, torch.float64):
        vec = cg.vector_width(seg_nodes, dtype)
        seen = np.zeros(seg_nodes, np.int64)
        for n0, n1 in blocks:
            assert n0 % vec == 0
            for n in thread_starts(n0, n1, vec):
                assert n + vec <= n1
                seen[n:n + vec] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("seg_nodes", SHAPE_BUCKETS + RAGGED_NODES)
def test_alpha_plan_tiles_the_segment_once(seg_nodes):
    cluster, span = cg.alpha_plan(seg_nodes)
    blocks = [(b * span, min(seg_nodes, (b + 1) * span)) for b in range(cluster)]
    assert 1 <= cluster <= cg.ALPHA_CLUSTER <= 16 and span % 4 == 0
    if seg_nodes >= cg.ALPHA_CLUSTER * cg.PROLONG_NODES:
        assert cluster == cg.ALPHA_CLUSTER
    assert blocks[0][0] == 0 and blocks[-1][1] == seg_nodes
    for (_, a1), (b0, _) in zip(blocks, blocks[1:]):
        assert a1 == b0
    assert all(n1 > n0 for n0, n1 in blocks)  # no rank idles
    assert_loads_cover(seg_nodes, blocks)


@pytest.mark.parametrize("seg_nodes", SHAPE_BUCKETS + RAGGED_NODES)
def test_update_p_plan_covers_every_node_once(seg_nodes):
    count, span = cg.update_p_plan(seg_nodes)
    blocks = [(b * span, min(seg_nodes, (b + 1) * span)) for b in range(count)]
    assert count >= 1 and span % 4 == 0
    assert blocks[0][0] == 0 and blocks[-1][1] == seg_nodes
    for (_, a1), (b0, _) in zip(blocks, blocks[1:]):
        assert a1 == b0
    assert all(n1 > n0 for n0, n1 in blocks)
    assert_loads_cover(seg_nodes, blocks)


@pytest.mark.parametrize("seg_nodes", SHAPE_BUCKETS + RAGGED_NODES)
def test_update_xr_plan_covers_every_node_once(seg_nodes):
    count, span = cg.update_xr_plan(seg_nodes)
    blocks = [(b * span, min(seg_nodes, (b + 1) * span)) for b in range(count)]
    assert count >= 1 and span % 4 == 0
    assert blocks[0][0] == 0 and blocks[-1][1] == seg_nodes
    for (_, a1), (b0, _) in zip(blocks, blocks[1:]):
        assert a1 == b0
    assert all(n1 > n0 for n0, n1 in blocks)
    assert_loads_cover(seg_nodes, blocks)


def restricted(plan, lanes, aggregates):
    """How many times the restriction's warps take each (lane, aggregate),
    as the kernel's grid of plan.grid(...) blocks of plan.warps warps
    assigns them: warp w to pass w // NA of aggregate w % NA, the pass to
    its `plan.lanes` lanes (fewer in the last)."""
    _, passes, blocks = plan.grid(lanes, 1, aggregates)
    seen = np.zeros((lanes, aggregates), np.int64)
    for wid in range(blocks * plan.warps):
        if wid >= passes * aggregates:
            continue
        pass_, a = divmod(wid, aggregates)
        l0 = pass_ * plan.lanes
        seen[l0:min(lanes, l0 + plan.lanes), a] += 1
    return seen


@pytest.mark.parametrize("lanes", [1, 3, 4, 12])
@pytest.mark.parametrize("lane_nodes, aggregates", [(32768, 2048), (5005, 312), (1001, 1)])
def test_restrict_plan_covers_every_aggregate_and_lane_once(lanes, lane_nodes, aggregates):
    plan = cg.restrict_plan(lanes)
    assert plan.lanes in (1, 2, 4, 8) and 1 <= plan.warps <= cg.THREADS // 32
    assert plan.lanes >= min(lanes, cg.RESTRICT_LANES)  # one pass where the registers allow
    assert plan.lanes < 2 * lanes  # no pass of more lanes than it needs but a power of two
    assert (restricted(plan, lanes, aggregates) == 1).all()
    # the Jacobi blocks of a lane, each of blockDim = 32 warps threads
    # taking V nodes a load, cover the lane's nodes once
    jac, _, _ = plan.grid(lanes, lane_nodes, aggregates)
    blocks = [(b * plan.span, min(lane_nodes, (b + 1) * plan.span)) for b in range(jac)]
    assert plan.span % 4 == 0 and blocks[-1][1] == lane_nodes
    assert all(n1 > n0 for n0, n1 in blocks)
    for dtype in (torch.float32, torch.float64):
        vec = cg.vector_width(lane_nodes, dtype)
        seen = np.zeros(lane_nodes, np.int64)
        threads = 32 * plan.warps
        for n0, n1 in blocks:
            for t in range(threads):
                for n in range(n0 + t * vec, n1, threads * vec):
                    assert n + vec <= n1
                    seen[n:n + vec] += 1
        assert (seen == 1).all()


def shuffle_tree(values):
    """Each warp lane's sum after a shuffle-down tree over the last axis (32
    lanes), rounded at each step: lane i adds lane i + off (a lane past the
    warp its own value)."""
    v = values.copy()
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., np.where(lanes + off < 32, lanes + off, lanes)]
    return v


def halving_tree(values):
    """The kernel's `tree_sums` on (..., 32 lanes, N values), N a power of
    two: at each offset a lane adds its partner's (lane ^ off) partials,
    keeping the upper half of its values where the bit `off` of its lane is
    set and the lower half elsewhere while it holds more than one. The one
    value each lane ends with, (..., 32)."""
    v = values.copy()
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        partner, upper = lanes ^ off, ((lanes & off) != 0)[:, None]
        half = v.shape[-1] // 2
        if half:
            send = np.where(upper, v[..., :half], v[..., half:])
            v = np.where(upper, v[..., half:], v[..., :half]) + send[..., partner, :]
        else:
            v = v + v[..., partner, :]
    return v[..., 0]


def restrict_emulation(r, arms, members):
    """rc (L, NA, 3) in the order the restriction kernel sums it, in numpy
    at r's precision (each product and sum rounded): member w of a row on
    warp lane w mod 32, each warp lane's sums in the order of w, then lane 0
    of a shuffle-down tree over the 32 warp lanes. A padding entry adds 0,
    which leaves a sum that starts at +0 as it is."""
    r, arms, members = (t.cpu().numpy() for t in (r, arms, members))
    L, PN = r.shape[0], r.shape[1] // 2
    NA, W = members.shape
    sums = np.zeros((L, NA, 3, 32), r.dtype)
    for w in range(W):
        real = members[:, w] < PN
        m = np.where(real, members[:, w], 0)
        rx, ry = np.where(real, r[:, m], 0), np.where(real, r[:, PN + m], 0)
        ax, ay = np.where(real, arms[m, 0], 0), np.where(real, arms[m, 1], 0)
        sums[..., 0, w % 32] += rx
        sums[..., 1, w % 32] += ry
        sums[..., 2, w % 32] += (-ay * rx) + (ax * ry)
    return torch.from_numpy(shuffle_tree(sums)[..., 0])


@pytest.mark.parametrize("values", [4, 8, 16, 32])
def test_the_restriction_tree_gives_the_shuffle_down_sums(values):
    # the kernel's tree leaves value k on the lanes lid with lid / (32 / N)
    # == k, with the bits lane 0 of a shuffle-down tree (the order of the
    # kernel before it) ends with
    rng = np.random.default_rng(3)
    for dtype in (np.float32, np.float64):
        v = (rng.normal(size=(200, 32, values))
             * 10.0 ** rng.integers(-6, 6, (200, 32, values))).astype(dtype)
        down = shuffle_tree(np.swapaxes(v, 1, 2))[..., 0]  # (200, N)
        got = halving_tree(v)  # (200, 32)
        assert (got == down[:, np.arange(32) // (32 // values)]).all()
        assert not (np.swapaxes(v, 1, 2).cumsum(axis=-1)[..., -1] == down).all()  # order matters


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_restrict_emulation_is_the_plain_restriction(dtype):
    st = tc.random_state("cpu", dtype, 3, 5, 1001, seed=2)
    tables = tc.coarse_tables("cpu", dtype, 3, 5005, 312, 32, seed=3)
    rc = st.r.new_empty((3, 312, 3))
    cg.jacobi_restrict_reference(st.r, None, tables["arms"], tables["members"], None, rc)
    got = restrict_emulation(st.r, tables["arms"], tables["members"])
    span = float(rc.max() - rc.min())
    assert float((got - rc).abs().max()) <= tc.KERNEL_TOL[dtype] * span


def test_update_xr_and_restrict_fill_the_card_at_the_production_chunk():
    lanes, plates, nodes, aggregates = 4, 4, 8192, 4 * 512  # phase 9's chunk
    least = lanes * plates * cg.update_p_plan(nodes)[0]
    assert least == 128
    assert lanes * plates * cg.update_xr_plan(nodes)[0] >= least
    plan = cg.restrict_plan(lanes)
    jac, passes, res = plan.grid(lanes, plates * nodes, aggregates)
    assert passes == 1 and lanes * jac >= least and res >= least
    loads = cg.vector_width(plates * nodes, torch.float32) * 32 * plan.warps
    assert plan.span % loads == 0  # whole 16-byte loads a thread


def test_alpha_and_update_p_fill_the_card_at_the_production_chunk():
    lanes, plates, nodes, sms = 4, 4, 8192, 132  # phase 9's chunk; an H100's SMs
    cluster, _ = cg.alpha_plan(nodes)
    count, _ = cg.update_p_plan(nodes)
    assert lanes * plates * cluster == 128 <= sms
    assert lanes * plates * count == 128
    assert cg.vector_width(nodes, torch.float32) * cg.THREADS == cg.UPDATE_P_NODES  # one load each


def test_state_allocates_no_scratch():
    st = cg.SegmentedState(2, 3, 1000, torch.float32, "cpu", 10, 180)
    tensors = {n: v for n, v in vars(st).items() if isinstance(v, torch.Tensor)}
    assert sorted(tensors) == sorted(cg.SegmentedState.TENSORS)
    for name in ("partials", "tickets", "groups"):
        assert not hasattr(st, name)
    vectors, per_segment, per_lane = 4 * 2 * 6000 * 4, 2 * 3 * (6 * 4 + 4 + 2), 2 * (4 + 1)
    assert sum(t.numel() * t.element_size() for t in tensors.values()) == \
        vectors + per_segment + per_lane


def test_prolong_takes_16_byte_loads_at_every_bucket():
    for n in SHAPE_BUCKETS:
        assert cg.vector_width(n, torch.float32) == 4
        assert cg.vector_width(n, torch.float64) == 2
    assert cg.vector_width(1001, torch.float32) == 1
    assert cg.vector_width(1001, torch.float64) == 1
    assert cg.vector_width(1002, torch.float32) == 1
    assert cg.vector_width(1002, torch.float64) == 2


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
    band.band_matvec_reference(op.vals, op.cols, u, want_plain)
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
    band.band_matvec_reference(vals, cols, u, plain)
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


# L lanes, P plates, Ns nodes a plate: the scalar route, the production
# chunk, and 2 lanes of 4 segments of the largest bucket (clusters of 16)
ALPHA_P_SHAPES = {"ragged": (3, 5, 1001), "chunk": (4, 4, 8192), "bucket 131072": (2, 4, 131072)}


def alpha_p_case(device, dtype, shape):
    """A random loop state (tests/test_torch_cg_kernels.py) with segment
    (0, last) stalled and lane 0 at its budget, so alpha stops both; lane 0
    and segment (last, 0) not running, so update_p leaves their p; and Ap."""
    L, P, Ns = ALPHA_P_SHAPES[shape]
    st = tc.random_state(device, dtype, L, P, Ns, seed=7)
    st.stall[0, -1] = st.stall_limit
    st.k[0] = st.max_iters
    st.lane[0], st.lane[-1] = False, True
    st.run[-1, 0], st.run[-1, -1] = False, True
    scale = np.random.default_rng(8).uniform(0.5, 1.5, size=tuple(st.p.shape))
    return st, st.p * torch.from_numpy(scale).to(device, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", ALPHA_P_SHAPES)
def test_alpha_and_update_p_match_their_plain_versions(shape, dtype):
    device = tc.cuda_or_skip()
    st, Ap = alpha_p_case(device, dtype, shape)
    for kernel, plain, args in ((cg.cg_alpha, cg.cg_alpha_reference, (Ap,)),
                                (cg.cg_update_p, cg.cg_update_p_reference, ())):
        mine, theirs = st.clone(), st.clone()
        before = kernel.launches
        kernel(mine, *args)
        plain(theirs, *args)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        # alpha within the tolerance of its span, every other tensor (p
        # included) bit for bit
        tc.compare(kernel.__name__, tc.outputs(mine, {}), tc.outputs(theirs, {}),
                   tc.KERNEL_TOL[dtype])
        if kernel is cg.cg_alpha:  # the stopped segment and lane
            assert not mine.run[0, -1] and float(mine.alpha[0, -1]) == 0.0 and not mine.lane[0]
            assert bool(mine.run.any()) and bool(mine.lane.any())
        else:
            assert torch.equal(mine.p[0], st.p[0])
            assert torch.equal(st.segments(mine.p)[-1, :, 0], st.segments(st.p)[-1, :, 0])
            assert not torch.equal(st.segments(mine.p)[-1, :, -1], st.segments(st.p)[-1, :, -1])


@pytest.mark.gpu
def test_alpha_and_update_p_repeat_their_bits():
    device = tc.cuda_or_skip()
    st, Ap = alpha_p_case(device, torch.float32, "chunk")
    first_alpha, first_p = st.clone(), st.clone()
    cg.cg_alpha(first_alpha, Ap)
    cg.cg_update_p(first_p)
    for _ in range(50):
        a, p = st.clone(), st.clone()
        cg.cg_alpha(a, Ap)
        cg.cg_update_p(p)
        for n in cg.SegmentedState.TENSORS:
            assert torch.equal(getattr(a, n), getattr(first_alpha, n)), n
            assert torch.equal(getattr(p, n), getattr(first_p, n)), n


@pytest.mark.gpu
def test_a_graph_of_alpha_and_update_p_replays_bit_for_bit():
    device = tc.cuda_or_skip()
    st, Ap = alpha_p_case(device, torch.float32, "chunk")
    eager, graphed = st.clone(), st.clone()

    def body(s):
        cg.cg_alpha(s, Ap)
        cg.cg_update_p(s)

    for _ in range(3):
        body(eager)
    block = cg.capture(lambda: body(graphed), lambda: None, device)
    counts = (cg.cg_alpha.launches, cg.cg_update_p.launches)
    for _ in range(3):
        block.replay()
    torch.cuda.synchronize()
    block.close()
    assert (cg.cg_alpha.launches, cg.cg_update_p.launches) == (counts[0] + 3, counts[1] + 3)
    for n in cg.SegmentedState.TENSORS:
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


@pytest.mark.gpu
def test_alpha_and_update_p_raise_on_what_the_kernels_do_not_take():
    device = tc.cuda_or_skip()
    st, Ap = alpha_p_case(device, torch.float32, "chunk")
    with pytest.raises(ValueError):
        cg.cg_alpha(st, Ap.cpu())
    with pytest.raises(ValueError):
        cg.cg_alpha(st, Ap.to(torch.bfloat16))
    with pytest.raises(ValueError):
        cg.cg_alpha(st, Ap.T.contiguous().T)
    with pytest.raises(ValueError, match="16-byte"):
        cg.cg_alpha(st, misaligned(Ap))
    off = st.clone()
    off.beta = off.beta.cpu()
    with pytest.raises(ValueError):
        cg.cg_update_p(off)
    off = st.clone()
    off.beta = off.beta.to(torch.float64)
    with pytest.raises(ValueError):
        cg.cg_update_p(off)
    off = st.clone()
    off.z = misaligned(off.z)
    with pytest.raises(ValueError, match="16-byte"):
        cg.cg_update_p(off)
    with pytest.raises(TypeError):
        cg.SegmentedState(2, 2, 64, torch.bfloat16, device, 10, 180)
    # the scalar route of a ragged node count takes a misaligned vector
    st, Ap = alpha_p_case(device, torch.float32, "ragged")
    mine, plain = st.clone(), st.clone()
    cg.cg_alpha(mine, misaligned(Ap))
    cg.cg_alpha_reference(plain, Ap)
    tc.compare("cg_alpha", tc.outputs(mine, {}), tc.outputs(plain, {}), tc.KERNEL_TOL[torch.float32])
    mine.z, plain.z = misaligned(mine.z), plain.z
    cg.cg_update_p(mine)
    cg.cg_update_p_reference(plain)
    assert torch.equal(mine.p, plain.p)


# L lanes, P plates, Ns nodes a plate, NA aggregates, W members at most: the
# scalar route (3 lanes in a pass of 4), the production chunk, 2 lanes of 4
# segments of the largest bucket (rows of 129 members) and 12 lanes (two
# passes, the second of 4)
XR_SHAPES = {"ragged": (3, 5, 1001, 312, 32), "chunk": (4, 4, 8192, 2048, 32),
             "bucket 131072": (2, 4, 131072, 4096, 136), "12 lanes": (12, 2, 1024, 128, 24)}
MODES = {"both": ("block_inv", "members"), "jacobi": ("block_inv",), "restrict": ("members",)}


def same_bits(a, b):
    """a and b hold the same bits (NaNs included)."""
    ints = {1: torch.uint8, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


def xr_case(device, dtype, shape):
    """The alpha_p_case state at a shape of XR_SHAPES (lane 0 stopped, the
    last lane running), its last lane's segment 0 stopped (alpha 0) with a
    node of p infinite and a node of x -0.0 (p 1.0 there), which x + 0 p
    makes NaN and +0.0; Ap; and the coarse tables with an all-padding row first and
    last."""
    L, P, Ns, NA, W = XR_SHAPES[shape]
    st = tc.random_state(device, dtype, L, P, Ns, seed=7)
    st.lane[0], st.lane[-1] = False, True
    st.alpha[-1, 0] = 0.0
    st.segments(st.p)[-1, 0, 0, 3] = float("inf")
    st.segments(st.x)[-1, 1, 0, 5] = -0.0
    st.segments(st.p)[-1, 1, 0, 5] = 1.0  # -0.0 + 0 * 1.0 is +0.0
    scale = np.random.default_rng(8).uniform(0.5, 1.5, size=tuple(st.p.shape))
    tables = tc.coarse_tables(device, dtype, L, P * Ns, NA - 2, W, seed=9)
    pad = torch.full((1, W), P * Ns, dtype=torch.int32, device=device)
    tables["members"] = torch.cat([pad, tables["members"], pad]).contiguous()
    return st, st.p * torch.from_numpy(scale).to(device, dtype), tables


def run_jacobi(fn, r, tables, mode):
    L, NA = r.shape[0], tables["members"].shape[0]
    given = {name: tables[name] if name in MODES[mode] else None for name in ("block_inv", "members")}
    out = {"zj": torch.full_like(r, 7.0) if given["block_inv"] is not None else None,
           "rc": r.new_full((L, NA, 3), 7.0) if given["members"] is not None else None}
    fn(r, given["block_inv"], tables["arms"], given["members"], out["zj"], out["rc"])
    return {k: v for k, v in out.items() if v is not None}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", XR_SHAPES)
def test_update_xr_matches_its_plain_version(shape, dtype):
    device = tc.cuda_or_skip()
    st, Ap, _ = xr_case(device, dtype, shape)
    mine, plain = st.clone(), st.clone()
    before = cg.cg_update_xr.launches
    cg.cg_update_xr(mine, Ap)
    cg.cg_update_xr_reference(plain, Ap)
    torch.cuda.synchronize()
    assert cg.cg_update_xr.launches == before + 1
    for name in cg.SegmentedState.TENSORS:  # x and r bit for bit, the rest untouched
        assert same_bits(getattr(mine, name), getattr(plain, name)), name
    assert same_bits(mine.x[0], st.x[0]) and same_bits(mine.r[0], st.r[0])  # the stopped lane
    # the stopped segment of a running lane takes x + 0 p, as fea_tpu does
    assert torch.isnan(st.segments(mine.x)[-1, 0, 0, 3])
    x0 = st.segments(mine.x)[-1, 1, 0, 5]
    assert float(x0) == 0.0 and not bool(torch.signbit(x0))
    assert not torch.equal(mine.x[-1], st.x[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", XR_SHAPES)
def test_jacobi_restrict_matches_its_plain_version(shape, dtype, mode):
    device = tc.cuda_or_skip()
    st, _, tables = xr_case(device, dtype, shape)
    before = cg.jacobi_restrict.launches
    got = run_jacobi(cg.jacobi_restrict, st.r, tables, mode)
    want = run_jacobi(cg.jacobi_restrict_reference, st.r, tables, mode)
    torch.cuda.synchronize()
    assert cg.jacobi_restrict.launches == before + 1
    assert sorted(got) == sorted({"both": ["rc", "zj"], "jacobi": ["zj"], "restrict": ["rc"]}[mode])
    if "zj" in got:
        assert same_bits(got["zj"], want["zj"])
    if "rc" in got:
        # within the tolerance of the plain version's sums, bit for bit the
        # kernel's order (the parent kernel's); the padding rows 0
        tc.compare("jacobi_restrict", {"rc": got["rc"]}, {"rc": want["rc"]}, tc.KERNEL_TOL[dtype])
        emulated = restrict_emulation(st.r, tables["arms"], tables["members"]).to(device)
        assert same_bits(got["rc"], emulated)
        for row in (0, -1):
            assert not got["rc"][:, row].any() and not torch.signbit(got["rc"][:, row]).any()


@pytest.mark.gpu
def test_update_xr_and_jacobi_restrict_repeat_their_bits_and_replay_them():
    device = tc.cuda_or_skip()
    st, Ap, tables = xr_case(device, torch.float32, "chunk")
    first = st.clone()
    cg.cg_update_xr(first, Ap)
    first_out = run_jacobi(cg.jacobi_restrict, first.r, tables, "both")
    for _ in range(50):
        again = st.clone()
        cg.cg_update_xr(again, Ap)
        out = run_jacobi(cg.jacobi_restrict, again.r, tables, "both")
        assert same_bits(again.x, first.x) and same_bits(again.r, first.r)
        for name in out:
            assert same_bits(out[name], first_out[name]), name
    eager, graphed = st.clone(), st.clone()
    outs = {id(s): {"zj": torch.empty_like(s.r), "rc": s.r.new_empty((s.r.shape[0], tables["members"].shape[0], 3))}
            for s in (eager, graphed)}

    def body(s):
        cg.cg_update_xr(s, Ap)
        o = outs[id(s)]
        cg.jacobi_restrict(s.r, tables["block_inv"], tables["arms"], tables["members"], o["zj"], o["rc"])

    for _ in range(3):
        body(eager)
    block = cg.capture(lambda: body(graphed), lambda: None, device)
    counts = (cg.cg_update_xr.launches, cg.jacobi_restrict.launches)
    for _ in range(3):
        block.replay()
    torch.cuda.synchronize()
    block.close()
    assert (cg.cg_update_xr.launches, cg.jacobi_restrict.launches) == (counts[0] + 3, counts[1] + 3)
    for name in cg.SegmentedState.TENSORS:
        assert same_bits(getattr(graphed, name), getattr(eager, name)), name
    for name in ("zj", "rc"):
        assert same_bits(outs[id(graphed)][name], outs[id(eager)][name]), name


@pytest.mark.gpu
def test_update_xr_and_jacobi_restrict_raise_on_what_the_kernels_do_not_take():
    device = tc.cuda_or_skip()
    st, Ap, tables = xr_case(device, torch.float32, "chunk")
    with pytest.raises(ValueError):
        cg.cg_update_xr(st, Ap.cpu())
    with pytest.raises(ValueError):
        cg.cg_update_xr(st, Ap.to(torch.bfloat16))
    with pytest.raises(ValueError):
        cg.cg_update_xr(st, Ap.T.contiguous().T)
    with pytest.raises(ValueError, match="16-byte"):
        cg.cg_update_xr(st, misaligned(Ap))
    off = st.clone()
    off.x = misaligned(off.x)
    with pytest.raises(ValueError, match="16-byte"):
        cg.cg_update_xr(off, Ap)
    r, (block_inv, arms, members) = st.r, (tables[n] for n in ("block_inv", "arms", "members"))
    L, NA = r.shape[0], members.shape[0]
    zj, rc = torch.empty_like(r), r.new_empty((L, NA, 3))
    with pytest.raises(ValueError):
        cg.jacobi_restrict(r, block_inv.cpu(), arms, members, zj, rc)
    with pytest.raises(ValueError):
        cg.jacobi_restrict(r, block_inv, arms, members.cpu(), zj, rc)
    with pytest.raises(TypeError):
        cg.jacobi_restrict(r.bfloat16(), block_inv.bfloat16(), arms.bfloat16(), members,
                           zj.bfloat16(), rc.bfloat16())
    with pytest.raises(ValueError):
        cg.jacobi_restrict(r, block_inv.transpose(0, 1).contiguous().transpose(0, 1), arms,
                           members, zj, rc)
    with pytest.raises(ValueError):
        cg.jacobi_restrict(r, block_inv, arms, members.long(), zj, rc)
    for name in ("r", "block_inv", "zj"):
        args = {"r": r, "block_inv": block_inv, "zj": zj}
        args[name] = misaligned(args[name])
        with pytest.raises(ValueError, match="16-byte"):
            cg.jacobi_restrict(args["r"], args["block_inv"], arms, members, args["zj"], rc)
    # the restriction alone, and the scalar route of a ragged node count,
    # take a misaligned r
    got = r.new_empty((L, NA, 3))
    cg.jacobi_restrict(misaligned(r), None, arms, members, None, got)
    cg.jacobi_restrict_reference(r, None, arms, members, None, rc)
    tc.compare("jacobi_restrict", {"rc": got}, {"rc": rc}, tc.KERNEL_TOL[torch.float32])
    st, Ap, tables = xr_case(device, torch.float32, "ragged")
    mine, plain = st.clone(), st.clone()
    mine.x, mine.r = misaligned(mine.x), misaligned(mine.r)
    cg.cg_update_xr(mine, misaligned(Ap))
    cg.cg_update_xr_reference(plain, Ap)
    assert same_bits(mine.x, plain.x) and same_bits(mine.r, plain.r)
    got = run_jacobi(cg.jacobi_restrict, misaligned(st.r), tables, "jacobi")
    want = run_jacobi(cg.jacobi_restrict_reference, st.r, tables, "jacobi")
    assert same_bits(got["zj"], want["zj"])
