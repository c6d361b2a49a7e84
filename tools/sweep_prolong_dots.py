"""The CG loop's kernels whose launch plans are chosen on the host
(csrc/cg_segmented.cu: `prolong_dots`, `cg_alpha`, `cg_update_p`,
`cg_update_xr`, `jacobi_restrict`) at the plans they can take, checked and
timed side by side on a CUDA card: at the production chunk, at chunks of
few segments and at the largest node bucket.

    python3 tools/sweep_prolong_dots.py [--against NAME=TREE ...]
        [--kernels prolong_dots,cg_alpha,cg_update_p,cg_update_xr,jacobi_restrict]
        [--clusters 8,16] [--spans 512,1024,2048] [--warps 1,2,4,8] [--bodies ROUNDS] [--table PATH]

For phase 9's chunk with its own loop state 20 bodies in and its own
tables (as chip_smoke.py phase 16 has them), and for each shape (L lanes
of P plates of Ns nodes, f32; a random loop state
whose lanes and segments run, stop and stall, contiguous aggregates of
about 25 nodes, 10% of the dofs fixed; for the restriction a member table
laid out as a chunk's, `member_table`) and each kernel: this tree's kernel
with the plan that `ops.cg` picks (marked `*`: `prolong_plan`,
`alpha_plan`, `update_p_plan`, `update_xr_plan`, `restrict_plan`), with
each cluster size of `--clusters` (`prolong_dots`, `cg_alpha`), each node
count a block of `--spans` (`cg_update_p`, `cg_update_xr`, and the Jacobi
blocks of `jacobi_restrict`), and for `jacobi_restrict` each warp count a
restriction block of `--warps` and the other role first, one change from
its plan at a time; and the kernel of each other checkout of this repo
given as `--against NAME=TREE` (with its own plan, and with the plans
swept where it has the plan function; its `cg_alpha` on a copy of the
state with the scratch it took). Each variant is first held against the
plain version (z, p, x, r and zj bit for bit; rz, r2, beta, best and
alpha within 1e-5 of each value's size, as random segments' sums are alike
and their span a few ulps wide; rc within 1e-5 of its span; the flags,
stall and k equal) and against
this tree's kernel at its plan (every output bit for bit where the two sum
in one order: all but `cg_alpha`'s and `prolong_dots`' sums), and run
twice for the same bits, then all are timed in turns on the device as
chip_smoke.py times kernels. Per variant: ms per call and the share of the
HBM rate that the launch's bytes (chip_smoke's byte counts: each input
read once, each output written once) reach in that time.

`--bodies ROUNDS` also times whole loop bodies on phase 9's chunk (the
state 20 bodies in, as chip_smoke.py phase 16 makes it): per tree, a CUDA
graph of a block of CHECK_EVERY bodies whose five CG kernels are that
tree's (the band operator and the coarse product this tree's), replayed 4
times from the same state in each of ROUNDS rounds of turns (in order,
then in reverse); device ms per body by CUDA events around the replays (no
host read between blocks), and each tree's state after the replays held
bit for bit against this tree's where its kernels sum in this tree's
order.
"""

import argparse
import contextlib
import functools
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from chip_smoke import CG_KERNEL_REL, EARLIER_EQUAL, HBM_BYTES_PER_S, log  # noqa: E402

# (L lanes, P plates, Ns nodes a plate)
SHAPES = (
    (4, 4, 8192),     # phase 9's chunk's shape
    (4, 1, 8192),     # 4 segments at the production bucket
    (4, 4, 32768),
    (1, 4, 131072),   # 4 segments at the largest bucket
    (4, 4, 131072),   # the largest bucket, 16 segments
)
NODES_PER_AGGREGATE = 25  # phase 9's chunk: 1,280 aggregates over 32,768 nodes
SUMMED = ("rz", "r2", "best", "beta", "alpha")
SPAN_SUMMED = ("rc",)  # sums of a few random values, some near 0: held to their span
REAL_SHARE = 0.7  # phase 9's plates: 4,777-6,254 real nodes of their bucket's 8,192
USED_ROWS = 484 / 512  # phase 9's plates: 484 grid cells of n_coarse 512 at most


def member_table(device, P, Ns, seed):
    """A chunk's member table (P n_coarse, W) as `flatgroup` builds it:
    `n_coarse_for_bucket(Ns)` rows a plate, a plate's first REAL_SHARE of
    nodes real (the rest ghosts, left out), each at a random one of the
    plate's first USED_ROWS of rows; the other rows all padding."""
    import numpy as np

    from fea_tpu_torch.fem.coarse import aggregate_members, n_coarse_for_bucket
    from fea_tpu_torch.fem.flatgroup import flatten_members

    rng = np.random.default_rng(seed)
    n_coarse, n_real = n_coarse_for_bucket(Ns), int(REAL_SHARE * Ns)
    tables = []
    for _ in range(P):
        agg = np.full(Ns, n_coarse - 1, np.int64)
        agg[:n_real] = rng.integers(0, int(USED_ROWS * n_coarse), n_real)
        tables.append(aggregate_members(agg, n_coarse, n_real))
    width = max(t.shape[1] for t in tables)
    members = np.full((P, n_coarse, width), Ns, np.int32)
    for p, t in enumerate(tables):
        members[p, :, :t.shape[1]] = t
    flat = flatten_members(torch.from_numpy(members), Ns)
    return flat.to(device=device, dtype=torch.int32).contiguous()


def case(device, L, P, Ns, seed):
    """(state, inputs of the launches but the state, aggregates) at a shape."""
    from fea_tpu_torch.ops import cg

    g = torch.Generator(device).manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=g, device=device)  # noqa: E731
    randn = lambda *shape: torch.randn(shape, generator=g, device=device)  # noqa: E731
    PN, ndof = P * Ns, 2 * P * Ns
    NA = max(1, PN // NODES_PER_AGGREGATE)
    st = cg.SegmentedState(L, P, Ns, torch.float32, device, 1000, 180)
    for t in (st.r, st.p, st.z):
        t.copy_(randn(L, ndof))
    st.r2.copy_(1 + 9 * rand(L, P))
    st.atol2.copy_(st.r2 * torch.where(rand(L, P) < 0.8, 0.1, 10.0))
    st.active.copy_(rand(L, P) < 0.9)
    st.rz.copy_(0.5 + 4.5 * rand(L, P))
    st.best.copy_(st.r2 * torch.where(rand(L, P) < 0.5, 0.5, 2.0))
    st.beta.copy_(1.5 * rand(L, P))
    st.stall.copy_((rand(L, P) * 181).to(torch.int32))
    st.run.copy_(rand(L, P) < 0.7)
    st.lane.copy_(rand(L) < 0.8)
    st.lane[0] = True
    agg = (torch.arange(PN, device=device) * NA // PN).to(torch.int32)
    inputs = dict(zj=st.r * 1.5 + 0.1 * st.p, zc=0.01 * randn(L, NA * 3), agg=agg,
                  arms=randn(PN, 2), free=(rand(L, ndof) < 0.9).float(),
                  Ap=st.p * (0.5 + rand(L, ndof)), block_inv=randn(L, 2, 2, PN),
                  members=member_table(device, P, Ns, seed))
    return st, inputs, NA


def prolong_launch(fn, st, inputs):
    fn(inputs["zj"], inputs["zc"], inputs["agg"], inputs["arms"], inputs["free"], st.z, st.P, st)
    return {name: getattr(st, name) for name in ("z", "rz", "r2", "best", "beta", "stall", "k")}


def alpha_launch(fn, st, inputs):
    fn(st, inputs["Ap"])
    return {name: getattr(st, name) for name in ("alpha", "run", "lane")}


def update_p_launch(fn, st, inputs):
    fn(st)
    return {"p": st.p}


def update_xr_launch(fn, st, inputs):
    fn(st, inputs["Ap"])
    return {"x": st.x, "r": st.r}


def jacobi_launch(fn, st, inputs):
    L, members = st.k.shape[0], inputs["members"]
    out = {"zj": torch.empty_like(st.r), "rc": st.r.new_empty((L, members.shape[0], 3))}
    fn(st.r, inputs["block_inv"], inputs["arms"], members, out["zj"], out["rc"])
    return out


def span_plans(own, args, shape):
    """(label, plan) of cg_update_p / cg_update_xr at each of `--spans`
    nodes a block."""
    Ns = shape[2]
    return [(str(span), (-(-Ns // span), span)) for span in args.spans]


def cluster_plans(own, args, shape):
    """(label, plan) at each cluster size of `--clusters`, spans a multiple
    of 4; none where a rank would get no node."""
    Ns = shape[2]
    for cluster in args.clusters:
        span = -(-(-(-Ns // cluster)) // 4) * 4
        if (cluster - 1) * span < Ns:
            yield str(cluster), (cluster, span)


def restrict_plans(own, args, shape):
    """(label, plan) of jacobi_restrict, one change from its own plan at a
    time: the Jacobi blocks' nodes (`--spans`), the restriction blocks'
    warps (`--warps`), and the other role first."""
    for span in args.spans:
        yield f"span {span}", own._replace(span=span)
    for warps in args.warps:
        yield f"warps {warps}", own._replace(warps=warps)
    yield ("restriction first" if own.jacobi_first else "Jacobi first",
           own._replace(jacobi_first=not own.jacobi_first))


def segment_args(L, P, Ns, members):
    return (Ns,)


def restrict_args(L, P, Ns, members):
    return (L,)


# {kernel: (launch(fn, state, inputs) -> outputs, its plan function's name
# in ops.cg, the plan function's arguments at a shape, the plans swept)}
KERNELS = {
    "prolong_dots": (prolong_launch, "prolong_plan", segment_args, cluster_plans),
    "cg_alpha": (alpha_launch, "alpha_plan", segment_args, cluster_plans),
    "cg_update_p": (update_p_launch, "update_p_plan", segment_args, span_plans),
    "cg_update_xr": (update_xr_launch, "update_xr_plan", segment_args, span_plans),
    "jacobi_restrict": (jacobi_launch, "restrict_plan", restrict_args, restrict_plans),
}


def launch_bytes(kernel, st, inputs, NA):
    L, P, Ns = st.k.shape[0], st.P, st.Ns
    if kernel == "prolong_dots":
        return chip_smoke.prolong_dots_bytes(L, P, Ns, NA, 4)
    if kernel == "cg_alpha":
        return chip_smoke.cg_alpha_bytes(L, P, Ns, 4)
    if kernel == "cg_update_xr":
        return chip_smoke.cg_update_xr_bytes(L, P, Ns, 4, float(st.lane.float().mean()))
    if kernel == "jacobi_restrict":
        members = inputs["members"]
        return chip_smoke.jacobi_restrict_bytes(L, P * Ns, *members.shape,
                                                int((members < P * Ns).sum()), 4)
    share = float((st.run & st.lane[:, None]).float().mean())
    return chip_smoke.cg_update_p_bytes(L, P, Ns, 4, share)


@contextlib.contextmanager
def plan_of(cg_module, name, plan):
    """`cg_module.<name>` (a plan function) set to give `plan` (None: its
    own)."""
    own = getattr(cg_module, name, None)
    if plan is not None:
        setattr(cg_module, name, lambda *args: plan)
    try:
        yield
    finally:
        if plan is not None:
            setattr(cg_module, name, own)


def variants(trees, kernel, shape, inputs, args):
    """{name: (fn, ops.cg module)} of every tree's kernel at its own plan
    and at each plan swept."""
    _, plan_name, plan_args, plans = KERNELS[kernel]
    out = {}
    for tree, cg_module in trees.items():
        own = getattr(cg_module, plan_name, None)
        out[f"{tree}*" if own else tree] = (cg_module, None)
        if own is None:
            continue
        mine = own(*plan_args(*shape, inputs["members"]))
        for label, swept in plans(mine, args, shape):
            if swept != mine:
                out[f"{tree}/{label}"] = (cg_module, swept)
    fns = {}
    for name, (cg_module, swept) in out.items():
        def fn(*args, cg_module=cg_module, swept=swept):
            with plan_of(cg_module, plan_name, swept):
                getattr(cg_module, kernel)(*args)
        fns[name] = (fn, cg_module)
    return fns


BODY_REPLAYS = 4  # blocks of bodies a timed run replays


@functools.cache
def phase9_chunk():
    """(state, operator, preconditioner) of phase 9's chunk on the card,
    the state 20 bodies in (chip_smoke.py phase 16's)."""
    from fea_tpu_torch.datagen.batched import chunk_inputs, chunk_keywords, chunk_tables
    from fea_tpu_torch.fem.flatgroup import chunk_system

    device = torch.device("cuda")
    chunk = chip_smoke.chunk_payloads(device, banded=True)
    solvers, host, m_real, band_hb = chunk_inputs(chunk)
    kw = chunk_keywords(solvers, band_hb)
    tables, m_real_p = chunk_tables(solvers, host, m_real, device)
    system = chunk_system(*tables, m_real_p=m_real_p, n_coarse=kw["n_coarse"], band_hb=band_hb)
    st, A = chip_smoke.chunk_state(system, len(chunk), kw["tol"], kw["max_iters"],
                                   chip_smoke.CG_STATE_BODIES)
    return st, A, system.precondition


def chunk_case():
    """`case`'s (state, inputs, aggregates) at phase 9's chunk itself: its
    loop state 20 bodies in and its preconditioner's tables."""
    st, A, pre = phase9_chunk()
    zj, zc = pre.parts(st.r)
    agg, arms, free = pre.finish
    inputs = dict(zj=zj, zc=zc, agg=agg, arms=arms, free=free, Ap=A(st.p),
                  block_inv=pre.block_inv, members=pre.members)
    return st.clone(), inputs, pre.members.shape[0]


def body_rows(trees, rounds):
    """Rows of device ms per loop body on phase 9's chunk, each tree's
    five CG kernels in a captured block of bodies (`--bodies`)."""
    from unittest import mock

    from fea_tpu_torch.fem.solver import CHECK_EVERY, segmented_body
    from fea_tpu_torch.ops import cg

    device = torch.device("cuda")
    st, A, pre = phase9_chunk()
    states, blocks = {}, {}
    for tree, cg_module in trees.items():
        if hasattr(cg_module, "LIBRARY"):  # loaded outside the capture
            cg_module.LIBRARY.loaded(0)
        else:  # a checkout from before the binder
            cg_module.load(0)
        s = states[tree] = chip_smoke.earlier_state(st, cg_module)

        def block(s=s):
            for _ in range(CHECK_EVERY):
                segmented_body(s, A, pre)

        with contextlib.ExitStack() as stack:
            for wrapper in cg.WRAPPERS:
                name = wrapper.__name__
                stack.enter_context(mock.patch.object(cg, name, getattr(cg_module, name)))
            blocks[tree] = cg.capture(block, lambda s=s: (A(s.p), pre.parts(s.r)), device)
    names = list(trees)
    ms = {tree: [] for tree in names}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(rounds):
        for tree in names + names[::-1]:
            for name in cg.SegmentedState.TENSORS:
                getattr(states[tree], name).copy_(getattr(st, name))
            torch.cuda.synchronize()
            torch.cuda._sleep(chip_smoke.QUEUE_CYCLES)
            start.record()
            for _ in range(BODY_REPLAYS):
                blocks[tree].replay()
            end.record()
            torch.cuda.synchronize()
            ms[tree].append(start.elapsed_time(end) / (BODY_REPLAYS * CHECK_EVERY))
    rows = []
    lanes = int(states["this"].lane.sum())
    for tree in names:
        same = all(torch.equal(getattr(states[tree], n), getattr(states["this"], n))
                   for n in cg.SegmentedState.TENSORS)
        v = sorted(ms[tree])
        rows.append(f"body (phase 9's chunk, graph of {CHECK_EVERY} bodies x {BODY_REPLAYS}, "
                    f"{len(v)} runs) {tree:11s} ms per body mean {sum(v) / len(v):.5f}, median "
                    f"{v[len(v) // 2]:.5f} [{v[0]:.5f}, {v[-1]:.5f}]; the state bit for bit "
                    f"this tree's: {same}")
        log(rows[-1])
    log(f"body: {lanes} of {st.k.shape[0]} lanes still running after the timed bodies")
    for block in blocks.values():
        block.close()
    return rows


def numbers(text):
    return [int(v) for v in text.split(",") if v]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", metavar="NAME=TREE", action="append", default=[])
    parser.add_argument("--kernels", default=",".join(KERNELS))
    parser.add_argument("--clusters", default="8,16", type=numbers)
    parser.add_argument("--spans", default="512,1024,2048", type=numbers)
    parser.add_argument("--warps", default="1,2,4,8", type=numbers)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--bodies", type=int, default=0, metavar="ROUNDS")
    parser.add_argument("--table", metavar="PATH")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("sweep_prolong_dots: no CUDA device", file=sys.stderr)
        return 1
    from fea_tpu_torch.ops import cg

    device = torch.device("cuda")
    trees = {"this": cg}
    for spec in args.against:
        name, tree = spec.split("=", 1)
        ops = chip_smoke.load_ops(tree, f"sweep_{name}_fea_tpu_torch")
        trees[name] = chip_smoke.earlier_module(ops, "cg")
    for tree, cg_module in trees.items():
        lib = chip_smoke.library_build(cg_module)()
        log(f"{tree}: {lib}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log("  nvcc: " + line.strip())
    rows = body_rows(trees, args.bodies) if args.bodies else []
    for kernel in filter(None, args.kernels.split(",")):
        launch = KERNELS[kernel][0]
        for L, P, Ns in ((None, None, None),) + SHAPES:
            if L is None:  # phase 9's chunk with its own state and tables
                st, inputs, NA = chunk_case()
                L, P, Ns, where = st.k.shape[0], st.P, st.Ns, "phase 9's state"
            else:
                st, inputs, NA = case(device, L, P, Ns, seed=L * P + Ns)
                where = "random state"
            plain = getattr(cg, kernel + "_reference")
            want = launch(plain, st.clone(), inputs)
            mine = launch(getattr(cg, kernel), st.clone(), inputs)
            timed = {}
            for name, (fn, cg_module) in variants(trees, kernel, (L, P, Ns), inputs, args).items():
                got, again = (launch(fn, chip_smoke.earlier_state(st, cg_module), inputs)
                              for _ in range(2))
                torch.cuda.synchronize()
                if any(not torch.equal(got[k], again[k]) for k in got):
                    raise AssertionError(f"{kernel} {name} at {(L, P, Ns)}: two runs differ")
                for k in got:
                    a, b = got[k].double(), want[k].double()
                    if k in SPAN_SUMMED:
                        rel = float((a - b).abs().max()) / max(float(b.max() - b.min()), 1e-30)
                    else:
                        rel = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                    if rel > (CG_KERNEL_REL if k in SUMMED + SPAN_SUMMED else 0.0):
                        raise AssertionError(f"{kernel} {name} at {(L, P, Ns)}: {k} {rel:.3e} "
                                             f"off plain")
                differ = [k for k in EARLIER_EQUAL[kernel] if not torch.equal(got[k], mine[k])]
                if differ:
                    raise AssertionError(f"{kernel} {name} at {(L, P, Ns)}: {differ} not this "
                                         f"tree's kernel's bits")
                s = chip_smoke.earlier_state(st, cg_module)
                timed[name] = lambda fn=fn, s=s: launch(fn, s, inputs)
            ms = chip_smoke.in_turns(timed, args.iters)
            nbytes = launch_bytes(kernel, st, inputs, NA)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            for name, t in ms.items():
                rows.append(f"{kernel:12s} L {L} P {P} Ns {Ns:6d} ({L * P:2d} segments, {where}, "
                            f"{nbytes / 1e6:7.3f} MB, bound {bound:.5f} ms) {name:11s} {t:.5f} ms  "
                            f"{bound / t:.3f} of the HBM rate")
                log(rows[-1])
            del st, inputs, want, mine, timed
    smi = chip_smoke.nvidia_smi()
    log(smi)
    if args.table:
        Path(args.table).parent.mkdir(parents=True, exist_ok=True)
        Path(args.table).write_text("\n".join(rows + [smi]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
