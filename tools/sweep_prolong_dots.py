"""`prolong_dots` (csrc/cg_segmented.cu) at the cluster sizes it can take,
checked and timed side by side on a CUDA card: at the production chunk,
at chunks of few segments and at the largest node bucket.

    python3 tools/sweep_prolong_dots.py [--against NAME=TREE ...] [--clusters 4,8,16] [--table PATH]

For each shape (L lanes of P plates of Ns nodes, f32; a random loop state
whose lanes and segments run, stop and stall, contiguous aggregates of
about 25 nodes, 10% of the dofs fixed): this tree's kernel with the
cluster that `ops.cg.prolong_plan` picks (marked `*`) and with each
cluster size of `--clusters`, and the `prolong_dots` of each other
checkout of this repo given as `--against NAME=TREE` (with its own plan,
and with the sizes of `--clusters` where it has a `prolong_plan`). Each
variant is first held against the plain version (z bit for bit; rz, r2,
beta, best within 1e-5 of each value's size, as random segments' sums are
alike and their span a few ulps wide; stall and k equal) and
run twice for the same bits, then all are timed in turns on the device as
chip_smoke.py times kernels. Per variant: ms per call and the share of
the HBM rate that the launch's bytes (chip_smoke.prolong_dots_bytes: each
input read once, each output written once) reach in that time.
"""

import argparse
import contextlib
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from chip_smoke import CG_KERNEL_REL, HBM_BYTES_PER_S, log  # noqa: E402

# (L lanes, P plates, Ns nodes a plate)
SHAPES = (
    (4, 4, 8192),     # phase 9's chunk
    (4, 1, 8192),     # 4 segments at the production bucket
    (4, 4, 32768),
    (1, 4, 131072),   # 4 segments at the largest bucket
    (4, 4, 131072),   # the largest bucket, 16 segments
)
NODES_PER_AGGREGATE = 25  # phase 9's chunk: 1,280 aggregates over 32,768 nodes
OUTPUTS = ("z", "rz", "r2", "best", "beta", "stall", "k")
SUMMED = ("rz", "r2", "best", "beta")


def case(device, L, P, Ns, seed):
    """(state, inputs of prolong_dots but z and the state) at a shape."""
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
    st.rz.copy_(0.5 + 4.5 * rand(L, P))
    st.best.copy_(st.r2 * torch.where(rand(L, P) < 0.5, 0.5, 2.0))
    st.stall.copy_((rand(L, P) * 181).to(torch.int32))
    st.run.copy_(rand(L, P) < 0.7)
    st.lane.copy_(rand(L) < 0.8)
    st.lane[0] = True
    agg = (torch.arange(PN, device=device) * NA // PN).to(torch.int32)
    inputs = dict(zj=st.r * 1.5 + 0.1 * st.p, zc=0.01 * randn(L, NA * 3), agg=agg,
                  arms=randn(PN, 2), free=(rand(L, ndof) < 0.9).float())
    return st, inputs, NA


def launch(fn, st, inputs):
    fn(inputs["zj"], inputs["zc"], inputs["agg"], inputs["arms"], inputs["free"], st.z, st.P, st)
    return {name: getattr(st, name) for name in OUTPUTS}


@contextlib.contextmanager
def plan_of(cg_module, plan):
    """`cg_module.prolong_plan` set to give `plan` (None: its own)."""
    own = getattr(cg_module, "prolong_plan", None)
    if plan is not None:
        cg_module.prolong_plan = lambda seg_nodes: plan
    try:
        yield
    finally:
        if plan is not None:
            cg_module.prolong_plan = own


def cluster_plan(Ns, cluster):
    """(cluster, span) over Ns nodes, spans a multiple of 4; None where a
    rank would get no node."""
    span = -(-(-(-Ns // cluster)) // 4) * 4
    return (cluster, span) if (cluster - 1) * span < Ns else None


def variants(trees, Ns, clusters):
    """{name: fn(zj, zc, agg, arms, free, z, n_seg, state)} of every
    tree's kernel at its own plan and at each cluster size given."""
    out = {}
    for tree, cg_module in trees.items():
        own = getattr(cg_module, "prolong_plan", None)
        out[f"{tree}*" if own else tree] = (cg_module, None)
        if own is None:
            continue
        for cluster in clusters:
            plan = cluster_plan(Ns, cluster)
            if plan is not None and plan != own(Ns):
                out[f"{tree}/c{cluster}"] = (cg_module, plan)
    fns = {}
    for name, (cg_module, plan) in out.items():
        def fn(*args, cg_module=cg_module, plan=plan):
            with plan_of(cg_module, plan):
                cg_module.prolong_dots(*args)
        fns[name] = fn
    return fns


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", metavar="NAME=TREE", action="append", default=[])
    parser.add_argument("--clusters", default="4,8,16")
    parser.add_argument("--iters", type=int, default=50)
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
        lib = cg_module.build()
        log(f"{tree}: {lib}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log("  nvcc: " + line.strip())
    clusters = [int(c) for c in args.clusters.split(",")]
    rows = []
    for L, P, Ns in SHAPES:
        st, inputs, NA = case(device, L, P, Ns, seed=L * P + Ns)
        want = launch(cg.prolong_dots_reference, st.clone(), inputs)
        fns = variants(trees, Ns, clusters)
        timed = {}
        for name, fn in fns.items():
            got, again = launch(fn, st.clone(), inputs), launch(fn, st.clone(), inputs)
            torch.cuda.synchronize()
            if any(not torch.equal(got[k], again[k]) for k in OUTPUTS):
                raise AssertionError(f"{name} at {(L, P, Ns)}: two runs differ")
            if not torch.equal(got["z"], want["z"]):
                raise AssertionError(f"{name} at {(L, P, Ns)}: z is not the plain version's")
            for k in OUTPUTS:
                a, b = got[k].double(), want[k].double()
                rel = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                if rel > (CG_KERNEL_REL if k in SUMMED else 0.0):
                    raise AssertionError(f"{name} at {(L, P, Ns)}: {k} {rel:.3e} off plain")
            s = st.clone()
            timed[name] = lambda fn=fn, s=s: launch(fn, s, inputs)
        ms = chip_smoke.in_turns(timed, args.iters)
        nbytes = chip_smoke.prolong_dots_bytes(L, P, Ns, NA, 4)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        for name, t in ms.items():
            rows.append(f"L {L} P {P} Ns {Ns:6d} ({L * P:2d} segments, {nbytes / 1e6:7.3f} MB, "
                        f"bound {bound:.5f} ms) {name:10s} {t:.5f} ms  "
                        f"{bound / t:.3f} of the HBM rate")
            log(rows[-1])
        del st, inputs, want, fns, timed
    smi = chip_smoke.nvidia_smi()
    log(smi)
    if args.table:
        Path(args.table).parent.mkdir(parents=True, exist_ok=True)
        Path(args.table).write_text("\n".join(rows + [smi]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
