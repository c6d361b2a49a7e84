"""Every way the GroupNorm+SiLU forward can run at the main path's shapes,
checked and timed side by side on a CUDA card.

    python3 tools/sweep_group_norm_fwd.py [--against TREE] [--table PATH]

For the decoder's four stage shapes at batches 2, 4 and 16, f32 and bf16:
the two-pass route and the cluster route at every cluster size, with all of
a block's share of a slab kept in shared memory where that fits and with at
most 64, 80, 96 and 112 KiB of it kept (`fused_norm.cluster_plans`; a
variant's name is cluster<blocks>/<KiB of shared memory>), each first held against the plain version (y
within chip_smoke's tolerances, coef's mean and rstd to rtol 1e-5) and run
twice for bit-identical results, then timed in turns on the device as
chip_smoke.py times kernels. Per variant: ms per call, the share of the HBM
rate that the function's bytes (x read once, y written once) reach in that
time, and, for a cluster plan, the clusters the card holds at once. The plan
that `forward_route` picks is marked with `*`. `--against TREE` also times
the `group_norm_silu` of another checkout of this repo as `earlier`.
"""

import argparse
import functools
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from chip_smoke import GN_EPS, GN_GROUPS, GN_STAGE_CALLS, HBM_BYTES_PER_S, log  # noqa: E402

BATCHES = (2, 4, 16)
HELD_KIB = (64, 80, 96, 112)
COEF_RTOL = 1e-5


def plain_mean_rstd(x):
    xg = x.float().reshape(x.shape[0], GN_GROUPS, -1)
    mean = xg.mean(-1)
    var = (xg.square().mean(-1) - mean.square()).clamp_min(0.0)
    return mean, torch.rsqrt(var + GN_EPS)


def check(name, run, x, gamma, beta, want, tol):
    y, coef = run()
    y2, coef2 = run()
    torch.cuda.synchronize()
    if not (torch.equal(y, y2) and torch.equal(coef, coef2)):
        raise AssertionError(f"{name}: two runs differ")
    torch.testing.assert_close(y.float(), want.float(), **tol)
    cg = x.shape[1] // GN_GROUPS
    mean, rstd = plain_mean_rstd(x)
    torch.testing.assert_close(coef[:, ::cg, 2], mean, rtol=COEF_RTOL, atol=1e-6)
    torch.testing.assert_close(coef[:, ::cg, 3], rstd, rtol=COEF_RTOL, atol=0)
    a = coef[..., 3] * gamma.float()
    torch.testing.assert_close(coef[..., 0], a, rtol=COEF_RTOL, atol=1e-7)
    torch.testing.assert_close(coef[..., 1], beta.float() - coef[..., 2] * a,
                               rtol=COEF_RTOL, atol=1e-6)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", metavar="TREE")
    parser.add_argument("--table", metavar="PATH")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("sweep_group_norm_fwd: no CUDA device", file=sys.stderr)
        return 1
    from fea_tpu_torch.ops import fused_norm
    from fea_tpu_torch.ops.fused_norm import ForwardPlan, group_norm_silu_reference

    device = torch.device("cuda")
    sms, smem_limit = fused_norm._device_limits(0)
    log(f"{torch.cuda.get_device_name(0)}: {sms} SMs, {smem_limit} bytes of shared memory a block")
    lib = fused_norm.LIBRARY.build()
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            log("  nvcc: " + line.strip())
    earlier = chip_smoke.load_ops(args.against) if args.against else None

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.empty((), dtype=dtype).element_size()
        tol = chip_smoke.GN_FWD_TOL if dtype == torch.float32 else chip_smoke.GN_BF16_TOL
        for batch in BATCHES:
            for hw, c in GN_STAGE_CALLS:
                x, gamma, beta, _ = chip_smoke.gn_case(device, batch, hw, c, dtype, chip_smoke.SEED)
                want = group_norm_silu_reference(x, gamma, beta, GN_GROUPS, GN_EPS)
                picked = fused_norm.forward_plan(x, GN_GROUPS)
                vec = 16 // size
                plans = [ForwardPlan("two_pass", vec, 0, 0,
                                     *fused_norm._partition(batch, c, hw, vec, sms))]
                # with all of a block's share kept in shared memory, or less
                for held in (smem_limit, *(kib * 1024 for kib in HELD_KIB)):
                    plans += [p for p in fused_norm.cluster_plans(
                        c, hw, GN_GROUPS, size, smem_limit, held) if p not in plans]
                fns, resident = {}, {}
                for plan in plans:
                    name = plan.route + (f"{plan.cluster}/{plan.smem_bytes // 1024}K"
                                         if plan.cluster else "")
                    name += "*" if plan == picked else ""
                    fns[name] = functools.partial(
                        fused_norm._launch_forward, x, gamma, beta, GN_GROUPS, GN_EPS, plan)
                    check(f"{name} {(batch, hw, c)} {dtype}", fns[name], x, gamma, beta, want, tol)
                    if plan.cluster:
                        resident[name] = fused_norm.resident_clusters(plan, x)
                if earlier is not None:
                    fns["earlier"] = torch.no_grad()(functools.partial(
                        earlier.group_norm_silu, x, gamma, beta, GN_GROUPS, GN_EPS))
                ms = chip_smoke.in_turns(fns, 20)
                nbytes = 2 * x.numel() * size
                for name, t in ms.items():
                    rows.append(
                        f"{str(dtype)[6:]:9s} b{batch:<3d} ({hw}, {c}) {name:16s} {t:.4f} ms  "
                        f"{nbytes / (t * 1e-3) / HBM_BYTES_PER_S:.3f} of HBM rate"
                        + (f"  resident clusters {resident[name]}" if name in resident else "")
                    )
                    log(rows[-1])
                del x, want, fns
    log(chip_smoke.nvidia_smi())
    if args.table:
        Path(args.table).parent.mkdir(parents=True, exist_ok=True)
        Path(args.table).write_text("\n".join(rows + [chip_smoke.nvidia_smi()]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
