"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints the result as one JSON object, the last line of standard output,
and the numbers that decide `correct`, each beside its limit, as the last
lines of standard error. With --trace 0 the metrics are the cell's
end-to-end metrics; with --trace 1 its per-layer metrics, read from a
torch.profiler trace of a shorter window. Exits non-zero, printing no
result, without the CUDA devices the cell asks for, or when JAX or the
JAX package (fea_tpu) was loaded.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
# the checkout, not this directory, on the path: portbench is a package
sys.path[0] = str(CHECKOUT)

CACHE = CHECKOUT / ".portbench_cache"
# intra-op threads of the run's one process: the host's cores are shared by
# the loop's main thread, the CUDA driver's threads and these; a full pool
# of spinning threads left the training loop's host work 5-14% slower and
# twice as spread (four runs each way, one call, NVIDIA H100 80GB HBM3)
THREADS = 4


def run_cell(cell, seed, seconds, trace, device, control=False):
    """Drive the cell once on `device` and return (outcome, result line);
    no look for a chip (the tests call this on the CPU)."""
    from portbench import harness

    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        ctx = harness.Context(seed=seed, seconds=seconds, trace=trace, config=cell.config,
                              traffic=cell.traffic, device=device, tmpdir=tmp, control=control)
        outcome = harness.driver_module(cell.driver).run(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return outcome, harness.result_line(cell, outcome, device, trace)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")

    import torch

    from portbench import harness

    torch.set_num_threads(THREADS)
    cell = harness.find_cell(args.workload, harness.benchmark_spec())
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found {found}")
        return 2
    outcome, line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0))
    found = harness.forbidden_modules()
    if found:
        harness.log(f"portbench: the run loaded {', '.join(found)}: no result")
        return 3
    for name, check in line["checks"].items():
        harness.log(f"check {name}: {check['value']!r} (limit {check['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
