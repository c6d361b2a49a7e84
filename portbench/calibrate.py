"""Read the two ends that each limit of `correct` is set between, for one
cell, on the card, in one process.

    python3 portbench/calibrate.py --workload NAME --seeds 1,2,... \
        --control-seeds 7,8,9 [--fault NAME --fault-seeds 4,5,6] [--seconds S]

For each seed of --seeds, the program as the configuration states it; for
each of --control-seeds, the control: the same cell with the program's
work in the nearest lower precision (bf16 where the configuration states
f32 with TF32 convolutions). A cell whose program has such a path of its
own (the Trainer's compute_dtype="bfloat16") runs it; the sampler's control
is the reference computed in bf16, put in the program's place at each
checked step. With --fault, the program with that fault of
portbench/faults.py planted, on --fault-seeds. Each run is a short window
at the cell's own load; prints one JSON line a run, then each compared
number's largest program reading and, for the control and the fault, its
smallest. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)

    import torch

    from portbench import faults, harness
    from portbench.run import THREADS, run_cell

    torch.set_num_threads(THREADS)
    if not torch.cuda.is_available():
        harness.log("calibrate: no CUDA device")
        return 2
    device = torch.device("cuda", 0)
    cell = harness.find_cell(args.workload, harness.benchmark_spec())

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    runs = ([(s, "program") for s in seeds(args.seeds)]
            + [(s, "control") for s in seeds(args.control_seeds)]
            + [(s, args.fault) for s in seeds(args.fault_seeds)])
    lower, upper = {}, {}
    for seed, kind in runs:
        remove = faults.FAULTS[kind]() if kind in faults.FAULTS else None
        try:
            outcome, line = run_cell(cell, seed, args.seconds, False, device,
                                     control=kind == "control")
        finally:
            if remove is not None:
                remove()
        control = kind == "control"
        checks = outcome.control_checks if control and outcome.control_checks else outcome.checks
        readings = {name: value for name, value, _ in checks}
        for name, value in readings.items():
            if kind == "program":
                lower[name] = max(lower.get(name, 0.0), value)
            else:
                upper.setdefault(kind, {})
                upper[kind][name] = min(upper[kind].get(name, float("inf")), value)
        print(json.dumps({"seed": seed, "kind": kind,
                          "readings": readings, "correct": line["correct"],
                          "metrics": {k: v["value"] for k, v in line["metrics"].items()},
                          "failed": line["failed"], "attempted": line["attempted"]}),
              flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
