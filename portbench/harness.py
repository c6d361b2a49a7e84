"""The parts of a run that every cell shares: finding a cell's files by the
names in BENCHMARK.json, the run's context, the check that nothing of JAX
or the JAX package was loaded, and the result line.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric is a file of its own, found by name:
  portbench/workloads/<cell>.json   its configuration, traffic and driver
  configs as BENCHMARK.json's `file` says (portbench/configs/<config>.json)
  portbench/traffic/<traffic>.json  the traffic mix's parameters
  portbench/drivers/<driver>.py     the code that drives one entry point
  portbench/metrics/<metric>.py     one per-layer metric's reader
"""

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "fea_tpu"})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: str
    end_to_end: list  # BENCHMARK.json's entries that this cell reports
    per_layer: list


def find_cell(name: str, spec: dict) -> Cell:
    """The cell `name` and everything it names, by file name."""
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    workload = load_json(ROOT / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: the workload file's {key} {workload[key]!r} is not "
                             f"BENCHMARK.json's {entry[key]!r}")
    configs = {c["name"]: c for c in spec["configs"]}
    end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"] if name in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in reported)]
    return Cell(
        name=name,
        chips=entry["chips"],
        config=load_json(CHECKOUT / configs[entry["config"]]["file"]),
        traffic=load_json(ROOT / "traffic" / f"{entry['traffic']}.json"),
        driver=workload["driver"],
        end_to_end=end_to_end,
        per_layer=per_layer,
    )


def driver_module(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def metric_module(name: str):
    """portbench/metrics/<name>.py, loaded by its path (names hold dots)."""
    path = ROOT / "metrics" / f"{name}.py"
    module_name = "portbench_metric_" + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    """The forbidden top-level names that sys.modules holds, compared whole:
    fea_tpu_torch is not fea_tpu."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def end_of_setup(ctx) -> float:
    """Set-up's seconds. Set-up's objects are moved out of the cyclic
    garbage collector's reach (gc.freeze), so that a collection inside the
    window scans only what the window allocates; `after_window` undoes it."""
    gc.collect()
    gc.freeze()
    return time.perf_counter() - ctx.t_start


def after_window() -> None:
    gc.unfreeze()
    gc.collect()


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Context:
    """What a driver is given: the run's arguments, the cell's files and
    a directory under the run's TMPDIR that is deleted afterwards.
    `control` runs the lower-precision control instead of the program as
    configured (for setting the limits of `correct`; no benchmark run
    asks for it)."""

    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    device: torch.device
    tmpdir: Path
    control: bool = False
    t_start: float = field(default_factory=time.perf_counter)

    @property
    def window_seconds(self) -> float:
        """The measured window; a traced run's first window (the device
        alone) is shorter, and its second (the host too) shorter again."""
        if self.trace:
            return min(self.seconds, self.traffic["trace_seconds"])
        return self.seconds

    @property
    def host_window_seconds(self) -> float:
        return min(self.seconds, self.traffic["host_trace_seconds"])


@dataclass
class Outcome:
    """What a driver returns."""

    attempted: int
    failed: int
    metrics: dict  # end-to-end values by name
    memory_peak_bytes: int
    checks: list  # (name, value, limit): the numbers that decide `correct`
    facts: dict = field(default_factory=dict)  # what per-layer readers need
    trace: object = None  # tracing.Trace of the device alone, in a traced run
    host_trace: object = None  # tracing.Trace of the host and the device
    control_checks: list = field(default_factory=list)


def correct(checks: list) -> bool:
    return bool(checks) and all(math.isfinite(v) and v <= limit for _, v, limit in checks)


def result_line(cell: Cell, outcome: Outcome, device: torch.device, trace: bool) -> dict:
    """The run's last line. With trace the per-layer metrics that have
    something to read; else the end-to-end metrics. The numbers that
    decide `correct` come last, each beside its limit."""
    metrics = {}
    if trace:
        for entry in cell.per_layer:
            value = metric_module(entry["name"]).read(outcome)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        for entry in cell.end_to_end:
            metrics[entry["name"]] = {"value": outcome.metrics[entry["name"]],
                                      "unit": entry["unit"]}
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": outcome.memory_peak_bytes,
    }
    line = {"correct": correct(outcome.checks), "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": dev}
    if trace and outcome.trace is not None:
        dev["busy_s"] = outcome.trace.busy_s
        dev["window_s"] = outcome.trace.window_s
        line["breakdown"] = {"device_ops": outcome.trace.breakdown()["device_ops"],
                             "idle_gaps": outcome.host_trace.breakdown()["idle_gaps"]}
    line["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in outcome.checks}
    return line
