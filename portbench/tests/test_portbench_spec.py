"""BENCHMARK.json against the contract's limits, and each of its names
against the files the harness finds by name."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_names_and_units():
    names = [SPEC[k][i]["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for i in range(len(SPEC[k]))]
    for name in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(name), name
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in SPEC[k]}) == len(SPEC[k]), k
    for metric in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
    for metric in SPEC["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_every_text_field_is_one_short_line():
    fields = [SPEC[k][i][f] for k, f in (("configs", "why"), ("configs", "source"),
                                         ("workloads", "why"), ("per_layer", "layer"))
              for i in range(len(SPEC[k]))] + SPEC["command"]
    for text in fields:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files(cell):
    found = harness.find_cell(cell, SPEC)
    assert (harness.ROOT / "drivers" / f"{found.driver}.py").is_file()
    reported = {m["name"] for m in found.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and found.per_layer
    for metric in found.per_layer:
        assert metric["moves"] in reported


def test_each_per_layer_metric_declares_what_the_spec_says():
    for metric in SPEC["per_layer"]:
        module = harness.metric_module(metric["name"])
        assert (module.LAYER, module.UNIT, module.SOURCE, module.MOVES) == (
            metric["layer"], metric["unit"], metric["source"], metric["moves"]), metric["name"]
        for cell in metric["workloads"]:
            moved = [m for m in harness.find_cell(cell, SPEC).end_to_end
                     if m["name"] == metric["moves"]]
            assert moved, (metric["name"], cell)


def test_configs_name_every_change_from_their_source():
    for entry in SPEC["configs"]:
        config = harness.load_json(harness.CHECKOUT / entry["file"])
        assert config["reduced"] == entry["reduced"] == []
        assert entry["file"].startswith("portbench/")


def test_a_new_workload_file_is_found_by_name(tmp_path):
    """A cell added as data alone: a copy of the benchmark with one more
    traffic file, workload file and BENCHMARK.json entry, no file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "ddpm-sample-b4", "config": "fdnunet-ddpm-256",
                              "traffic": "sample-b4-closed", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = harness.load_json(harness.ROOT / "traffic" / "sample-b2-closed.json")
    traffic["batch"] = 4
    (root / "portbench" / "traffic" / "sample-b4-closed.json").write_text(json.dumps(traffic))
    (root / "portbench" / "workloads" / "ddpm-sample-b4.json").write_text(json.dumps(
        {"config": "fdnunet-ddpm-256", "traffic": "sample-b4-closed", "driver": "sample_ddpm"}))
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from portbench import harness;"
        "c = harness.find_cell('ddpm-sample-b4', harness.benchmark_spec());"
        "print(c.traffic['batch'], c.driver, harness.ROOT)"
    )
    out = subprocess.run([sys.executable, "-c", code, str(root)], capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["4", "sample_ddpm", str(root / "portbench")]


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    """On a machine without CUDA, and in a directory that holds only
    BENCHMARK.json and the benchmark's files, a run exits non-zero and
    prints no result."""
    root = tmp_path / "bare"
    shutil.copytree(harness.ROOT, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.CHECKOUT / "BENCHMARK.json", root)
    for where in (harness.CHECKOUT, root):
        proc = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1",
             "--seconds", "1", "--trace", "0"], cwd=where, capture_output=True, text=True)
        assert proc.returncode != 0
        assert not proc.stdout.strip().startswith("{")
