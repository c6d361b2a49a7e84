"""`correct` on the CPU at 32 px: sound runs come out correct; the
lower-precision control and each fault a cell can have, planted in the
timed path underneath, come out not correct. The harness's look for a
chip is skipped; the rest of a run is driven as the benchmark drives it."""

import sys

import pytest
import torch

from portbench import faults, harness
from small import run_small

TRAIN, SAMPLE = "regression-train-b16", "ddpm-sample-b2"


@pytest.mark.parametrize("cell", [TRAIN, SAMPLE])
def test_sound_runs_are_correct(cell):
    outcome, line = run_small(cell)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", [TRAIN, SAMPLE])
def test_traced_runs_read_their_metrics(cell):
    outcome, line = run_small(cell, trace=True)
    assert line["correct"]
    assert line["device"]["window_s"] > 0
    # the CPU has no device trace: only the whole step's share is read
    assert set(line["metrics"]) == {"mfu.train" if cell == TRAIN else "mfu.sample"}


def test_the_bf16_training_path_is_not_correct():
    _, line = run_small(TRAIN, control=True)
    assert not line["correct"], line["checks"]


def test_the_bf16_reference_in_the_samplers_place_is_not_correct():
    outcome, _ = run_small(SAMPLE, control=True)
    assert not harness.correct(outcome.control_checks), outcome.control_checks


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_a_broken_train_step_is_not_correct(fault):
    remove = faults.FAULTS[fault]()
    try:
        _, line = run_small(TRAIN)
    finally:
        remove()
    assert not line["correct"], (fault, line["checks"])
    if fault == "unchanged_state":
        assert line["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("fault", ["altered_output", "half_requests", "stale_step"])
def test_a_broken_sampler_is_not_correct(fault):
    remove = faults.FAULTS[fault]()
    try:
        _, line = run_small(SAMPLE)
    finally:
        remove()
    assert not line["correct"], (fault, line["checks"])


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fea_tpu_torch_like", object())
    assert "fea_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fea_tpu.models", object())
    assert "fea_tpu" in harness.forbidden_modules()


def test_a_cell_run_loads_nothing_of_jax_or_the_jax_package():
    import subprocess

    code = (
        "import sys, torch; sys.path.insert(0, '.'); sys.path.insert(0, 'portbench/tests');"
        "from small import run_small; run_small('ddpm-sample-b2', seconds=0.5);"
        "run_small('regression-train-b16', seconds=0.5);"
        "from portbench import harness; print(harness.forbidden_modules())"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.CHECKOUT, capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[-1]
    assert out == "[]"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [TRAIN, SAMPLE])
def test_cells_are_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.run import run_cell

    found = harness.find_cell(cell, harness.benchmark_spec())
    _, line = run_cell(found, 2**31 + 4242, 3.0, False, torch.device("cuda", 0))
    assert line["correct"], line["checks"]
