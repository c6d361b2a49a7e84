"""The cell `regression-train-b16-store`: its files found by name, the
store it writes against what the Trainer reads from it, and `correct` on
the CPU at 32 px for a sound run, the bf16 training path and planted
faults."""

import numpy as np
import pytest
import torch

from portbench import faults, harness
from portbench.drivers import train_regression_store as driver
from small import SEED, run_cell, small_cell

SPEC = harness.benchmark_spec()
STORE = "regression-train-b16-store"


def cell():
    found = small_cell(STORE)
    found.traffic["plates"] = 7  # 112 rows: the Trainer's floor is 100
    return found


def run_small(trace=False, control=False):
    torch.set_num_threads(2)
    return run_cell(cell(), SEED, 1.0, trace, torch.device("cpu"), control=control)


def test_the_cell_finds_its_files_and_metrics():
    found = harness.find_cell(STORE, SPEC)
    assert found.driver == "train_regression_store" and found.chips == 1
    assert found.config == harness.find_cell("regression-train-b16", SPEC).config
    assert {m["name"] for m in found.end_to_end} == {"train_step_ms", "setup_s"}
    assert {m["name"] for m in found.per_layer} == {
        "idle_pct.train", "mfu.train", "optimizer_ms.train", "roofline_pct.gn_bwd.train"}
    t = found.traffic
    assert t["plates"] * t["conditions_per_plate"] * (t["num_steps"] - 1) == 256


def test_the_store_holds_the_seeded_draws(tmp_path):
    """The store as the Trainer opens it: every condition done, masks
    binary, the plate's share near 70%, forces and materials only on the
    plate, from the traffic's regions, N(0, 1) there as `train-b16`'s rows
    (the forces at the last step); the same seed writes the same store."""
    from fea_tpu_torch.data.store import StoredFEADataset

    found = cell()
    ctx = harness.Context(seed=SEED, seconds=1.0, trace=False, config=found.config,
                          traffic=found.traffic, device=torch.device("cpu"), tmpdir=tmp_path)
    driver.write_store(ctx, tmp_path / "a")
    driver.write_store(ctx, tmp_path / "b")
    a, b = StoredFEADataset(str(tmp_path / "a")), StoredFEADataset(str(tmp_path / "b"))
    assert len(a) == 112 and a.C == 4 and a.num_steps == 4 and a.image_size == 32
    for name in ("geometry", "constraints", "displacement", "force_winner", "mat_winner"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert set(np.unique(a.geometry)) == {0, 1} and set(np.unique(a.constraints)) <= {0, 1}
    assert abs(a.geometry.mean() - 0.7) < 0.05
    plate = np.repeat(np.asarray(a.geometry), 4, axis=0)[..., None].repeat(2, -1) > 0
    assert (np.asarray(a.force_winner)[~plate] == -1).all()
    assert set(np.unique(np.asarray(a.force_winner)[plate])) == set(range(96))
    assert set(np.unique(np.asarray(a.mat_winner)[plate])) == set(range(96))
    last = driver.StoreRows(a).batch(range(3, 112, 4), "cpu")  # each condition's step 4
    on = last["geometry"][..., 0] > 0
    for key in ("forces", "materials"):
        values = last[key][on]
        assert abs(float(values.mean())) < 0.1 and abs(float(values.std()) - 1) < 0.1, key
        assert not last[key][~on].any(), key
    first = driver.StoreRows(a).batch(range(0, 112, 4), "cpu")  # step 1: no load yet
    assert not first["forces"].any()
    rows = driver.StoreRows(a).batch([0, 37, 111], "cpu")
    assert {k: tuple(v.shape) for k, v in rows.items()} == {
        "materials": (3, 32, 32, 2), "forces": (3, 32, 32, 2), "constraints": (3, 32, 32, 1),
        "geometry": (3, 32, 32, 1), "displacement": (3, 32, 32, 2)}
    assert rows["forces"].abs().max() > 0 and rows["materials"].abs().max() > 0


def test_a_sound_run_is_correct():
    _, line = run_small()
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1


def test_a_traced_run_reads_the_whole_steps_share():
    _, line = run_small(trace=True)
    assert line["correct"]
    assert set(line["metrics"]) == {"mfu.train"}


def test_the_bf16_training_path_is_not_correct():
    _, line = run_small(control=True)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_a_broken_train_step_is_not_correct(fault):
    remove = faults.FAULTS[fault]()
    try:
        _, line = run_small()
    finally:
        remove()
    assert not line["correct"], (fault, line["checks"])
