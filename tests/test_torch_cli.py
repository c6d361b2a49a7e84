"""The port's CLI (fea_tpu_torch.cli, `python -m fea_tpu_torch`) against
fea_tpu's, on the CPU.

The two argparse trees hold the same subcommands, options, defaults and
choices; the port adds only the global `--device`. fea_tpu's tree is built
from its `_add_*` functions (fea_tpu/cli.py imports only argparse and os
at module level). Then the port's CLI runs the pipeline end to end with
`--device cpu` at a small size (32 px, input_dim 8, 2 stages): generate
(batched for the train set, sequential for the held-out set) -> store ->
train 1 step from the store held on the device -> sample -> accuracy ->
app without a checkpoint. Its accuracy output must equal fea_tpu's
`calculate_accuracy` on the same files.
"""

import argparse
import contextlib
import io

import numpy as np
import pytest
import torch

from fea_tpu_torch import cli

torch.set_num_threads(1)

SIZE, DIM, STAGES = 32, 8, 2


def jax_parser():
    from fea_tpu import cli as jcli

    parser = argparse.ArgumentParser(prog="fea_tpu")
    sub = parser.add_subparsers(dest="command", required=True)
    for add in (jcli._add_generate, jcli._add_train, jcli._add_store, jcli._add_train_diffusion,
                jcli._add_sample, jcli._add_accuracy, jcli._add_app):
        add(sub)
    return parser


def subparsers(parser):
    (action,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return action.choices


def options(parser):
    """Every argument of `parser` but help and the subcommands: its flags,
    destination, default, choices, type, nargs, const, required and kind."""
    out = {}
    for a in parser._actions:
        if isinstance(a, (argparse._HelpAction, argparse._SubParsersAction)):
            continue
        out[tuple(a.option_strings) or a.dest] = (
            a.dest, a.default, a.choices, a.type, a.nargs, a.const, a.required, type(a).__name__,
        )
    return out


def test_top_level_adds_only_device():
    ours, theirs = cli.build_parser(), jax_parser()
    assert list(subparsers(ours)) == list(subparsers(theirs)) == [
        "generate", "train", "store", "train-diffusion", "sample", "accuracy", "app"]
    assert options(theirs) == {}
    assert options(ours) == {("--device",): ("device", None, None, str, None, None, False,
                                             "_StoreAction")}


@pytest.mark.parametrize("command", list(cli.COMMANDS))
def test_subcommand_options_match(command):
    ours = options(subparsers(cli.build_parser())[command])
    theirs = options(subparsers(jax_parser())[command])
    assert ours == theirs
    assert ours  # every subcommand has options


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """The port's CLI, command after command, on the CPU; each command's
    return value and standard output."""
    root = tmp_path_factory.mktemp("cli")
    runs = {}

    def run(name, *argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = cli.main(["--device", "cpu", *map(str, argv)])
        runs[name] = (result, out.getvalue())

    data = dict(mesh_size=0.12, image_size=SIZE)
    run("generate", "generate", "--batched", "--num_plates", 2, "--conditions_per_plate", 2,
        "--steps_per_condition", 3, "--mesh_size", data["mesh_size"], "--image_size", SIZE,
        "--save_displacement", "--save_meshes", "--data_dir", root / "train", "--seed", 1234)
    run("generate_sequential", "generate", "--num_plates", 1, "--conditions_per_plate", 1,
        "--steps_per_condition", 3, "--mesh_size", data["mesh_size"], "--image_size", SIZE,
        "--save_displacement", "--save_meshes", "--data_dir", root / "held_out", "--seed", 99)
    run("store", "store", "--data_dir", root / "train", "--store_dir", root / "store",
        "--num_plates", 2, "--image_size", SIZE, "--conditions_per_plate", 2,
        "--steps_per_condition", 3)
    model = ("--input_dim", DIM, "--num_stages", STAGES, "--image_size", SIZE)
    run("train", "train", "--data_dir", root / "train", "--sample_data_dir", root / "held_out",
        "--dataset_store", root / "store", "--device_resident_store", "--batch_size", 2,
        "--num_gradient_accumulation_steps", 8, "--num_steps", 1, "--num_steps_per_milestone", 1,
        "--num_steps_per_condition", 3, "--num_steps_per_sample_condition", 3,
        "--conditions_per_plate", 2, "--num_sample_conditions_per_plate", 1,
        "--skip_dataset_size_check", "--use_ema_model", "--no_progress_bar",
        "--results_dir", root / "results", *model)
    run("sample", "sample", "--milestone", "final", "--data_dir", root / "train",
        "--sample_data_dir", root / "held_out", "--batch_size", 2, "--num_steps_per_condition", 3,
        "--num_sample_conditions_per_plate", 1, "--results_dir", root / "results", *model)
    run("accuracy", "accuracy", "--data_dir", root / "held_out", "--results_dir",
        root / "results", "--milestone", "final", "--image_size", SIZE, "--num_plates", 1,
        "--conditions_per_plate", 1, "--steps_per_condition", 3)
    run("app", "app", "gusset", "--output_dir", root / "app", "--image_size", 64)
    return root, runs


def test_generate_writes_both_trees(pipeline):
    root, runs = pipeline
    stats = runs["generate"][1].split("solver stats: ", 1)[1].splitlines()[0]
    assert eval(stats.replace("null", "None"))["plates"] == 2
    for tree, plates, conditions in (("train", 2, 2), ("held_out", 1, 1)):
        for plate in range(1, plates + 1):
            for condition in range(1, conditions + 1):
                folder = root / tree / str(plate) / str(condition)
                for name in ("outputs_displacement_x.png", "ranges.txt", "domain.1.vtk",
                             "domain.2.vtk"):
                    assert (folder / name).is_file(), folder / name


def test_store_holds_the_train_set(pipeline):
    from fea_tpu_torch.data.dataset import FEADataset
    from fea_tpu_torch.data.store import StoredFEADataset

    root, _ = pipeline
    stored = StoredFEADataset(str(root / "store"))
    pngs = FEADataset(str(root / "train"), image_size=SIZE, conditions_per_plate=2, num_steps=3)
    assert len(stored) == len(pngs) == 2 * 2 * 2
    for i in range(len(stored)):
        a, b = stored[i], pngs[i]
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_allclose(a[key], b[key], atol=1e-6, rtol=0)


def test_train_and_sample_wrote_their_files(pipeline):
    from fea_tpu_torch.utils.logs import parse_train_log

    root, _ = pipeline
    results = root / "results"
    state = torch.load(results / "model-final" / "state.pt", weights_only=True)
    assert state["step"] == 1 and state["ema_params"] is not None
    (log,) = [p for p in results.glob("train-e1-b2-lr0003-*.log")
              if parse_train_log(str(p))["steps"].size]
    parsed = parse_train_log(str(log))
    np.testing.assert_array_equal(parsed["steps"], [0])
    assert np.isfinite(parsed["losses"]).all() and parsed["sample_losses"].size == 1
    for step in (1, 2):
        for axis in ("x", "y"):
            assert (results / "final" / "1" / "1" / f"sample_{axis}_{step}.png").is_file()


def test_accuracy_equals_fea_tpu(pipeline):
    from fea_tpu.metrics import calculate_accuracy

    root, runs = pipeline
    ours, printed = runs["accuracy"]
    theirs = calculate_accuracy(data_dir=str(root / "held_out"), results_dir=str(root / "results"),
                                milestone="final", image_size=SIZE, num_plates=1,
                                conditions_per_plate=1, steps_per_condition=3)
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])
    assert np.isfinite(ours["mae"]) and "'mae'" in printed


def test_app_without_checkpoint(pipeline):
    root, runs = pipeline
    out, printed = runs["app"]
    assert out["converged"] and out["raster_roundtrip_mae"] < 1e-2
    assert "pred_mae" not in out and "'raster_roundtrip_mae'" in printed
    for name in ("geometry", "outline", "constraint", "force", "displacement_x",
                 "displacement_y"):
        assert (root / "app" / f"{name}.png").is_file()


def test_cli_needs_a_device(monkeypatch, tmp_path):
    """Without --device the CLI takes the CUDA device, and raises where
    there is none; nothing runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["app", "gusset", "--output_dir", str(tmp_path / "app")])
    assert not (tmp_path / "app").exists()


@pytest.mark.parametrize("batched", [False, True])
def test_more_than_one_device_raises(tmp_path, batched, monkeypatch):
    """`generate --num_devices 2` raises where it cannot be met: the
    sequential path runs on one device, and the batched path asked for two
    cards where one is visible (tests/test_torch_datagen_dp.py runs it on
    two CPU shards)."""
    argv = ["generate", "--num_devices", "2", "--save_displacement", "--data_dir",
            str(tmp_path / "data")]
    if batched:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="2 shards from cuda:0 need 2 CUDA devices, 1 visible"):
            cli.main(argv + ["--batched"])
    else:
        with pytest.raises(ValueError, match="shards the --batched path"):
            cli.main(["--device", "cpu"] + argv)
    assert not (tmp_path / "data").exists()
