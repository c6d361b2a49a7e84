"""The port's accuracy metrics, dataset statistics and training-log parser
(fea_tpu_torch.metrics, fea_tpu_torch.utils.logs) against fea_tpu's, on
the CPU.

One tiny dataset tree is written by the port's `generate_data` (2 plates x
2 conditions x 3 steps, 64 px, mesh 0.12, `save_meshes`), and sample PNGs
beside it with PIL from a seed, at 48 px so that the metrics' resize runs.
Both packages hold host NumPy and PIL code over the same files: every
result must be equal, not merely close.
"""

import numpy as np
import pytest
from PIL import Image

from fea_tpu_torch import metrics
from fea_tpu_torch.utils import logs

PLATES, CONDITIONS, STEPS, SIZE = 2, 2, 3, 64
MILESTONE = "final"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from fea_tpu_torch.datagen import generate_data

    root = tmp_path_factory.mktemp("metrics")
    data = root / "data"
    generate_data(data_dir=str(data), image_size=SIZE, num_plates=PLATES,
                  conditions_per_plate=CONDITIONS, num_steps_per_condition=STEPS,
                  mesh_size=0.12, holes_per_polygon_range=(0, 1), save_meshes=True,
                  seed=5, verbose=False, device="cpu")
    rng = np.random.default_rng(0)
    results = root / "results"
    for plate in range(1, PLATES + 1):
        for condition in range(1, CONDITIONS + 1):
            folder = results / MILESTONE / str(plate) / str(condition)
            folder.mkdir(parents=True)
            for step in range(1, STEPS):
                for axis in ("x", "y"):
                    img = rng.integers(0, 256, (48, 48), dtype=np.uint8)
                    Image.fromarray(img).save(folder / f"sample_{axis}_{step}.png")
    return data, results


def test_accuracy_for_one_sample_equal(tree):
    from fea_tpu.metrics import accuracy_for_one_sample

    data, results = tree
    for plate in range(1, PLATES + 1):
        for condition in range(1, CONDITIONS + 1):
            for step in range(1, STEPS):
                paths = (
                    data / str(plate) / str(condition) / f"domain.{step}.vtk",
                    results / MILESTONE / str(plate) / str(condition) / f"sample_x_{step}.png",
                    results / MILESTONE / str(plate) / str(condition) / f"sample_y_{step}.png",
                    data / str(plate) / "input.png",
                )
                for clip in (0.05, 0.2):
                    ours = metrics.accuracy_for_one_sample(*paths, image_size=SIZE, clip=clip)
                    theirs = accuracy_for_one_sample(*paths, image_size=SIZE, clip=clip)
                    assert ours == theirs
                    assert np.isfinite(ours).all()


@pytest.mark.parametrize("per_step", [False, True])
def test_calculate_accuracy_equal(tree, per_step):
    from fea_tpu.metrics import calculate_accuracy, calculate_accuracy_per_step

    data, results = tree
    ours_fn = metrics.calculate_accuracy_per_step if per_step else metrics.calculate_accuracy
    theirs_fn = calculate_accuracy_per_step if per_step else calculate_accuracy
    kw = dict(data_dir=str(data), results_dir=str(results), milestone=MILESTONE,
              image_size=SIZE, num_plates=PLATES, conditions_per_plate=CONDITIONS,
              steps_per_condition=STEPS)
    ours, theirs = ours_fn(**kw), theirs_fn(**kw)
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])
    assert np.isfinite(ours["mae"])
    if per_step:
        assert ours["mae_per_step"].shape == (STEPS - 1,)


def test_predicted_displacement_at_nodes_fallbacks(tree):
    """Nodes on whole pixels take the NaN fallbacks: x on a pixel column
    gives a zero x-span (f_xy1 -> q11, f_xy2 -> q22), y on a pixel row a
    zero y-span (f_xy -> f_xy1); nodes off the plate move the corners
    inward. Both packages give equal values, all finite."""
    from fea_tpu.metrics import predicted_displacement_at_nodes

    data, results = tree
    folder = results / MILESTONE / "1" / "1"
    files = (folder / "sample_x_1.png", folder / "sample_y_1.png", data / "1" / "input.png")
    rng = np.random.default_rng(1)
    # x spans 0.75 and y 1.0, so x is centred by (1 - 0.75) / 2 = 0.125: every
    # coordinate below is a multiple of 1/64, exact in binary
    off_pixels = rng.uniform(0.0, 1.0, (40, 2)) * [0.75, 1.0]
    on_x = np.stack([np.arange(20, 30) / SIZE - 0.125, rng.uniform(0.1, 0.9, 10)], axis=1)
    on_y = np.stack([rng.uniform(0.1, 0.7, 10), np.arange(20, 30) / SIZE], axis=1)
    on_both = np.stack([np.arange(30, 40) / SIZE - 0.125, np.arange(30, 40) / SIZE], axis=1)
    corners = np.array([[0.0, 0.0], [0.75, 0.0], [0.0, 1.0], [0.75, 1.0]])
    coords = np.concatenate([off_pixels, on_x, on_y, on_both, corners])
    cords = coords.copy()
    cords[:, 0] += (1.0 - cords[:, 0].max()) / 2.0
    cords *= SIZE
    assert (np.floor(cords[:, 0]) == np.ceil(cords[:, 0])).sum() >= 20
    assert (np.floor(cords[:, 1]) == np.ceil(cords[:, 1])).sum() >= 20
    for decode_scale in (0.05, 1.0):
        ours = metrics.predicted_displacement_at_nodes(coords, *files, image_size=SIZE,
                                                       decode_scale=decode_scale)
        theirs = predicted_displacement_at_nodes(coords, *files, image_size=SIZE,
                                                 decode_scale=decode_scale)
        assert ours.shape == (len(coords), 2)
        np.testing.assert_array_equal(ours, theirs)
        assert np.isfinite(ours).all()


def test_dataset_displacement_stats_equal(tree):
    from fea_tpu.metrics import dataset_displacement_stats

    data, _ = tree
    ours = metrics.dataset_displacement_stats(str(data))
    assert ours == dataset_displacement_stats(str(data))
    assert ours["num_files"] == len(list(data.rglob("domain.*.vtk"))) >= PLATES * CONDITIONS
    assert metrics.dataset_displacement_stats(str(data / "1" / "1" / "missing")) == {}


def test_parse_train_log_equal(tmp_path):
    """Lines as the port's Trainer logs them (step / loss, sample loss, a
    non-finite warning) parse to the same series in both packages."""
    from fea_tpu.utils.logs import parse_train_log

    path = tmp_path / "train-e4-b16-lr0003-2026.log"
    path.write_text(
        "2026-10-17 00:00:00,000 step: 0, loss: 0.5123\n"
        "2026-10-17 00:00:01,000 step: 1, loss: 0.4011\n"
        "2026-10-17 00:00:02,000 step: 2, non-finite loss (nan) — update skipped\n"
        "2026-10-17 00:00:02,000 step: 2, loss: nan\n"
        "2026-10-17 00:00:03,000 sample loss: 0.3901\n"
        "2026-10-17 00:00:04,000 step: 3, loss: 1.5e-03\n"
    )
    ours, theirs = logs.parse_train_log(str(path)), parse_train_log(str(path))
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])
    np.testing.assert_array_equal(ours["steps"], [0, 1, 3])
    np.testing.assert_array_equal(ours["sample_steps"], [1])
