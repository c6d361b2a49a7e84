"""Displacement-accuracy metrics against ground-truth solves (the port's
own copy of fea_tpu/metrics/accuracy.py: host NumPy and PIL).

Reproduces the reference metrics semantics
(metrics/accuracy_function.py:7-206, metrics/calculate_accuracy.py:7-189):
  * node coords centered on the short axis, scaled by image_size;
  * predicted x/y PNGs loaded ROTATE_270 + grayscale, decoded with the
    fixed +-0.05 physics scale ((v/255)*2-1)*0.05;
  * geometry-aware nudging of the bilinear-interpolation corner pixels
    (corners falling outside the geometry are pushed inward);
  * bilinear interpolation with the reference's NaN fallbacks
    (degenerate x-span -> q11/q22, degenerate y-span -> f_xy1);
  * ground-truth node displacements from domain.N.vtk clipped to +-0.05;
  * MAE / MSE / RMSE of the displacement magnitude (resultant).

Deviation (documented): the reference hardcodes a 256px resize for the
geometry mask (accuracy_function.py:48) and would index out of bounds for
other image sizes; we resize the mask to image_size.

Interpretation caveat (reference-parity by design, do NOT "fix"): the
fixed ±0.05 decode is applied to prediction PNGs whose training targets
were *per-condition auto-range* normalized, so the reported MAE is a
scale-mismatched quantity, not a physical displacement error — it is
only comparable to the reference's own published number (0.0144), which
embeds the exact same mismatch (accuracy_function.py:118-125 vs
fea_analysis.py's auto-ranged image export).
"""

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageOps

from ..mesh import read_vtk


def _load_rotated_gray(path, image_size: int) -> np.ndarray:
    return np.asarray(
        ImageOps.grayscale(
            Image.open(path)
            .resize((image_size, image_size))
            .transpose(Image.Transpose.ROTATE_270)
        ),
        dtype=np.float64,
    )


def predicted_displacement_at_nodes(
    node_coords: np.ndarray,
    displacement_x_file,
    displacement_y_file,
    geometry_file,
    image_size: int,
    decode_scale: float = 0.05,
) -> np.ndarray:
    """Sample predicted displacement images at mesh node coordinates.

    Returns (N, 2) displacements in physics units (+-decode_scale)."""
    cords = np.asarray(node_coords, dtype=np.float64)[:, :2].copy()
    x_max = cords[:, 0].max()
    y_max = cords[:, 1].max()
    if x_max <= y_max:
        cords[:, 0] += (1.0 - x_max) / 2.0
    else:
        cords[:, 1] += (1.0 - y_max) / 2.0
    cords = cords * image_size

    pixels_min = np.floor(cords).astype(int)
    pixels_max = np.clip(np.ceil(cords).astype(int), 1, image_size)

    pred = np.stack(
        [
            _load_rotated_gray(displacement_x_file, image_size),
            _load_rotated_gray(displacement_y_file, image_size),
        ]
    )
    pred = ((pred / 255.0) * 2.0 - 1.0) * decode_scale

    geometry = _load_rotated_gray(geometry_file, image_size)
    geometry = 1.0 - geometry / 255.0

    x1 = np.clip(pixels_min[:, 0] + 1, 1, image_size)
    y1 = np.clip(pixels_min[:, 1] - 1, 1, image_size)
    x2 = np.clip(pixels_max[:, 0] + 1, 1, image_size)
    y2 = np.clip(pixels_max[:, 1] - 1, 1, image_size)

    # nudge corners that land outside the geometry inward
    outside = geometry[x1 - 1, y1 - 1] == 0
    x1 = np.clip(np.where(outside, x1 + 1, x1), 1, image_size)
    y1 = np.clip(np.where(outside, y1 + 1, y1), 1, image_size)
    outside = geometry[x2 - 1, y2 - 1] == 0
    x2 = np.clip(np.where(outside, x2 - 1, x2), 1, image_size)
    y2 = np.clip(np.where(outside, y2 - 1, y2), 1, image_size)

    x = cords[:, 0]
    y = cords[:, 1]
    q11 = pred[:, x1 - 1, y1 - 1]
    q12 = pred[:, x1 - 1, y2 - 1]
    q21 = pred[:, x2 - 1, y1 - 1]
    q22 = pred[:, x2 - 1, y2 - 1]

    with np.errstate(all="ignore"):
        wx2 = (x2 - x) / (x2 - x1)
        wx1 = (x - x1) / (x2 - x1)
        f_xy1 = wx2[None] * q11 + wx1[None] * q21
        f_xy1 = np.where(np.isnan(f_xy1), q11, f_xy1)
        f_xy2 = wx2[None] * q12 + wx1[None] * q22
        f_xy2 = np.where(np.isnan(f_xy2), q22, f_xy2)
        wy2 = (y2 - y) / (y2 - y1)
        wy1 = (y - y1) / (y2 - y1)
        f_xy = wy2[None] * f_xy1 + wy1[None] * f_xy2
        f_xy = np.where(np.isnan(f_xy), f_xy1, f_xy)
    return f_xy.T


def accuracy_for_one_sample(
    mesh_file,
    displacement_x_file,
    displacement_y_file,
    geometry_file,
    image_size: int,
    clip: float = 0.05,
) -> Tuple[float, float, float]:
    """(MAE, MSE, RMSE) of the displacement magnitude for one sample."""
    data = read_vtk(str(mesh_file))
    coords = data["points"][:, :2]
    gt = np.clip(data["u"][:, :2], -clip, clip)

    pred = predicted_displacement_at_nodes(
        coords,
        displacement_x_file,
        displacement_y_file,
        geometry_file,
        image_size,
        decode_scale=clip,
    )
    pred_mag = np.sqrt(pred[:, 0] ** 2 + pred[:, 1] ** 2)
    gt_mag = np.sqrt(gt[:, 0] ** 2 + gt[:, 1] ** 2)
    mae = float(np.mean(np.abs(pred_mag - gt_mag)))
    mse = float(np.mean((pred_mag - gt_mag) ** 2))
    return mae, mse, float(np.sqrt(mse))


def _sample_paths(
    gt_path: Path, samples_path: Path, index: int, conditions: int, steps: int
):
    from ..datagen.writers import domain_vtk_name

    per_plate = conditions * (steps - 1)
    plate = index // per_plate + 1
    condition = (index % per_plate) // (steps - 1) + 1
    step = (index % per_plate) % (steps - 1) + 1
    # the VTK naming rule lives in ONE place (the datagen writer) so
    # eval can never drift from what datagen wrote
    domain = domain_vtk_name(step, steps)
    return (
        gt_path / str(plate) / str(condition) / domain,
        samples_path / str(plate) / str(condition) / f"sample_x_{step}.png",
        samples_path / str(plate) / str(condition) / f"sample_y_{step}.png",
        gt_path / str(plate) / "input.png",
        step,
    )


def calculate_accuracy(
    data_dir: str,
    results_dir: str,
    milestone: Optional[str] = None,
    image_size: int = 256,
    num_plates: int = 1,
    conditions_per_plate: int = 4,
    steps_per_condition: int = 6,
    progress: bool = False,
):
    """Aggregate MAE/MSE/RMSE over a sampled dataset
    (reference metrics/calculate_accuracy.py:7-92)."""
    assert steps_per_condition > 1
    gt_path = Path(data_dir)
    samples_path = Path(results_dir)
    if milestone is not None:
        samples_path = samples_path / str(milestone)
    assert gt_path.exists() and samples_path.exists()

    total = num_plates * conditions_per_plate * (steps_per_condition - 1)
    maes = np.zeros(total)
    mses = np.zeros(total)
    rmses = np.zeros(total)
    indices = range(total)
    if progress:
        from tqdm import tqdm

        indices = tqdm(indices, desc="accuracy")
    for index in indices:
        mesh_p, x_p, y_p, g_p, _ = _sample_paths(
            gt_path, samples_path, index, conditions_per_plate, steps_per_condition
        )
        maes[index], mses[index], rmses[index] = accuracy_for_one_sample(
            mesh_p, x_p, y_p, g_p, image_size
        )
    return {
        "mae_values": maes,
        "mse_values": mses,
        "rmse_values": rmses,
        "mae": float(maes.mean()),
        "mse": float(mses.mean()),
        "rmse": float(rmses.mean()),
    }


def calculate_accuracy_per_step(
    data_dir: str,
    results_dir: str,
    milestone: Optional[str] = None,
    image_size: int = 256,
    num_plates: int = 1,
    conditions_per_plate: int = 4,
    steps_per_condition: int = 6,
    progress: bool = False,
):
    """Per-step aggregation (reference calculate_accuracy.py:95-189)."""
    assert steps_per_condition > 1
    gt_path = Path(data_dir)
    samples_path = Path(results_dir)
    if milestone is not None:
        samples_path = samples_path / str(milestone)

    total = num_plates * conditions_per_plate * (steps_per_condition - 1)
    n_steps = steps_per_condition - 1
    maes = np.full((total, n_steps), np.nan)
    mses = np.full((total, n_steps), np.nan)
    rmses = np.full((total, n_steps), np.nan)
    # Explicit fill mask: NaN doubles as the 'not this step's slot'
    # sentinel, and nanmean over it would ALSO silently drop a sample
    # whose metric is genuinely NaN (diverged/singular ground truth),
    # flattering the per-step numbers. Mean over filled slots only and
    # let a real NaN propagate, matching calculate_accuracy.
    filled = np.zeros((total, n_steps), dtype=bool)
    indices = range(total)
    if progress:
        from tqdm import tqdm

        indices = tqdm(indices, desc="accuracy (per step)")
    for index in indices:
        mesh_p, x_p, y_p, g_p, step = _sample_paths(
            gt_path, samples_path, index, conditions_per_plate, steps_per_condition
        )
        maes[index, step - 1], mses[index, step - 1], rmses[index, step - 1] = (
            accuracy_for_one_sample(mesh_p, x_p, y_p, g_p, image_size)
        )
        filled[index, step - 1] = True

    def _mean_filled(grid: np.ndarray) -> np.ndarray:
        out = np.full(n_steps, np.nan)
        for s in range(n_steps):
            col = grid[filled[:, s], s]
            if col.size:
                out[s] = col.mean()
        return out

    mae_steps = _mean_filled(maes)
    mse_steps = _mean_filled(mses)
    rmse_steps = _mean_filled(rmses)
    return {
        "mae_per_step": mae_steps,
        "mse_per_step": mse_steps,
        "rmse_per_step": rmse_steps,
        "mae": float(mae_steps.mean()),
        "mse": float(mse_steps.mean()),
        "rmse": float(rmse_steps.mean()),
    }
