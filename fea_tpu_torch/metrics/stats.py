"""Dataset statistics utility (the port's own copy of
fea_tpu/metrics/stats.py, over the port's read_vtk).

Mirrors the reference's setscale.py (test_scripts/setscale.py:1-45): scan
solved VTK files for the displacement distribution — the basis of the
+-0.05 clip/decode range used across metrics and app sampling."""

import os
from typing import Dict

import numpy as np

from ..mesh import read_vtk


def dataset_displacement_stats(data_dir: str) -> Dict[str, float]:
    maxes, mins, means, medians, stds = [], [], [], [], []
    for root, _dirs, files in os.walk(data_dir):
        for name in files:
            if not (name.startswith("domain.") and name.endswith(".vtk")):
                continue
            data = read_vtk(os.path.join(root, name))
            if "u" not in data:
                continue
            u = data["u"][:, :2]
            maxes.append(u.max())
            mins.append(u.min())
            means.append(u.mean())
            medians.append(float(np.median(u)))
            stds.append(u.std())
    if not maxes:
        return {}
    return {
        "max": float(np.max(maxes)),
        "min": float(np.min(mins)),
        "mean": float(np.mean(means)),
        "median": float(np.median(medians)),
        "std": float(np.mean(stds)),
        "num_files": len(maxes),
    }
