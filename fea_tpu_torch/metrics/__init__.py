"""Accuracy metrics against ground-truth solves and dataset statistics; the
port's own copy of fea_tpu/metrics (host NumPy and PIL)."""

from .accuracy import (
    accuracy_for_one_sample,
    calculate_accuracy,
    calculate_accuracy_per_step,
    predicted_displacement_at_nodes,
)
from .stats import dataset_displacement_stats

__all__ = [
    "accuracy_for_one_sample",
    "calculate_accuracy",
    "calculate_accuracy_per_step",
    "predicted_displacement_at_nodes",
    "dataset_displacement_stats",
]
