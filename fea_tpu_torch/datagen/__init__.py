"""Datagen, the port of fea_tpu/datagen: samplers, writers, the sequential
pipeline and the batched plate-group scheduler."""

from .batched import PlateSolver, generate_data_batched
from .conditions import ConditionSampler
from .pipeline import generate_data
from .regions import cluster_regions

__all__ = ["ConditionSampler", "PlateSolver", "cluster_regions", "generate_data", "generate_data_batched"]
