from .arrays import InMemoryFEADataset, condition_to_samples
from .dataset import EpochSampler, FEADataset, collate, from_signed, to_signed
from .store import ConditionStoreBuilder, StoredFEADataset, build_condition_store

__all__ = [
    "InMemoryFEADataset",
    "condition_to_samples",
    "ConditionStoreBuilder",
    "EpochSampler",
    "FEADataset",
    "StoredFEADataset",
    "build_condition_store",
    "collate",
    "from_signed",
    "to_signed",
]
