from .dataset import EpochSampler, FEADataset, collate, from_signed, to_signed

__all__ = ["EpochSampler", "FEADataset", "collate", "from_signed", "to_signed"]
