from .base import SequenceDataset, SequenceSource
from .synthetic import SyntheticDataset, SyntheticSequence

__all__ = ["SequenceDataset", "SequenceSource", "SyntheticDataset",
           "SyntheticSequence"]
