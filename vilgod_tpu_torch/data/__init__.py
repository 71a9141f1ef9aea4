from .argoverse import ArgoverseSequenceDataset
from .base import SequenceDataset, SequenceSource
from .export import export_pseudo_dataset, export_pseudo_labels
from .openpcdet import OpenPCDetSequenceDataset
from .synthetic import SyntheticDataset, SyntheticSequence
from .waymo import WaymoSequenceDataset

__all__ = ["SequenceDataset", "SequenceSource", "SyntheticDataset",
           "export_pseudo_dataset", "export_pseudo_labels",
           "SyntheticSequence", "OpenPCDetSequenceDataset",
           "WaymoSequenceDataset", "ArgoverseSequenceDataset"]
