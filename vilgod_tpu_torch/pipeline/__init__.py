from .runner import STAGE_REGISTRY, ZeroShotDetector, run_sequences
from .state import (CLS_NONE, MAPPED_CLASSES, ST_MOVING, ST_STATIC, ST_UNSET,
                    Capacity, SequenceState)

__all__ = [
    "STAGE_REGISTRY", "ZeroShotDetector", "run_sequences",
    "Capacity", "SequenceState", "MAPPED_CLASSES",
    "CLS_NONE", "ST_MOVING", "ST_STATIC", "ST_UNSET",
]
