from .detection_metrics import waymo_detection_ap
from .format import EVAL_MAPPING, format_eval_log, print_eval_log
from .masking import evaluate_detections, mask_eval_annos
from .sequence_eval import (Accuracy, ClusterResult, SequenceEvaluation,
                            evaluate_sequence_quality)

__all__ = ["waymo_detection_ap", "evaluate_detections", "mask_eval_annos",
           "EVAL_MAPPING", "format_eval_log", "print_eval_log",
           "ClusterResult", "Accuracy", "SequenceEvaluation",
           "evaluate_sequence_quality"]
