"""Human-readable AP table formatting; the port's own copy of
``vilgod_tpu/eval/format.py`` (the reference's ``EVAL_MAPPING`` /
``print_eval_log``, range-breakdown keys generated)."""
from __future__ import annotations


def _build_mapping() -> dict:
    mapping = {}
    for cls in ("VEHICLE", "PEDESTRIAN", "CYCLIST"):
        nice = cls.capitalize()
        for level in (1, 2):
            mapping[f"OBJECT_TYPE_TYPE_{cls}_LEVEL_{level}/AP"] = (
                f"{nice} AP  L{level}")
            mapping[f"OBJECT_TYPE_TYPE_{cls}_LEVEL_{level}/APH"] = (
                f"{nice} APH L{level}")
    for cls in ("VEHICLE", "PEDESTRIAN", "CYCLIST"):
        nice = cls.capitalize()
        for level in (1, 2):
            for rng in ("[0, 30)", "[30, 50)", "[50, +inf)"):
                mapping[f"RANGE_TYPE_{cls}_{rng}_LEVEL_{level}/AP"] = (
                    f"{nice} AP  L{level} {rng}")
                mapping[f"RANGE_TYPE_{cls}_{rng}_LEVEL_{level}/APH"] = (
                    f"{nice} APH L{level} {rng}")
    return mapping


EVAL_MAPPING = _build_mapping()


def format_eval_log(ap_dict: dict) -> list[str]:
    """Ordered, aligned metric lines (eval_utils.print_eval_log)."""
    lines = []
    width = max((len(v) for k, v in EVAL_MAPPING.items() if k in ap_dict),
                default=0)
    for key, label in EVAL_MAPPING.items():
        if key in ap_dict:
            val = ap_dict[key]
            val = float(val if not hasattr(val, "shape") else val)
            lines.append(f"{label:<{width}} : {val:.4f}")
    for key in sorted(ap_dict):
        if key not in EVAL_MAPPING:
            lines.append(f"{key} : {float(ap_dict[key]):.4f}")
    return lines


def print_eval_log(ap_dict: dict, logger=None):
    for line in format_eval_log(ap_dict):
        (logger.info if logger else print)(line)
