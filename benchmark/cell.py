"""A cell's files, found by name: ``workloads/<cell>.json`` (its traffic
and check sample), ``configs/<config>.json`` (the configuration as run),
``limits/<config>.json`` (the limits of ``correct``'s numbers)."""
from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def load(name: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(workload, configuration, limits) of cell ``name``."""
    workload = json.loads((root / "workloads" / f"{name}.json").read_text())
    config = json.loads(
        (root / "configs" / f"{workload['config']}.json").read_text())
    limits = json.loads(
        (root / "limits" / f"{workload['config']}.json").read_text())
    return workload, config, limits


def program_config(config: dict):
    """The program's configuration of ``config``: its preprocessor's
    preset with the file's caps and stages, the file's prompts checked
    against the preset's."""
    from vilgod_tpu_torch import config as presets

    make = getattr(presets, f"{config['preprocessor']}_config")
    cfg = make(capacity=dict(config["capacity"]),
               pipeline_active=list(config["pipeline_active"]))
    clip = cfg["preprocessor"]["clip"]
    prompts = config["prompts"]
    if (clip["prompt_template"] != prompts["template"]
            or list(clip["class_list"]) != prompts["class_list"]
            or dict(clip["class_mapping"]) != prompts["class_mapping"]):
        raise ValueError(f"{config['name']}: the program's prompts differ "
                         "from the configuration file's")
    args = {p["name"]: p.get("args", {}) for p in cfg["pipeline"]}
    proj = cfg["preprocessor"]["lidar_image_projection"]
    if (any(args["calculate_entropy_scores"][k] != v
            for k, v in config["entropy"].items())
            or any(proj[k] != v for k, v in config["projection"].items()
                   if k != "image_size")):
        raise ValueError(f"{config['name']}: the program's entropy or "
                         "projection settings differ from the file's")
    clu = cfg["preprocessor"]["clustering"]
    model = clu["model"]
    stated = dict(n_frames=args["spatial_clustering"].get("n_frames", 2),
                  eps=model["cluster_selection_epsilon"],
                  min_samples=model["min_samples"],
                  min_cluster_size=model["min_cluster_size"],
                  prob_threshold=clu["propability_threshold"])
    active = [f for f in clu["filters"] if f["name"] in clu["filters_active"]]
    if (stated != config["clustering"]
            or sorted(active, key=lambda f: f["name"])
            != sorted(config["filter"]["filters"], key=lambda f: f["name"])
            or cfg["capacity"].get("ransac_iters", 100)
            != config["filter"]["ransac_iters"]
            or cfg.get("random_seed", 666) != config["random_seed"]):
        raise ValueError(f"{config['name']}: the program's clustering or "
                         "filter settings differ from the file's")
    return cfg
