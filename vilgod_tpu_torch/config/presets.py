"""Default configurations (the port's copy of ``vilgod_tpu.config.presets``;
the values must stay identical so both packages read one config the same way).

Parameter values mirror the reference pipeline configuration
(`tools/configs/preprocessing.yaml`,
`tools/configs/preprocessor/waymo.yaml`, `argoverse.yaml`) so that a user
of the reference finds the same knobs with the same semantics. Additions
beyond the reference live under ``capacity`` (fixed padded-buffer sizes,
which both packages use as static shapes) and ``mesh`` (device-mesh axes).
"""
from __future__ import annotations

from .confdict import Config, merge


def default_pipeline() -> list:
    # Stage list + args; mirrors tools/configs/preprocessing.yaml:50-108.
    return [
        {"name": "mask_ground_points", "args": {"min_range": 1.5, "z_offset": 1.723}},
        {
            "name": "calculate_entropy_scores",
            "args": {
                "force": False,
                "n_neighbouring_frames": 15,
                "skip_frames": 1,
                "max_neighbor_point_dist": 0.3,
                "max_neighbor_points": 1000,
                "include_ground_points": False,
            },
        },
        {"name": "spatial_clustering", "args": {"force": False, "n_frames": 2}},
        {"name": "filter_detections", "args": {"force": False}},
        {"name": "track_clusters", "args": {"force": True, "valid_only": True}},
        {
            "name": "classification",
            "args": {
                "image_size": 224,
                "key": "clip",
                "aggregation": "voting",
                "valid_only": True,
                "missing_only": False,
                "force": False,
            },
        },
        {
            "name": "fit_bounding_boxes_simple",
            "args": {
                "force": True,
                "valid_only": True,
                "fg_only": False,
                "classification_key": "clip",
                "method": {"name": "minimum_bounding_rectangle", "args": {}},
            },
        },
        {"name": "propagate_labels", "args": {"classification_key": "clip", "min_length": 5}},
        {
            "name": "evaluate_sequence",
            "args": {
                "modes": ["detection_3d"],
                "eval_range": [-50.0, -20.0, 50.0, 20.0],
                "moving": False,
                "static": False,
                "classification_key": "clip",
                "detection_3d": {
                    "class_agnostic": False,
                    "bev": False,
                    "score_thresh": 0.0,
                    "sampling_rate": 1,
                },
            },
        },
    ]


_CLIP_CLASS_LIST = [
    "car", "truck", "bus", "van", "minivan", "pickup truck", "school bus",
    "fire truck", "ambulance",
    "pedestrian", "human body", "human",
    "cyclist", "rider", "bicycle", "bike",
    "traffic light", "traffic sign", "fence", "pole", "clutter", "tree",
    "house", "wall",
]

_CLIP_CLASS_MAPPING = {
    "car": "Vehicle", "truck": "Vehicle", "bus": "Vehicle", "van": "Vehicle",
    "minivan": "Vehicle", "pickup truck": "Vehicle", "school bus": "Vehicle",
    "fire truck": "Vehicle", "ambulance": "Vehicle",
    "pedestrian": "Pedestrian", "human body": "Pedestrian", "human": "Pedestrian",
    "cyclist": "Cyclist", "rider": "Cyclist", "bicycle": "Cyclist", "bike": "Cyclist",
    "traffic light": "Background", "traffic sign": "Background",
    "fence": "Background", "pole": "Background", "clutter": "Background",
    "tree": "Background", "house": "Background", "wall": "Background",
}


def _base_preprocessor() -> dict:
    # Mirrors tools/configs/preprocessor/waymo.yaml (argoverse.yaml is near-identical).
    return {
        "name": "waymo",
        "class_names": ["Vehicle", "Pedestrian", "Cyclist"],
        "pseudo_label_tag": "vilgod_waymo",
        "clustering": {
            # radius-graph density clustering replacing hdbscan.HDBSCAN
            # (waymo.yaml:10-15); radius graph + connected components with
            # DBSCAN-style core/border semantics at matched fidelity.
            "model": {
                "cluster_selection_epsilon": 0.15,
                "min_cluster_size": 15,
                "min_samples": 5,
                "metric": "euclidean",
            },
            "filters_active": [
                "filter_by_number_points",
                "filter_by_plane_distance",
                "filter_by_height",
            ],
            "filters": [
                {"name": "filter_by_number_points",
                 "args": {"logic": "and", "required": True, "min_points": 10}},
                {"name": "filter_by_height",
                 "args": {"logic": "and", "required": True, "min_height": 0.3, "max_height": 6}},
                {"name": "filter_by_aspect_ratio",
                 "args": {"min_aspect_ratio": 1.0, "max_aspect_ratio": 5.0}},
                {"name": "filter_by_volume", "args": {"logic": "and", "min_volume": 0.5}},
                {"name": "filter_by_area", "args": {"logic": "and", "min_area": 0.35}},
                {"name": "filter_by_plane_distance",
                 "args": {"logic": "and", "required": True,
                          "max_min_height": 1.0, "min_max_height": 0.5}},
                {"name": "filter_by_density", "args": {"min_density": 0.1, "max_density": 10}},
                {"name": "filter_by_ephemeral_score",
                 "args": {"logic": "or", "percentile": 20, "min_percentile_pp_score": 0.7}},
            ],
            "entropy_score_filter": {"percentile": 30, "min_percentile_pp_score": 0.5},
            "propability_threshold": 0.3,
        },
        "tracking": {
            "cluster": {
                "mode": "cluster_center",
                "assignment": {"method": "assign_detections_greedy", "max_distance": 1.0},
                "min_length": 5,
                "max_missed": 3,
                "min_distance_dynamic": 2.0,
            },
        },
        "lidar_image_projection": {
            "depth_bias": 0.2,
            "obj_ratio": 0.8,
            "bg_clr": 0.0,
            "resolution": 112,
            "depth": 8,
            "maxpool": {"kernel_size": [1, 5, 5], "stride": 1, "padding": [0, 1, 1]},
            "conv3d": {"kernel_size": [1, 3, 3], "stride": 1, "padding": [0, 1, 1]},
            "gaussian_kernel": {"sigma": 3, "zsigma": 1},
        },
        "clip": {
            "name": "clip",
            "model_name": "ViT-B-16.pt",
            "top_k": 1,
            "split_size": 50,
            "prompt_template": "a point representation of a {}",
            "class_list": list(_CLIP_CLASS_LIST),
            "class_mapping": dict(_CLIP_CLASS_MAPPING),
        },
        "ground": {
            # Patchwork++-style segmentation defaults
            # (third_party/patchwork-plusplus/patchworkpp/include/patchworkpp.h:75-107).
            "enable_rnr": True,
            "enable_rvpf": True,
            "enable_tgr": True,
            "num_iter": 3,
            "num_lpr": 20,
            "num_min_pts": 10,
            "num_rings_of_interest": 4,
            "rnr_ver_angle_thr": -15.0,
            "rnr_intensity_thr": 0.2,
            "sensor_height": 1.723,
            "th_seeds": 0.125,
            "th_dist": 0.125,
            "th_seeds_v": 0.25,
            "th_dist_v": 0.1,
            "max_range": 80.0,
            "min_range": 2.7,
            "uprightness_thr": 0.707,
            "adaptive_seed_selection_margin": -1.2,
            "num_sectors_each_zone": [16, 32, 54, 32],
            "num_rings_each_zone": [2, 4, 4, 4],
            "elevation_thr": [0.0, 0.0, 0.0, 0.0],
            "flatness_thr": [0.0, 0.0, 0.0, 0.0],
            "max_storage": 1000,
        },
    }


def _tpu_defaults() -> dict:
    return {
        # Fixed capacities for padded, array-resident state. Static shapes
        # keep everything jittable; caps are sized for Waymo P99 and are
        # overridable per run.
        "capacity": {
            "max_points": 196608,        # per-frame padded point budget (Waymo ~165k)
            "max_ground_points": 131072,
            "max_clusters": 256,          # per-frame cluster table
            "max_cluster_points": 4096,   # per-cluster gathered point budget
            "max_tracks": 1024,           # per-sequence track pool
            "patch_capacity": 1024,       # per-CZM-patch point budget (ground seg)
            "ransac_iters": 100,
            "rect_sweep_step_deg": 0.5,   # dense angle sweep for min-area rect
            "clip_batch": 64,             # fused render+CLIP batch (4 views each)
        },
        "mesh": {"dp": -1, "tp": 1},      # -1: all remaining devices
        "dtype": {"compute": "float32", "clip": "bfloat16"},
        "random_seed": 666,
        "eval_cfg": {
            "difficulties": [2],
            "breakdown_range": False,
            "iou_thresholds": [0.4, 0.4, 0.4, 0.4],
        },
        "paths": {
            "data": None,
            "sequence_data": None,
            "results": None,
            "clip_model": None,
        },
    }


def waymo_config(**overrides) -> Config:
    cfg = Config(_tpu_defaults())
    cfg = merge(cfg, {
        "preprocessor": _base_preprocessor(),
        "pipeline": default_pipeline(),
        "pipeline_active": [
            "mask_ground_points", "calculate_entropy_scores", "spatial_clustering",
            "filter_detections", "track_clusters", "classification",
            "fit_bounding_boxes_simple", "propagate_labels", "evaluate_sequence",
        ],
    })
    return merge(cfg, overrides) if overrides else cfg


def argoverse_config(**overrides) -> Config:
    cfg = waymo_config()
    pre = _base_preprocessor()
    pre["name"] = "argoverse"
    pre["pseudo_label_tag"] = "vilgod_argoverse"
    cfg = merge(cfg, {"preprocessor": pre})
    return merge(cfg, overrides) if overrides else cfg
