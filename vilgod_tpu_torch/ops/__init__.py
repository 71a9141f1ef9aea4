"""Geometry kernel library of the port: banded and dense neighbour passes
(CUDA kernels with plain PyTorch versions), entropy, density clustering,
box geometry, per-cluster statistics, transforms and the
jax.random-compatible draws. Exports every name of
``vilgod_tpu/ops/__init__.py``."""
from .boxes import (bin_angles, box_corners_3d, box_corners_bev,
                    closeness_rect, get_box_heights, iou3d_matrix,
                    iou_bev_matrix, min_area_rect, pca_rect, points_in_boxes,
                    variance_rect)
from .cluster import (build_cluster_table, cluster_sizes, compact_labels,
                      dbscan_labels)
from .entropy import entropy_from_counts, entropy_scores_window, entropy_sequence
from .neighbors import (chamfer_distance, knn, knn_labels, radius_count,
                        radius_count_self)
from .plane import (fit_ground_plane, pca_plane_stats, point_plane_distance,
                    ransac_plane, refine_plane_lsq)
from .rasterize import NUM_VIEWS, cluster_to_origin, render_cluster_views
from .segment import (convex_hull_area_bev, gather_cluster_points,
                      hull_area_by_label, seg_count, seg_count_by_label,
                      seg_max, seg_max_by_label, seg_mean, seg_median,
                      seg_median_by_label, seg_min, seg_min_by_label,
                      seg_percentile, seg_percentile_by_label)
from .transforms import (apply_transform, apply_transform_boxes, euler2mat,
                         invert_se3, make_se3, rot_x, rot_y, rot_z, yaw_of)

__all__ = [
    "bin_angles", "box_corners_3d", "box_corners_bev", "closeness_rect",
    "get_box_heights", "iou3d_matrix", "iou_bev_matrix", "min_area_rect",
    "pca_rect", "points_in_boxes", "variance_rect",
    "build_cluster_table", "cluster_sizes", "compact_labels", "dbscan_labels",
    "entropy_from_counts", "entropy_scores_window", "entropy_sequence",
    "chamfer_distance", "knn", "knn_labels", "radius_count",
    "radius_count_self",
    "fit_ground_plane", "pca_plane_stats", "point_plane_distance",
    "ransac_plane", "refine_plane_lsq",
    "NUM_VIEWS", "cluster_to_origin", "render_cluster_views",
    "convex_hull_area_bev", "gather_cluster_points", "hull_area_by_label",
    "seg_count", "seg_count_by_label", "seg_max", "seg_max_by_label",
    "seg_mean", "seg_median", "seg_median_by_label", "seg_min",
    "seg_min_by_label", "seg_percentile", "seg_percentile_by_label",
    "apply_transform", "apply_transform_boxes", "euler2mat", "invert_se3",
    "make_se3", "rot_x", "rot_y", "rot_z", "yaw_of",
]
