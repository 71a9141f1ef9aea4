from .mesh import Mesh, frame_sharding, local_devices, make_mesh, replicated
from .sharded import (global_detection_count, sharded_cluster_chunk,
                      sharded_entropy, sharded_filter_metrics,
                      sharded_ground)

__all__ = ["make_mesh", "frame_sharding", "replicated",
           "sharded_entropy", "sharded_cluster_chunk", "sharded_ground",
           "sharded_filter_metrics",
           "global_detection_count",
           "Mesh", "local_devices"]
