from .common import (angle_between_vectors, build_number_file_path,
                     check_and_create_dir, create_logger, extract_groups,
                     flatten, interpolate_bounding_boxes, print_separator,
                     resolve_device, set_random_seed)

__all__ = ["angle_between_vectors", "build_number_file_path",
           "check_and_create_dir", "create_logger", "extract_groups",
           "flatten", "interpolate_bounding_boxes", "print_separator",
           "resolve_device", "set_random_seed"]
