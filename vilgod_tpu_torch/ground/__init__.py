from .patchwork import (GroundConfig, GroundState, ground_config_from_cfg,
                        init_ground_state, segment_ground, segment_sequence)

__all__ = ["GroundConfig", "GroundState", "ground_config_from_cfg",
           "init_ground_state", "segment_ground", "segment_sequence"]
