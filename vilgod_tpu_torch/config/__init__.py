from .confdict import Config, load_yaml, merge
from .presets import waymo_config, argoverse_config, default_pipeline

__all__ = [
    "Config",
    "load_yaml",
    "merge",
    "waymo_config",
    "argoverse_config",
    "default_pipeline",
]
