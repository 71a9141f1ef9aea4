"""Lightweight attribute-access config tree (copy of
``vilgod_tpu.config.confdict``).

Plays the role of the reference's Hydra/OmegaConf composition
(`tools/configs/preprocessing.yaml`,
`tools/preprocess_data.py:18-23`) without the Hydra dependency: nested
dict with attribute access, YAML loading, and recursive merge. The
pipeline itself stays config-driven (an ordered list of ``{name, args}``
plus ``pipeline_active``), matching the reference contract
(`tools/configs/preprocessing.yaml:50-108`).
"""
from __future__ import annotations

import copy
from typing import Any, Iterator, Mapping


class Config(dict):
    """dict with attribute access; nested dicts are wrapped lazily."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as e:  # pragma: no cover - attribute protocol
            raise AttributeError(name) from e
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
            self[name] = value
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(name) from e

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def to_dict(self) -> dict:
        def conv(v: Any) -> Any:
            if isinstance(v, Mapping):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [conv(x) for x in v]
            return v

        return conv(self)

    def copy(self) -> "Config":  # type: ignore[override]
        return Config(copy.deepcopy(self.to_dict()))

    def walk(self, prefix: str = "") -> Iterator[tuple[str, Any]]:
        for k, v in self.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                yield from Config(v).walk(key)
            else:
                yield key, v


def merge(base: Mapping, override: Mapping) -> Config:
    """Recursive merge: ``override`` wins; dicts merge, everything else replaces."""
    out: dict = dict(copy.deepcopy(dict(base)))
    for k, v in override.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return Config(out)


def load_yaml(path: str) -> Config:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return Config(data)
