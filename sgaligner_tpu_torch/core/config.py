"""Config: the fields ``build_model`` and the serving step read.

A trimmed copy of ``sgaligner_tpu/core/config.py``'s dataclasses with the same
key names, so a config dict written for the JAX package merges unchanged
(keys the port does not read are ignored with a warning).
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Any


@dataclass
class ModelConfig:
    rel_dim: int = 41
    attr_dim: int = 164
    emb_dim: int = 100
    pt_out_dim: int = 256
    hidden_units: list[int] = field(default_factory=lambda: [3, 128, 128])
    heads: list[int] = field(default_factory=lambda: [2, 2])
    dropout: float = 0.0


@dataclass
class TpuConfig:
    """Static-shape knobs (the section keeps the JAX package's name)."""

    max_objects: int = 48
    points_per_object: int = 512
    # "bfloat16" or "float32" (parameters stay float32)
    compute_dtype: str = "float32"


@dataclass
class Config:
    seed: int = 42
    modules: list[str] = field(default_factory=list)
    model: ModelConfig = field(default_factory=ModelConfig)
    tpu: TpuConfig = field(default_factory=TpuConfig)


def _merge_into_dataclass(obj: Any, values: dict[str, Any], path: str = "") -> None:
    valid = {f.name for f in dataclasses.fields(obj)}
    for key, val in values.items():
        if key not in valid:
            warnings.warn(f"Unknown config key: {path}{key}", stacklevel=2)
            continue
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            _merge_into_dataclass(cur, val, path=f"{path}{key}.")
        else:
            setattr(obj, key, val)


def make_cfg(**overrides: Any) -> Config:
    cfg = Config()
    if overrides:
        _merge_into_dataclass(cfg, overrides)
    return cfg
