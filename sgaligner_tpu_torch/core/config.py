"""Config: the fields the model, the optimizer, the steps, the data path and
the tester read.

A copy of ``sgaligner_tpu/core/config.py``'s dataclasses with the same key
names (the registration model's section included), so a config written for
the JAX package merges unchanged (keys the port does not read are ignored
with a warning). ``make_cfg(**values)`` takes the config as a dict;
``update_config`` merges a YAML file (PyYAML is imported only there);
``make_output_tree`` derives the snapshot, log and event directories.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
import warnings
from dataclasses import dataclass, field
from typing import Any


@dataclass
class DataConfig:
    name: str = "Scan3R"
    root_dir: str = ""
    subscan_dir: str = ""
    label_file_name: str = ""
    ply_subfix: str = ""
    seg_subfix: str = ""
    aggre_subfix: str = ""


@dataclass
class PreprocessConfig:
    pc_resolutions: list[int] = field(default_factory=lambda: [512])
    subscenes_per_scene: int = 7
    min_obj_points: int = 50
    anchor_type_name: str = ""
    filter_segment_size: int = 512
    overlap_radius: float = 1e-7


@dataclass
class TrainConfig:
    batch_size: int = 4
    pc_res: int = 512
    # augmentation runs only with augmentation_active (upstream's knobs are
    # dead config; the JAX package gates them the same way)
    use_augmentation: bool = True
    rot_factor: float = 1.0
    augmentation_noise: float = 0.005
    augmentation_active: bool = False
    log_steps: int = 1
    best_metric: str = "loss"
    best_mode: str = "min"


@dataclass
class ValConfig:
    data_mode: str = "orig"
    batch_size: int = 4
    pc_res: int = 512
    overlap_low: float = 0.0
    overlap_high: float = 0.0


@dataclass
class ModelConfig:
    rel_dim: int = 41
    attr_dim: int = 164
    # overlap detection: a pair overlaps when its alignment score is above
    alignment_thresh: float = 0.4
    emb_dim: int = 100
    pt_out_dim: int = 256
    hidden_units: list[int] = field(default_factory=lambda: [3, 128, 128])
    heads: list[int] = field(default_factory=lambda: [2, 2])
    dropout: float = 0.0
    # "parity": upstream PointNet computes its BatchNorms and drops them
    # (the only mode ported)
    pointnet_bn_mode: str = "parity"


@dataclass
class OptimConfig:
    lr: float = 1e-3
    lr_decay: float = 0.95
    lr_decay_steps: int = 1
    weight_decay: float = 1e-6
    max_epoch: int = 50
    grad_acc_steps: int = 1
    # "none" (constant, upstream's choice), "exponential", "cosine",
    # "warmup-cosine"
    scheduler: str = "none"
    warmup_steps: int = 0
    # steps per epoch for epoch-denominated schedules; 0 = decay per step
    steps_per_epoch: int = 0


@dataclass
class LossConfig:
    zoom: float = 0.1


@dataclass
class RegModelConfig:
    """The registration section (``reg_model``), with the JAX package's
    names and defaults. The port runs ``backend: "ransac"`` (the classical
    mutual-NN + RANSAC backend) and ``"learned"`` (the coarse-to-fine
    matcher); ``"geotransformer"`` is not ported and raises in
    ``reg.backend.build_backend``."""

    K: int = 1
    neighbor_limits: list[int] = field(default_factory=lambda: [38, 36, 36, 38])
    num_p2p_corrs: int = 20000
    corr_score_thresh: float = 0.1
    rmse_thresh: float = 0.2
    inlier_ratio_thresh: float = 0.05
    ransac_threshold: float = 0.03
    ransac_min_iters: int = 5000
    ransac_max_iters: int = 5000
    ransac_use_sprt: bool = True
    backend: str = "ransac"
    # coarse initializer of the mutual-NN backend: "none" (upstream's
    # same-world-frame evaluation) or "pca" (principal axes, for pairs with
    # a non-identity gt transform)
    coarse: str = "none"


@dataclass
class MetricsConfig:
    all_k: list[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])


@dataclass
class TpuConfig:
    """Static-shape knobs (the section keeps the JAX package's name)."""

    max_objects: int = 48
    points_per_object: int = 512
    # "bfloat16" or "float32" (parameters stay float32)
    compute_dtype: str = "float32"
    # data-parallel size: only 1 (or 0, one device) is ported
    dp: int = 0
    # per-pair compaction (not ported: the loader and the model raise)
    compact_slots: int = 0
    # batch-pooled compaction (data/batch.py::pool_compact) bucket; 0 = off
    pooled_bucket: int = 0


@dataclass
class Config:
    seed: int = 42
    num_workers: int = 4
    model_name: str = ""
    modules: list[str] = field(default_factory=list)
    registration: bool = False
    scan_type: str = "subscan"

    data: DataConfig = field(default_factory=DataConfig)
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    val: ValConfig = field(default_factory=ValConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    reg_model: RegModelConfig = field(default_factory=RegModelConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    tpu: TpuConfig = field(default_factory=TpuConfig)

    # derived by update_config
    output_dir: str = ""
    snapshot_dir: str = ""
    log_dir: str = ""
    event_dir: str = ""
    exp_name: str = ""


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


def load_yaml(filename: str) -> dict[str, Any]:
    import yaml

    with open(filename) as f:
        return yaml.safe_load(f) or {}


def update_config(cfg: Config, filename: str, ensure_dir: bool = True,
                  output_root: str | None = None) -> Config:
    """Merge a YAML file into ``cfg``; with ``ensure_dir``, derive and
    create its output tree (``make_output_tree``)."""
    _merge_into_dataclass(cfg, load_yaml(filename))
    if ensure_dir:
        make_output_tree(cfg, output_root)
    return cfg


def make_output_tree(cfg: Config, output_root: str | None = None) -> Config:
    """Derive and create the output tree ``<root>/output/<data.name>/
    <model_name>/<modules joined by '_'>`` with ``snapshots/``, ``logs/``
    and ``events/`` (root: ``output_root``, else the working directory);
    a config given as a dict gets its tree here."""
    root = output_root if output_root is not None else os.getcwd()
    cfg.exp_name = "_".join(cfg.modules)
    cfg.output_dir = osp.join(root, "output", cfg.data.name, cfg.model_name,
                              cfg.exp_name)
    cfg.snapshot_dir = osp.join(cfg.output_dir, "snapshots")
    cfg.log_dir = osp.join(cfg.output_dir, "logs")
    cfg.event_dir = osp.join(cfg.output_dir, "events")
    for d in (cfg.output_dir, cfg.snapshot_dir, cfg.log_dir, cfg.event_dir):
        os.makedirs(d, exist_ok=True)
    return cfg


def to_dict(cfg: Config) -> dict[str, Any]:
    return dataclasses.asdict(cfg)
