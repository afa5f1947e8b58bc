"""Point-registration backends.

Counterpart of ``sgaligner_tpu/reg/backend.py``. The evaluator consumes a
backend with GeoTransformer inference's output contract
(``estimated_transform``, ``src_corr_points``, ``ref_corr_points``,
``corr_scores``):

* ``MutualNNBackend``: the classical backend. Voxel downsampling, mutual
  nearest-neighbour correspondences (scipy kd-trees on the host),
  distance-kernel scores, the rigid fit by RANSAC on the device
  (``reg/ransac.py``), optionally a PCA coarse alignment first
  (``coarse="pca"``) and ICP after (``reg/icp.py``).
* ``LearnedBackend`` (``reg/learned.py``, ``backend: "learned"``): the
  coarse-to-fine matcher with the tracked ``geo_reg`` weights.
* ``backend: "geotransformer"`` (upstream's external GeoTransformer) is not
  ported: ``build_backend`` raises for it (ROADMAP.md).
"""

from __future__ import annotations

import os.path as osp
from typing import Protocol

import numpy as np
import torch

from sgaligner_tpu_torch.reg.ransac import find_rigid_transform
from sgaligner_tpu_torch.utils.pointcloud import apply_transform, get_nearest_neighbor


class RegistrationBackend(Protocol):
    def register(self, src_points: np.ndarray, ref_points: np.ndarray,
                 gt_transform: np.ndarray | None = None) -> dict | None: ...


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """First-point-per-voxel downsampling (Open3D voxel_down_sample role)."""
    if len(points) == 0:
        return points
    keys = np.floor(points / voxel_size).astype(np.int64)
    _, first = np.unique(keys, axis=0, return_index=True)
    return points[np.sort(first)]


class MutualNNBackend:
    def __init__(self, voxel_size: float = 0.025, score_sigma: float = 0.05,
                 max_points: int = 10000, ransac_threshold: float = 0.03,
                 ransac_iters: int = 1000, seed: int = 0,
                 refine_icp: bool = False, icp_iters: int = 10,
                 coarse: str = "none", device: str | torch.device = "cuda"):
        self.voxel_size = voxel_size
        self.score_sigma = score_sigma
        self.max_points = max_points
        self.ransac_threshold = ransac_threshold
        self.ransac_iters = ransac_iters
        self.seed = seed
        self.refine_icp = refine_icp
        self.icp_iters = icp_iters
        # "pca": principal-axes coarse alignment before NN matching, for
        # src/ref that are not co-registered; "none" keeps upstream's
        # same-world-frame evaluation
        self.coarse = coarse
        self.device = device

    def register(self, src_points: np.ndarray, ref_points: np.ndarray,
                 gt_transform: np.ndarray | None = None) -> dict | None:
        rng = np.random.default_rng(self.seed)
        # upstream's 10k-point cap (registration_evaluator.py:59-66)
        if src_points.shape[0] > self.max_points:
            src_points = src_points[rng.choice(len(src_points), self.max_points,
                                               replace=False)]
        if ref_points.shape[0] > self.max_points:
            ref_points = ref_points[rng.choice(len(ref_points), self.max_points,
                                               replace=False)]

        src_d = voxel_downsample(src_points, self.voxel_size)
        ref_d = voxel_downsample(ref_points, self.voxel_size)
        if len(src_d) < 3 or len(ref_d) < 3:
            return None

        # correspondences are found in the (coarsely) aligned frame but
        # returned in the original frames: the rigid fit estimates the full
        # transform from them
        src_m = src_d
        if self.coarse == "pca":
            from sgaligner_tpu_torch.reg.coarse import pca_coarse_align

            src_m = apply_transform(src_d, pca_coarse_align(src_d, ref_d,
                                                            seed=self.seed))

        d_sr, i_sr = get_nearest_neighbor(src_m, ref_d, return_index=True)
        _, i_rs = get_nearest_neighbor(ref_d, src_m, return_index=True)
        mutual = i_rs[i_sr] == np.arange(len(src_d))
        if mutual.sum() < 3:
            return None

        src_corr = src_d[mutual]
        ref_corr = ref_d[i_sr[mutual]]
        scores = np.exp(-d_sr[mutual] / self.score_sigma)

        est, _ = find_rigid_transform(src_corr.astype(np.float32),
                                      ref_corr.astype(np.float32),
                                      threshold=self.ransac_threshold,
                                      max_iters=self.ransac_iters,
                                      seed=self.seed, device=self.device)
        if est is None:
            return None
        if self.refine_icp:
            from sgaligner_tpu_torch.reg.icp import icp_refine_host

            est, _ = icp_refine_host(src_d, ref_d, init_transform=est,
                                     iters=self.icp_iters,
                                     max_corr_dist=4 * self.voxel_size,
                                     seed=self.seed, device=self.device)
        return {
            "estimated_transform": est,
            "src_corr_points": src_corr,
            "ref_corr_points": ref_corr,
            "corr_scores": scores,
        }


REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
GEO_CHECKPOINT = osp.join(REPO, "checkpoints", "torch", "geo_reg.pth.tar")


def build_backend(cfg, reg_snapshot: str | None = None,
                  device: str | torch.device = "cuda") -> RegistrationBackend:
    """The backend ``cfg.reg_model.backend`` names, on ``device``:
    ``"ransac"`` (``MutualNNBackend``) or ``"learned"`` (``LearnedBackend``
    with ``reg_snapshot``, by default the tracked weights and their
    ``geo_meta.json`` in ``checkpoints/torch/geo_reg.pth.tar``);
    ``"geotransformer"`` raises."""
    backend = cfg.reg_model.backend
    if backend == "geotransformer":
        raise NotImplementedError(
            "registration backend 'geotransformer' is not ported (ROADMAP.md); "
            "use backend: 'learned' or 'ransac'")
    if backend == "learned":
        from sgaligner_tpu_torch.reg.learned import LearnedBackend

        return LearnedBackend(checkpoint=reg_snapshot or GEO_CHECKPOINT, device=device)
    if backend != "ransac":
        raise ValueError(f"unknown registration backend {backend!r}")
    if reg_snapshot is not None:
        raise ValueError("the 'ransac' backend takes no --reg_snapshot")
    return MutualNNBackend(ransac_threshold=cfg.reg_model.ransac_threshold,
                           ransac_iters=cfg.reg_model.ransac_max_iters,
                           coarse=cfg.reg_model.coarse, device=device)
