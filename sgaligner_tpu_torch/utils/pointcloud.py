"""Host-side point-cloud utilities (numpy and scipy).

A copy of the parts of ``sgaligner_tpu/utils/pointcloud.py`` that the
registration stack and the demo read: farthest-point sampling, the
exact-match overlap, 1-NN distances, rigid transforms. Nearest neighbours
are scipy ``cKDTree`` queries; the JAX package's optional C++ kd-tree (a
host speed-up for support sets above 5,000 points, with the same answers)
is not ported.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def pcl_farthest_sample(point: np.ndarray, npoint: int, return_idxs: bool = False,
                        rng: np.random.Generator | None = None):
    """Farthest point sampling (upstream point_cloud.py:61-89 semantics).

    N < npoint falls back to random choice WITH replacement like upstream
    (np.random.choice default), since 3RScan objects routinely have fewer
    than 512 points.
    """
    rng = rng or np.random.default_rng()
    n = point.shape[0]
    if n < npoint:
        indices = rng.choice(n, npoint, replace=True)
        out = point[indices]
        return (out, indices.astype(np.int32)) if return_idxs else out

    xyz = point[:, :3]
    centroids = np.zeros(npoint, dtype=np.int64)
    distance = np.full(n, 1e10)
    farthest = int(rng.integers(0, n))
    for i in range(npoint):
        centroids[i] = farthest
        dist = np.sum((xyz - xyz[farthest]) ** 2, axis=-1)
        np.minimum(distance, dist, out=distance)
        farthest = int(np.argmax(distance))
    out = point[centroids]
    return (out, centroids.astype(np.int32)) if return_idxs else out


def compute_pcl_overlap(source: np.ndarray, target: np.ndarray,
                        threshold: float = 1e-7):
    """Overlap ratio source->target (upstream point_cloud.py:91-103): the
    share of source points with a target point within ``threshold`` (a
    kd-tree radius query), rounded to 4 places, and their indices."""
    source = np.asarray(source)
    ctree = cKDTree(np.asarray(target, np.float64))
    neighbors = ctree.query_ball_point(np.asarray(source, np.float64), threshold)
    common_pts_idx_src = np.array([i for i, lst in enumerate(neighbors) if lst],
                                  dtype=np.int64)
    overlap_ratio = round(common_pts_idx_src.shape[0] / source.shape[0], 4)
    return overlap_ratio, common_pts_idx_src


def inverse_relative(pose1to2: np.ndarray) -> np.ndarray:
    """Rigid pose inverse (upstream point_cloud.py:105-110)."""
    pose2to1 = np.zeros((4, 4), dtype="float32")
    pose2to1[:3, :3] = pose1to2[:3, :3].T
    pose2to1[:3, 3:4] = -pose1to2[:3, :3].T @ pose1to2[:3, 3:4]
    pose2to1[3, 3] = 1
    return pose2to1


def get_nearest_neighbor(q_points: np.ndarray, s_points: np.ndarray,
                         return_index: bool = False):
    """KD-tree 1-NN distances of ``q_points`` in ``s_points`` (upstream
    point_cloud.py:136-147)."""
    distances, indices = cKDTree(s_points).query(q_points, k=1)
    return (distances, indices) if return_index else distances


def apply_transform(points: np.ndarray, transform: np.ndarray,
                    normals: np.ndarray | None = None):
    """``points @ R.T + t`` (and the normals rotated)."""
    rotation = transform[:3, :3]
    translation = transform[:3, 3]
    points = points @ rotation.T + translation
    if normals is not None:
        return points, normals @ rotation.T
    return points
