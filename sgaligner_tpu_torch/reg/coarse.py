"""Pose-invariant coarse rigid alignment (classical PCA + hypothesis scoring).

A copy of ``sgaligner_tpu/reg/coarse.py``.

The reference's evaluation setting has all subscans in ONE world frame
(gt_transform == I, upstream's
src/inference/sgaligner/inference_align_reg.py:168),
so its correspondence engine never needs to bridge a pose gap on its own —
GeoTransformer's learned features do that implicitly. The self-contained
MutualNN backend, by contrast, matches points by proximity and needs a coarse
initializer when src/ref are NOT co-registered: centroid + principal-axes
alignment with the 4 proper-rotation sign hypotheses, scored by
nearest-neighbor RMSE.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def _principal_axes(points: np.ndarray) -> np.ndarray:
    """Right-handed eigenbasis of the point covariance, columns sorted by
    descending eigenvalue."""
    c = points - points.mean(axis=0)
    cov = c.T @ c / max(len(points), 1)
    vals, vecs = np.linalg.eigh(cov)
    vecs = vecs[:, ::-1]  # descending
    if np.linalg.det(vecs) < 0:
        vecs[:, -1] = -vecs[:, -1]
    return vecs


# the 4 sign matrices with det=+1 (axis flips preserving handedness)
_SIGNS = [np.diag(s) for s in
          ([1.0, 1, 1], [1.0, -1, -1], [-1.0, 1, -1], [-1.0, -1, 1])]


def pca_coarse_align(src: np.ndarray, ref: np.ndarray,
                     n_score: int = 512, seed: int = 0) -> np.ndarray:
    """Coarse rigid [4, 4] transform mapping src into ref's frame.

    R = U_ref · S · U_srcᵀ for each of the 4 proper sign hypotheses S;
    the hypothesis with the lowest NN-RMSE (subsampled) wins."""
    rng = np.random.default_rng(seed)
    us, ur = _principal_axes(src), _principal_axes(ref)
    cs, cr = src.mean(axis=0), ref.mean(axis=0)

    probe = src[rng.choice(len(src), min(n_score, len(src)), replace=False)]
    tree = cKDTree(ref)
    best, best_rmse = np.eye(4), np.inf
    for s in _SIGNS:
        r = ur @ s @ us.T
        t = cr - r @ cs
        d, _ = tree.query(probe @ r.T + t, k=1)
        rmse = float(np.sqrt(np.mean(d ** 2)))
        if rmse < best_rmse:
            best_rmse = rmse
            best = np.eye(4)
            best[:3, :3] = r
            best[:3, 3] = t
    return best
