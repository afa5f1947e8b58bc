"""Registration metrics (numpy host side).

A copy of ``sgaligner_tpu/reg/metrics.py``: equivalents of upstream's
utils/registration.py with Open3D's KDTreeFlann replaced by scipy cKDTree
(identical 1-NN semantics): modified chamfer distance (:9-17), inlier ratio
(:19-24), registration RMSE (:26-29), isotropic RRE/RTE (:65-105), and
mosaicking precision/recall/acc/comp/F1 (:107-143).
"""

from __future__ import annotations

import numpy as np

from sgaligner_tpu_torch.utils.pointcloud import apply_transform, get_nearest_neighbor


def compute_modified_chamfer_distance(src_points, ref_points, raw_points,
                                      est_transform, gt_transform):
    aligned_src = apply_transform(src_points, est_transform)
    cd_p_q = get_nearest_neighbor(aligned_src, raw_points).mean()
    composed = est_transform @ np.linalg.inv(gt_transform)
    aligned_raw = apply_transform(raw_points, composed)
    cd_q_p = get_nearest_neighbor(ref_points, aligned_raw).mean()
    return cd_p_q + cd_q_p


def compute_inlier_ratio(ref_corr_points, src_corr_points, transform,
                         positive_radius: float = 0.1):
    src_corr_points = apply_transform(src_corr_points, transform)
    residuals = np.sqrt(((ref_corr_points - src_corr_points) ** 2).sum(1))
    return float(np.mean(residuals < positive_radius))


def compute_registration_rmse(ref_points, src_points, transform):
    if src_points.shape[0] == 0:
        return float("inf")  # no GT correspondences -> never "accepted"
    src_points = apply_transform(src_points, transform)
    return float(np.sqrt(((ref_points - src_points) ** 2).sum() / src_points.shape[0]))


def get_rotation_translation_from_transform(transform, inverse_trans: bool = False):
    rotation = transform[:3, :3]
    translation = transform[3, :3] if inverse_trans else transform[:3, 3]
    return rotation, translation


def compute_relative_rotation_error(gt_rotation, est_rotation):
    x = 0.5 * (np.trace(est_rotation.T @ gt_rotation) - 1.0)
    x = np.clip(x, -1.0, 1.0)
    return float(180.0 * np.arccos(x) / np.pi)


def compute_relative_translation_error(gt_translation, est_translation):
    return float(np.linalg.norm(gt_translation - est_translation))


def compute_registration_error(gt_transform, est_transform,
                               inverse_trans: bool = False):
    gt_r, gt_t = get_rotation_translation_from_transform(gt_transform)
    est_r, est_t = get_rotation_translation_from_transform(est_transform,
                                                           inverse_trans)
    return (compute_relative_rotation_error(gt_r, est_r),
            compute_relative_translation_error(gt_t, est_t))


def nn_correspondence(verts1, verts2):
    """For each vertex in verts2, nearest vertex in verts1 (registration.py:107-129)."""
    if len(verts1) == 0 or len(verts2) == 0:
        return [], []
    distances, indices = get_nearest_neighbor(np.asarray(verts2),
                                              np.asarray(verts1),
                                              return_index=True)
    return list(np.atleast_1d(indices)), list(np.atleast_1d(distances))


def compute_mosaicking_error(verts_pred, verts_gt, threshold: float = 0.05):
    _, dist1 = nn_correspondence(verts_pred, verts_gt)
    _, dist2 = nn_correspondence(verts_gt, verts_pred)
    dist1, dist2 = np.array(dist1), np.array(dist2)
    precision = np.mean((dist2 < threshold).astype(float))
    recall = np.mean((dist1 < threshold).astype(float))
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return {"prec": precision, "recall": recall,
            "acc": float(np.mean(dist1)), "comp": float(np.mean(dist2)),
            "fscore": f1}
