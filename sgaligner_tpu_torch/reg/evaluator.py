"""Registration evaluator: normal and aligner-seeded paths with metric
scoring.

Counterpart of ``sgaligner_tpu/reg/evaluator.py`` (upstream's
registration_evaluator.py:16-220) over a pluggable backend:

* ``run_normal_registration``: the backend on the whole (<=10k pt) clouds
  (:92-127).
* ``run_aligner_registration``: one backend call per node correspondence;
  each object pair's point correspondences capped at ``num_p2p_corrs /
  len(node_corrs)`` by score (:157-161); the pooled correspondences go to
  the rigid RANSAC fit on the device (``reg/ransac.py``). A backend with
  ``register_batch`` registers every object pair in one call.
* ``evaluate_registration``: CD / IR / RRE / RTE / recall(RMSE<thresh) /
  FMR (:47-56).

The fit runs on ``device`` (by default the backend's): the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np

import torch

from sgaligner_tpu_torch.reg import metrics as rm
from sgaligner_tpu_torch.reg.backend import RegistrationBackend
from sgaligner_tpu_torch.reg.ransac import find_rigid_transform


class RegistrationEvaluator:
    def __init__(self, cfg, backend: RegistrationBackend, logger=None,
                 device: str | torch.device | None = None):
        self.backend = backend
        self.device = device if device is not None else getattr(backend, "device",
                                                                "cuda")
        self.logger = logger
        self.num_p2p_corrs = cfg.reg_model.num_p2p_corrs
        self.ransac_threshold = cfg.reg_model.ransac_threshold
        self.ransac_min_iters = cfg.reg_model.ransac_min_iters
        self.ransac_max_iters = cfg.reg_model.ransac_max_iters
        self.inlier_ratio_thresh = cfg.reg_model.inlier_ratio_thresh
        self.rmse_thresh = cfg.reg_model.rmse_thresh
        self.min_object_points = 50

    def evaluate_registration(self, src_points, ref_points, raw_points,
                              est_transform, gt_transform,
                              src_corr_points, ref_corr_points,
                              gt_src_corr_points, gt_ref_corr_points):
        cd = rm.compute_modified_chamfer_distance(
            src_points, ref_points, raw_points, est_transform, gt_transform)
        ir = rm.compute_inlier_ratio(ref_corr_points, src_corr_points, gt_transform)
        rre, rte = rm.compute_registration_error(gt_transform, est_transform)
        rmse = rm.compute_registration_rmse(gt_ref_corr_points,
                                            gt_src_corr_points, est_transform)
        fmr = float(ir >= self.inlier_ratio_thresh)
        accepted = float(rmse < self.rmse_thresh)
        return cd, ir, rre, rte, accepted, fmr

    def _metrics_dict(self, vals):
        cd, ir, rre, rte, recall, fmr = vals
        return {"CD": cd, "IR": ir, "RRE": rre, "RTE": rte,
                "recall": recall, "FMR": fmr}

    def run_normal_registration(self, reg_data_dict, evaluate_registration=True):
        src_points = reg_data_dict["src_points"]
        ref_points = reg_data_dict["ref_points"]
        gt_transform = reg_data_dict.get("gt_transform")

        out = self.backend.register(src_points, ref_points, gt_transform)
        if out is None:
            return None
        est_transform = out["estimated_transform"]
        mean_corr_score = float(np.mean(out["corr_scores"]))

        if evaluate_registration:
            vals = self.evaluate_registration(
                src_points, ref_points, reg_data_dict.get("raw_points"),
                est_transform, gt_transform,
                out["src_corr_points"], out["ref_corr_points"],
                reg_data_dict.get("gt_src_corr_points"),
                reg_data_dict.get("gt_ref_corr_points"))
            return self._metrics_dict(vals)
        return est_transform, mean_corr_score

    def run_aligner_registration(self, reg_data_dict, evaluate_registration=True):
        node_corrs = reg_data_dict["node_corrs"]
        src_points = reg_data_dict["src_points"]
        ref_points = reg_data_dict["ref_points"]
        src_plydata = reg_data_dict["src_plydata"]
        ref_plydata = reg_data_dict["ref_plydata"]
        gt_transform = reg_data_dict["gt_transform"]

        pooled = {"src": [], "ref": [], "scores": []}
        obj_pairs = []
        for node_corr in node_corrs:
            pts_src = src_points[np.where(src_plydata["objectId"] == node_corr[0])[0]]
            pts_ref = ref_points[np.where(ref_plydata["objectId"] == node_corr[1])[0]]
            if (pts_src.shape[0] < self.min_object_points
                    or pts_ref.shape[0] < self.min_object_points):
                continue
            obj_pairs.append((pts_src, pts_ref))
        # a batch-capable backend registers every object pair in one call
        if hasattr(self.backend, "register_batch"):
            outs = self.backend.register_batch(obj_pairs)
        else:
            outs = [self.backend.register(s, r, gt_transform)
                    for s, r in obj_pairs]
        for out in outs:
            if out is None:
                continue
            src_c, ref_c = out["src_corr_points"], out["ref_corr_points"]
            scores = out["corr_scores"]
            cap = self.num_p2p_corrs // max(len(node_corrs), 1)
            if scores.shape[0] > cap:
                sel = np.argsort(-scores)[:cap]
                src_c, ref_c, scores = src_c[sel], ref_c[sel], scores[sel]
            pooled["src"].append(src_c)
            pooled["ref"].append(ref_c)
            pooled["scores"].append(scores)

        if not pooled["src"]:
            return None
        src_corr = np.concatenate(pooled["src"])
        ref_corr = np.concatenate(pooled["ref"])

        est_transform, _ = find_rigid_transform(
            src_corr.astype(np.float32), ref_corr.astype(np.float32),
            threshold=self.ransac_threshold, max_iters=self.ransac_max_iters,
            device=self.device)
        if est_transform is None:
            return None

        if not evaluate_registration:
            return est_transform
        vals = self.evaluate_registration(
            src_points, ref_points, reg_data_dict.get("raw_points"),
            est_transform, gt_transform, src_corr, ref_corr,
            reg_data_dict.get("gt_src_corr_points"),
            reg_data_dict.get("gt_ref_corr_points"))
        return self._metrics_dict(vals)

    def run_registration(self, reg_data_dict):
        normal = self.run_normal_registration(reg_data_dict)
        if normal is None:
            return None, None
        aligner = self.run_aligner_registration(reg_data_dict)
        return normal, aligner
