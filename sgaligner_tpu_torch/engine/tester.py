"""Inference tester: alignment metrics of a snapshot over a val loader.

Counterpart of ``sgaligner_tpu/engine/tester.py`` (``BaseTester``, and the
alignment half of ``AlignRegTester.run``): snapshot resolution as the JAX
tester does it (``--snapshot``, ``<snapshot_dir>/epoch-<N>[.pth.tar]``,
``<snapshot_dir>/iter-<n>[.pth.tar]``, else the newest snapshot,
``core.checkpoint.latest_snapshot``), the
model from ``build_model`` on the device the caller names (the card unless
it asks for ``"cpu"``), the weights loaded strictly, and per batch the
port's ``make_eval_step`` (``loss_kind``'s objective with zero
log-variances, ranks, MRR / Hits@k, SGAR) on the batch moved there with
``to_device``. A snapshot is a ``.pth.tar`` in upstream's layout
(``load_torch_snapshot``) or a JAX-package snapshot directory
(``read_ocdbt_snapshot``, which needs ``tensorstore``). With
``cfg.registration`` and a registration evaluator (``reg/evaluator.py``),
``AlignRegTester`` also registers every pair that has anchors, seeded by the
node matches of the same eval step's similarity matrices, and summarises the
normal and the aligner registration (the JAX ``AlignRegTester._register_pair``).
"""

from __future__ import annotations

import os.path as osp
from typing import Any

import numpy as np
import torch

from sgaligner_tpu_torch.align import alignment
from sgaligner_tpu_torch.core import checkpoint as ckpt
from sgaligner_tpu_torch.core.config import Config
from sgaligner_tpu_torch.engine.factory import (build_model, build_objective,
                                                resolve_device)
from sgaligner_tpu_torch.engine.train_step import eval_epoch, make_eval_step
from sgaligner_tpu_torch.utils.io import load_plydata_npy
from sgaligner_tpu_torch.utils.logging import SummaryBoard
from sgaligner_tpu_torch.utils.pointcloud import apply_transform, compute_pcl_overlap


class BaseTester:
    """Snapshot resolution, the model with its weights, and the eval step."""

    def __init__(self, cfg: Config, snapshot: str | None = None,
                 test_epoch: int | None = None, test_iter: int | None = None,
                 device: str | torch.device = "cuda", with_sim: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device)
        self.objective = build_objective(cfg).to(self.device)
        self.modules = tuple(cfg.modules)

        for flag, value, stem in (("--test_epoch", test_epoch, "epoch"),
                                  ("--test_iter", test_iter, "iter")):
            if snapshot is None and value is not None:
                cands = [osp.join(cfg.snapshot_dir, f"{stem}-{value}{suffix}")
                         for suffix in (".pth.tar", "")]
                snapshot = next((c for c in cands if osp.exists(c)), None)
                if snapshot is None:
                    raise FileNotFoundError(f"{flag} {value}: none of {cands} exist")
        if snapshot is None:
            snapshot = ckpt.latest_snapshot(cfg.snapshot_dir)
        if snapshot is None:
            raise FileNotFoundError(
                f"no snapshot found under {cfg.snapshot_dir}; pass --snapshot")
        self.snapshot_path = snapshot
        self.epoch, self.iteration = self._load(snapshot)
        self.eval_step = make_eval_step(self.model, self.objective, self.modules,
                                        ks=tuple(cfg.metrics.all_k),
                                        with_sim=with_sim)

    def _load(self, snapshot: str) -> tuple[int, int]:
        """Loads the weights strictly; returns (epoch, iteration)."""
        state_dict, epoch, iteration = ckpt.load_model_state(snapshot, self.modules)
        self.model.load_state_dict(state_dict, strict=True)
        return epoch, iteration


class AlignRegTester(BaseTester):
    """inference_align_reg: node-matching metrics and, with
    ``cfg.registration`` and an evaluator, registration."""

    def __init__(self, cfg: Config, dataset, loader,
                 registration_evaluator=None, **kw):
        self.run_reg = bool(cfg.registration) and registration_evaluator is not None
        super().__init__(cfg, with_sim=self.run_reg, **kw)
        self.dataset = dataset
        self.loader = loader
        self.reg_evaluator = registration_evaluator
        self.reg_k = cfg.reg_model.K

    def run(self) -> dict[str, Any]:
        """MRR, Hits@k and SGAR over the loader (the loss is left out); with
        registration also ``normal_registration`` and
        ``aligner_registration``, the two boards' summaries."""
        boards = (SummaryBoard(), SummaryBoard())
        seen = [0]

        def visit(batch, out):
            sim = out["sim"].cpu().numpy()
            b = batch["obj_mask"].shape[0]
            for i in range(b):
                self._register_pair(batch, sim, i, seen[0] + i, *boards)
            seen[0] += b

        results = eval_epoch(self.eval_step, self.loader, self.cfg.metrics.all_k,
                             self.device, visit if self.run_reg else None)
        results = {k: v for k, v in results.items()
                   if k not in ("loss", "last_batch_loss")}
        if self.run_reg:
            results["normal_registration"] = boards[0].summary()
            results["aligner_registration"] = boards[1].summary()
        return results

    def _register_pair(self, batch, sim, i, dataset_idx, normal_board,
                       aligner_board) -> None:
        n = batch["obj_mask"].shape[1] // 2
        n_src, n_ref = int(batch["n_src"][i]), int(batch["n_ref"][i])
        # upstream gates registration on having anchors (inference_align_reg.py:122)
        if n_src == 0 or n_ref == 0 or not batch["anchor_mask"][i].any():
            return
        node_corrs = alignment.compute_node_corrs(sim[i], n_src, n, self.reg_k)
        node_corrs = alignment.get_node_corrs_objects_ids(node_corrs,
                                                          batch["obj_ids"][i])

        src_scan_id, ref_scan_id = self.dataset.pair_scan_ids(dataset_idx)
        scans_dir = self.dataset.scans_scenes_dir
        src_points, src_ply = load_plydata_npy(
            osp.join(scans_dir, src_scan_id, "data.npy"), return_ply_data=True)
        ref_points, ref_ply = load_plydata_npy(
            osp.join(scans_dir, ref_scan_id, "data.npy"), return_ply_data=True)
        pcl_center = src_points.mean(axis=0)  # val centering (scan3r.py:76)

        # whole-scene cloud: subscan ids are '<scan>_<suffix>'
        raw_points = None
        if "_" in src_scan_id and self.cfg.data.root_dir:
            scan_id = src_scan_id[: src_scan_id.index("_")]
            raw_path = osp.join(self.cfg.data.root_dir, "scans", scan_id, "data.npy")
            if osp.exists(raw_path):
                raw_points = load_plydata_npy(raw_path) - pcl_center
        if raw_points is None:
            raw_points = np.concatenate([src_points, ref_points]) - pcl_center

        # gt transform: identity in upstream's setting; a stored per-pair
        # transform is conjugated by the centring (both clouds get
        # -pcl_center): t' = R c + t - c
        gt = self.dataset.pair_gt_transform(dataset_idx)
        identity_gt = np.allclose(gt, np.eye(4))
        gt_c = gt.copy()
        gt_c[:3, 3] = gt[:3, :3] @ pcl_center + gt[:3, 3] - pcl_center

        reg = {
            "node_corrs": node_corrs,
            "src_points": src_points - pcl_center,
            "ref_points": ref_points - pcl_center,
            "src_plydata": src_ply,
            "ref_plydata": ref_ply,
            "raw_points": raw_points,
            "gt_transform": gt_c,
        }
        # GT correspondences: exact-match overlap in the gt-aligned frame
        # (upstream point_cloud.py:91-103); off identity the f32 transform
        # round trip needs a looser radius
        src_al = (reg["src_points"] if identity_gt
                  else apply_transform(reg["src_points"], gt_c))
        thresh = 1e-7 if identity_gt else 1e-4
        _, gt_src_idx = compute_pcl_overlap(src_al, reg["ref_points"], thresh)
        _, gt_ref_idx = compute_pcl_overlap(reg["ref_points"], src_al, thresh)
        reg["gt_src_corr_points"] = reg["src_points"][gt_src_idx]
        reg["gt_ref_corr_points"] = reg["ref_points"][gt_ref_idx]

        normal, aligner = self.reg_evaluator.run_registration(reg)
        if normal is not None and aligner is not None:
            normal_board.update_from_dict(normal)
            aligner_board.update_from_dict(aligner)
