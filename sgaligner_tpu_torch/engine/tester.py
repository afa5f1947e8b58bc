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

The two downstream tasks (the JAX ``OverlapTester`` and ``MosaickTester``)
read the key modality's similarity matrices of a batch (``sim_matrices``:
the model's forward and the cosine distances, no loss) and register with
the evaluator's backend (the learned one in the JAX package's quality
contract): ``OverlapTester`` classifies each val pair as overlapping or not
by the alignment score and by the registration's mean correspondence score
(precision / recall / F1 of each); ``MosaickTester`` registers every
subscan of a scan onto its first, from the node matches (aligner) and from
the whole clouds (normal), and scores the two reconstructions against the
subscans in place (accuracy, completion, precision, recall, F-score).
"""

from __future__ import annotations

import os.path as osp
from typing import Any

import numpy as np
import torch

from sgaligner_tpu_torch.align import alignment
from sgaligner_tpu_torch.core import checkpoint as ckpt
from sgaligner_tpu_torch.core.config import Config
from sgaligner_tpu_torch.data.batch import BatchSpec, collate, pack_pair, to_device
from sgaligner_tpu_torch.engine.factory import (build_model, build_objective,
                                                resolve_device)
from sgaligner_tpu_torch.engine.train_step import eval_epoch, make_eval_step
from sgaligner_tpu_torch.ops import metrics as M
from sgaligner_tpu_torch.utils.io import load_pkl_data, load_plydata_npy
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

    @torch.inference_mode()
    def sim_matrices(self, batch: dict) -> np.ndarray:
        """The key modality's per-pair cosine distances ``[B, 2N, 2N]`` of a
        host batch (the model's forward on the tester's device; the JAX
        ``BaseTester.sim_matrices``)."""
        self.model.train(False)
        batch = to_device(batch, self.device)
        key = "joint" if len(self.modules) > 1 else self.modules[0]
        b, two_n = batch["obj_mask"].shape
        emb = self.model(batch)[key].reshape(b, two_n, -1)
        return M.cosine_sim_matrix(emb, batch["obj_mask"]).cpu().numpy()


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


class OverlapTester(BaseTester):
    """inference_find_overlapper: overlap-or-not classification of the val
    pairs, P/R/F1 of the alignment score (``model.alignment_thresh``) and
    of the registration's mean correspondence score
    (``reg_model.corr_score_thresh``). A pair the backend declines to
    register counts in neither."""

    def __init__(self, cfg: Config, dataset, loader, registration_evaluator, **kw):
        super().__init__(cfg, **kw)
        self.dataset = dataset
        self.loader = loader
        self.reg_evaluator = registration_evaluator
        self.alignment_thresh = cfg.model.alignment_thresh
        self.corr_score_thresh = cfg.reg_model.corr_score_thresh

    def run(self) -> dict[str, Any]:
        aligner = {"true": [], "pred": []}
        registration = {"true": [], "pred": []}
        pair_idx = 0
        scans_dir = self.dataset.scans_scenes_dir
        for batch in self.loader:
            b = batch["obj_mask"].shape[0]
            sim = self.sim_matrices(batch)
            n = batch["obj_mask"].shape[1] // 2
            for i in range(b):
                n_src, n_ref = int(batch["n_src"][i]), int(batch["n_ref"][i])
                truth = 1.0 if float(batch["overlap"][i]) > 0.0 else 0.0
                src_id, ref_id = self.dataset.pair_scan_ids(pair_idx + i)
                src_points = load_plydata_npy(osp.join(scans_dir, src_id, "data.npy"))
                ref_points = load_plydata_npy(osp.join(scans_dir, ref_id, "data.npy"))
                center = src_points.mean(axis=0)
                reg = {"src_points": src_points - center,
                       "ref_points": ref_points - center,
                       "gt_transform": np.eye(4)}
                res = self.reg_evaluator.run_normal_registration(
                    reg, evaluate_registration=False)
                if res is None:
                    continue
                _, mean_corr_score = res
                score = alignment.compute_alignment_score(sim[i], n_src, n_ref, n)
                registration["pred"].append(
                    1.0 if mean_corr_score > self.corr_score_thresh else 0.0)
                registration["true"].append(truth)
                aligner["pred"].append(1.0 if score > self.alignment_thresh else 0.0)
                aligner["true"].append(truth)
            pair_idx += b
        return {
            "aligner_overlapper": alignment.precision_recall_f1(
                aligner["true"], aligner["pred"]),
            "registration_overlapper": alignment.precision_recall_f1(
                registration["true"], registration["pred"]),
        }


class MosaickTester(BaseTester):
    """inference_mosaicking: each scan's subscans registered onto its first
    and merged, from the node matches (aligner) and from the whole clouds
    (normal), scored against the subscans in place. ``max_scans`` keeps the
    map's first scans (upstream keeps 2; None keeps all)."""

    def __init__(self, cfg: Config, registration_evaluator,
                 scan_subscan_map: dict[str, list[str]], subscans_dir: str,
                 max_scans: int | None = 2, **kw):
        super().__init__(cfg, **kw)
        self.reg_evaluator = registration_evaluator
        keys = list(scan_subscan_map)[:max_scans] if max_scans else list(scan_subscan_map)
        self.scan_subscan_map = {k: scan_subscan_map[k] for k in keys}
        self.subscans_dir = subscans_dir
        self.pc_res = cfg.val.pc_res

    def _load_pair_batch(self, src_id: str, ref_id: str):
        """upstream's load_subscan_pair: one pair as a batch of 1, its
        points centred on the src scan's mean; returns (batch, centre)."""
        from sgaligner_tpu_torch.data.scan3r import Scan3RDataset

        scenes = osp.join(self.subscans_dir, "scans")
        files = osp.join(self.subscans_dir, "files", self.cfg.val.data_mode)
        center = load_plydata_npy(osp.join(scenes, src_id, "data.npy")).mean(axis=0)
        src = load_pkl_data(osp.join(files, "data", f"{src_id}.pkl"))
        ref = load_pkl_data(osp.join(files, "data", f"{ref_id}.pkl"))
        spec = BatchSpec(1, self.cfg.tpu.max_objects, self.pc_res,
                         self.cfg.model.rel_dim, self.cfg.model.attr_dim)
        fit = Scan3RDataset._fit_dim

        def side(d):
            return {
                "points": (d["obj_points"][self.pc_res] - center).astype(np.float32),
                "bow_rel": fit(d["bow_vec_object_edge_feats"].astype(np.float32),
                               spec.rel_dim, "relation"),
                "bow_attr": fit(d["bow_vec_object_attr_feats"].astype(np.float32),
                                spec.attr_dim, "attribute"),
                "rel_pose": d["rel_trans"].astype(np.float32),
                "edges": np.asarray(d["edges"], np.int64),
                "obj_ids": np.asarray(d["objects_id"], np.int64),
            }

        s, r = side(src), side(ref)
        sample = pack_pair(
            spec, **{f"src_{k}": v for k, v in s.items()},
            **{f"ref_{k}": v for k, v in r.items()},
            e1i=np.zeros(0, np.int64), e2i=np.zeros(0, np.int64),
            e1j=np.arange(len(src["objects_id"])), e2j=np.arange(len(ref["objects_id"])))
        return collate([sample]), center

    def run(self) -> dict[str, Any]:
        from sgaligner_tpu_torch.reg.metrics import compute_mosaicking_error

        boards = {"aligner_mosaicking_metrics": SummaryBoard(),
                  "normal_mosaicking_metrics": SummaryBoard()}
        scenes = osp.join(self.subscans_dir, "scans")
        for subscan_ids in self.scan_subscan_map.values():
            if not subscan_ids:
                continue
            origin_id = subscan_ids[0]
            origin_points = load_plydata_npy(osp.join(scenes, origin_id, "data.npy"))
            recon_aligner, recon_normal, gt_points = ([origin_points], [origin_points],
                                                      [origin_points])
            for src_id in subscan_ids[1:]:
                batch, center = self._load_pair_batch(src_id, origin_id)
                sim = self.sim_matrices(batch)
                n = batch["obj_mask"].shape[1] // 2
                node_corrs = alignment.compute_node_corrs(sim[0], int(batch["n_src"][0]),
                                                          n, k=1)
                node_corrs = alignment.get_node_corrs_objects_ids(node_corrs,
                                                                  batch["obj_ids"][0])
                src_points, src_ply = load_plydata_npy(
                    osp.join(scenes, src_id, "data.npy"), return_ply_data=True)
                ref_points, ref_ply = load_plydata_npy(
                    osp.join(scenes, origin_id, "data.npy"), return_ply_data=True)
                gt_points.append(src_points)
                reg = {"node_corrs": node_corrs,
                       "src_points": src_points - center,
                       "ref_points": ref_points - center,
                       "src_plydata": src_ply, "ref_plydata": ref_ply,
                       "gt_transform": np.eye(4)}
                est_aligner = self.reg_evaluator.run_aligner_registration(
                    reg, evaluate_registration=False)
                res_normal = self.reg_evaluator.run_normal_registration(
                    reg, evaluate_registration=False)
                if res_normal is None or est_aligner is None:
                    continue
                recon_aligner.append(apply_transform(src_points, est_aligner))
                recon_normal.append(apply_transform(src_points, res_normal[0]))
            gt = np.concatenate(gt_points)
            boards["aligner_mosaicking_metrics"].update_from_dict(
                compute_mosaicking_error(np.concatenate(recon_aligner), gt))
            boards["normal_mosaicking_metrics"].update_from_dict(
                compute_mosaicking_error(np.concatenate(recon_normal), gt))
        return {k: b.summary() for k, b in boards.items()}
