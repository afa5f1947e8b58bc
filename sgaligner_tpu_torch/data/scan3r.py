"""Scan3RDataset — reads upstream SGAligner's processed 3RScan/3DSSG format.

A copy of ``sgaligner_tpu/data/scan3r.py`` (the whole class, the train
branch and ``_augment_side`` too), ending in the padded PairBatch layout of
``data/batch.py``; ``tests/test_torch_eval.py`` holds its items
array-equal to the JAX package's. Upstream's semantics
(``src/datasets/scan3r.py``):

* anchors json with val overlap-band filtering (scan3r.py:35-41),
* centering by a randomly chosen src/ref scene mean at train, src mean at val
  (:70-76),
* anchor filtering (drop id 0, require presence in both subscans, :86-87),
* train-time 30%-of-anchors subsample with a floor of 2 (:89-91),
* e1i/e2i (anchor) and e1j/e2j (non-anchor) index construction (:101-107) —
  local slot indices here, offset to the flat axis by the loss code.
"""

from __future__ import annotations

import os.path as osp
import threading

import numpy as np

from sgaligner_tpu_torch.core.config import Config
from sgaligner_tpu_torch.data.batch import BatchSpec, pack_pair
from sgaligner_tpu_torch.utils.io import load_json, load_pkl_data, load_plydata_npy


class Scan3RDataset:
    def __init__(self, cfg: Config, split: str):
        self.cfg = cfg
        self.split = split
        self.pc_resolution = cfg.val.pc_res if split == "val" else cfg.train.pc_res
        self.anchor_type_name = cfg.preprocess.anchor_type_name
        self.scan_type = cfg.scan_type

        self.scans_dir = (cfg.data.root_dir if self.scan_type == "scan"
                          else cfg.data.subscan_dir)
        self.scans_scenes_dir = osp.join(self.scans_dir, "scans")
        self.scans_files_dir = osp.join(self.scans_dir, "files")

        self.mode = "orig" if split == "train" else cfg.val.data_mode
        self.anchor_data_filename = osp.join(
            self.scans_files_dir, self.mode,
            f"anchors{self.anchor_type_name}_{split}.json")
        self.anchor_data = load_json(self.anchor_data_filename)

        if split == "val" and cfg.val.overlap_low != cfg.val.overlap_high:
            self.anchor_data = [
                a for a in self.anchor_data
                if cfg.val.overlap_low <= a["overlap"] < cfg.val.overlap_high
            ]

        self.spec = BatchSpec(
            batch_size=(cfg.val.batch_size if split == "val"
                        else cfg.train.batch_size),
            max_objects=cfg.tpu.max_objects,
            points_per_object=self.pc_resolution,
            rel_dim=cfg.model.rel_dim,
            attr_dim=cfg.model.attr_dim,
            compact_slots=cfg.tpu.compact_slots,
        )
        # the loader reads items from a thread pool (data/loaders.py) and
        # numpy Generators are not thread-safe: guard the draws
        self.rng = np.random.default_rng(cfg.seed)
        self._rng_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.anchor_data)

    def _load_scene_points(self, scan_id: str) -> np.ndarray:
        return load_plydata_npy(
            osp.join(self.scans_scenes_dir, scan_id, "data.npy"), obj_ids=None)

    def _augment_side(self, obj_pts: np.ndarray, rel_pose: np.ndarray,
                      seed: int) -> tuple[np.ndarray, np.ndarray]:
        """Working train-time augmentation (opt-in; the reference's equivalent
        config is dead code, scan3r.py:44-55): a per-side random rotation about
        the gravity axis (angle <= rot_factor * pi, the GeoTransformer-family
        convention the knob names come from) + Gaussian point jitter. The
        relative-translation graph features rotate with their side so the
        structure modality stays geometrically consistent."""
        rng = np.random.default_rng(seed)
        theta = rng.uniform(-1.0, 1.0) * np.pi * self.cfg.train.rot_factor
        c, s = np.cos(theta), np.sin(theta)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                       np.float32)
        pts = obj_pts.astype(np.float32) @ rot.T
        pts = pts + rng.normal(
            0.0, self.cfg.train.augmentation_noise, pts.shape).astype(np.float32)
        return pts, (rel_pose @ rot.T).astype(np.float32)

    @staticmethod
    def _fit_dim(bow: np.ndarray, dim: int, what: str) -> np.ndarray:
        """Right-pad BoW features to the configured vocab width.

        The reference relies on the preprocessed vocab exactly matching
        cfg.model.{rel,attr}_dim (its attr vocab is seeded from obj_attr.pkl and
        grown over the split, preprocess.py:328-344); we tolerate a narrower
        on-disk vocab and fail loudly on a wider one.
        """
        if bow.shape[1] == dim:
            return bow
        if bow.shape[1] > dim:
            raise ValueError(
                f"{what} BoW width {bow.shape[1]} exceeds configured {dim}")
        pad = np.zeros((bow.shape[0], dim - bow.shape[1]), bow.dtype)
        return np.concatenate([bow, pad], axis=1)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        graph_data = self.anchor_data[idx]
        src_scan_id, ref_scan_id = graph_data["src"], graph_data["ref"]
        overlap = graph_data.get("overlap", -1.0)

        src_points = self._load_scene_points(src_scan_id)
        ref_points = self._load_scene_points(ref_scan_id)
        with self._rng_lock:
            center_on_ref = self.split == "train" and self.rng.random() > 0.5
        if center_on_ref:
            pcl_center = np.mean(ref_points, axis=0)
        else:
            pcl_center = np.mean(src_points, axis=0)

        src = load_pkl_data(osp.join(self.scans_files_dir, self.mode, "data",
                                     f"{src_scan_id}.pkl"))
        ref = load_pkl_data(osp.join(self.scans_files_dir, self.mode, "data",
                                     f"{ref_scan_id}.pkl"))

        src_object_ids = src["objects_id"]
        ref_object_ids = ref["objects_id"]
        anchor_obj_ids = graph_data.get("anchorIds", list(src_object_ids))
        anchor_obj_ids = [i for i in anchor_obj_ids if i != 0
                          and i in src_object_ids and i in ref_object_ids]
        if self.split == "train":
            # Parity-exact with upstream src/datasets/scan3r.py:89-90:
            # int(0.3*len) unless that is <1, in which case 2 — NOT max(2, .),
            # so pairs with 4-6 anchors train on exactly 1 anchor.
            anchor_cnt = (2 if int(0.3 * len(anchor_obj_ids)) < 1
                          else int(0.3 * len(anchor_obj_ids)))
            anchor_obj_ids = anchor_obj_ids[:anchor_cnt]

        src_obj_pts = src["obj_points"][self.pc_resolution] - pcl_center
        ref_obj_pts = ref["obj_points"][self.pc_resolution] - pcl_center

        src_rel_pose = src["rel_trans"].astype(np.float32)
        ref_rel_pose = ref["rel_trans"].astype(np.float32)
        if (self.split == "train" and self.cfg.train.use_augmentation
                and self.cfg.train.augmentation_active):
            with self._rng_lock:
                seeds = self.rng.integers(0, 2**31, size=2)
            src_obj_pts, src_rel_pose = self._augment_side(
                src_obj_pts, src_rel_pose, int(seeds[0]))
            ref_obj_pts, ref_rel_pose = self._augment_side(
                ref_obj_pts, ref_rel_pose, int(seeds[1]))

        src_id2idx, ref_id2idx = src["object_id2idx"], ref["object_id2idx"]
        e1i = np.array([src_id2idx[i] for i in anchor_obj_ids], np.int64)
        e2i = np.array([ref_id2idx[i] for i in anchor_obj_ids], np.int64)
        e1j = np.array([src_id2idx[i] for i in src_object_ids
                        if i not in anchor_obj_ids], np.int64)
        e2j = np.array([ref_id2idx[i] for i in ref_object_ids
                        if i not in anchor_obj_ids], np.int64)

        return pack_pair(
            self.spec,
            src_points=src_obj_pts.astype(np.float32),
            ref_points=ref_obj_pts.astype(np.float32),
            src_bow_rel=self._fit_dim(
                src["bow_vec_object_edge_feats"].astype(np.float32),
                self.spec.rel_dim, "relation"),
            ref_bow_rel=self._fit_dim(
                ref["bow_vec_object_edge_feats"].astype(np.float32),
                self.spec.rel_dim, "relation"),
            src_bow_attr=self._fit_dim(
                src["bow_vec_object_attr_feats"].astype(np.float32),
                self.spec.attr_dim, "attribute"),
            ref_bow_attr=self._fit_dim(
                ref["bow_vec_object_attr_feats"].astype(np.float32),
                self.spec.attr_dim, "attribute"),
            src_rel_pose=src_rel_pose,
            ref_rel_pose=ref_rel_pose,
            src_edges=np.asarray(src["edges"], np.int64),
            ref_edges=np.asarray(ref["edges"], np.int64),
            e1i=e1i, e2i=e2i, e1j=e1j, e2j=e2j,
            src_obj_ids=np.asarray(src_object_ids, np.int64),
            ref_obj_ids=np.asarray(ref_object_ids, np.int64),
            src_global_ids=np.asarray(src["objects_cat"], np.int64),
            ref_global_ids=np.asarray(ref["objects_cat"], np.int64),
            overlap=float(overlap),
        )

    # Extras used by the inference entry points ----------------------------
    def pair_scan_ids(self, idx: int) -> tuple[str, str]:
        a = self.anchor_data[idx]
        return a["src"], a["ref"]

    def pair_gt_transform(self, idx: int) -> np.ndarray:
        """Ground-truth src->ref rigid transform for this pair. Identity in
        the reference's evaluation setting (all subscans share one world
        frame, inference_align_reg.py:168); non-identity when the anchors
        entry carries a ``"transform"`` (e.g. rescan pairs, cf. the
        rescan->refscan map from 3RScan.json)."""
        t = self.anchor_data[idx].get("transform")
        return np.eye(4) if t is None else np.asarray(t, np.float64)

    def scene_points(self, scan_id: str) -> np.ndarray:
        return self._load_scene_points(scan_id)
