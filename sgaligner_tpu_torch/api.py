"""High-level library API.

Counterpart of ``sgaligner_tpu/api.py``: a three-call surface over the
port,

    from sgaligner_tpu_torch import api
    aligner = api.load_aligner(cfg_yaml_or_cfg, snapshot=...)   # once
    result = aligner.align(src_scene_npy, ref_scene_npy)        # per pair
    result = aligner.align_arrays(src_obj_pts, ref_obj_pts, ...)  # in-memory

``align`` carves objects from two structured ``data.npy`` scenes,
farthest-point samples them, runs the model, ranks the similarities into
node matches and, with ``register=True``, fits the rigid transform between
the clouds (``reg/evaluator.py``, seeded by the node matches). Weights come
from a ``.pth.tar`` (or a JAX-package snapshot directory); with no snapshot
the model keeps the port's seeded initialisation. The model runs on the
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os.path as osp
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from sgaligner_tpu_torch.core.config import Config, make_cfg, update_config


@dataclass
class AlignResult:
    node_matches: list[tuple[int, int]]     # (src object id, ref object id)
    alignment_score: float
    sim: np.ndarray                         # [2N, 2N] slot similarity
    n_src: int
    n_ref: int
    transform: np.ndarray | None = None     # [4, 4] when registration ran
    registration: dict | None = None        # metric dict when GT available


class Aligner:
    def __init__(self, cfg: Config, snapshot: str | None = None,
                 registration: bool | None = None,
                 device: str | torch.device = "cuda"):
        from sgaligner_tpu_torch.core import checkpoint as ckpt
        from sgaligner_tpu_torch.engine.factory import build_model, resolve_device

        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device)
        self.modules = tuple(cfg.modules)
        self.key_modality = "joint" if len(self.modules) > 1 else self.modules[0]
        if snapshot:
            state_dict, _, _ = ckpt.load_model_state(snapshot, self.modules)
            self.model.load_state_dict(state_dict, strict=True)
        self.reg_evaluator = None
        if registration if registration is not None else cfg.registration:
            self.reg_evaluator = self._evaluator()

    def _evaluator(self):
        from sgaligner_tpu_torch.reg.backend import build_backend
        from sgaligner_tpu_torch.reg.evaluator import RegistrationEvaluator

        return RegistrationEvaluator(self.cfg, build_backend(self.cfg, device=self.device))

    def align_arrays(
        self,
        src_obj_points: np.ndarray,   # [n_src, P, 3] (centered or not)
        ref_obj_points: np.ndarray,   # [n_ref, P, 3]
        src_obj_ids: np.ndarray | None = None,
        ref_obj_ids: np.ndarray | None = None,
        k: int = 1,
        center: bool = True,
        **pair_kwargs: Any,
    ) -> AlignResult:
        """Align two in-memory object sets (point modality fields required;
        BoW / rel_pose / edges may be passed via pair_kwargs for full
        models)."""
        from sgaligner_tpu_torch.align import alignment
        from sgaligner_tpu_torch.data.batch import (BatchSpec, collate, pack_pair,
                                                    to_device)
        from sgaligner_tpu_torch.ops import metrics as M

        n_src, n_ref = len(src_obj_points), len(ref_obj_points)
        p = src_obj_points.shape[1]
        if center:
            c = src_obj_points.reshape(-1, 3).mean(axis=0)
            src_obj_points = src_obj_points - c
            ref_obj_points = ref_obj_points - c
        n_max = 1 << int(np.ceil(np.log2(max(n_src, n_ref, 8))))
        spec = BatchSpec(1, n_max, p, rel_dim=self.cfg.model.rel_dim,
                         attr_dim=self.cfg.model.attr_dim)

        defaults = dict(
            src_bow_rel=np.zeros((n_src, spec.rel_dim), np.float32),
            ref_bow_rel=np.zeros((n_ref, spec.rel_dim), np.float32),
            src_bow_attr=np.zeros((n_src, spec.attr_dim), np.float32),
            ref_bow_attr=np.zeros((n_ref, spec.attr_dim), np.float32),
            src_rel_pose=np.zeros((n_src, 3), np.float32),
            ref_rel_pose=np.zeros((n_ref, 3), np.float32),
            src_edges=np.zeros((0, 2), np.int64),
            ref_edges=np.zeros((0, 2), np.int64),
        )
        defaults.update(pair_kwargs)
        sample = pack_pair(
            spec,
            src_points=np.asarray(src_obj_points, np.float32),
            ref_points=np.asarray(ref_obj_points, np.float32),
            e1i=np.zeros(0, np.int64), e2i=np.zeros(0, np.int64),
            e1j=np.arange(n_src), e2j=np.arange(n_ref),
            src_obj_ids=src_obj_ids, ref_obj_ids=ref_obj_ids,
            **defaults,
        )
        batch = collate([sample])
        dev_batch = to_device(batch, self.device)
        self.model.train(False)
        with torch.inference_mode():
            embs = self.model(dev_batch)
            emb = embs[self.key_modality].reshape(1, 2 * n_max, -1)
            sim = M.cosine_sim_matrix(emb, dev_batch["obj_mask"])[0].cpu().numpy()

        node_corrs = alignment.compute_node_corrs(sim, n_src, n_max, k=k)
        matches = alignment.get_node_corrs_objects_ids(node_corrs,
                                                       batch["obj_ids"][0])
        score = alignment.compute_alignment_score(sim, n_src, n_ref, n_max)
        return AlignResult(node_matches=matches, alignment_score=score,
                           sim=sim, n_src=n_src, n_ref=n_ref)

    def align(self, src_scene_npy: str, ref_scene_npy: str, k: int = 1,
              pc_res: int | None = None, min_obj_points: int | None = None,
              register: bool = False, seed: int = 42) -> AlignResult:
        """Align two raw structured scenes (data.npy): carve objects by id,
        farthest-point sample them, run the model, optionally register the
        clouds (``result.transform``)."""
        from sgaligner_tpu_torch.cli.demo_align import objects_from_npy
        from sgaligner_tpu_torch.utils.io import load_plydata_npy

        pc_res = pc_res or self.cfg.val.pc_res
        min_pts = min_obj_points or self.cfg.preprocess.min_obj_points
        rng = np.random.default_rng(seed)
        src_ids, src_pts = objects_from_npy(src_scene_npy, pc_res, min_pts, rng)
        ref_ids, ref_pts = objects_from_npy(ref_scene_npy, pc_res, min_pts, rng)
        result = self.align_arrays(src_pts, ref_pts, src_ids, ref_ids, k=k)

        if register:
            if self.reg_evaluator is None:
                self.reg_evaluator = self._evaluator()
            src_points, src_ply = load_plydata_npy(src_scene_npy,
                                                   return_ply_data=True)
            ref_points, ref_ply = load_plydata_npy(ref_scene_npy,
                                                   return_ply_data=True)
            center = src_points.mean(axis=0)
            reg = {"node_corrs": result.node_matches,
                   "src_points": src_points - center,
                   "ref_points": ref_points - center,
                   "src_plydata": src_ply, "ref_plydata": ref_ply,
                   "gt_transform": np.eye(4)}
            result.transform = self.reg_evaluator.run_aligner_registration(
                reg, evaluate_registration=False)
        return result


def load_aligner(cfg_or_yaml: Config | str, snapshot: str | None = None,
                 **kw) -> Aligner:
    """An ``Aligner`` from a ``Config`` or a YAML file (``device=``,
    ``registration=`` pass through)."""
    if isinstance(cfg_or_yaml, str):
        if not osp.exists(cfg_or_yaml):
            raise FileNotFoundError(cfg_or_yaml)
        cfg = update_config(make_cfg(), cfg_or_yaml, ensure_dir=False)
    else:
        cfg = cfg_or_yaml
    return Aligner(cfg, snapshot=snapshot, **kw)
