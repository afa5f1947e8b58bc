"""Learned registration backend: host orchestration around
``reg/geo_model.py``.

Counterpart of ``sgaligner_tpu/reg/learned.py``. The pipeline (the role of
GeoTransformer inference in upstream's registration evaluator):

1. voxel-downsample both clouds, pick S superpoints by farthest-point
   sampling on the device (``ops/fps.py``), and group the M nearest dense
   points around each (static ``[S, M]`` patches, superpoint-centred);
2. the matcher (``GeoRegModel``) on the device: a Sinkhorn superpoint
   assignment and per-point patch features;
3. one-to-one superpoint correspondences from the assignment (greedy by
   score), then point correspondences from a point-level Sinkhorn inside
   each matched patch pair (mutual argmax above a score threshold);
4. RANSAC hypotheses on the device, SE(3) non-max suppression and host
   refinement, verification against the raw clouds, and ICP on the device
   from the best candidates (``reg/learned_batch.py``).

Output contract as the other backends: ``estimated_transform``,
``src_corr_points``, ``ref_corr_points``, ``corr_scores``, plus
``fit_score``. The matcher runs on ``device`` (the card unless the caller
asks for ``"cpu"``) at the dtype of its weights: float32 for the tracked
ones. Weights come from a ``.pth.tar`` (``{"model": state_dict, "meta":
geo_meta}``, what ``scripts/export_torch_snapshots.py`` writes to
``checkpoints/torch/geo_reg.pth.tar``) or from a JAX-package checkpoint
directory (``geo_params`` read with ``tensorstore``), with the
configuration and preprocessing of ``geo_meta.json``.
"""

from __future__ import annotations

import json
import os.path as osp

import numpy as np
import torch

from sgaligner_tpu_torch.reg.geo_model import GeoModelConfig, GeoRegModel, fine_log_assign


def load_geo_checkpoint(path: str) -> tuple[dict[str, torch.Tensor], dict | None]:
    """``(state_dict, meta)`` of a learned-registration checkpoint: a
    ``.pth.tar`` file (its ``"model"`` and ``"meta"``), or a JAX-package
    directory (``<path>/geo_params`` through ``read_ocdbt_tree`` and
    ``geo_state_dict_from_flax``, needs ``tensorstore``; ``<path>/
    geo_meta.json``). ``meta`` is the parsed ``geo_meta.json``
    (``{"cfg": ..., "prep": ...}``), or None where the checkpoint has
    none."""
    if not osp.isdir(path):
        blob = torch.load(path, map_location="cpu", weights_only=True)
        return blob["model"], blob.get("meta")
    from sgaligner_tpu_torch.core.checkpoint import geo_state_dict_from_flax, read_ocdbt_tree

    sd = geo_state_dict_from_flax(read_ocdbt_tree(osp.join(path, "geo_params")))
    meta_path = osp.join(path, "geo_meta.json")
    if not osp.exists(meta_path):
        return sd, None
    with open(meta_path) as f:
        return sd, json.load(f)


def _downsample_cloud(points: np.ndarray, voxel_size: float, max_points: int,
                      rng) -> np.ndarray:
    from sgaligner_tpu_torch.reg.backend import voxel_downsample

    pts = voxel_downsample(points.astype(np.float32), voxel_size)
    if len(pts) > max_points:
        pts = pts[rng.choice(len(pts), max_points, replace=False)]
    return pts


def _finish_prep(pts: np.ndarray, sp_idx: np.ndarray, n_super: int,
                 patch_m: int) -> dict:
    """The static model inputs of one cloud from its FPS superpoint indices
    (host): superpoints, their M nearest points as centred patches, the
    patches' invariants, and the masks, padded to ``n_super``."""
    n = len(pts)
    s = min(n_super, n)
    sp = pts[sp_idx[:s]]                                      # [s, 3]
    d = ((sp[:, None, :] - pts[None, :, :]) ** 2).sum(-1)     # [s, n]
    m = min(patch_m, n)
    nbr = np.argpartition(d, m - 1, axis=1)[:, :m]            # [s, m]
    patch = pts[nbr] - sp[:, None, :]
    pmask = np.ones((s, m), bool)
    inv, eig = patch_invariants(patch)

    def pad(a, k, fill=0.0):
        out = np.full((k,) + a.shape[1:], fill, a.dtype)
        out[: len(a)] = a
        return out

    return {
        "sp": pad(sp, n_super),
        "patch": pad(patch, n_super),
        "inv": pad(inv, n_super),
        "eig": pad(eig, n_super),
        "pmask": pad(pmask, n_super, fill=False),
        "mask": pad(np.ones(s, bool), n_super, fill=False),
        "points": pts,
        "nbr": pad(nbr, n_super),
    }


def _prep_cloud(points: np.ndarray, n_super: int, patch_m: int,
                voxel_size: float, max_points: int, rng,
                device: str | torch.device = "cuda") -> dict:
    """One cloud's model inputs: downsample, FPS on ``device`` (the cloud
    padded to a power-of-two bucket of at least 256), patches."""
    from sgaligner_tpu_torch.ops.fps import farthest_point_sample

    pts = _downsample_cloud(points, voxel_size, max_points, rng)
    n = len(pts)
    bucket = 256
    while bucket < n:
        bucket *= 2
    pts_pad = np.zeros((1, bucket, 3), np.float32)
    pts_pad[0, :n] = pts
    valid = np.zeros((1, bucket), bool)
    valid[0, :n] = True
    sp_idx = farthest_point_sample(torch.from_numpy(pts_pad).to(device), n_super,
                                   mask=torch.from_numpy(valid).to(device))
    return _finish_prep(pts, sp_idx[0].cpu().numpy(), n_super, patch_m)


def patch_invariants(patch: np.ndarray):
    """Rotation-invariant per-point patch features (host numpy): for each
    superpoint-centred point p, ``(r, z, rho)`` about the patch's covariance
    normal n (the smallest eigenvector, its sign fixed by the third moment
    of p·n), and the patch's sqrt-eigenvalue spectrum.

    patch: [S, M, 3] -> (inv [S, M, 3], eig [S, 3])."""
    s, m, _ = patch.shape
    cov = np.einsum("smi,smj->sij", patch, patch) / max(m, 1)
    w, v = np.linalg.eigh(cov)                  # ascending eigenvalues
    normal = v[:, :, 0]                         # [S, 3]
    zdot = np.einsum("smi,si->sm", patch, normal)
    sign = np.where((zdot ** 3).sum(axis=1, keepdims=True) >= 0, 1.0, -1.0)
    z = zdot * sign
    r = np.linalg.norm(patch, axis=-1)
    rho = np.sqrt(np.maximum(r * r - z * z, 0.0))
    inv = np.stack([r, z, rho], axis=-1).astype(np.float32)
    eig = np.sqrt(np.maximum(w, 0.0)).astype(np.float32)
    return inv, eig


def extract_correspondences(out: dict, src: dict, ref: dict, top_pairs: int):
    """Superpoint correspondences from the Sinkhorn assignment (host):
    one-to-one (i, j) pairs in greedy score order. Returns the superpoint
    centres (the coarse fit's fallback), their scores and the index pairs
    the fine stage matches inside, or None below 3 pairs."""
    la = np.asarray(out["log_assign"], np.float32)
    s = la.shape[0] - 1
    a = np.exp(la[:s, :s])
    a = a * src["mask"][:, None] * ref["mask"][None, :]
    flat = a.reshape(-1)
    order = np.argsort(-flat)[: top_pairs * 4]
    src_pts, ref_pts, scores, idx_pairs = [], [], [], []
    seen_i, seen_j = set(), set()
    for f in order:
        i, j = divmod(int(f), s)
        if flat[f] <= 1e-6:
            break
        if i in seen_i or j in seen_j:
            continue
        seen_i.add(i)
        seen_j.add(j)
        src_pts.append(src["sp"][i])
        ref_pts.append(ref["sp"][j])
        scores.append(float(flat[f]))
        idx_pairs.append((i, j))
        if len(src_pts) >= top_pairs:
            break
    if len(src_pts) < 3:
        return None
    return (np.asarray(src_pts, np.float32), np.asarray(ref_pts, np.float32),
            np.asarray(scores, np.float32), np.asarray(idx_pairs, np.int32))


def extract_fine_correspondences(fla: np.ndarray, idx_pairs: np.ndarray,
                                 n_valid: int, src: dict, ref: dict,
                                 score_thresh: float = 0.2):
    """Point correspondences from the fine Sinkhorn (host): ``fla [K, M+1,
    M+1]`` for the K padded superpoint pairs, the first ``n_valid`` real.
    Keeps the mutual-argmax point pairs whose mass clears ``score_thresh``,
    as the patches' absolute points. Returns (src [C, 3], ref [C, 3],
    scores [C]) or None."""
    m = fla.shape[1] - 1
    src_abs = src["patch"] + src["sp"][:, None, :]
    ref_abs = ref["patch"] + ref["sp"][:, None, :]
    out_s, out_r, out_w = [], [], []
    for k in range(min(n_valid, len(fla))):
        i, j = int(idx_pairs[k, 0]), int(idx_pairs[k, 1])
        a = np.exp(fla[k][:m, :m].astype(np.float32))
        a = a * src["pmask"][i][:, None] * ref["pmask"][j][None, :]
        best_j = a.argmax(axis=1)
        best_i = a.argmax(axis=0)
        rows = np.arange(m)
        w = a[rows, best_j]
        keep = (best_i[best_j] == rows) & (w > score_thresh) & src["pmask"][i]
        if not keep.any():
            continue
        out_s.append(src_abs[i][keep])
        out_r.append(ref_abs[j][best_j[keep]])
        out_w.append(w[keep])
    if not out_s:
        return None
    return (np.concatenate(out_s).astype(np.float32),
            np.concatenate(out_r).astype(np.float32),
            np.concatenate(out_w).astype(np.float32))


def weighted_kabsch(src: np.ndarray, ref: np.ndarray,
                    w: np.ndarray) -> np.ndarray:
    """Weighted rigid fit src -> ref on the host (float64), ``[4, 4]``."""
    w = np.maximum(w, 1e-9)
    w = w / w.sum()
    cs = (w[:, None] * src).sum(0)
    cr = (w[:, None] * ref).sum(0)
    h = (src - cs).T @ (w[:, None] * (ref - cr))
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    t = np.eye(4)
    t[:3, :3] = r
    t[:3, 3] = cr - r @ cs
    return t


class LearnedBackend:
    """``GeoRegModel``-based backend with the evaluator's ``register``
    contract and a batched ``register_batch``.

    ``params`` is the matcher's state_dict (or, as a string, the
    checkpoint); ``checkpoint`` a path ``load_geo_checkpoint`` reads, whose
    ``geo_meta.json`` sets ``cfg``, ``n_super``, ``patch_m`` and
    ``voxel_size``. The other knobs are the JAX package's defaults; the
    RANSAC hypotheses and the ICP schedule run at float64. With
    ``profile_stages`` set, ``register_round``
    adds each stage's host-clock seconds (device stages synchronised) to
    the dict ``_stage_times``."""

    def __init__(self, params=None, checkpoint: str | None = None,
                 cfg: GeoModelConfig = GeoModelConfig(),
                 n_super: int = 128, patch_m: int = 32,
                 voxel_size: float = 0.05, max_points: int = 8192,
                 top_pairs: int = 24, inlier_thresh: float = 0.15,
                 refine_icp: bool = True, seed: int = 0,
                 fine: bool = True, fine_score_thresh: float = 0.2,
                 min_fine_corrs: int = 12, hypotheses: int = 3,
                 max_refine: int = 3, retries: int = 2,
                 retry_score_thresh: float = 0.45,
                 icp_anchor_frac: float = 0.15,
                 device: str | torch.device = "cuda"):
        if isinstance(params, (str, bytes)):
            # LearnedBackend("path/to/checkpoint"): a string is the checkpoint
            params, checkpoint = None, params
        if params is None and checkpoint is not None:
            params, geo_meta = load_geo_checkpoint(checkpoint)
            if geo_meta is not None:
                cfg = GeoModelConfig(**geo_meta["cfg"])
                n_super = geo_meta["prep"]["n_super"]
                patch_m = geo_meta["prep"]["patch_m"]
                voxel_size = geo_meta["prep"]["voxel_size"]
        if params is None:
            raise ValueError("LearnedBackend needs params= or checkpoint=")
        from sgaligner_tpu_torch.engine.factory import resolve_device

        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_super = n_super
        self.patch_m = patch_m
        self.voxel_size = voxel_size
        self.max_points = max_points
        self.top_pairs = top_pairs
        self.inlier_thresh = inlier_thresh
        self.refine_icp = refine_icp
        self.seed = seed
        self.fine = fine
        self.fine_score_thresh = fine_score_thresh
        self.min_fine_corrs = min_fine_corrs
        self.hypotheses = hypotheses
        self.max_refine = max_refine
        self.retries = retries
        self.retry_score_thresh = retry_score_thresh
        # corr-anchored ICP (reg/icp.py): the share of each iteration's NN
        # inlier mass carried by the candidate's matcher correspondences,
        # which pins the translation on self-similar planar geometry; 0
        # turns the anchors off
        self.icp_anchor_frac = icp_anchor_frac
        self.profile_stages = False
        self._round_cache = None
        dtype = (torch.float64 if any(v.dtype == torch.float64 for v in params.values())
                 else torch.float32)
        self.model = GeoRegModel(cfg).to(dtype)
        self.model.load_state_dict(params, strict=True)
        self.model.to(self.device).eval()
        self.dtype = dtype

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.is_floating_point():
            t = t.to(self.dtype)
        return t.to(self.device)

    @torch.inference_mode()
    def _apply_batch(self, *arrays) -> dict[str, np.ndarray]:
        """The matcher over a batch of pairs (``GeoRegModel``'s inputs as
        numpy arrays): its outputs on the host."""
        out = self.model(*(self._tensor(a) for a in arrays))
        return {k: v.detach().cpu().numpy() for k, v in out.items()}

    @torch.inference_mode()
    def _fine_assign_batch(self, src_pf, ref_pf, src_pmask, ref_pmask,
                           pairs) -> np.ndarray:
        """``fine_log_assign`` over a batch of pairs, on the host."""
        fla = fine_log_assign(self._tensor(src_pf), self._tensor(ref_pf),
                              self._tensor(src_pmask), self._tensor(ref_pmask),
                              self._tensor(pairs), self.model.fine_inv_temp,
                              self.model.fine_dustbin, iters=self.cfg.sinkhorn_iters)
        return fla.cpu().numpy()

    def register(self, src_points: np.ndarray, ref_points: np.ndarray,
                 gt_transform: np.ndarray | None = None) -> dict | None:
        return self.register_batch([(src_points, ref_points)])[0]

    def register_batch(self, pairs) -> list[dict | None]:
        """Register many pairs, every stage of a retry round batched over
        the round's pairs (``reg/learned_batch.py::register_round``). A pair
        whose best verification score stays below ``retry_score_thresh``
        joins the next round (up to ``retries`` more), which re-seeds the
        RANSAC draws and starts FPS at a random point: superpoint placement
        is the luck factor on planar, self-similar scans. A pair's
        randomness is keyed on its index in ``pairs``, not on the pairs
        sharing its round. Returns one result dict (or None) per pair."""
        from sgaligner_tpu_torch.reg.learned_batch import register_round

        results: list[dict | None] = [None] * len(pairs)
        active = list(range(len(pairs)))
        # the downsampled clouds and kd-trees that stay the same across
        # rounds, kept for this call only (learned_batch._prep_round)
        self._round_cache = {}
        try:
            for attempt in range(1 + self.retries):
                if not active:
                    break
                outs = register_round(self, [pairs[i] for i in active],
                                      seed=self.seed + 1009 * attempt,
                                      diversify_fps=attempt > 0,
                                      pair_ids=active)
                still = []
                for i, res in zip(active, outs):
                    if res is not None and (results[i] is None
                                            or res["fit_score"]
                                            > results[i]["fit_score"]):
                        results[i] = res
                    if (results[i] is None
                            or results[i]["fit_score"] < self.retry_score_thresh):
                        still.append(i)
                active = still
        finally:
            self._round_cache = None
        return results
