"""Batched multi-pair registration rounds for the learned backend.

Counterpart of ``sgaligner_tpu/reg/learned_batch.py``. One retry round over
a set of pairs runs each device stage once for the whole set:

  1. one batched FPS over every cloud of the round (``ops/fps.py``; padded
     points are never picked, so the padding gives the same superpoints),
  2. one matcher forward (``GeoRegModel``) over the pair axis,
  3. one fine Sinkhorn over the pairs with superpoint correspondences,
  4. one RANSAC hypothesis sweep over every pair's fine and coarse
     correspondence sets (``reg/ransac.py::ransac_hypotheses_batch``),
  5. one trimmed-ICP schedule over every surviving (pair, candidate)
     (``reg/icp.py::icp_refine_stages_batch``);

the greedy extraction, SE(3) non-max suppression and kd-tree verification
stay on the host. ``LearnedBackend.register_batch`` (``reg/learned.py``)
owns the retry loop; ``register_round`` here is one attempt.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np
import torch
from scipy.spatial import cKDTree


@contextmanager
def _timed(backend, stage: str):
    """Add the block's host-clock seconds to ``backend._stage_times[stage]``
    when ``backend.profile_stages`` is set. The device stages end in a copy
    to the host, so their device time is inside the block."""
    if not getattr(backend, "profile_stages", False):
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        times = getattr(backend, "_stage_times", None)
        if times is None:
            times = backend._stage_times = {}
        times[stage] = times.get(stage, 0.0) + time.perf_counter() - t0


def _pow2(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class _NNCache:
    """A pair's 1-NN structure over its ref cloud (scipy's kd-tree), built
    once and reused by every candidate verification of the round."""

    def __init__(self, ref_points: np.ndarray):
        self._ctree = cKDTree(ref_points)

    def distances(self, q: np.ndarray) -> np.ndarray:
        d, _ = self._ctree.query(q, k=1)
        return d


def _fit_score(nn: _NNCache, src_points: np.ndarray, est: np.ndarray,
               voxel_size: float) -> float:
    """The share of src points that land within 2 voxels of ref under
    ``est``: a candidate's verification (a wrong consensus scores about 0)."""
    moved = src_points @ est[:3, :3].T + est[:3, 3]
    return float((nn.distances(moved) < 2.0 * voxel_size).mean())


def _topk_nms_refine(tfs: np.ndarray, scores: np.ndarray,
                     src_corr: np.ndarray, ref_corr: np.ndarray,
                     threshold: float, k: int, min_inliers: int = 3,
                     rot_deg: float = 15.0, trans: float = 0.3,
                     refine_steps: int = 3) -> list[np.ndarray]:
    """The host half of ``find_rigid_transforms_topk`` over precomputed
    hypotheses: greedy SE(3) non-max suppression by inlier score, then
    inlier-reweighted Kabsch refinement at float64."""
    from sgaligner_tpu_torch.reg.learned import weighted_kabsch
    from sgaligner_tpu_torch.reg.ransac import _se3_distinct

    out: list[np.ndarray] = []
    for i in np.argsort(-scores):
        if scores[i] < min_inliers:
            break
        tf = np.asarray(tfs[i], np.float64)
        if not _se3_distinct(tf, out, rot_deg, trans):
            continue
        for _ in range(refine_steps):
            res = np.linalg.norm(
                src_corr @ tf[:3, :3].T + tf[:3, 3] - ref_corr, axis=-1)
            w = (res < threshold).astype(np.float64)
            if w.sum() < 3:
                break
            tf = weighted_kabsch(src_corr.astype(np.float64),
                                 ref_corr.astype(np.float64), w)
        if _se3_distinct(tf, out, rot_deg, trans) or not out:
            out.append(tf)
        if len(out) >= k:
            break
    return out


def _prep_round(backend, pairs, seed, diversify_fps: bool = False,
                pair_ids=None):
    """Stage 1: host downsampling, one batched FPS on the device, host
    patches. Returns ``[(src_prep, ref_prep)]`` a pair.

    ``diversify_fps`` (the retry rounds) starts each cloud's FPS at a random
    point, drawn from ``(seed, pair id, side, 17)``; the first round starts
    at 0. ``pair_ids`` are the pairs' stable identities (their indices in
    ``register_batch``'s list), so a pair's draws do not depend on which
    other pairs are still active."""
    from sgaligner_tpu_torch.ops.fps import farthest_point_sample
    from sgaligner_tpu_torch.reg.backend import voxel_downsample
    from sgaligner_tpu_torch.reg.learned import _finish_prep

    if pair_ids is None:
        pair_ids = list(range(len(pairs)))
    # a cloud the voxel grid leaves under max_points consumes no draw and is
    # the same in every round: kept for the call (register_batch's cache)
    cache = getattr(backend, "_round_cache", None)
    clouds = []
    with _timed(backend, "prep.downsample"):
        for (src_points, ref_points), pid in zip(pairs, pair_ids):
            # one generator a pair, consumed src then ref
            rng = np.random.default_rng(seed)
            for role, pts in ((0, src_points), (1, ref_points)):
                key = ("down", pid, role)
                if cache is not None and key in cache:
                    clouds.append(cache[key])
                    continue
                c = voxel_downsample(pts.astype(np.float32), backend.voxel_size)
                if len(c) > backend.max_points:
                    # drawn anew each round, never cached
                    c = c[rng.choice(len(c), backend.max_points, replace=False)]
                elif cache is not None:
                    cache[key] = c
                clouds.append(c)
    g = _pow2(len(clouds), 2)
    bucket = _pow2(max(len(c) for c in clouds), 256)
    pts_pad = np.zeros((g, bucket, 3), np.float32)
    valid = np.zeros((g, bucket), bool)
    starts = np.zeros((g,), np.int64)
    for i, c in enumerate(clouds):
        pts_pad[i, : len(c)] = c
        valid[i, : len(c)] = True
        if diversify_fps and len(c):
            # an empty cloud keeps start 0 and ends in the too-few-
            # superpoints None below
            starts[i] = np.random.default_rng(
                (seed, pair_ids[i // 2], i % 2, 17)).integers(len(c))
    dev = backend.device
    with _timed(backend, "prep.fps"):
        sp_idx = farthest_point_sample(
            torch.from_numpy(pts_pad).to(dev, backend.dtype), backend.n_super,
            start_idx=torch.from_numpy(starts).to(dev),
            mask=torch.from_numpy(valid).to(dev)).cpu().numpy()
    with _timed(backend, "prep.finish"):
        preps = [_finish_prep(c, sp_idx[i], backend.n_super, backend.patch_m)
                 for i, c in enumerate(clouds)]
    return [(preps[2 * i], preps[2 * i + 1]) for i in range(len(pairs))]


def register_round(backend, pairs, seed: int, diversify_fps: bool = False,
                   pair_ids=None) -> list[dict | None]:
    """One registration attempt over ``pairs`` (a list of (src, ref)
    arrays), every device stage batched. Returns a result dict (with
    ``fit_score``) or None a pair."""
    from sgaligner_tpu_torch.reg.icp import icp_refine_stages_batch
    from sgaligner_tpu_torch.reg.learned import (extract_correspondences,
                                                 extract_fine_correspondences,
                                                 weighted_kabsch)
    from sgaligner_tpu_torch.reg.ransac import ransac_hypotheses_batch

    n_pairs = len(pairs)
    if n_pairs == 0:
        return []
    if pair_ids is None:
        pair_ids = list(range(n_pairs))
    dev = backend.device
    preps = _prep_round(backend, pairs, seed, diversify_fps=diversify_fps,
                        pair_ids=pair_ids)

    # ---- stage 2: the matcher, the batch padded to a power of two by
    # repeating the last pair (the extra rows are dropped)
    b = _pow2(n_pairs, 1)

    def stack(side, key):
        return np.stack([preps[min(i, n_pairs - 1)][side][key] for i in range(b)])

    with _timed(backend, "matcher"):
        out = backend._apply_batch(
            stack(0, "sp"), stack(1, "sp"), stack(0, "inv"), stack(1, "inv"),
            stack(0, "eig"), stack(1, "eig"), stack(0, "pmask"),
            stack(1, "pmask"), stack(0, "mask"), stack(1, "mask"))

    # ---- stage 3: superpoint correspondences (host, a pair at a time)
    with _timed(backend, "coarse_extract"):
        coarse = []
        for i in range(n_pairs):
            src, ref = preps[i]
            if src["mask"].sum() < 4 or ref["mask"].sum() < 4:
                coarse.append(None)
                continue
            coarse.append(extract_correspondences(
                {"log_assign": out["log_assign"][i]}, src, ref, backend.top_pairs))

    # ---- stage 4: the fine Sinkhorn over the pairs with superpoint
    # correspondences, padded as the matcher's batch
    fine_results: list[tuple | None] = [None] * n_pairs
    act = [i for i in range(n_pairs) if coarse[i] is not None]
    if backend.fine and act:
        bf = _pow2(len(act), 1)
        rows = act + [act[-1]] * (bf - len(act))
        pad_pairs = np.zeros((bf, backend.top_pairs, 2), np.int32)
        for r, i in enumerate(rows):
            idx_pairs = coarse[i][3]
            pad_pairs[r, : len(idx_pairs)] = idx_pairs
        with _timed(backend, "fine.device"):
            fla = backend._fine_assign_batch(
                out["src_pf"][rows], out["ref_pf"][rows],
                np.stack([preps[i][0]["pmask"] for i in rows]),
                np.stack([preps[i][1]["pmask"] for i in rows]), pad_pairs)
        with _timed(backend, "fine.extract"):
            for r, i in enumerate(rows[: len(act)]):
                fine = extract_fine_correspondences(
                    fla[r], pad_pairs[r], len(coarse[i][3]), preps[i][0],
                    preps[i][1], backend.fine_score_thresh)
                if fine is not None and len(fine[0]) >= backend.min_fine_corrs:
                    fine_results[i] = fine

    # ---- stage 5: RANSAC hypotheses over every (pair, set) instance at
    # once; each instance draws from its identity (seed, pair id, role)
    instances = []   # (pair index, role, src_corr, ref_corr, thresh, corrs)
    for i in act:
        src_c, ref_c, scores, _ = coarse[i]
        fine = fine_results[i]
        if fine is not None:
            f_thresh = max(1.5 * backend.voxel_size, 0.075)
            instances.append((i, 0, fine[0], fine[1], f_thresh, fine))
        instances.append((i, 1, src_c, ref_c, backend.inlier_thresh,
                          (src_c, ref_c, scores)))
    hyps_per_pair: dict[int, list] = {i: [] for i in act}
    if instances:
        # the hypotheses and the ICP schedule fit at float64 (the JAX package
        # at float32): float32 rounding, carried far by the trimmed ICP, parts
        # the card's transforms from the CPU's
        gi = len(instances)
        nc = _pow2(max(len(inst[2]) for inst in instances), 64)
        src_p = np.zeros((gi, nc, 3), np.float64)
        ref_p = np.zeros((gi, nc, 3), np.float64)
        mask_p = np.zeros((gi, nc), bool)
        thr = np.zeros((gi,), np.float64)
        for r, (_, _role, sc, rc, t, _c) in enumerate(instances):
            src_p[r, : len(sc)] = sc
            ref_p[r, : len(rc)] = rc
            mask_p[r, : len(sc)] = True
            thr[r] = t
        # the minimal sets drawn on the host's generator, fitted and scored
        # on the device
        with _timed(backend, "ransac.device"):
            tfs, scores_h = ransac_hypotheses_batch(
                torch.from_numpy(src_p).to(dev), torch.from_numpy(ref_p).to(dev),
                torch.from_numpy(mask_p).to(dev), seed,
                [pair_ids[inst[0]] for inst in instances],
                [inst[1] for inst in instances], torch.from_numpy(thr), iters=1000)
            tfs = tfs.cpu().numpy()
            scores_h = scores_h.cpu().numpy()
        with _timed(backend, "ransac.nms"):
            for r, (i, _role, sc, rc, t, corrs) in enumerate(instances):
                for tf in _topk_nms_refine(tfs[r], scores_h[r], sc, rc, t,
                                           k=backend.hypotheses):
                    hyps_per_pair[i].append((tf, corrs))

    # ---- stage 6: pre-score (host kd-trees, kept per pair) and the
    # candidates for the ICP budget
    with _timed(backend, "verify.tree_build"):
        cache = getattr(backend, "_round_cache", None)
        nns = {}
        for i in act:
            nn_key = ("nn", pair_ids[i])
            if cache is not None and ("down", pair_ids[i], 1) in cache:
                # the ref cloud is the same every round: so is its tree
                if nn_key not in cache:
                    cache[nn_key] = _NNCache(preps[i][1]["points"])
                nns[i] = cache[nn_key]
            else:
                nns[i] = _NNCache(preps[i][1]["points"])
    with _timed(backend, "verify.prescore"):
        cands: dict[int, list] = {}
        for i in act:
            hyps = hyps_per_pair[i]
            if not hyps:
                src_c, ref_c, scores, _ = coarse[i]
                hyps = [(weighted_kabsch(src_c, ref_c, scores),
                         (src_c, ref_c, scores))]
            hyps = sorted(
                hyps, key=lambda h: -_fit_score(nns[i], preps[i][0]["points"],
                                                h[0], backend.voxel_size))
            cands[i] = hyps[: backend.max_refine]

    # ---- stage 7: the trimmed-ICP schedule over every (pair, candidate),
    # wide to tight: the wide pass pulls a decimetre-off start into the
    # basin, the tight ones keep non-overlap points from biasing it
    flat = [(i, c) for i in act for c in range(len(cands[i]))]
    if backend.refine_icp and flat:
        g2 = len(flat)
        sb = _pow2(max(len(preps[i][0]["points"]) for i, _ in flat), 64)
        rb = _pow2(max(len(preps[i][1]["points"]) for i, _ in flat), 64)
        src_p = np.zeros((g2, sb, 3), np.float64)
        ref_p = np.zeros((g2, rb, 3), np.float64)
        src_m = np.zeros((g2, sb), bool)
        ref_m = np.zeros((g2, rb), bool)
        inits = np.tile(np.eye(4, dtype=np.float64), (g2, 1, 1))
        frac = float(backend.icp_anchor_frac)
        if frac > 0:
            pb = _pow2(max(len(cands[i][c][1][0]) for i, c in flat), 16)
            a_src = np.zeros((g2, pb, 3), np.float64)
            a_ref = np.zeros((g2, pb, 3), np.float64)
            a_w = np.zeros((g2, pb), np.float64)
        for r, (i, c) in enumerate(flat):
            sp, rp = preps[i][0]["points"], preps[i][1]["points"]
            src_p[r, : len(sp)] = sp
            ref_p[r, : len(rp)] = rp
            src_m[r, : len(sp)] = True
            ref_m[r, : len(rp)] = True
            inits[r] = np.asarray(cands[i][c][0], np.float64)
            if frac > 0:
                # anchor only to the matches the candidate already agrees
                # with: at low overlap most of the set are outliers, whose
                # consensus would drag the solution
                cs, cr, cw = cands[i][c][1]
                init = np.asarray(cands[i][c][0], np.float64)
                res = np.linalg.norm(cs @ init[:3, :3].T + init[:3, 3] - cr, axis=-1)
                gate = res < max(1.5 * backend.voxel_size, 0.075)
                a_src[r, : len(cs)] = cs
                a_ref[r, : len(cr)] = cr
                a_w[r, : len(cw)] = np.maximum(cw, 0.0) * gate
        trims = np.array([6.0, 2.0, 1.0], np.float64) * backend.voxel_size

        def on_dev(a):
            return torch.from_numpy(a).to(dev)

        with _timed(backend, "icp.device"):
            anchors = ((on_dev(a_src), on_dev(a_ref), on_dev(a_w)) if frac > 0
                       else (None, None, None))
            refined = icp_refine_stages_batch(
                on_dev(src_p), on_dev(ref_p), on_dev(src_m), on_dev(ref_m),
                on_dev(inits), on_dev(trims), *anchors, anchor_frac=frac,
                iters=10).cpu().numpy()
        ests = {fc: np.asarray(refined[r], np.float64) for r, fc in enumerate(flat)}
    else:
        ests = {(i, c): np.asarray(cands[i][c][0], np.float64) for i, c in flat}

    # ---- stage 8: final verification, the best candidate a pair
    results: list[dict | None] = [None] * n_pairs
    with _timed(backend, "verify.final"):
        for i in act:
            best = None
            for c in range(len(cands[i])):
                est = ests[(i, c)]
                score = _fit_score(nns[i], preps[i][0]["points"], est,
                                   backend.voxel_size)
                if best is None or score > best[0]:
                    best = (score, est, cands[i][c][1])
            if best is None:
                continue
            score, est, (src_c, ref_c, scores) = best
            results[i] = {
                "estimated_transform": est,
                "src_corr_points": src_c,
                "ref_corr_points": ref_c,
                "corr_scores": scores,
                "fit_score": score,
            }
    return results
