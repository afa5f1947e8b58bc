"""Rigid-transform estimation from 3D-3D correspondences: batched Kabsch and
RANSAC on the device.

Counterpart of ``sgaligner_tpu/reg/ransac.py`` (upstream's GC-RANSAC role,
``pygcransac.findRigidTransform``): every hypothesis is evaluated at once.
``iters`` minimal 3-point sets are drawn, each is solved by a batched
Kabsch SVD, all are scored by their inlier counts in chunks of residuals,
and the winner (the first of the highest count) is refined on its inlier
set by reweighted Kabsch.

The draw is a function of its own, ``draw_minimal_sets(n_valid, iters,
seed)``: uniform over ordered triples of distinct valid correspondences,
drawn on a CPU ``torch.Generator`` and moved to the device, so the card and
the CPU test the same hypotheses. (The JAX package draws by Gumbel top-k
over the whole padded axis, ``iters x bucket`` floats; the answers of
everything after the draw are the same for the same samples.)

The device functions compute at the dtype of their inputs. The host
wrappers (``find_rigid_transform``, ``find_rigid_transforms_topk``) fit at
float64, as upstream's ``pygcransac`` does: the card has float64 units, so
the card and the CPU agree to rounding (a rotation error read through
arccos near 0 turns float32 rounding into 1e-4 to 1e-2 degrees).

Transform convention as upstream: ``x' = x @ R.T + t`` with
``transform[:3, :3] = R``, ``transform[:3, 3] = t``.
"""

from __future__ import annotations

import numpy as np
import torch


def draw_minimal_sets(n_valid: int, iters: int, seed: int) -> torch.Tensor:
    """``[iters, 3]`` int64 indices into the ``n_valid`` valid
    correspondences, on the CPU: each row three distinct indices, uniform
    over ordered triples (the second and third skip the ones drawn
    before them)."""
    if n_valid < 3:
        raise ValueError(f"a minimal set needs 3 correspondences, got {n_valid}")
    g = torch.Generator().manual_seed(int(seed))
    a = torch.randint(0, n_valid, (iters,), generator=g)
    b = torch.randint(0, n_valid - 1, (iters,), generator=g)
    c = torch.randint(0, n_valid - 2, (iters,), generator=g)
    b = b + (b >= a)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    c = c + (c >= lo)
    c = c + (c >= hi)
    return torch.stack([a, b, c], dim=1)


def kabsch(src: torch.Tensor, ref: torch.Tensor,
           weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted least-squares rigid transform src -> ref, batched over the
    leading axes: ``src, ref [..., N, 3]``, ``weights [..., N]`` ->
    ``[..., 4, 4]``. The SVD's reflection is fixed by the sign of
    ``det(V Uᵀ)``."""
    w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device) \
        if weights is None else weights
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    src_c = (w[..., None] * src).sum(-2)
    ref_c = (w[..., None] * ref).sum(-2)
    h = ((w[..., None] * (src - src_c[..., None, :])).transpose(-1, -2)
         @ (ref - ref_c[..., None, :]))
    u, _, vt = torch.linalg.svd(h)
    v, ut = vt.transpose(-1, -2), u.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(v @ ut))
    diag = torch.ones(d.shape + (3,), dtype=src.dtype, device=src.device)
    diag[..., 2] = d
    r = (v * diag[..., None, :]) @ ut
    t = ref_c - (r @ src_c[..., None])[..., 0]
    tf = torch.eye(4, dtype=src.dtype, device=src.device).expand(
        d.shape + (4, 4)).clone()
    tf[..., :3, :3] = r
    tf[..., :3, 3] = t
    return tf


def _residuals(src, ref, tf):
    """``|src·Rᵀ + t - ref|`` per correspondence; ``tf [..., 4, 4]`` ->
    ``[..., N]``."""
    moved = src @ tf[..., :3, :3].transpose(-1, -2) + tf[..., None, :3, 3]
    return torch.linalg.vector_norm(moved - ref, dim=-1)


def _samples(mask: torch.Tensor, iters: int, seed: int) -> torch.Tensor:
    """``draw_minimal_sets`` over the valid entries of ``mask``, as indices
    into the padded axis, on the mask's device."""
    valid = torch.nonzero(mask.cpu())[:, 0]
    return valid[draw_minimal_sets(len(valid), iters, seed)].to(mask.device)


def _hypotheses(src, ref, mask, seed, threshold, iters, chunk):
    maskf = mask.to(src.dtype)
    samples = _samples(mask, iters, seed)
    tfs = kabsch(src[samples], ref[samples])                 # [iters, 4, 4]
    scores = torch.cat([((_residuals(src, ref, tfs[i:i + chunk]) < threshold)
                         * maskf).sum(-1) for i in range(0, iters, chunk)])
    return tfs, scores


def ransac_hypotheses(src: torch.Tensor, ref: torch.Tensor, mask: torch.Tensor,
                      seed: int, threshold: float = 0.03, iters: int = 5000,
                      chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Every minimal-set hypothesis with its inlier count: ``(tfs [iters, 4,
    4], scores [iters])``. ``src, ref [N, 3]`` (padding allowed), ``mask
    [N]`` marks the valid correspondences; residuals are scored ``chunk``
    hypotheses at a time."""
    return _hypotheses(src, ref, mask, seed, threshold, iters, chunk)


def ransac_rigid_transform(src: torch.Tensor, ref: torch.Tensor,
                           mask: torch.Tensor, seed: int,
                           threshold: float = 0.03, iters: int = 5000,
                           chunk: int = 256, refine_steps: int = 3
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(transform [4, 4], inlier count)``: the first hypothesis of the
    highest count, then ``refine_steps`` Kabsch fits on its inliers (a step
    with fewer than 3 inliers keeps the transform it had). No host sync
    after the draw."""
    maskf = mask.to(src.dtype)
    tfs, scores = _hypotheses(src, ref, mask, seed, threshold, iters, chunk)
    best = tfs[torch.argmax(scores)]
    for _ in range(refine_steps):
        w = (_residuals(src, ref, best) < threshold) * maskf
        best = torch.where(w.sum() >= 3, kabsch(src, ref, w + 1e-12), best)
    inliers = ((_residuals(src, ref, best) < threshold) * maskf).sum()
    return best, inliers


def _padded(src_corr, ref_corr, device):
    """The correspondences in a power-of-two bucket (at least 64) of float64
    rows, with the mask of the real ones."""
    n = len(src_corr)
    bucket = 1 << max(int(np.ceil(np.log2(n))), 6)
    src_p = np.zeros((bucket, 3))
    ref_p = np.zeros((bucket, 3))
    mask = np.zeros(bucket, bool)
    src_p[:n], ref_p[:n], mask[:n] = src_corr, ref_corr, True
    return (torch.from_numpy(src_p).to(device), torch.from_numpy(ref_p).to(device),
            torch.from_numpy(mask).to(device))


def _se3_distinct(tf: np.ndarray, kept: list[np.ndarray],
                  rot_deg: float, trans: float) -> bool:
    for k in kept:
        r = tf[:3, :3] @ k[:3, :3].T
        ang = np.degrees(np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)))
        dt = np.linalg.norm(tf[:3, 3] - k[:3, 3])
        if ang < rot_deg and dt < trans:
            return False
    return True


def find_rigid_transforms_topk(
    src_corr: np.ndarray,
    ref_corr: np.ndarray,
    threshold: float = 0.03,
    k: int = 3,
    max_iters: int = 5000,
    seed: int = 0,
    min_inliers: int = 3,
    rot_deg: float = 15.0,
    trans: float = 0.3,
    refine_steps: int = 3,
    device: str | torch.device = "cuda",
) -> list[np.ndarray]:
    """Top-k RANSAC fits from distinct consensus clusters (greedy SE(3)
    non-max suppression over hypothesis score), each refined on the host by
    inlier reweighting, at float64. Returns [] when no 3-point consensus
    exists."""
    if len(src_corr) < 3:
        return []
    tfs, scores = ransac_hypotheses(*_padded(src_corr, ref_corr, device),
                                    seed, threshold=threshold, iters=max_iters)
    tfs = tfs.cpu().numpy()
    scores = scores.cpu().numpy()
    src_t = torch.from_numpy(np.asarray(src_corr, np.float64))
    ref_t = torch.from_numpy(np.asarray(ref_corr, np.float64))

    out: list[np.ndarray] = []
    for i in np.argsort(-scores):
        if scores[i] < min_inliers:
            break
        tf = tfs[i]
        if not _se3_distinct(tf, out, rot_deg, trans):
            continue
        for _ in range(refine_steps):
            res = np.linalg.norm(
                src_corr @ tf[:3, :3].T + tf[:3, 3] - ref_corr, axis=-1)
            w = torch.from_numpy(res < threshold).to(torch.float64)
            if w.sum() < 3:
                break
            tf = kabsch(src_t, ref_t, w).numpy()
        if _se3_distinct(tf, out, rot_deg, trans) or not out:
            out.append(tf)
        if len(out) >= k:
            break
    return out


def find_rigid_transform(
    src_corr: np.ndarray,
    ref_corr: np.ndarray,
    threshold: float = 0.03,
    max_iters: int = 5000,
    seed: int = 0,
    max_corrs: int = 20000,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray | None, np.ndarray]:
    """Host wrapper in the ``pygcransac.findRigidTransform`` role: the rigid
    transform mapping src correspondences onto ref (fitted at float64) and
    the inlier mask of the given correspondences. More than
    ``max_corrs`` are subsampled with ``np.random.default_rng(seed)``; the
    set is padded to a power-of-two bucket."""
    n = len(src_corr)
    if n < 3:
        return None, np.zeros(0, bool)
    if n > max_corrs:
        sel = np.random.default_rng(seed).choice(n, max_corrs, replace=False)
        src_corr, ref_corr = src_corr[sel], ref_corr[sel]
    tf, _ = ransac_rigid_transform(*_padded(src_corr, ref_corr, device),
                                   seed, threshold=threshold, iters=max_iters)
    tf = tf.cpu().numpy()
    res = np.linalg.norm(src_corr @ tf[:3, :3].T + tf[:3, 3] - ref_corr, axis=-1)
    return tf, res < threshold
