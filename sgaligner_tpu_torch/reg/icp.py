"""Point-to-point ICP refinement on the device.

Counterpart of ``sgaligner_tpu/reg/icp.py`` (``icp_refine`` and
``icp_refine_host``): a fixed number of ICP iterations at float32, nearest
neighbours by chunked brute-force distance products (``|s|² - 2 s·r +
|r|²``, the first index of the minimum), rigid updates by the weighted
Kabsch of ``reg/ransac.py``. Correspondences beyond ``max_corr_dist`` get
zero weight (trimmed ICP); an iteration with fewer than 3 keeps the
transform it had. Used by ``MutualNNBackend(refine_icp=True)``;
``icp_refine_stages_batch`` runs the learned backend's trim schedule over
many (pair, candidate) instances at once, with optional correspondence
anchors.
"""

from __future__ import annotations

import numpy as np
import torch

from sgaligner_tpu_torch.reg.ransac import kabsch


def _chunked_nn(src: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor,
                chunk: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """1-NN of each src point among the valid ref points: (squared
    distances, indices), ``chunk`` src rows at a time."""
    ref_sq = (ref * ref).sum(1)
    big = torch.where(ref_mask, 0.0, 1e30).to(ref.dtype)
    d2, idx = [], []
    for i in range(0, src.shape[0], chunk):
        s = src[i:i + chunk]
        d = ((s * s).sum(1)[:, None] - 2.0 * s @ ref.T + ref_sq[None, :]
             + big[None, :])
        m = torch.min(d, dim=1)
        d2.append(m.values)
        idx.append(m.indices)
    return torch.cat(d2), torch.cat(idx)


def icp_refine(src: torch.Tensor, ref: torch.Tensor, src_mask: torch.Tensor,
               ref_mask: torch.Tensor, init_transform: torch.Tensor,
               iters: int = 10, max_corr_dist: float = 0.1, chunk: int = 1024
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration point-to-point ICP of ``src [N, 3]`` onto ``ref [M,
    3]`` (padding allowed, the masks mark the real points) from
    ``init_transform [4, 4]``. Returns ``(transform, inlier rmse)`` at
    float32, whatever the input dtype (as the JAX function does)."""
    src_f = src.to(torch.float32)
    ref_f = ref.to(torch.float32)
    maskf = src_mask.to(torch.float32)
    tf = init_transform.to(torch.float32)
    for _ in range(iters):
        moved = src_f @ tf[:3, :3].T + tf[:3, 3]
        d2, idx = _chunked_nn(moved, ref_f, ref_mask, chunk)
        w = maskf * (d2 < max_corr_dist ** 2)
        new_tf = kabsch(src_f, ref_f[idx], w + 1e-12)
        tf = torch.where(w.sum() >= 3, new_tf, tf)
    moved = src_f @ tf[:3, :3].T + tf[:3, 3]
    d2, _ = _chunked_nn(moved, ref_f, ref_mask, chunk)
    w = maskf * (d2 < max_corr_dist ** 2)
    rmse = torch.sqrt((d2 * w).sum() / torch.clamp(w.sum(), min=1.0))
    return tf, rmse


def icp_refine_stages_batch(src: torch.Tensor, ref: torch.Tensor,
                            src_mask: torch.Tensor, ref_mask: torch.Tensor,
                            init_transforms: torch.Tensor, trims: torch.Tensor,
                            anchor_src: torch.Tensor | None = None,
                            anchor_ref: torch.Tensor | None = None,
                            anchor_w: torch.Tensor | None = None,
                            anchor_frac: float = 0.15, iters: int = 10,
                            chunk: int | None = None) -> torch.Tensor:
    """The trim schedule of the learned backend over G (pair, candidate)
    instances at once: ``iters`` ICP iterations at each ``max_corr_dist``
    of ``trims [T]``, in order, at the source's dtype (float32 at least; the
    JAX function casts to float32). ``src [G, N, 3]``, ``ref [G, M,
    3]`` with their masks, ``init_transforms [G, 4, 4]``; returns the
    refined ``[G, 4, 4]``. Nearest neighbours are found ``chunk`` source
    points at a time, so the ``[G, chunk, M]`` distance transient stays
    small at G instances: by default 256 on the card, and on the CPU as
    many as keep it within 2^21 floats (the cache; the answers do not
    depend on the chunk).

    ``anchor_*`` (``[G, P, 3]``, ``[G, P, 3]``, weights ``[G, P]``, 0 for
    padding): the candidate's matcher correspondences, added to every
    Kabsch solve with a total weight of ``anchor_frac`` times that
    iteration's trimmed-NN inlier weight. Point-to-point ICP slides along
    self-similar planar geometry, where the NN cost is flat in the tangent
    direction; the anchors are the one term that is not."""
    g, n, _ = src.shape
    if chunk is None:
        chunk = 256 if src.is_cuda else max(16, (1 << 21) // max(g * ref.shape[1], 1))
    dt = torch.promote_types(src.dtype, torch.float32)
    src_f = src.to(dt)
    ref_f = ref.to(dt)
    maskf = src_mask.to(dt)
    big = torch.where(ref_mask, 0.0, 1e30).to(dt)
    ref_sq = (ref_f * ref_f).sum(-1) + big                          # [G, M]

    def nn_all(moved):
        d2, idx = [], []
        for i in range(0, n, chunk):
            s = moved[:, i:i + chunk]                               # [G, c, 3]
            # |s|² - 2 s·r + |r|², in place (-2 s·r + |s|² rounds as |s|² - 2 s·r)
            d = torch.bmm(s, ref_f.transpose(1, 2)).mul_(-2.0)
            d.add_((s * s).sum(-1)[..., None]).add_(ref_sq[:, None, :])
            m = torch.min(d, dim=-1)
            d2.append(m.values)
            idx.append(m.indices)
        return torch.cat(d2, dim=1), torch.cat(idx, dim=1)

    anchored = anchor_src is not None
    if anchored:
        a_src = anchor_src.to(dt)
        a_ref = anchor_ref.to(dt)
        a_w = anchor_w.to(dt)
    tf = init_transforms.to(dt)
    for trim in torch.repeat_interleave(trims.to(dt), iters):
        moved = torch.einsum("gnd,ged->gne", src_f, tf[:, :3, :3]) + tf[:, None, :3, 3]
        d2, idx = nn_all(moved)
        w = maskf * (d2 < trim * trim)
        targets = torch.gather(ref_f, 1, idx[..., None].expand(-1, -1, 3))
        if anchored:
            # the anchors carry anchor_frac of the NN inlier mass
            scale = anchor_frac * w.sum(-1) / torch.clamp(a_w.sum(-1), min=1e-9)
            s_all = torch.cat([src_f, a_src], dim=1)
            t_all = torch.cat([targets, a_ref], dim=1)
            w_all = torch.cat([w, a_w * scale[:, None]], dim=1)
        else:
            s_all, t_all, w_all = src_f, targets, w
        new_tf = kabsch(s_all, t_all, w_all + 1e-12)
        tf = torch.where((w.sum(-1) >= 3)[:, None, None], new_tf, tf)
    return tf


def icp_refine_host(src_points: np.ndarray, ref_points: np.ndarray,
                    init_transform: np.ndarray | None = None,
                    iters: int = 10, max_corr_dist: float = 0.1,
                    max_points: int = 8192, seed: int = 0,
                    device: str | torch.device = "cuda"):
    """Host wrapper: subsample to ``max_points`` (``np.random.
    default_rng(seed)``), pad to power-of-two buckets, run ``icp_refine``
    on ``device``. Returns ``(transform float64, rmse)``."""
    rng = np.random.default_rng(seed)

    def prep(pts):
        if len(pts) > max_points:
            pts = pts[rng.choice(len(pts), max_points, replace=False)]
        bucket = 1 << max(int(np.ceil(np.log2(max(len(pts), 64)))), 6)
        out = np.zeros((bucket, 3), np.float32)
        mask = np.zeros(bucket, bool)
        out[: len(pts)] = pts
        mask[: len(pts)] = True
        return torch.from_numpy(out).to(device), torch.from_numpy(mask).to(device)

    src_p, src_m = prep(np.asarray(src_points, np.float32))
    ref_p, ref_m = prep(np.asarray(ref_points, np.float32))
    init = (np.eye(4, dtype=np.float32) if init_transform is None
            else np.asarray(init_transform, np.float32))
    tf, rmse = icp_refine(src_p, ref_p, src_m, ref_m,
                          torch.from_numpy(init).to(device), iters=iters,
                          max_corr_dist=max_corr_dist)
    return tf.cpu().numpy().astype(np.float64), float(rmse)
