"""Batched farthest-point sampling on the device.

Counterpart of ``sgaligner_tpu/ops/fps.py``: ``npoint`` sequential picks
over ``[B, N, 3]`` point sets, each a distance update and an argmax over the
whole batch at once. The argmax keeps the first index of the maximum, as
``jnp.argmax`` does; padded points (``mask`` False) hold distance -1 and are
never picked while a valid point remains, so the picks do not depend on the
padding length.
"""

from __future__ import annotations

import torch


def farthest_point_sample(points: torch.Tensor, npoint: int,
                          start_idx: torch.Tensor | int = 0,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """FPS indices ``[B, npoint]`` (int64) into ``points [B, N, 3]``.
    ``start_idx`` (``[B]`` or a scalar) is the first pick of each set;
    ``mask [B, N]`` marks the valid points."""
    b, n, _ = points.shape
    dev = points.device
    farthest = torch.as_tensor(start_idx, dtype=torch.int64, device=dev).expand(b).clone()
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    neg = torch.full((), -1.0, dtype=points.dtype, device=dev)
    dist = torch.where(mask, torch.full((), 1e10, dtype=points.dtype, device=dev), neg)
    idxs = torch.empty((b, npoint), dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)
    for i in range(npoint):
        idxs[:, i] = farthest
        centroid = points[rows, farthest][:, None, :]                 # [B, 1, 3]
        d = ((points - centroid) ** 2).sum(-1)                         # [B, N]
        dist = torch.minimum(dist, torch.where(mask, d, neg))
        farthest = torch.argmax(dist, dim=-1)
    return idxs


def fps_sample(points: torch.Tensor, npoint: int, start_idx=0,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """The sampled points: ``[B, N, 3] -> [B, npoint, 3]``."""
    idxs = farthest_point_sample(points, npoint, start_idx, mask)
    return torch.gather(points, 1, idxs[:, :, None].expand(-1, -1, 3))
