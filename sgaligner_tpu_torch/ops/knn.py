"""Batched KNN grouping for point-cloud encoders.

Counterpart of ``sgaligner_tpu/ops/knn.py``: ``square_distance``,
``knn_point``, ``index_points`` and ``sample_and_knn_group`` (upstream
SGAligner's pct.py helpers), with the port's device FPS (``ops/fps.py``).
The distances keep the JAX order of operations (the product, then + |src|²,
then + |dst|²). The k nearest are taken by a stable sort, so exact ties
(padded all-zero objects, points repeated by resampling) go to the lower
index first, as ``lax.top_k`` orders them. Indices are int64.
"""

from __future__ import annotations

import torch

from sgaligner_tpu_torch.ops.fps import farthest_point_sample


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances ``[B, N, M]`` of src [B, N, C] and dst
    [B, M, C]."""
    d = -2.0 * torch.einsum("bnc,bmc->bnm", src, dst)
    d = d + torch.sum(src ** 2, -1)[:, :, None]
    return d + torch.sum(dst ** 2, -1)[:, None, :]


def knn_point(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """Indices ``[B, S, k]`` of the k points of xyz [B, N, 3] nearest each
    query of new_xyz [B, S, 3], nearest first, ties to the lower index."""
    sqrdists = square_distance(new_xyz, xyz)
    return torch.sort(sqrdists, dim=-1, stable=True).indices[..., :k]


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows by per-batch indices: [B, N, C] x [B, ...] -> [B, ..., C]."""
    b, c = points.shape[0], points.shape[-1]
    flat = idx.reshape(b, -1)
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, c))
    return out.reshape(*idx.shape, c)


def sample_and_knn_group(s: int, k: int, coords: torch.Tensor, features: torch.Tensor,
                         start_idx=0) -> tuple[torch.Tensor, torch.Tensor]:
    """FPS-sample s centres of coords [B, N, 3], group the k nearest points'
    features [B, N, D] around each, each less its centre's, beside the
    centre's own: ``([B, s, 3], [B, s, k, 2D])``."""
    fps_idx = farthest_point_sample(coords, s, start_idx=start_idx)   # [B, s]
    new_coords = index_points(coords, fps_idx)
    new_features = index_points(features, fps_idx)                   # [B, s, D]
    idx = knn_point(k, coords, new_coords)                           # [B, s, k]
    grouped = index_points(features, idx)                            # [B, s, k, D]
    centre = new_features[:, :, None, :]
    return new_coords, torch.cat([grouped - centre, centre.expand_as(grouped)], dim=-1)
