"""MultiModalEncoder — the SGAligner model.

Counterpart of ``sgaligner_tpu/models/sg_aligner.py`` for the modules
``point`` or ``pct``, ``gat``, ``rel`` and ``attr``: per-object embeddings,
each a Linear to ``emb_dim``, and the ``joint`` softmax-weighted concat of
the L2-normalised modal embeddings. Embeddings come back flat ``[B·2N, D]``.

Both configurations train (``train(True)``): NaivePCT's training form
(batch-statistics BatchNorm, the head's dropout, the backward kernels) and
the point encoder's. The caller's generator draws every dropout mask (the
GAT's and NaivePCT's head's).

Under data parallel the forward takes this rank's block of the batch
(``parallel.mesh.shard_batch``) and the ``mesh``: NaivePCT's BatchNorms
fold from the whole batch's statistics and every dropout mask is this
block's rows of the whole batch's; the embeddings are this block's.

Two point layouts: batch-pooled (``obj_points_pooled``, ``pooled_mask``,
``pooled_flat_idx`` from ``data.batch.pool_compact``; the encoder sees only
real objects and ``index_add_`` scatters them back to their slots) and the
uncompacted ``obj_points [B, 2N, 3, P]``.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from sgaligner_tpu_torch.models.pct import Linear, NaivePCT
from sgaligner_tpu_torch.models.pointnet import PointNetEncoder
from sgaligner_tpu_torch.models.structure import MultiGAT
from sgaligner_tpu_torch.ops.losses import l2_normalize


def point_inputs(batch: dict, b: int, two_n: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The object encoder's input ``[O, 3, P]`` and its mask ``[O]``: the
    batch-pooled points, or every slot of the uncompacted layout."""
    if "obj_points_pooled" in batch:
        pts, mask = batch["obj_points_pooled"], batch["pooled_mask"]
    elif "obj_points" in batch:
        pts, mask = batch["obj_points"], batch["obj_mask"].reshape(b * two_n)
    else:
        raise NotImplementedError("per-pair compacted points are not "
                                  "ported yet; use pool_compact")
    return pts.reshape(-1, 3, pts.shape[-1]), mask


def scatter_pooled(emb: torch.Tensor, batch: dict, b: int, two_n: int
                   ) -> torch.Tensor:
    """Per-object rows back to the ``[B·2N]`` slots: the pooled layout's
    padded rows zeroed and scattered by ``pooled_flat_idx``; the uncompacted
    layout's rows are the slots already."""
    if "obj_points_pooled" not in batch:
        return emb
    emb = emb * batch["pooled_mask"][:, None].to(emb.dtype)
    out = torch.zeros((b * two_n, emb.shape[-1]), dtype=emb.dtype,
                      device=emb.device)
    return out.index_add_(0, batch["pooled_flat_idx"].long(), emb)


class MultiModalFusion(nn.Module):
    """Learned softmax weights over modalities."""

    def __init__(self, modal_num: int):
        super().__init__()
        self.modal_num = modal_num
        self.weight = nn.Parameter(torch.ones(modal_num, 1))

    def forward(self, embs: list[torch.Tensor]) -> torch.Tensor:
        dt = embs[0].dtype
        wn = torch.softmax(self.weight.to(dt), dim=0)
        return torch.cat([wn[i] * l2_normalize(e, dim=-1)
                          for i, e in enumerate(embs)], dim=-1)


class MultiModalEncoder(nn.Module):
    """Built in eval mode; ``train(True)`` switches every module to its
    training form."""

    def __init__(self, modules: Sequence[str] = ("pct", "gat", "rel", "attr"),
                 rel_dim: int = 41, attr_dim: int = 164, emb_dim: int = 100,
                 pt_out_dim: int = 256,
                 hidden_units: Sequence[int] = (3, 128, 128),
                 heads: Sequence[int] = (2, 2), dropout: float = 0.0,
                 pointnet_bn_mode: str = "parity",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.modal_names = tuple(modules)
        self.dtype = dtype
        for m in self.modal_names:
            if m not in ("point", "pct", "gat", "rel", "attr"):
                raise NotImplementedError(
                    f"module {m!r} is not ported yet "
                    "(point, pct, gat, rel, attr are)")
        if "pct" in self.modal_names:
            self.object_encoder = NaivePCT(pt_out_dim, dtype=dtype)
        elif "point" in self.modal_names:
            self.object_encoder = PointNetEncoder(pt_out_dim, pointnet_bn_mode,
                                                  dtype=dtype)
        if "pct" in self.modal_names or "point" in self.modal_names:
            self.object_embedding = Linear(pt_out_dim, emb_dim)
        if "gat" in self.modal_names:
            self.structure_encoder = MultiGAT(hidden_units, heads, dropout)
            self.structure_embedding = Linear(hidden_units[-1] * heads[-1], emb_dim)
        if "rel" in self.modal_names:
            self.meta_embedding_rel = Linear(rel_dim, emb_dim)
        if "attr" in self.modal_names:
            self.meta_embedding_attr = Linear(attr_dim, emb_dim)
        if len(self.modal_names) > 1:
            self.fusion = MultiModalFusion(len(self.modal_names))
        self.eval()

    def _points(self, batch: dict, b: int, two_n: int,
                generator: torch.Generator | None, mesh) -> torch.Tensor:
        pts, mask = point_inputs(batch, b, two_n)
        feat = self.object_encoder(pts, mask, generator, mesh)
        return scatter_pooled(self.object_embedding(feat, self.dtype), batch,
                              b, two_n)

    def forward(self, batch: dict, generator: torch.Generator | None = None,
                mesh=None) -> dict[str, torch.Tensor]:
        """``generator`` draws the dropout masks in training mode; ``mesh``
        (``parallel.mesh.Mesh``) when ``batch`` is one rank's block."""
        dt = self.dtype
        b, two_n = batch["obj_mask"].shape
        n = two_n // 2
        embs: dict[str, torch.Tensor] = {}
        for module in self.modal_names:
            if module in ("point", "pct"):
                emb = self._points(batch, b, two_n, generator, mesh)
            elif module == "gat":
                rel_pose = batch["rel_pose"].to(dt).reshape(2 * b, n, 3)
                node_mask = batch["obj_mask"].reshape(2 * b, n)
                adj = batch["adj"].reshape(2 * b, n, n)
                feat = self.structure_encoder(rel_pose, adj, node_mask,
                                              generator, mesh)
                emb = self.structure_embedding(feat.reshape(b * two_n, -1), dt)
            elif module == "rel":
                emb = self.meta_embedding_rel(batch["bow_rel"], dt)
            else:
                emb = self.meta_embedding_attr(batch["bow_attr"], dt)
            embs[module] = emb.reshape(b * two_n, -1)
        if len(self.modal_names) > 1:
            embs["joint"] = self.fusion([embs[m] for m in self.modal_names])
        return embs
