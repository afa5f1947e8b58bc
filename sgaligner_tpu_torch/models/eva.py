"""EVA — the baseline aligner with a GCN structure encoder.

Counterpart of ``sgaligner_tpu/models/eva.py::EVA``: the modules ``point``,
``gcn``, ``rel`` and ``attr``; a 200-wide PointNet (``pt_out_dim``) whose
raw feature is the point embedding (no projection), MultiGCN
``(3, 200, 400)`` whose output is the structure embedding (no projection),
and the relation and attribute bags of words each through a Linear to
``emb_dim``. With more than one module, ``joint`` is the softmax-weighted
concat of the L2-normalised modal embeddings (``MultiModalFusion``).
Embeddings come back flat ``[B·2N, D]``.

Points come batch-pooled (``obj_points_pooled``; padded rows zeroed and
scattered back to their slots) or uncompacted (``obj_points``, every slot
through the encoder); the per-pair compacted layout raises. Parameters carry
upstream EVA's torch names (``object_encoder.conv{1,2,3}``,
``structure_encoder.layer_stack.{i}.lin.weight`` and ``.bias``,
``meta_embedding_{rel,attr}``, ``fusion.weight``).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from sgaligner_tpu_torch.models.pct import Linear
from sgaligner_tpu_torch.models.pointnet import PointNetEncoder
from sgaligner_tpu_torch.models.sg_aligner import (MultiModalFusion,
                                                   point_inputs, scatter_pooled)
from sgaligner_tpu_torch.parallel.mesh import sharded
from sgaligner_tpu_torch.models.structure import MultiGCN


class EVA(nn.Module):
    """Built in eval mode, as ``MultiModalEncoder`` is."""

    def __init__(self, modules: Sequence[str] = ("point", "gcn", "rel", "attr"),
                 rel_dim: int = 41, attr_dim: int = 164,
                 n_units: Sequence[int] = (3, 200, 400), emb_dim: int = 100,
                 pt_out_dim: int = 200, dropout: float = 0.0,
                 pointnet_bn_mode: str = "parity",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.modal_names = tuple(modules)
        self.dtype = dtype
        for m in self.modal_names:
            if m not in ("point", "gcn", "rel", "attr"):
                raise NotImplementedError(f"unknown EVA module {m!r}")
        if "point" in self.modal_names:
            self.object_encoder = PointNetEncoder(pt_out_dim, pointnet_bn_mode,
                                                  dtype=dtype)
        if "gcn" in self.modal_names:
            self.structure_encoder = MultiGCN(n_units, dropout)
        if "rel" in self.modal_names:
            self.meta_embedding_rel = Linear(rel_dim, emb_dim)
        if "attr" in self.modal_names:
            self.meta_embedding_attr = Linear(attr_dim, emb_dim)
        if len(self.modal_names) > 1:
            self.fusion = MultiModalFusion(len(self.modal_names))
        self.eval()

    def forward(self, batch: dict, generator: torch.Generator | None = None,
                mesh=None) -> dict[str, torch.Tensor]:
        """``generator`` draws the GCN's dropout masks in training mode.
        ``mesh``: ``batch`` is one rank's block; in eval mode each object is
        computed alone, and training under data parallel is not ported
        (ROADMAP §1 item 8)."""
        if self.training and sharded(mesh):
            raise NotImplementedError("EVA's training under data parallel (nca step) "
                                      "is not ported yet (ROADMAP §1 item 8)")
        dt = self.dtype
        b, two_n = batch["obj_mask"].shape
        n = two_n // 2
        embs: dict[str, torch.Tensor] = {}
        for module in self.modal_names:
            if module == "point":
                pts, mask = point_inputs(batch, b, two_n)
                feat = self.object_encoder(pts, mask, generator)
                emb = scatter_pooled(feat, batch, b, two_n)
            elif module == "gcn":
                rel_pose = batch["rel_pose"].to(dt).reshape(2 * b, n, 3)
                node_mask = batch["obj_mask"].reshape(2 * b, n)
                adj = batch["adj"].reshape(2 * b, n, n)
                emb = self.structure_encoder(rel_pose, adj, node_mask, generator)
            elif module == "rel":
                emb = self.meta_embedding_rel(batch["bow_rel"], dt)
            else:
                emb = self.meta_embedding_attr(batch["bow_attr"], dt)
            embs[module] = emb.reshape(b * two_n, -1)
        if len(self.modal_names) > 1:
            embs["joint"] = self.fusion([embs[m] for m in self.modal_names])
        return embs
