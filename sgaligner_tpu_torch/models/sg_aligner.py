"""MultiModalEncoder — the SGAligner model, inference form.

Counterpart of ``sgaligner_tpu/models/sg_aligner.py`` for the modules
``pct``, ``gat``, ``rel`` and ``attr``: per-object embeddings, each a Linear
to ``emb_dim``, and the ``joint`` softmax-weighted concat of the
L2-normalised modal embeddings. Embeddings come back flat ``[B·2N, D]``.

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
from sgaligner_tpu_torch.models.structure import MultiGAT
from sgaligner_tpu_torch.ops.losses import l2_normalize


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
    """Inference only: ``train(True)`` raises (training is a later slice)."""

    def __init__(self, modules: Sequence[str] = ("pct", "gat", "rel", "attr"),
                 rel_dim: int = 41, attr_dim: int = 164, emb_dim: int = 100,
                 pt_out_dim: int = 256,
                 hidden_units: Sequence[int] = (3, 128, 128),
                 heads: Sequence[int] = (2, 2),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.modal_names = tuple(modules)
        self.dtype = dtype
        for m in self.modal_names:
            if m not in ("pct", "gat", "rel", "attr"):
                raise NotImplementedError(
                    f"module {m!r} is not ported yet (pct, gat, rel, attr are)")
        if "pct" in self.modal_names:
            self.object_encoder = NaivePCT(pt_out_dim, dtype=dtype)
            self.object_embedding = Linear(pt_out_dim, emb_dim)
        if "gat" in self.modal_names:
            self.structure_encoder = MultiGAT(hidden_units, heads)
            self.structure_embedding = Linear(hidden_units[-1] * heads[-1], emb_dim)
        if "rel" in self.modal_names:
            self.meta_embedding_rel = Linear(rel_dim, emb_dim)
        if "attr" in self.modal_names:
            self.meta_embedding_attr = Linear(attr_dim, emb_dim)
        if len(self.modal_names) > 1:
            self.fusion = MultiModalFusion(len(self.modal_names))
        self.eval()

    def train(self, mode: bool = True):
        if mode:
            raise NotImplementedError("the port's MultiModalEncoder runs "
                                      "inference only so far")
        return super().train(False)

    def _points(self, batch: dict, b: int, two_n: int) -> torch.Tensor:
        dt = self.dtype
        if "obj_points_pooled" in batch:
            pts = batch["obj_points_pooled"]
            mask = batch["pooled_mask"]
        elif "obj_points" in batch:
            pts = batch["obj_points"]
            mask = batch["obj_mask"].reshape(b * two_n)
        else:
            raise NotImplementedError("per-pair compacted points are not "
                                      "ported yet; use pool_compact")
        pts = pts.reshape(-1, 3, pts.shape[-1])
        feat = self.object_encoder(pts, mask)
        emb = self.object_embedding(feat, dt)
        if "obj_points_pooled" in batch:
            emb = emb * batch["pooled_mask"][:, None].to(emb.dtype)
            out = torch.zeros((b * two_n, emb.shape[-1]), dtype=emb.dtype,
                              device=emb.device)
            emb = out.index_add_(0, batch["pooled_flat_idx"].long(), emb)
        return emb

    def forward(self, batch: dict) -> dict[str, torch.Tensor]:
        dt = self.dtype
        b, two_n = batch["obj_mask"].shape
        n = two_n // 2
        embs: dict[str, torch.Tensor] = {}
        for module in self.modal_names:
            if module == "pct":
                emb = self._points(batch, b, two_n)
            elif module == "gat":
                rel_pose = batch["rel_pose"].to(dt).reshape(2 * b, n, 3)
                node_mask = batch["obj_mask"].reshape(2 * b, n)
                adj = batch["adj"].reshape(2 * b, n, n)
                feat = self.structure_encoder(rel_pose, adj, node_mask)
                emb = self.structure_embedding(feat.reshape(b * two_n, -1), dt)
            elif module == "rel":
                emb = self.meta_embedding_rel(batch["bow_rel"], dt)
            else:
                emb = self.meta_embedding_attr(batch["bow_attr"], dt)
            embs[module] = emb.reshape(b * two_n, -1)
        if len(self.modal_names) > 1:
            embs["joint"] = self.fusion([embs[m] for m in self.modal_names])
        return embs
