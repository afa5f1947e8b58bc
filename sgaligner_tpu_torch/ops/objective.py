"""Training objectives: OverallLoss (SGAligner) and OverallNCALoss (EVA).

Counterpart of ``sgaligner_tpu/ops/objective.py`` (``init_loss_params``,
``flat_loss_indices``, ``overall_loss``, ``overall_nca_loss``) over a padded
PairBatch. SGAligner's:
per-modality ICL and IAL (against the joint embedding), each group combined
by Kendall uncertainty weights, plus ICL on the joint embedding. The
weights' log-variances are the ``nn.Parameter``s of ``OverallLoss``, which
the optimizer updates with the model's (upstream adds the loss layers'
parameters to its optimizer). EVA's: NCA over every output head (each
modality and ``joint``), summed; it has no parameters, and the port runs
it forward only (the EVA eval step's loss).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from sgaligner_tpu_torch.ops.losses import (ial_loss, icl_loss, kendall_combine,
                                            l2_normalize, nca_loss)


def init_loss_params(num_modules: int) -> dict[str, torch.Tensor]:
    return {"ial_log_vars": torch.zeros(num_modules),
            "icl_log_vars": torch.zeros(num_modules)}


def flat_loss_indices(batch: dict) -> dict[str, torch.Tensor]:
    """Per-pair slot indices -> flat indices into the [B·2N] object axis."""
    b, two_n = batch["obj_mask"].shape
    offs = torch.arange(b, device=batch["obj_mask"].device)[:, None] * two_n

    def flat(idx_key, mask_key):
        return ((batch[idx_key].long() + offs).reshape(-1),
                batch[mask_key].reshape(-1))

    e1i, m_i = flat("e1i", "anchor_mask")
    e2i, _ = flat("e2i", "anchor_mask")
    e1j, m_j1 = flat("e1j", "e1j_mask")
    e2j, m_j2 = flat("e2j", "e2j_mask")
    return {"e1i": e1i, "e2i": e2i, "e1j": e1j, "e2j": e2j,
            "m_i": m_i, "m_j1": m_j1, "m_j2": m_j2}


def overall_loss(embs: dict[str, torch.Tensor], batch: dict,
                 loss_params: dict[str, torch.Tensor], modules: Sequence[str],
                 zoom: float = 0.1) -> dict[str, torch.Tensor]:
    """Upstream OverallLoss.forward: ``loss``, ``icl_loss_unimodal``,
    ``icl_loss_multimodal`` and ``ial_loss``."""
    ix = flat_loss_indices(batch)
    idx = (ix["e1i"], ix["e2i"], ix["e1j"], ix["e2j"],
           ix["m_i"], ix["m_j1"], ix["m_j2"])
    multi = len(modules) > 1
    icl_each = torch.stack([icl_loss(embs[m], *idx) for m in modules])
    if not multi:
        zero = torch.zeros((), dtype=torch.float32, device=icl_each.device)
        return {"loss": icl_each[0], "icl_loss_unimodal": icl_each[0],
                "icl_loss_multimodal": zero, "ial_loss": zero}
    ial_each = torch.stack([ial_loss(embs[m], embs["joint"], *idx)
                            for m in modules])
    total_align = kendall_combine(ial_each, loss_params["ial_log_vars"]) * zoom
    icl_unimodal = kendall_combine(icl_each, loss_params["icl_log_vars"])
    icl_multimodal = icl_loss(embs["joint"], *idx)
    return {"loss": total_align + icl_unimodal + icl_multimodal,
            "icl_loss_unimodal": icl_unimodal,
            "icl_loss_multimodal": icl_multimodal,
            "ial_loss": total_align}


class OverallLoss(nn.Module):
    """The objective with its trainable Kendall log-variances (one per
    module for IAL and for ICL, zero at the start)."""

    def __init__(self, modules: Sequence[str], zoom: float = 0.1):
        super().__init__()
        self.modal_names = tuple(modules)
        self.zoom = zoom
        for name, value in init_loss_params(len(self.modal_names)).items():
            setattr(self, name, nn.Parameter(value))

    def forward(self, embs: dict[str, torch.Tensor], batch: dict
                ) -> dict[str, torch.Tensor]:
        params = {"ial_log_vars": self.ial_log_vars,
                  "icl_log_vars": self.icl_log_vars}
        return overall_loss(embs, batch, params, self.modal_names, self.zoom)


def overall_nca_loss(embs: dict[str, torch.Tensor], batch: dict,
                     alpha: float = 1.0, beta: float = 1.0, ep: float = 0.0
                     ) -> dict[str, torch.Tensor]:
    """Upstream OverallNCALoss.forward: one NCA term per output head, and
    their sum ``loss``."""
    ix = flat_loss_indices(batch)
    mask = ix["m_i"]
    out: dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=mask.device)
    for key, emb in embs.items():
        e = l2_normalize(emb, dim=-1)
        m = mask[:, None].to(e.dtype)
        out[key] = nca_loss(e[ix["e1i"]] * m, e[ix["e2i"]] * m, mask,
                            alpha=alpha, beta=beta, ep=ep)
        total = total + out[key]
    out["loss"] = total
    return out


class OverallNCALoss(nn.Module):
    """EVA's objective, in the call form of ``OverallLoss``."""

    def __init__(self, modules: Sequence[str]):
        super().__init__()
        self.modal_names = tuple(modules)

    def forward(self, embs: dict[str, torch.Tensor], batch: dict
                ) -> dict[str, torch.Tensor]:
        return overall_nca_loss(embs, batch)
