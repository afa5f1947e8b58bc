"""Masked contrastive losses (ICL / IAL) and Kendall uncertainty weighting.

Counterpart of ``sgaligner_tpu/ops/losses.py`` (``l2_normalize``,
``masked_prob_dist``, ``_gather``, ``icl_loss``, ``ial_loss``,
``kendall_combine``, and EVA's ``nca_loss``) over padded anchor / negative index sets: every index
array has a static length and a boolean mask, and every sum is a masked sum.
The upstream quirks the JAX package keeps are kept here:

* ICL's temperature is 0.1, IAL's 1.0 with zoom 0.1;
* the eps placement of upstream ``calculate_prob_dist``;
* IAL is called as ``align_loss(modal_emb, joint_emb)``;
* negatives pool across all pairs of the batch (scalar sums);
* IAL's KLDiv is built with ``log_target=True`` but given the probability
  ``qo`` as target: ``Σ exp(qo) · (qo - log qm)``.
"""

from __future__ import annotations

import torch

EPS = 1e-9


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """torch.nn.functional.normalize semantics, x / max(||x||, 1e-12), written
    as x * rsqrt(max(||x||², 1e-24)) like the JAX package (NaN-free gradient
    at exact-zero padded rows)."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=1e-24))


def _outer(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return a.to(dtype)[:, None] * b.to(dtype)[None, :]


def masked_prob_dist(e1i, e2i, e1j, e2j, m_i, m_j1, m_j2, temp: float):
    """Anchors e1i / e2i [A, D], negatives e1j [J1, D], e2j [J2, D] and
    their masks -> q [A, A]. Entries outside ``outer(m_i, m_i)`` are garbage
    the caller masks out; the negative sums are exact masked sums."""
    dt = e1i.dtype
    d_ii = torch.exp(e1i @ e2i.t() / temp)                           # [A, A]
    d_1j = torch.exp(e1i @ e1j.t() / temp) * _outer(m_i, m_j1, dt)   # [A, J1]
    d_2j = torch.exp(e1i @ e2j.t() / temp) * _outer(m_i, m_j2, dt)   # [A, J2]
    d_ii_1j = d_ii / (d_1j.sum() + EPS)
    d_ii_2j = d_ii / (d_2j.sum() + EPS)
    q_inv = 1.0 + 1.0 / (d_ii_1j + EPS) + 1.0 / (d_ii_2j + EPS)
    return 1.0 / (q_inv + EPS)


def _gather(emb: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Rows of emb at idx, masked rows zeroed."""
    return emb[idx] * mask[:, None].to(emb.dtype)


def icl_loss(emb, e1i, e2i, e1j, e2j, m_i, m_j1, m_j2, temp: float = 0.1,
             alpha: float = 0.5):
    """Intra-graph contrastive loss over flat object embeddings [O, D] and
    flat index / mask arrays."""
    emb = l2_normalize(emb, dim=1)
    v1i, v2i = _gather(emb, e1i, m_i), _gather(emb, e2i, m_i)
    v1j, v2j = _gather(emb, e1j, m_j1), _gather(emb, e2j, m_j2)
    q_12 = masked_prob_dist(v1i, v2i, v1j, v2j, m_i, m_j1, m_j2, temp)
    q_21 = masked_prob_dist(v2i, v1i, v2j, v1j, m_i, m_j2, m_j1, temp)
    mix = alpha * q_12 + (1.0 - alpha) * q_21
    valid = _outer(m_i, m_i, emb.dtype)
    safe = torch.where(valid > 0, mix, torch.ones_like(mix))
    return -(torch.log(safe) * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def ial_loss(emb_modal, emb_joint, e1i, e2i, e1j, e2j, m_i, m_j1, m_j2,
             temp: float = 1.0, alpha: float = 0.5, zoom: float = 0.1):
    """Inter-modal alignment loss: the modal distribution against the
    joint one, with upstream's KLDiv ``log_target`` quirk."""
    o = l2_normalize(emb_modal, dim=1)
    m = l2_normalize(emb_joint, dim=1)

    def dists(e):
        e1, e2 = _gather(e, e1i, m_i), _gather(e, e2i, m_i)
        n1, n2 = _gather(e, e1j, m_j1), _gather(e, e2j, m_j2)
        return (masked_prob_dist(e1, e2, n1, n2, m_i, m_j1, m_j2, temp),
                masked_prob_dist(e2, e1, n2, n1, m_i, m_j2, m_j1, temp))

    qo_12, qo_21 = dists(o)
    qm_12, qm_21 = dists(m)
    valid = m_i[:, None] & m_i[None, :]

    def kl(q_target, q_input):
        # torch.kl_div(input=log(qi), target=qt, log_target=True)
        #   = Σ exp(qt) · (qt - log qi)   [qt is a probability: the quirk]
        qt = torch.where(valid, q_target, torch.zeros_like(q_target))
        qi = torch.where(valid, q_input, torch.ones_like(q_input))
        return (torch.exp(qt) * (qt - torch.log(qi)) * valid).sum()

    return zoom * (alpha * kl(qo_12, qm_12) + (1.0 - alpha) * kl(qo_21, qm_21))


def kendall_combine(losses: torch.Tensor, log_vars: torch.Tensor) -> torch.Tensor:
    """Upstream CustomMultiLossLayer: Σᵢ exp(-sᵢ) Lᵢ + sᵢ."""
    return (torch.exp(-log_vars) * losses + log_vars).sum()


def nca_loss(src: torch.Tensor, ref: torch.Tensor, mask: torch.Tensor,
             alpha: float = 1.0, beta: float = 1.0, ep: float = 0.0
             ) -> torch.Tensor:
    """Upstream NCALoss over masked anchors: src / ref [A, D] gathered,
    normalised anchor embeddings, mask [A]."""
    mask_f = mask.to(src.dtype)
    valid2 = mask_f[:, None] * mask_f[None, :]                      # [A, A]
    scores = (src @ ref.t()) * valid2
    eye = torch.eye(scores.shape[0], dtype=scores.dtype, device=scores.device)
    s_diag = eye * scores
    s_off = torch.exp(alpha * (scores - ep)) * valid2
    s_off = s_off - s_off * eye
    n_valid = torch.clamp(mask_f.sum(), min=1.0)
    loss_diag = -torch.log1p(torch.relu(s_diag.sum(0)))             # [A]
    term_0 = (torch.log1p(s_off.sum(0)) / alpha * mask_f).sum() / n_valid
    term_1 = (torch.log1p(s_off.sum(1)) / alpha * mask_f).sum() / n_valid
    term_d = (beta * loss_diag * mask_f).sum() / n_valid
    return term_0 + term_1 + term_d
