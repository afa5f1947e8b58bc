"""Alignment metrics on padded pair batches.

Counterpart of ``sgaligner_tpu/ops/metrics.py`` (the serving and eval
subset: similarities, ranks, MRR / Hits@K, SGAR, alignment score). Ranks
follow numpy's stable argsort with the self column removed: the rank of
candidate t in row r is 1 + #{k valid, k != r: sim[r,k] < sim[r,t]} +
#{k valid, k != r: sim[r,k] == sim[r,t] and k < t}.
"""

from __future__ import annotations

import torch

from sgaligner_tpu_torch.ops.losses import l2_normalize

BIG = 1e30


def cosine_sim_matrix(emb: torch.Tensor, obj_mask: torch.Tensor) -> torch.Tensor:
    """Per-pair cosine distance 1 - ê·êᵀ; invalid rows/cols and the diagonal
    are +BIG. emb [B, S, D]; obj_mask [B, S] bool -> [B, S, S]."""
    e = l2_normalize(emb, dim=-1)
    sim = 1.0 - torch.einsum("bsd,btd->bst", e, e)
    valid2 = obj_mask[:, :, None] & obj_mask[:, None, :]
    eye = torch.eye(sim.shape[1], dtype=torch.bool, device=sim.device)[None]
    return torch.where(valid2 & ~eye, sim, torch.full_like(sim, BIG))


def anchor_ranks(sim, e1i, e2i, anchor_mask):
    """1-based rank of each anchor's true match: (ranks [B, A], mask)."""
    b, s, _ = sim.shape
    rows = torch.gather(sim, 1, e1i.long()[:, :, None].expand(-1, -1, s))  # [B, A, S]
    tvals = torch.gather(rows, 2, e2i.long()[:, :, None])                  # [B, A, 1]
    col = torch.arange(s, device=sim.device)[None, None, :]
    is_cand = rows < BIG / 2
    less = (rows < tvals) & is_cand
    tie_before = (rows == tvals) & (col < e2i.long()[:, :, None]) & is_cand
    ranks = 1 + less.sum(-1) + tie_before.sum(-1)
    return ranks, anchor_mask


def mrr_from_ranks(ranks, mask):
    """(sum of reciprocal ranks, count); scores are float64 throughout."""
    rr = torch.where(mask, 1.0 / ranks.to(torch.float64), 0.0)
    return rr.sum(), mask.sum()


def hits_at_k_from_ranks(ranks, mask, ks=(1, 2, 3, 4, 5)):
    """Per-k (correct, total) counts."""
    total = mask.sum()
    return {k: (((ranks <= k) & mask).sum(), total) for k in ks}


def alignment_score(sim, n_src, n_ref, max_objects: int):
    """Fraction of src objects whose top-1 match lands on the ref side,
    normalised by n_ref. [B] float."""
    src_rows = sim[:, :max_objects, :]
    pred = torch.argmin(src_rows, dim=-1)                         # first min
    row_valid = (torch.arange(max_objects, device=sim.device)[None, :]
                 < n_src[:, None])
    aligned = (pred >= max_objects) & row_valid
    return (aligned.sum(-1).to(torch.float64)
            / torch.clamp(n_ref, min=1).to(torch.float64))


def top1_predictions(sim, e1i):
    """Top-1 candidate and its similarity per anchor row (argmin ties go to
    the lowest index)."""
    s = sim.shape[-1]
    rows = torch.gather(sim, 1, e1i.long()[:, :, None].expand(-1, -1, s))  # [B, A, S]
    pred_sim, _ = rows.min(dim=-1)
    return torch.argmin(rows, dim=-1), pred_sim


def sgar(sim, e1i, e2i, anchor_mask) -> dict[str, torch.Tensor]:
    """Scene-graph alignment recall, upstream's compute_sgar: per pair, sort
    the anchors by their top-1 similarity (ascending, stable), then mode '2'
    asks the first two to be matched correctly, '50' the first half, '100'
    all of them. Returns {mode: [B] float32}; a pair with no anchors scores
    1.0 (callers mask it out with ``pair_valid``)."""
    pred, pred_sim = top1_predictions(sim, e1i)
    correct = (pred == e2i.long()) | ~anchor_mask
    key = torch.where(anchor_mask, pred_sim, torch.full_like(pred_sim, BIG))
    order = torch.argsort(key, dim=-1, stable=True)
    correct_sorted = torch.gather(correct, 1, order)
    prefix_ok = torch.cumprod(correct_sorted.to(torch.int32), dim=-1)
    n_valid = anchor_mask.sum(-1)
    a = anchor_mask.shape[1]

    def all_first(m):
        idx = torch.clamp(m - 1, 0, a - 1)
        val = torch.gather(prefix_ok, 1, idx[:, None])[:, 0]
        return torch.where(m > 0, val, torch.ones_like(val)).to(torch.float32)

    return {"2": all_first(torch.clamp(n_valid, max=2)),
            "50": all_first(n_valid // 2),
            "100": all_first(n_valid)}
