"""Serving steps: forward -> joint cosine-distance matrices -> anchor ranks ->
MRR / Hits@K components and ``alignment_score``.

Counterpart of ``sgaligner_tpu/engine/train_step.py::_serving_metrics``,
``make_serving_step`` and ``make_serving_queue``. The JAX step takes
``(params, batch_stats, batch)``; here the model holds its weights and the
step takes the batch (a dict of tensors on the model's device, see
``data.batch.to_device``). Training steps come with a later slice.
"""

from __future__ import annotations

import torch

from sgaligner_tpu_torch.ops import metrics as M


def serving_metrics(model, modules: tuple[str, ...], ks: tuple[int, ...],
                    batch: dict) -> dict:
    """One batch: the metric components the host accumulates."""
    embs = model(batch)
    key = "joint" if len(modules) > 1 else modules[0]
    b, two_n = batch["obj_mask"].shape
    emb = embs[key].reshape(b, two_n, -1)
    sim = M.cosine_sim_matrix(emb, batch["obj_mask"])
    ranks, mask = M.anchor_ranks(sim, batch["e1i"], batch["e2i"],
                                 batch["anchor_mask"])
    rr_sum, rr_count = M.mrr_from_ranks(ranks, mask)
    out = {
        "rr_sum": rr_sum,
        "rr_count": rr_count,
        "alignment_score": M.alignment_score(sim, batch["n_src"],
                                             batch["n_ref"], two_n // 2),
    }
    for k, (correct, total) in M.hits_at_k_from_ranks(ranks, mask, ks).items():
        out[f"hits@{k}"] = (correct, total)
    return out


def make_serving_step(model, modules: tuple[str, ...],
                      ks: tuple[int, ...] = (1, 2, 3, 4, 5)):
    """Returns ``step(batch) -> metric components`` (inference mode)."""

    @torch.inference_mode()
    def step(batch: dict) -> dict:
        return serving_metrics(model, modules, ks, batch)

    return step


def serve_queue(model, modules: tuple[str, ...], batches: list[dict],
                ks: tuple[int, ...] = (1, 2, 3, 4, 5)) -> dict:
    """A queue of batches, one step each: scalar components summed over the
    queue, ``alignment_score`` stacked to ``[Q, B]`` (the outputs of
    ``make_serving_queue``)."""
    step = make_serving_step(model, modules, ks)
    outs = [step(b) for b in batches]
    summed = {}
    for k in outs[0]:
        if k == "alignment_score":
            summed[k] = torch.stack([o[k] for o in outs])
        elif isinstance(outs[0][k], tuple):
            summed[k] = tuple(sum(o[k][i] for o in outs) for i in range(2))
        else:
            summed[k] = sum(o[k] for o in outs)
    return summed
