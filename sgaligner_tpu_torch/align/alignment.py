"""Host-side alignment helpers over per-pair slot similarity matrices.

A copy of ``sgaligner_tpu/align/alignment.py`` (numpy ports of upstream
utils/alignment.py used by the inference scripts). All functions operate on
the padded slot layout: a pair's similarity matrix is [2N, 2N] with the src
graph in slots [0, N) and ref in [N, 2N); invalid entries hold +inf-like
sentinels (ops.metrics.BIG).
"""

from __future__ import annotations

import numpy as np

BIG = 1e30


def compute_node_corrs(sim: np.ndarray, n_src: int, max_objects: int,
                       k: int = 1) -> list[tuple[int, int]]:
    """Top-k cross-graph matches per src object (alignment.py:59-70).

    Returns (src_slot, ref_slot) pairs where ref_slot >= max_objects.
    """
    node_corrs = []
    for idx in range(n_src):
        order = np.argsort(sim[idx], kind="stable")[:k]
        for cand in order:
            if cand < max_objects or sim[idx, cand] >= BIG / 2:
                continue
            node_corrs.append((idx, int(cand)))
    return node_corrs


def get_node_corrs_objects_ids(node_corrs, obj_ids: np.ndarray
                               ) -> list[tuple[int, int]]:
    """Slot pairs -> 3RScan object-id pairs (alignment.py:72-77); obj_ids is the
    pair's [2N] slot->id array."""
    return [(int(obj_ids[a]), int(obj_ids[b])) for a, b in node_corrs]


def compute_alignment_score(sim: np.ndarray, n_src: int, n_ref: int,
                            max_objects: int) -> float:
    """Fraction of src objects whose top-1 match is on the ref side, normalized
    by n_ref (alignment.py:79-89 — can exceed 1, quirk preserved)."""
    aligned = 0
    for idx in range(n_src):
        top = int(np.argmin(sim[idx]))
        if top >= max_objects:
            aligned += 1
    return aligned / max(n_ref, 1)


def precision_recall_f1(true: list[float], pred: list[float]) -> dict[str, float]:
    """Binary P/R/F1 (replaces sklearn confusion_matrix in
    inference_find_overlapper.py:75-82)."""
    t = np.asarray(true, bool)
    p = np.asarray(pred, bool)
    tp = float((t & p).sum())
    fp = float((~t & p).sum())
    fn = float((t & ~p).sum())
    precision = round(tp / max(tp + fp, 1e-12), 4)
    recall = round(tp / max(tp + fn, 1e-12), 4)
    f1 = round(2 * precision * recall / max(precision + recall, 1e-12), 4)
    return {"precision": precision, "recall": recall, "f1_score": f1}
