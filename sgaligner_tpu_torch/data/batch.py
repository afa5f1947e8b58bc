"""PairBatch — the static-shape data contract for scene-graph pairs.

A copy of the numpy contract in ``sgaligner_tpu/data/batch.py`` (``BatchSpec``,
``pack_pair``, ``collate``, ``pad_batch_to``, ``pool_compact``,
``pool_compact_sharded``, ``stack_queue``), so the port builds the same
batches without importing the JAX package, plus ``to_device``.

Each pair owns ``2N`` object slots: ``[0, N)`` the source graph, ``[N, 2N)``
the reference graph. Points ship channel-first ``[.., 3, P]``; graph
structure is a dense adjacency ``adj[g, i, j]`` = edge j -> i; anchor index
arrays are padded with masks and local to the pair's 2N slots.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch


@dataclass(frozen=True)
class BatchSpec:
    """Static shape parameters of a PairBatch."""

    batch_size: int           # B — pairs per batch
    max_objects: int          # N — object slots per graph
    points_per_object: int    # P
    rel_dim: int = 41
    attr_dim: int = 164
    # > 0: points ship as obj_points_compact [compact_slots, 3, P] holding
    # only real objects + a compact_idx slot map
    compact_slots: int = 0

    @property
    def slots_per_pair(self) -> int:
        return 2 * self.max_objects

    @property
    def total_slots(self) -> int:
        return self.batch_size * self.slots_per_pair


PairBatch = dict[str, Any]


def empty_pair_sample(spec: BatchSpec) -> dict[str, np.ndarray]:
    """An all-padding single-pair sample (no leading batch dim)."""
    n, p = spec.max_objects, spec.points_per_object
    if spec.compact_slots > 0:
        points_fields = {
            "obj_points_compact": np.zeros((spec.compact_slots, 3, p),
                                           np.float32),
            "compact_idx": np.zeros((spec.compact_slots,), np.int32),
            "compact_mask": np.zeros((spec.compact_slots,), bool),
        }
    else:
        points_fields = {"obj_points": np.zeros((2 * n, 3, p), np.float32)}
    return {
        **points_fields,
        "obj_mask": np.zeros((2 * n,), bool),
        "bow_rel": np.zeros((2 * n, spec.rel_dim), np.float32),
        "bow_attr": np.zeros((2 * n, spec.attr_dim), np.float32),
        "rel_pose": np.zeros((2 * n, 3), np.float32),
        "adj": np.zeros((2, n, n), bool),
        "e1i": np.zeros((n,), np.int32),
        "e2i": np.zeros((n,), np.int32),
        "anchor_mask": np.zeros((n,), bool),
        "e1j": np.zeros((n,), np.int32),
        "e1j_mask": np.zeros((n,), bool),
        "e2j": np.zeros((n,), np.int32),
        "e2j_mask": np.zeros((n,), bool),
        "obj_ids": np.zeros((2 * n,), np.int32),
        "global_obj_ids": np.zeros((2 * n,), np.int32),
        "n_src": np.int32(0),
        "n_ref": np.int32(0),
        "overlap": np.float32(-1.0),
    }


def pack_pair(
    spec: BatchSpec,
    *,
    src_points: np.ndarray,      # [n_src, P, 3]
    ref_points: np.ndarray,      # [n_ref, P, 3]
    src_bow_rel: np.ndarray,     # [n_src, rel_dim]
    ref_bow_rel: np.ndarray,
    src_bow_attr: np.ndarray,    # [n_src, attr_dim]
    ref_bow_attr: np.ndarray,
    src_rel_pose: np.ndarray,    # [n_src, 3]
    ref_rel_pose: np.ndarray,
    src_edges: np.ndarray,       # [e_src, 2] local (s_idx, o_idx) pairs
    ref_edges: np.ndarray,
    e1i: np.ndarray,             # [a] anchor indices into src objects
    e2i: np.ndarray,             # [a] anchor indices into ref objects (local)
    e1j: np.ndarray,             # non-anchor src indices
    e2j: np.ndarray,             # non-anchor ref indices (local)
    src_obj_ids: np.ndarray | None = None,
    ref_obj_ids: np.ndarray | None = None,
    src_global_ids: np.ndarray | None = None,
    ref_global_ids: np.ndarray | None = None,
    overlap: float = -1.0,
) -> dict[str, np.ndarray]:
    """Pack one ragged scene-graph pair into the padded slot layout (the ref
    graph's indices are shifted to slot offset N)."""
    n = spec.max_objects
    n_src, n_ref = len(src_points), len(ref_points)
    if n_src > n or n_ref > n:
        raise ValueError(
            f"graph exceeds max_objects={n}: n_src={n_src}, n_ref={n_ref}; "
            f"raise cfg.tpu.max_objects"
        )
    a = len(e1i)
    if a > n:
        raise ValueError(f"too many anchors ({a} > {n})")

    out = empty_pair_sample(spec)
    src_points_cf = np.transpose(np.asarray(src_points), (0, 2, 1))
    ref_points_cf = np.transpose(np.asarray(ref_points), (0, 2, 1))
    if spec.compact_slots > 0:
        kc = spec.compact_slots
        if n_src + n_ref > kc:
            raise ValueError(
                f"pair has {n_src + n_ref} real objects > compact_slots={kc}")
        out["obj_points_compact"][:n_src] = src_points_cf
        out["obj_points_compact"][n_src : n_src + n_ref] = ref_points_cf
        out["compact_idx"][:n_src] = np.arange(n_src)
        out["compact_idx"][n_src : n_src + n_ref] = n + np.arange(n_ref)
        out["compact_mask"][: n_src + n_ref] = True
    else:
        out["obj_points"][:n_src] = src_points_cf
        out["obj_points"][n : n + n_ref] = ref_points_cf
    out["obj_mask"][:n_src] = True
    out["obj_mask"][n : n + n_ref] = True
    out["bow_rel"][:n_src] = src_bow_rel
    out["bow_rel"][n : n + n_ref] = ref_bow_rel
    out["bow_attr"][:n_src] = src_bow_attr
    out["bow_attr"][n : n + n_ref] = ref_bow_attr
    out["rel_pose"][:n_src] = src_rel_pose
    out["rel_pose"][n : n + n_ref] = ref_rel_pose

    # dense adjacency adj[g, tgt, src_node]: edges[:, 0] subject -> [:, 1] object
    for g, edges in ((0, src_edges), (1, ref_edges)):
        if len(edges):
            e = np.asarray(edges, np.int64)
            out["adj"][g, e[:, 1], e[:, 0]] = True

    out["e1i"][:a] = e1i
    out["e2i"][:a] = np.asarray(e2i) + n
    out["anchor_mask"][:a] = True
    j1 = len(e1j)
    out["e1j"][:j1] = e1j
    out["e1j_mask"][:j1] = True
    j2 = len(e2j)
    out["e2j"][:j2] = np.asarray(e2j) + n
    out["e2j_mask"][:j2] = True

    if src_obj_ids is not None:
        out["obj_ids"][:n_src] = src_obj_ids
    if ref_obj_ids is not None:
        out["obj_ids"][n : n + n_ref] = ref_obj_ids
    if src_global_ids is not None:
        out["global_obj_ids"][:n_src] = src_global_ids
    if ref_global_ids is not None:
        out["global_obj_ids"][n : n + n_ref] = ref_global_ids

    out["n_src"] = np.int32(n_src)
    out["n_ref"] = np.int32(n_ref)
    out["overlap"] = np.float32(overlap)
    return out


def collate(samples: list[dict[str, np.ndarray]]) -> PairBatch:
    """Stack padded single-pair samples into a batch."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def pad_batch_to(batch: PairBatch, target_b: int) -> PairBatch:
    """Pad the pair axis with empty pairs (overlap -1, every mask off) up to
    ``target_b`` pairs, so it splits evenly over the ranks."""
    b = batch["overlap"].shape[0]
    if b == target_b:
        return batch
    if b > target_b:
        raise ValueError(f"batch {b} > target {target_b}")
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        pad = np.zeros((target_b - b,) + v.shape[1:], v.dtype)
        if k == "overlap":
            pad -= 1.0
        out[k] = np.concatenate([v, pad], axis=0)
    return out


def pool_compact(batch: PairBatch, bucket: int = 128) -> PairBatch:
    """Batch-pooled object compaction: every real object of the batch packed
    into one flat ``obj_points_pooled [K, 3, P]``, K = real objects rounded up
    to a multiple of ``bucket`` (capped at B·2N), with ``pooled_flat_idx [K]``
    (flat slot ``b * 2N + slot``) and ``pooled_mask [K]``."""
    two_n = batch["obj_mask"].shape[1]
    b = batch["obj_mask"].shape[0]
    if "obj_points_pooled" in batch:
        return batch
    if "obj_points_compact" in batch:
        cmask = np.asarray(batch["compact_mask"])
        flat = (np.arange(b)[:, None] * two_n
                + np.asarray(batch["compact_idx"]))[cmask]
        pooled = np.asarray(batch["obj_points_compact"])[cmask]
        drop = ("obj_points_compact", "compact_idx", "compact_mask")
    else:
        m = np.asarray(batch["obj_mask"])
        flat = (np.arange(b)[:, None] * two_n
                + np.arange(two_n)[None, :])[m]
        pooled = np.asarray(batch["obj_points"])[m]
        drop = ("obj_points",)

    r = len(flat)
    cap = b * two_n
    k = min(cap, max(bucket, -(-r // bucket) * bucket))
    out = {kk: v for kk, v in batch.items() if kk not in drop}
    pts = np.zeros((k,) + pooled.shape[1:], pooled.dtype)
    pts[:r] = pooled
    idx = np.zeros((k,), np.int32)
    idx[:r] = flat
    mask = np.zeros((k,), bool)
    mask[:r] = True
    out["obj_points_pooled"] = pts
    out["pooled_flat_idx"] = idx
    out["pooled_mask"] = mask
    return out


def pool_compact_sharded(batch: PairBatch, bucket: int = 128,
                         dp: int = 1) -> PairBatch:
    """Per-shard pooled compaction for ``dp`` ranks: each contiguous block
    of ``B/dp`` pairs (the batch padded with empty pairs to a multiple of
    ``dp`` first) is pooled alone, every block to one common K, and the
    blocks are concatenated, so rows ``[i·K, (i+1)·K)`` hold only objects of
    block i's pairs. ``pooled_flat_idx`` stays global (``b * 2N + slot``);
    ``parallel.mesh.shard_batch`` makes a rank's rows local. ``dp = 1`` is
    ``pool_compact``."""
    if dp <= 1:
        return pool_compact(batch, bucket)
    b = batch["obj_mask"].shape[0]
    if b % dp != 0:
        batch = pad_batch_to(batch, ((b + dp - 1) // dp) * dp)
        b = batch["obj_mask"].shape[0]
    two_n = batch["obj_mask"].shape[1]
    bs = b // dp
    shards = [pool_compact({k: v[i * bs:(i + 1) * bs]
                            for k, v in batch.items()}, bucket)
              for i in range(dp)]
    k = max(s["obj_points_pooled"].shape[0] for s in shards)

    def repad(s, i):
        kk = s["obj_points_pooled"].shape[0]
        pts = np.zeros((k,) + s["obj_points_pooled"].shape[1:],
                       s["obj_points_pooled"].dtype)
        pts[:kk] = s["obj_points_pooled"]
        idx = np.zeros((k,), np.int32)
        idx[:kk] = s["pooled_flat_idx"] + i * bs * two_n  # block -> global
        mask = np.zeros((k,), bool)
        mask[:kk] = s["pooled_mask"]
        return pts, idx, mask

    parts = [repad(s, i) for i, s in enumerate(shards)]
    out = {kk: np.concatenate([s[kk] for s in shards])
           for kk in shards[0] if kk not in POOLED_KEYS}
    for j, key in enumerate(POOLED_KEYS):
        out[key] = np.concatenate([p[j] for p in parts])
    return out


POOLED_KEYS = ("obj_points_pooled", "pooled_flat_idx", "pooled_mask")


def stack_queue(batches: list[dict], dp: int = 1) -> dict:
    """Stack batches of one B into a ``[Q, ...]`` serving queue. The pooled
    axis K may differ per batch (bucket quantisation); each is padded to the
    queue's largest with masked rows. With ``dp > 1`` (batches from
    ``pool_compact_sharded``) the padding goes at the end of each rank's
    block of rows, so every block keeps referencing its own pairs."""
    out = {k: np.stack([np.asarray(b[k]) for b in batches])
           for k in batches[0] if k not in POOLED_KEYS}
    if "obj_points_pooled" not in batches[0]:
        return out
    ks = [b["obj_points_pooled"].shape[0] for b in batches]
    for k in ks:
        if k % dp != 0:
            raise ValueError(
                f"pooled axis {k} not divisible by dp={dp}: build batches "
                "with pool_compact_sharded(dp=dp)")
    kmax = max(k // dp for k in ks)

    def pad_blocks(b):
        k = b["obj_points_pooled"].shape[0] // dp
        res = {}
        for key in POOLED_KEYS:
            v = np.asarray(b[key]).reshape((dp, k) + b[key].shape[1:])
            pad = np.zeros((dp, kmax - k) + v.shape[2:], v.dtype)
            res[key] = np.concatenate([v, pad], axis=1).reshape(
                (dp * kmax,) + v.shape[2:])
        return res

    padded = [pad_blocks(b) for b in batches]
    for key in POOLED_KEYS:
        out[key] = np.stack([p[key] for p in padded])
    return out


def to_device(batch: PairBatch, device: str | torch.device = "cuda"
              ) -> dict[str, torch.Tensor]:
    """numpy PairBatch -> tensors on ``device``: bool stays bool, integers
    become int64 (index tensors), floats keep their dtype. Asking for a CUDA
    device without one raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("to_device: CUDA requested but no CUDA device")
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if np.issubdtype(a.dtype, np.integer):
            t = t.to(torch.int64)
        out[k] = t.to(device, non_blocking=True)
    return out
