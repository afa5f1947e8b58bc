"""Synthetic scene-graph pair fixtures.

A copy of ``sgaligner_tpu/data/synthetic.py`` (the same seed gives the same
arrays), so the port can build batches without the JAX package.

Random scene-graph pairs with the statistical shape of upstream SGAligner's
preprocessed 3RScan pairs:

* per-object point clouds sampled around object centroids,
* a dense 'none'-completed directed edge set,
* per-object relationship / attribute bag-of-words vectors,
* relative translations to a root object,
* anchor object ids shared between the two subscans of a pair.

Anchored objects share geometry + BoW signature between src and ref (with
noise), so the alignment is learnable.
"""

from __future__ import annotations

import numpy as np

from sgaligner_tpu_torch.data.batch import BatchSpec, collate, pack_pair


def _dense_edges(n: int, rng: np.random.Generator, keep: float = 1.0) -> np.ndarray:
    """All ordered pairs (i, j), i != j — the post-'none'-completion edge set."""
    s, o = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    mask = s != o
    edges = np.stack([s[mask], o[mask]], axis=1)
    if keep < 1.0:
        sel = rng.random(len(edges)) < keep
        edges = edges[sel]
    return edges.astype(np.int64)


def make_synthetic_pair(
    spec: BatchSpec,
    rng: np.random.Generator,
    n_src: int | None = None,
    n_ref: int | None = None,
    n_anchor: int | None = None,
    noise: float = 0.02,
    anchor_fraction_kept: float = 1.0,
    bow_noise: float = 0.0,
    resample: bool = False,
) -> dict[str, np.ndarray]:
    """``resample=True`` makes anchors share only their SHAPE (a per-object
    covariance) while src/ref draw independent point samples — like the same
    3RScan object carved by two different camera sweeps. Matching then has to
    be learned from shape statistics instead of exact point identity."""
    """Generate one padded pair sample with planted anchor correspondences."""
    n_max, p = spec.max_objects, spec.points_per_object
    if n_src is None:
        n_src = int(rng.integers(6, min(20, n_max) + 1))
    if n_ref is None:
        n_ref = int(rng.integers(6, min(20, n_max) + 1))
    max_anchor = min(n_src, n_ref)
    if n_anchor is None:
        n_anchor = int(rng.integers(2, max_anchor + 1))
    n_anchor = min(n_anchor, max_anchor)

    # Shared "scene objects": anchors exist in both graphs with the same local
    # geometry and BoW signature; the rest are independent.
    def sample_shape(cov):
        return (rng.normal(size=(p, 3)) @ cov).astype(np.float32)

    def make_objects(n, shared_pts, shared_rel, shared_attr, shared_centers,
                     shared_covs=None):
        k = len(shared_rel)
        anchor_centers = shared_centers
        if shared_covs is not None:
            # per-side barycenter jitter: real subscans compute rel_trans from
            # different point subsets (preprocess.py:93-96,169-174)
            anchor_centers = shared_centers + rng.normal(
                0, 0.2, shared_centers.shape)
        centers = np.concatenate(
            [anchor_centers, rng.uniform(-3, 3, size=(n - k, 3))], axis=0
        ).astype(np.float32)
        local = rng.normal(0, 0.3, size=(n - k, p, 3)).astype(np.float32)
        if shared_covs is not None:  # resample mode: fresh draws per side
            anchor_pts = np.stack([sample_shape(c) for c in shared_covs])
        else:
            anchor_pts = shared_pts
        pts_local = np.concatenate([anchor_pts, local], axis=0)
        pts = pts_local + centers[:, None, :] + rng.normal(0, noise, size=(n, p, 3))
        bow_rel = np.concatenate(
            [shared_rel, rng.integers(0, 3, size=(n - k, spec.rel_dim))], axis=0
        ).astype(np.float32)
        bow_attr = np.concatenate(
            [shared_attr, (rng.random((n - k, spec.attr_dim)) < 0.03).astype(np.float64)],
            axis=0,
        ).astype(np.float32)
        if bow_noise > 0:
            # corrupt the anchors' BoW signatures so exact-match shortcuts
            # disappear and the model must learn from geometry/structure
            bow_rel[:k] += rng.integers(
                0, 2, size=(k, spec.rel_dim)) * (rng.random((k, 1)) < bow_noise)
            flips = rng.random((k, spec.attr_dim)) < bow_noise * 0.2
            bow_attr[:k] = np.where(flips, 1 - bow_attr[:k], bow_attr[:k])
        return pts.astype(np.float32), centers, bow_rel, bow_attr

    shared_pts = rng.normal(0, 0.3, size=(n_anchor, p, 3)).astype(np.float32)
    shared_rel = rng.integers(0, 3, size=(n_anchor, spec.rel_dim)).astype(np.float32)
    shared_attr = (rng.random((n_anchor, spec.attr_dim)) < 0.03).astype(np.float32)
    shared_centers = rng.uniform(-3, 3, size=(n_anchor, 3)).astype(np.float32)
    shared_covs = None
    if resample:
        # distinctive anisotropic shapes: random scale per axis + rotation-ish mix
        shared_covs = [np.diag(rng.uniform(0.05, 0.6, size=3))
                       @ (np.eye(3) + 0.3 * rng.normal(size=(3, 3)))
                       for _ in range(n_anchor)]

    src_pts, src_centers, src_rel, src_attr = make_objects(
        n_src, shared_pts, shared_rel, shared_attr, shared_centers,
        shared_covs=shared_covs,
    )
    ref_pts, ref_centers, ref_rel, ref_attr = make_objects(
        n_ref, shared_pts, shared_rel, shared_attr, shared_centers,
        shared_covs=shared_covs,
    )

    # Relative translation to root object (max out-degree; dense edges make the
    # choice arbitrary, so use object 0) — preprocess.py:164-174.
    src_rel_pose = (src_centers[0] - src_centers).astype(np.float32)
    ref_rel_pose = (ref_centers[0] - ref_centers).astype(np.float32)

    src_edges = _dense_edges(n_src, rng)
    ref_edges = _dense_edges(n_ref, rng)

    # Anchors: shared objects sit at local indices [0, n_anchor) on both sides.
    all_anchor = np.arange(n_anchor)
    n_keep = max(2, int(anchor_fraction_kept * n_anchor))
    e1i = all_anchor[:n_keep]
    e2i = all_anchor[:n_keep]
    e1j = np.setdiff1d(np.arange(n_src), e1i)
    e2j = np.setdiff1d(np.arange(n_ref), e2i)

    # 3RScan-style object ids (nonzero).
    src_ids = np.arange(1, n_src + 1, dtype=np.int32)
    ref_ids = np.concatenate(
        [np.arange(1, n_anchor + 1), np.arange(100, 100 + n_ref - n_anchor)]
    ).astype(np.int32)

    return pack_pair(
        spec,
        src_points=src_pts,
        ref_points=ref_pts,
        src_bow_rel=src_rel,
        ref_bow_rel=ref_rel,
        src_bow_attr=src_attr,
        ref_bow_attr=ref_attr,
        src_rel_pose=src_rel_pose,
        ref_rel_pose=ref_rel_pose,
        src_edges=src_edges,
        ref_edges=ref_edges,
        e1i=e1i,
        e2i=e2i,
        e1j=e1j,
        e2j=e2j,
        src_obj_ids=src_ids,
        ref_obj_ids=ref_ids,
        src_global_ids=src_ids % 40,
        ref_global_ids=ref_ids % 40,
        overlap=float(rng.uniform(0.1, 0.9)),
    )


def make_synthetic_batch(
    spec: BatchSpec, seed: int = 0, **kwargs
) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return collate(
        [make_synthetic_pair(spec, rng, **kwargs) for _ in range(spec.batch_size)]
    )
