"""Synthetic on-disk workspaces in upstream SGAligner's processed-data layout.

A copy of ``make_synthetic_workspace`` (with ``_blob`` and
``_make_subscan``) from ``sgaligner_tpu/data/fixtures.py``: the same seed
writes the same files, byte for byte in the arrays
(``tests/test_torch_eval.py``). The layout ``Scan3RDataset`` reads:

    <subscan_dir>/scans/<scan_id>/data.npy                 structured point cloud
    <subscan_dir>/files/<mode>/data/<scan_id>.pkl          preprocessed graph dict
    <subscan_dir>/files/<mode>/anchors_<split>.json        pair list with anchors
    <subscan_dir>/files/<mode>/<split>_scans_subscenes.txt

The raw-scene workspace functions of the JAX module are not copied yet.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from sgaligner_tpu_torch.utils.io import (
    ensure_dir,
    make_ply_npy,
    write_json,
    write_pkl_data,
)

REL_DIM = 41
ATTR_DIM = 164


def _blob(rng: np.random.Generator, n_pts: int) -> np.ndarray:
    """Anisotropic object geometry (~0.3 m): real objects have distinct
    principal axes — isotropic gaussian blobs would make any PCA-based
    coarse registration degenerate."""
    scale = np.array([0.45, 0.25, 0.12]) * (0.8 + 0.4 * rng.random(3))
    axes, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return rng.normal(size=(n_pts, 3)) * scale @ axes.T


def _make_subscan(rng: np.random.Generator, scan_id: str, object_ids: np.ndarray,
                  centers: np.ndarray, local_geoms: list[np.ndarray],
                  pc_resolutions: list[int],
                  shared_bow: tuple[np.ndarray, np.ndarray] | None = None
                  ) -> tuple[dict, np.ndarray]:
    """Build one subscan's pkl dict + structured point cloud.

    ``shared_bow`` (rel, attr) rows overwrite the leading objects' BoW
    features — anchors in real data are the SAME object in both subscans, so
    their graph-derived features coincide; matching relies on that."""
    n = len(object_ids)
    all_pts, all_oids = [], []
    obj_points = {res: [] for res in pc_resolutions}
    for i in range(n):
        pts = local_geoms[i] + centers[i]
        all_pts.append(pts)
        all_oids.append(np.full(len(pts), object_ids[i]))
        for res in pc_resolutions:
            sel = rng.choice(len(pts), res, replace=len(pts) < res)
            obj_points[res].append(pts[sel].astype(np.float32))
    for res in pc_resolutions:
        obj_points[res] = np.stack(obj_points[res])

    # dense 'none'-completed directed edge set in id space -> idx space
    object_id2idx = {int(v): i for i, v in enumerate(object_ids)}
    pairs, triples, edges_cat = [], [], []
    for a in object_ids:
        for b in object_ids:
            if a == b:
                continue
            rel = int(rng.integers(0, REL_DIM))
            pairs.append([int(a), int(b)])
            triples.append([int(a), int(b), rel])
            edges_cat.append(rel)
    edges = np.array([[object_id2idx[s], object_id2idx[o]] for s, o in pairs],
                     dtype=np.int64)

    root_idx = 0
    rel_trans = (centers[root_idx] - centers).astype(np.float64)

    bow_rel = rng.integers(0, 3, size=(n, REL_DIM)).astype(np.float64)
    bow_attr = (rng.random((n, ATTR_DIM)) < 0.05).astype(np.float64)
    if shared_bow is not None:
        k = len(shared_bow[0])
        bow_rel[:k] = shared_bow[0]
        bow_attr[:k] = shared_bow[1]

    pkl = {
        "scan_id": scan_id,
        "objects_id": object_ids.astype(np.int64),
        "global_objects_id": (object_ids % 40).astype(np.int64),
        "objects_cat": (object_ids % 40).astype(np.int64),
        "triples": triples,
        "pairs": pairs,
        "edges": edges,
        "obj_points": obj_points,
        "objects_count": n,
        "edges_count": len(edges),
        "object_id2idx": object_id2idx,
        "object_attributes": [[] for _ in range(n)],
        "edges_cat": edges_cat,
        "rel_trans": rel_trans,
        "root_obj_id": int(object_ids[root_idx]),
        "bow_vec_object_edge_feats": bow_rel,
        "bow_vec_object_attr_feats": bow_attr,
    }
    points = np.concatenate(all_pts)
    rec = make_ply_npy(points.astype(np.float32), np.concatenate(all_oids))
    return pkl, rec


def make_synthetic_workspace(
    root: str,
    split: str = "val",
    mode: str = "orig",
    n_pairs: int = 3,
    n_shared: int = 4,
    n_extra: int = 3,
    pts_per_obj: int = 80,
    pc_resolutions: list[int] | None = None,
    seed: int = 0,
    n_nonoverlap_pairs: int = 0,
    ref_transform: np.ndarray | None = None,
    view_noise: float = 0.0,
    bow_flip: float = 0.0,
    proto_classes: int = 0,
    center_noise: float = 0.0,
) -> dict:
    """Write a workspace of ``n_pairs`` overlapping subscan pairs; returns info.

    ``n_nonoverlap_pairs`` additionally emits pairs with zero shared objects and
    overlap 0.0 (the overlapper-eval fileset, reference
    gen_all_pairs_fileset.py:12-53). Also writes a scan->subscan map json
    (``scan_subscan_map_<split>.json``) treating each pair as two subscans of
    one scan, for mosaicking.

    ``ref_transform`` (4x4) expresses every REF subscan in a rigidly
    transformed frame (like 3RScan rescans vs their reference scan) and
    records it in the pair's anchors entry under ``"transform"`` — the
    registration path must then recover it instead of identity.

    ``view_noise`` / ``bow_flip`` make the matching problem NON-trivial (the
    aligner quality benchmark): each side observes an independently jittered
    copy of the shared objects' geometry (sensor noise between visits), and
    each anchor BoW entry is independently re-drawn with probability
    ``bow_flip`` per side (annotation variation) — with both at 0 the anchor
    features coincide bit-exactly and Hits@1 saturates. Leaving them at 0
    keeps the rng stream and thus every existing seeded workspace unchanged."""
    pc_resolutions = pc_resolutions or [64]
    rng = np.random.default_rng(seed)
    scans_dir = osp.join(root, "scans")
    files_dir = osp.join(root, "files", mode)
    ensure_dir(osp.join(files_dir, "data"))

    anchors, scan_ids = [], []
    scan_subscan_map: dict[str, list[str]] = {}
    for p in range(n_pairs + n_nonoverlap_pairs):
        overlapping = p < n_pairs
        shared_ids = np.arange(1, n_shared + 1)
        if proto_classes > 0:
            # CONFUSABLE geometry: objects are perturbed instances of a small
            # per-pair prototype bank (real scans hold several near-identical
            # chairs/tables) — point features alone can no longer separate
            # instances, so alignment must lean on graph context. With the
            # knob at 0 the rng stream and every seeded workspace are
            # unchanged.
            protos = [_blob(rng, pts_per_obj) for _ in range(proto_classes)]

            def _geom():
                # instance deform: per-axis scale ONLY (+-10%) — it must not
                # exceed the per-VIEW deform below, or the instance's scale
                # signature becomes a cross-view fingerprint and point
                # features re-saturate Hits@1 (measured: 0.996 with a
                # per-instance yaw+scale)
                pr = protos[int(rng.integers(proto_classes))]
                return pr * (0.9 + 0.2 * rng.random(3))
        else:
            def _geom():
                return _blob(rng, pts_per_obj)

        def _view_of(g):
            # one side's OBSERVATION of a shared object: point jitter plus an
            # independent per-view yaw/scale (sensor pose + segmentation
            # variation between visits) at the same magnitude as the
            # instance deform, so same-prototype instances are ambiguous to
            # point features and graph context must disambiguate
            if view_noise <= 0:
                return g
            yaw = rng.uniform(-0.3, 0.3)
            c, si = np.cos(yaw), np.sin(yaw)
            rot = np.array([[c, -si, 0.0], [si, c, 0.0], [0.0, 0.0, 1.0]])
            s = 1.0 + rng.uniform(-2.0 * view_noise, 2.0 * view_noise, 3)
            return (g * s) @ rot.T + rng.normal(0, view_noise, g.shape)
        shared_geoms = [_geom() for _ in shared_ids]
        shared_centers = rng.uniform(-3, 3, size=(n_shared, 3))
        shared_bow = (
            rng.integers(0, 3, size=(n_shared, REL_DIM)).astype(np.float64),
            (rng.random((n_shared, ATTR_DIM)) < 0.05).astype(np.float64))

        pair_scans = {}
        for side in ("src", "ref"):
            extra_lo = 100 if side == "src" else 200
            extra_ids = np.arange(extra_lo, extra_lo + n_extra)
            side_bow = shared_bow
            if overlapping:
                ids = np.concatenate([shared_ids, extra_ids])
                # with view_noise=0 shared objects are bit-identical across
                # sides: real subscans carve the SAME scene cloud, and the
                # GT-correspondence path relies on exact point matches
                # (point_cloud.py:91-103)
                shared_side = [_view_of(g) for g in shared_geoms]
                geoms = shared_side + [_geom() for _ in extra_ids]
                # center_noise: objects MOVE between visits (3RScan is
                # literally a dataset of rescans with moved furniture) —
                # without it the shared scene position is a cross-view
                # fingerprint that lets raw-position point features rank the
                # true anchor first even among identical-prototype instances
                # (measured: Hits@1 0.98 with geometry fully confusable)
                side_centers = shared_centers if center_noise <= 0 else (
                    shared_centers
                    + rng.normal(0, center_noise, shared_centers.shape))
                centers = np.concatenate(
                    [side_centers, rng.uniform(-3, 3, size=(n_extra, 3))])
                if bow_flip > 0:
                    rel = shared_bow[0].copy()
                    attr = shared_bow[1].copy()
                    mrel = rng.random(rel.shape) < bow_flip
                    rel[mrel] = rng.integers(0, 3, size=int(mrel.sum()))
                    mattr = rng.random(attr.shape) < bow_flip
                    attr[mattr] = (rng.random(int(mattr.sum())) < 0.05
                                   ).astype(np.float64)
                    side_bow = (rel, attr)
            else:  # disjoint object sets, disjoint regions
                lo = 1 if side == "src" else n_shared + 1
                ids = np.concatenate([np.arange(lo, lo + n_shared), extra_ids])
                offset = np.array([0.0, 0.0, 0.0]) if side == "src" else \
                    np.array([20.0, 0.0, 0.0])
                geoms = [_geom() for _ in range(n_shared + n_extra)]
                centers = rng.uniform(-3, 3, size=(n_shared + n_extra, 3)) + offset
            if side == "ref" and ref_transform is not None:
                # rotate local geometry + transform centers: the assembled
                # points become R (g + c) + t exactly
                r, t = ref_transform[:3, :3], ref_transform[:3, 3]
                geoms = [g @ r.T for g in geoms]
                centers = centers @ r.T + t
            scan_id = f"scene{p:02d}_{side}"
            pkl, rec = _make_subscan(
                rng, scan_id, ids, centers, geoms, pc_resolutions,
                shared_bow=side_bow if overlapping else None)
            ensure_dir(osp.join(scans_dir, scan_id))
            np.save(osp.join(scans_dir, scan_id, "data.npy"), rec)
            write_pkl_data(pkl, osp.join(files_dir, "data", f"{scan_id}.pkl"))
            pair_scans[side] = scan_id
            scan_ids.append(scan_id)

        entry = {
            "src": pair_scans["src"],
            "ref": pair_scans["ref"],
            "overlap": float(rng.uniform(0.2, 0.8)) if overlapping else 0.0,
            "anchorIds": [int(i) for i in shared_ids] if overlapping else [],
        }
        if ref_transform is not None:
            entry["transform"] = np.asarray(ref_transform).tolist()
        anchors.append(entry)
        scan_subscan_map[f"scene{p:02d}"] = [pair_scans["src"],
                                             pair_scans["ref"]]

    write_json(anchors, osp.join(files_dir, f"anchors_{split}.json"))
    write_json(scan_subscan_map,
               osp.join(files_dir, f"scan_subscan_map_{split}.json"))
    with open(osp.join(files_dir, f"{split}_scans_subscenes.txt"), "w") as f:
        f.write("\n".join(scan_ids))
    return {"anchors": anchors, "scan_ids": scan_ids,
            "pc_resolutions": pc_resolutions,
            "scan_subscan_map": scan_subscan_map}
