"""Demo: point-modality alignment directly from two raw ``data.npy`` scenes.

Counterpart of ``sgaligner_tpu/cli/demo_align.py``: no preprocessed pkl is
needed. Objects are carved from the structured clouds by objectId,
farthest-point sampled, run through a point-only ``MultiModalEncoder``
(``api.Aligner``), and the cross-scene node matches are printed as one
JSON line:

    python -m sgaligner_tpu_torch.cli.demo_align --src .../scene_1/data.npy \\
        --ref .../scene_2/data.npy [--snapshot X.pth.tar] [--pc_res 512] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def objects_from_npy(path: str, pc_res: int, min_points: int,
                     rng: np.random.Generator):
    """``(object ids [n], points [n, pc_res, 3] float32)``: every object of
    the scene (objectId 0 left out) with at least ``min_points`` points,
    farthest-point sampled to ``pc_res``."""
    from sgaligner_tpu_torch.utils.io import load_plydata_npy
    from sgaligner_tpu_torch.utils.pointcloud import pcl_farthest_sample

    points, ply = load_plydata_npy(path, return_ply_data=True)
    obj_ids = []
    obj_points = []
    for oid in np.unique(ply["objectId"]):
        if oid == 0:
            continue
        pts = points[ply["objectId"] == oid]
        if len(pts) < min_points:
            continue
        obj_ids.append(int(oid))
        obj_points.append(pcl_farthest_sample(pts, pc_res, rng=rng))
    return np.array(obj_ids), np.stack(obj_points).astype(np.float32)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True, help="src scene data.npy")
    parser.add_argument("--ref", required=True, help="ref scene data.npy")
    parser.add_argument("--snapshot", default=None,
                        help="trained point-model snapshot (seeded init if absent)")
    parser.add_argument("--pc_res", type=int, default=512)
    parser.add_argument("--min_obj_points", type=int, default=50)
    parser.add_argument("--k", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from sgaligner_tpu_torch.api import Aligner
    from sgaligner_tpu_torch.core.config import make_cfg

    aligner = Aligner(make_cfg(model_name="sgaligner", modules=["point"]),
                      snapshot=args.snapshot, device=args.device)
    if not args.snapshot:
        print("[WARN] no snapshot given: seeded random weights (the structure "
              "of the pipeline only; the matches are meaningless)")
    res = aligner.align(args.src, args.ref, k=args.k, pc_res=args.pc_res,
                        min_obj_points=args.min_obj_points)
    print(json.dumps({
        "src_objects": res.n_src,
        "ref_objects": res.n_ref,
        "alignment_score": res.alignment_score,
        "node_matches(src_obj_id -> ref_obj_id)": res.node_matches,
    }, default=int))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
