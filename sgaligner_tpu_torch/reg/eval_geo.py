"""Held-out synthetic evaluation of the learned registration backend.

Counterpart of ``sgaligner_tpu/reg/eval_geo.py``: upstream's registration
metrics (CD, RRE, RTE, FMR, RR as its registration evaluator computes them)
plus the hit rate at (5 deg, 10 cm), on synthetic pairs
(``reg/synthetic_pairs.py``, seeds apart from the training streams) swept
across overlap bands. The crops come from one scene cloud, so the pairs
carry true point correspondences and RR is a real check.

    python -m sgaligner_tpu_torch.reg.eval_geo [--checkpoint X.pth.tar] [--device cpu]
"""

from __future__ import annotations

import numpy as np

from sgaligner_tpu_torch.reg.metrics import (
    compute_inlier_ratio,
    compute_modified_chamfer_distance,
    compute_registration_error,
    compute_registration_rmse,
)
from sgaligner_tpu_torch.reg.synthetic_pairs import make_pair
from sgaligner_tpu_torch.utils.pointcloud import apply_transform, get_nearest_neighbor


def gt_point_corrs(src, ref, gt, radius: float = 0.02):
    """True correspondences between the crops: src warped by gt, its
    nearest ref point within ``radius`` (the crops share the scene's
    points up to the added noise)."""
    src_w = apply_transform(src, gt)
    d, idx = get_nearest_neighbor(src_w, ref, return_index=True)
    sel = d < radius
    return src[sel], ref[idx[sel]]


def is_hit(rre: float, rte: float) -> bool:
    """A registration within 5 degrees and 10 cm."""
    return rre < 5.0 and rte < 0.10


def metrics_for_pair(out, src, ref, gt, scene, ir_thresh: float = 0.05,
                     rmse_thresh: float = 0.2):
    """The metric dict of one registered pair (None if the backend
    declined)."""
    if out is None:
        return None
    est = out["estimated_transform"]
    gt_src_c, gt_ref_c = gt_point_corrs(src, ref, gt)
    cd = compute_modified_chamfer_distance(src, ref, scene, est, gt)
    ir = compute_inlier_ratio(out["ref_corr_points"], out["src_corr_points"], gt)
    rre, rte = compute_registration_error(gt, est)
    rmse = compute_registration_rmse(gt_ref_c, gt_src_c, est)
    return {
        "CD": cd, "IR": ir, "RRE": rre, "RTE": rte,
        "FMR": float(ir >= ir_thresh), "RR": float(rmse < rmse_thresh),
        "hit": float(is_hit(rre, rte)),
        "n_corrs": len(out["corr_scores"]),
    }


def evaluate_pair(backend, src, ref, gt, scene, ir_thresh: float = 0.05,
                  rmse_thresh: float = 0.2):
    """Register one pair and score it (None if the backend declines)."""
    return metrics_for_pair(backend.register(src, ref), src, ref, gt, scene,
                            ir_thresh, rmse_thresh)


def _register_all(backend, quads):
    """Register ``[(src, ref, gt, scene)]``: one ``register_batch`` call
    where the backend has it, else a pair at a time."""
    if hasattr(backend, "register_batch"):
        return backend.register_batch([(s, r) for s, r, _, _ in quads])
    return [backend.register(s, r) for s, r, _, _ in quads]


def _evaluate_band(backend, quads, ov, verbose):
    outs = _register_all(backend, quads)
    rows, fails = [], 0
    for out, (src, ref, gt, scene) in zip(outs, quads):
        r = metrics_for_pair(out, src, ref, gt, scene)
        if r is None:
            fails += 1
        else:
            rows.append(r)
    return _aggregate(rows, fails, len(quads), ov, verbose)


def band_pairs(ov: float, n_pairs: int = 8, seed: int = 777_000,
               n_points: int = 2048, scene_kind: str = "patches") -> list:
    """The ``(src, ref, gt, scene)`` quads of one overlap band, pair p from
    ``np.random.default_rng((seed, int(ov * 100), p))``."""
    return [make_pair(np.random.default_rng((seed, int(ov * 100), p)),
                      n_points=n_points, overlap=ov, return_scene=True,
                      kind=scene_kind) for p in range(n_pairs)]


def evaluate(backend, overlaps=(0.3, 0.4, 0.5, 0.6), n_pairs: int = 8,
             seed: int = 777_000, n_points: int = 2048,
             scene_kind: str = "patches", verbose: bool = True):
    """Sweep the overlap bands: ``{overlap: {metric: mean}}``. A declined
    registration counts 0 toward FMR / RR / hit and is left out of the
    error means."""
    return {ov: _evaluate_band(backend, band_pairs(ov, n_pairs, seed, n_points,
                                                   scene_kind), ov, verbose)
            for ov in overlaps}


def evaluate_cloud(backend, cloud, overlaps=(0.3, 0.4, 0.5, 0.6),
                   n_pairs: int = 8, seed: int = 555_000,
                   noise: float = 0.005, verbose: bool = True):
    """The same sweep over crops of a given cloud (a real scan) by
    ``make_pair_from_cloud``."""
    from sgaligner_tpu_torch.reg.synthetic_pairs import make_pair_from_cloud

    results = {}
    for ov in overlaps:
        quads = []
        for p in range(n_pairs):
            rng = np.random.default_rng((seed, int(ov * 100), p))
            quads.append(make_pair_from_cloud(
                rng, cloud, overlap=ov, noise=noise, return_scene=True))
        results[ov] = _evaluate_band(backend, quads, ov, verbose)
    return results


def _aggregate(rows, fails, n_pairs, ov, verbose):
    agg = {}
    for k in ("CD", "IR", "RRE", "RTE", "n_corrs"):
        vals = [r[k] for r in rows]
        agg[k] = float(np.mean(vals)) if vals else float("nan")
    n = max(n_pairs, 1)
    for k in ("FMR", "RR", "hit"):
        agg[k] = float(sum(r[k] for r in rows)) / n
    hits = [r for r in rows if r["hit"]]
    agg["RRE_hit"] = float(np.mean([r["RRE"] for r in hits])) if hits else float("nan")
    agg["RTE_hit"] = float(np.mean([r["RTE"] for r in hits])) if hits else float("nan")
    agg["hits"] = int(sum(r["hit"] for r in rows))
    agg["n"] = n_pairs
    agg["fails"] = fails
    if verbose:
        print(f"overlap {ov:.1f}: hit {agg['hits']}/{n_pairs}  "
              f"CD {agg['CD']:.4f}  RRE {agg['RRE']:.2f}deg  "
              f"RTE {agg['RTE'] * 100:.1f}cm  FMR {agg['FMR']:.2f}  "
              f"RR {agg['RR']:.2f}  "
              f"(hit-only RRE {agg['RRE_hit']:.2f} RTE "
              f"{agg['RTE_hit'] * 100:.1f}cm, corrs {agg['n_corrs']:.0f})",
              flush=True)
    return agg


def main(argv=None):
    import argparse

    from sgaligner_tpu_torch.reg.backend import GEO_CHECKPOINT

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", type=str, default=GEO_CHECKPOINT,
                    help="a .pth.tar, or a JAX-package checkpoint directory")
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--seed", type=int, default=777_000)
    ap.add_argument("--overlaps", type=float, nargs="+",
                    default=[0.3, 0.4, 0.5, 0.6])
    ap.add_argument("--no_fine", action="store_true",
                    help="disable the fine point-matching stage (ablation)")
    ap.add_argument("--scene_kind", type=str, default="patches",
                    choices=["patches", "room", "mix", "patches+rough",
                             "room+rough", "mix+rough"])
    ap.add_argument("--cloud", type=str, default=None,
                    help="structured data.npy scan: evaluate on crops of this"
                         " cloud instead of synthetic scenes")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from sgaligner_tpu_torch.reg.learned import LearnedBackend

    be = LearnedBackend(checkpoint=args.checkpoint, fine=not args.no_fine,
                        device=args.device)
    if args.cloud:
        from sgaligner_tpu_torch.utils.io import load_plydata_npy

        return evaluate_cloud(be, load_plydata_npy(args.cloud),
                              overlaps=tuple(args.overlaps), n_pairs=args.pairs,
                              seed=args.seed)
    return evaluate(be, overlaps=tuple(args.overlaps), n_pairs=args.pairs,
                    seed=args.seed, scene_kind=args.scene_kind)


if __name__ == "__main__":
    main()
