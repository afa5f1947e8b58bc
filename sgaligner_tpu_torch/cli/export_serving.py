"""Export a serving artifact from a trained snapshot.

Counterpart of ``sgaligner_tpu/cli/export_serving.py``, with ``--device``
(``cuda`` unless ``cpu`` is asked for) in place of ``--platform``: the
serving step (``engine/train_step.py``) and the trained weights are frozen
into one artifact directory with ``torch.export`` (``serving.py``),
traced on that device:

    python -m sgaligner_tpu_torch.cli.export_serving \\
        --config configs/scan3r/scan3r_ground_truth.yaml \\
        --snapshot checkpoints/torch/aligner_full.pth.tar --out artifact/ \\
        --batch 128 --pooled_bucket 2048

Prints one JSON line naming the artifact.
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--snapshot", required=True,
                        help="a .pth.tar snapshot (or a JAX-package snapshot dir)")
    parser.add_argument("--out", required=True, help="artifact directory")
    parser.add_argument("--batch", type=int, default=128,
                        help="pairs per serving batch (pinned)")
    parser.add_argument("--pooled_bucket", type=int, default=0,
                        help="pinned pooled point axis K; 0 = dense bound")
    parser.add_argument("--queue", type=int, default=1,
                        help="export the queue form: this many stacked "
                             "batches per call")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--with_sim", action="store_true",
                        help="the artifact also returns per-pair sim matrices")
    parser.add_argument("--points_dtype", default="",
                        help="pin the point-cloud input dtype, e.g. bfloat16")
    parser.add_argument("--output_root", default=None)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from sgaligner_tpu_torch.core import checkpoint as ckpt
    from sgaligner_tpu_torch.core.config import make_cfg, update_config
    from sgaligner_tpu_torch.engine.factory import build_model
    from sgaligner_tpu_torch.serving import export_serving_artifact

    cfg = update_config(make_cfg(), args.config, output_root=args.output_root)
    model = build_model(cfg, args.device)
    state_dict, _, _ = ckpt.load_model_state(args.snapshot, tuple(cfg.modules))
    model.load_state_dict(state_dict, strict=True)
    out = export_serving_artifact(
        cfg, model, args.out, batch_size=args.batch,
        pooled_bucket=args.pooled_bucket or None, queue=args.queue,
        with_sim=args.with_sim, points_dtype=args.points_dtype)
    print(json.dumps({"artifact": out, "batch_size": args.batch,
                      "queue": args.queue, "device": args.device}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
