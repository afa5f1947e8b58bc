"""Overlap detection entry point.

Counterpart of ``sgaligner_tpu/cli/inference_find_overlapper.py``, with the
same flags (``--config``, ``--snapshot``, ``--test_epoch``, ``--test_iter``,
``--reg_snapshot``, ``--output_root``) plus ``--device`` (``cuda`` unless
``cpu`` is asked for). The val fileset must hold overlapping and
non-overlapping pairs for P/R/F1 to mean anything. Builds the registration
backend ``reg_model.backend`` names (``learned`` in the JAX package's
quality contract) and prints ``OverlapTester``'s results as one JSON line:

    python -m sgaligner_tpu_torch.cli.inference_find_overlapper --config CFG.yaml \\
        --snapshot checkpoints/torch/aligner_full.pth.tar --device cpu
"""

from __future__ import annotations

import argparse
import json

from sgaligner_tpu_torch.core.config import make_cfg, update_config
from sgaligner_tpu_torch.data.loaders import get_val_dataloader
from sgaligner_tpu_torch.engine.tester import OverlapTester
from sgaligner_tpu_torch.reg.backend import build_backend
from sgaligner_tpu_torch.reg.evaluator import RegistrationEvaluator


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--snapshot", default=None)
    parser.add_argument("--test_epoch", type=int, default=None)
    parser.add_argument("--test_iter", type=int, default=None)
    parser.add_argument("--reg_snapshot", default=None)
    parser.add_argument("--output_root", default=None)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def run(cfg, device: str = "cuda", snapshot: str | None = None,
        test_epoch: int | None = None, test_iter: int | None = None,
        reg_snapshot: str | None = None) -> dict:
    """``OverlapTester`` over ``cfg``'s val split on ``device``."""
    loader = get_val_dataloader(cfg)
    backend = build_backend(cfg, reg_snapshot, device=device)
    tester = OverlapTester(cfg, loader.dataset, loader,
                           RegistrationEvaluator(cfg, backend, device=device),
                           snapshot=snapshot, test_epoch=test_epoch,
                           test_iter=test_iter, device=device)
    return tester.run()


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = update_config(make_cfg(), args.config, output_root=args.output_root)
    results = run(cfg, args.device, args.snapshot, args.test_epoch, args.test_iter,
                  args.reg_snapshot)
    print(json.dumps(results, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
