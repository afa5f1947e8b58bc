"""Alignment and registration inference entry point.

Counterpart of ``sgaligner_tpu/cli/inference_align_reg.py``, with the same
flags (``--config``, ``--snapshot``, ``--test_epoch``, ``--test_iter``,
``--reg_snapshot``, ``--output_root``) plus ``--device`` (``cuda`` unless
``cpu`` is asked for). With ``registration: true`` in the config it builds
the registration backend (``reg_model.backend``: ``ransac`` or ``learned``;
GeoTransformer raises) and the
evaluator, and the results hold the normal and the aligner registration
summaries. Prints the results as one JSON line:

    python -m sgaligner_tpu_torch.cli.inference_align_reg --config CFG.yaml \\
        --snapshot checkpoints/torch/aligner_full.pth.tar --device cpu
"""

from __future__ import annotations

import argparse
import json

from sgaligner_tpu_torch.core.config import make_cfg, update_config
from sgaligner_tpu_torch.data.loaders import get_val_dataloader
from sgaligner_tpu_torch.engine.tester import AlignRegTester
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


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = update_config(make_cfg(), args.config, output_root=args.output_root)
    loader = get_val_dataloader(cfg)
    reg_eval = None
    if cfg.registration:
        backend = build_backend(cfg, args.reg_snapshot, device=args.device)
        reg_eval = RegistrationEvaluator(cfg, backend, device=args.device)
    tester = AlignRegTester(cfg, loader.dataset, loader,
                            registration_evaluator=reg_eval,
                            snapshot=args.snapshot, test_epoch=args.test_epoch,
                            test_iter=args.test_iter, device=args.device)
    print(json.dumps(tester.run(), default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
