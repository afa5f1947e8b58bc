"""3D mosaicking entry point.

Counterpart of ``sgaligner_tpu/cli/inference_mosaicking.py``, with the same
flags (``--config``, ``--snapshot``, ``--test_epoch``, ``--test_iter``,
``--reg_snapshot``, ``--split``, ``--max_scans``, ``--output_root``) plus
``--device`` (``cuda`` unless ``cpu`` is asked for). The scan -> subscan
map is ``<subscan_dir>/files/<data_mode>/<anchor_type_name>_<split>.json``
(``scan_subscan_map`` when the name is empty); ``--max_scans`` keeps the
map's first scans (upstream keeps 2; 0 keeps all). Prints
``MosaickTester``'s results as one JSON line:

    python -m sgaligner_tpu_torch.cli.inference_mosaicking --config CFG.yaml \\
        --snapshot checkpoints/torch/aligner_full.pth.tar --max_scans 8 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os.path as osp

from sgaligner_tpu_torch.core.config import make_cfg, update_config
from sgaligner_tpu_torch.engine.tester import MosaickTester
from sgaligner_tpu_torch.reg.backend import build_backend
from sgaligner_tpu_torch.reg.evaluator import RegistrationEvaluator
from sgaligner_tpu_torch.utils.io import load_json


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--snapshot", default=None)
    parser.add_argument("--test_epoch", type=int, default=None)
    parser.add_argument("--test_iter", type=int, default=None)
    parser.add_argument("--reg_snapshot", default=None)
    parser.add_argument("--split", default="val")
    parser.add_argument("--max_scans", type=int, default=2)
    parser.add_argument("--output_root", default=None)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def run(cfg, device: str = "cuda", snapshot: str | None = None,
        test_epoch: int | None = None, test_iter: int | None = None,
        reg_snapshot: str | None = None, split: str = "val",
        max_scans: int | None = 2) -> dict:
    """``MosaickTester`` over the first ``max_scans`` scans of ``split``'s
    scan -> subscan map, on ``device``."""
    map_name = cfg.preprocess.anchor_type_name or "scan_subscan_map"
    scan_subscan_map = load_json(osp.join(cfg.data.subscan_dir, "files",
                                          cfg.val.data_mode, f"{map_name}_{split}.json"))
    backend = build_backend(cfg, reg_snapshot, device=device)
    tester = MosaickTester(cfg, RegistrationEvaluator(cfg, backend, device=device),
                           scan_subscan_map, subscans_dir=cfg.data.subscan_dir,
                           max_scans=max_scans or None, snapshot=snapshot,
                           test_epoch=test_epoch, test_iter=test_iter, device=device)
    return tester.run()


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = update_config(make_cfg(), args.config, output_root=args.output_root)
    results = run(cfg, args.device, args.snapshot, args.test_epoch, args.test_iter,
                  args.reg_snapshot, args.split, args.max_scans)
    print(json.dumps(results, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
