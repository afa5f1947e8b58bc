"""Train / val entry point for SGAligner.

Counterpart of ``sgaligner_tpu/cli/trainval_sgaligner.py``, with the same
flags (``--config``, ``--resume``, ``--snapshot``, ``--load_transform``
and ``--local_rank`` accepted for compatibility and unused,
``--output_root``) plus ``--device`` (``cuda`` unless ``cpu`` is asked
for). Snapshots go to ``<output_root>/output/<data>/<model>/<modules>/
snapshots/`` as ``.pth.tar`` files, which the inference CLIs find:

    python -m sgaligner_tpu_torch.cli.trainval_sgaligner --config CFG.yaml \\
        --device cpu

``train(cfg, ...)`` is the body, for a config given as a dict
(``core.config.make_cfg`` and ``make_output_tree``; no PyYAML).
"""

from __future__ import annotations

import argparse
from typing import Any

from sgaligner_tpu_torch.core.config import Config, make_cfg, update_config
from sgaligner_tpu_torch.data.loaders import get_train_val_data_loader
from sgaligner_tpu_torch.engine.trainer import Trainer


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train SGAligner (PyTorch / CUDA)")
    parser.add_argument("--config", required=True, help="config YAML path")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the rolling snapshot")
    parser.add_argument("--snapshot", default=None,
                        help="load pretrained weights before training")
    parser.add_argument("--load_transform", default=None, help="(compat, unused)")
    parser.add_argument("--local_rank", type=int, default=-1, help="(compat, unused)")
    parser.add_argument("--output_root", default=None,
                        help="root for the derived output/ tree (default: cwd)")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def train(cfg: Config, device: str = "cuda", resume: bool = False,
          snapshot: str | None = None) -> dict[str, Any]:
    """Train ``cfg`` (its output tree already derived) on ``device``: the
    Scan3R loaders, a ``Trainer``, the pretrained weights of ``snapshot``
    when given, then ``Trainer.run``. Returns its history."""
    train_loader, val_loader = get_train_val_data_loader(cfg)
    trainer = Trainer(cfg, lambda: iter(train_loader), lambda: iter(val_loader),
                      device=device)
    trainer.init_state()
    if snapshot:
        trainer.load_pretrained(snapshot)
    return trainer.run(resume=resume)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = update_config(make_cfg(), args.config, output_root=args.output_root)
    train(cfg, args.device, resume=args.resume, snapshot=args.snapshot)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
