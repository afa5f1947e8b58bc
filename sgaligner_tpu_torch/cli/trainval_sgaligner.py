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

Data parallel: launch one process per rank with ``torchrun``; each joins
the launcher's process group over ``--dist_backend`` (``nccl`` unless
asked otherwise; ``gloo`` for ranks on the CPU or sharing a card), and
``--device cuda`` is the card of its ``LOCAL_RANK`` (``cuda:0`` puts every
rank on card 0). ``tpu.dp`` in the config is 0 (every launched rank) or
their number:

    torchrun --nproc_per_node 2 -m sgaligner_tpu_torch.cli.trainval_sgaligner \\
        --config CFG.yaml
"""

from __future__ import annotations

import argparse
from typing import Any

from sgaligner_tpu_torch.core.config import Config, make_cfg, update_config
from sgaligner_tpu_torch.data.loaders import get_train_val_data_loader
from sgaligner_tpu_torch.engine.trainer import Trainer
from sgaligner_tpu_torch.parallel.mesh import (init_from_launcher, leave_launcher,
                                               make_mesh, rank_device)


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
    parser.add_argument("--dist_backend", default="nccl",
                        help="torch.distributed backend under torchrun (nccl, gloo)")
    return parser.parse_args(argv)


def train(cfg: Config, device: str = "cuda", resume: bool = False,
          snapshot: str | None = None) -> dict[str, Any]:
    """Train ``cfg`` (its output tree already derived) on ``device``: the
    Scan3R loaders, a ``Trainer``, the pretrained weights of ``snapshot``
    when given, then ``Trainer.run``. Returns its history. Under data
    parallel ``cfg.tpu.dp`` is set to the ranks' number first, so the
    loaders pool each rank's block of a batch apart."""
    cfg.tpu.dp = make_mesh(cfg.tpu.dp).dp
    train_loader, val_loader = get_train_val_data_loader(cfg)
    trainer = Trainer(cfg, lambda: iter(train_loader), lambda: iter(val_loader),
                      device=device)
    trainer.init_state()
    if snapshot:
        trainer.load_pretrained(snapshot)
    return trainer.run(resume=resume)


def main(argv=None) -> int:
    args = parse_args(argv)
    local_rank = init_from_launcher(args.dist_backend)
    try:
        cfg = update_config(make_cfg(), args.config, output_root=args.output_root)
        train(cfg, rank_device(args.device, local_rank), resume=args.resume,
              snapshot=args.snapshot)
    finally:
        leave_launcher()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
