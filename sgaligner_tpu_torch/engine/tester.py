"""Inference tester: alignment metrics of a snapshot over a val loader.

Counterpart of ``sgaligner_tpu/engine/tester.py`` (``BaseTester``, and the
alignment half of ``AlignRegTester.run``): snapshot resolution as the JAX
tester does it (``--snapshot``, ``<snapshot_dir>/epoch-<N>[.pth.tar]``,
``<snapshot_dir>/iter-<n>[.pth.tar]``, else the newest snapshot,
``core.checkpoint.latest_snapshot``), the
model from ``build_model`` on the device the caller names (the card unless
it asks for ``"cpu"``), the weights loaded strictly, and per batch the
port's ``make_eval_step`` (``loss_kind``'s objective with zero
log-variances, ranks, MRR / Hits@k, SGAR) on the batch moved there with
``to_device``. A snapshot is a ``.pth.tar`` in upstream's layout
(``load_torch_snapshot``) or a JAX-package snapshot directory
(``read_ocdbt_snapshot``, which needs ``tensorstore``). Registration
(``cfg.registration``) is not ported yet and raises.
"""

from __future__ import annotations

import os.path as osp
from typing import Any

import torch

from sgaligner_tpu_torch.core import checkpoint as ckpt
from sgaligner_tpu_torch.core.config import Config
from sgaligner_tpu_torch.engine.factory import (build_model, build_objective,
                                                resolve_device)
from sgaligner_tpu_torch.engine.train_step import eval_epoch, make_eval_step


class BaseTester:
    """Snapshot resolution, the model with its weights, and the eval step."""

    def __init__(self, cfg: Config, snapshot: str | None = None,
                 test_epoch: int | None = None, test_iter: int | None = None,
                 device: str | torch.device = "cuda"):
        if cfg.registration:
            raise NotImplementedError("registration is not ported yet; run the "
                                      "tester with registration off")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device)
        self.objective = build_objective(cfg).to(self.device)
        self.modules = tuple(cfg.modules)

        for flag, value, stem in (("--test_epoch", test_epoch, "epoch"),
                                  ("--test_iter", test_iter, "iter")):
            if snapshot is None and value is not None:
                cands = [osp.join(cfg.snapshot_dir, f"{stem}-{value}{suffix}")
                         for suffix in (".pth.tar", "")]
                snapshot = next((c for c in cands if osp.exists(c)), None)
                if snapshot is None:
                    raise FileNotFoundError(f"{flag} {value}: none of {cands} exist")
        if snapshot is None:
            snapshot = ckpt.latest_snapshot(cfg.snapshot_dir)
        if snapshot is None:
            raise FileNotFoundError(
                f"no snapshot found under {cfg.snapshot_dir}; pass --snapshot")
        self.snapshot_path = snapshot
        self.epoch, self.iteration = self._load(snapshot)
        self.eval_step = make_eval_step(self.model, self.objective, self.modules,
                                        ks=tuple(cfg.metrics.all_k))

    def _load(self, snapshot: str) -> tuple[int, int]:
        """Loads the weights strictly; returns (epoch, iteration)."""
        state_dict, epoch, iteration = ckpt.load_model_state(snapshot, self.modules)
        self.model.load_state_dict(state_dict, strict=True)
        return epoch, iteration


class AlignRegTester(BaseTester):
    """inference_align_reg's alignment metrics (registration not ported)."""

    def __init__(self, cfg: Config, dataset, loader,
                 registration_evaluator=None, **kw):
        if registration_evaluator is not None:
            raise NotImplementedError("registration is not ported yet")
        super().__init__(cfg, **kw)
        self.dataset = dataset
        self.loader = loader

    def run(self) -> dict[str, Any]:
        """MRR, Hits@k and SGAR over the loader (the loss is left out)."""
        results = eval_epoch(self.eval_step, self.loader, self.cfg.metrics.all_k,
                             self.device)
        return {k: v for k, v in results.items()
                if k not in ("loss", "last_batch_loss")}
