"""Inference tester: alignment metrics of a snapshot over a val loader.

Counterpart of ``sgaligner_tpu/engine/tester.py`` (``BaseTester``, and the
alignment half of ``AlignRegTester.run``): snapshot resolution as the JAX
tester does it (``--snapshot``, ``<snapshot_dir>/epoch-<N>``,
``<snapshot_dir>/iter-<n>[.pth.tar]``, else the newest snapshot), the
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
from sgaligner_tpu_torch.data.batch import to_device
from sgaligner_tpu_torch.engine.factory import (build_model, build_objective,
                                                resolve_device)
from sgaligner_tpu_torch.engine.train_step import make_eval_step


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

        if snapshot is None and test_epoch is not None:
            snapshot = osp.join(cfg.snapshot_dir, f"epoch-{test_epoch}")
        if snapshot is None and test_iter is not None:
            cands = [osp.join(cfg.snapshot_dir, f"iter-{test_iter}"),
                     osp.join(cfg.snapshot_dir, f"iter-{test_iter}.pth.tar")]
            snapshot = next((c for c in cands if osp.exists(c)), None)
            if snapshot is None:
                raise FileNotFoundError(
                    f"--test_iter {test_iter}: none of {cands} exist")
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
        if snapshot.endswith((".pth.tar", ".pth", ".tar")):
            blob = ckpt.load_torch_snapshot(snapshot)
            state_dict = blob["model"]
        else:
            blob = ckpt.read_ocdbt_snapshot(snapshot)
            params = blob["params"]
            params = params["model"] if "model" in params else params
            state_dict = ckpt.state_dict_from_flax(params, blob.get("batch_stats"),
                                                   self.modules)
        self.model.load_state_dict(state_dict, strict=True)
        return blob["epoch"], blob["iteration"]


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
        ks = self.cfg.metrics.all_k
        rr_sum = rr_count = 0.0
        hits = {k: [0.0, 0.0] for k in ks}
        sgar_sums = {"2": 0.0, "50": 0.0, "100": 0.0}
        n_pairs = 0.0
        for batch in self.loader:
            out = self.eval_step(to_device(batch, self.device))
            rr_sum += float(out["rr_sum"])
            rr_count += float(out["rr_count"])
            for k in ks:
                c, t = out[f"hits@{k}"]
                hits[k][0] += float(c)
                hits[k][1] += float(t)
            pv = out["pair_valid"]
            n_pairs += float(pv.sum())
            for mode in sgar_sums:
                sgar_sums[mode] += float((out["sgar"][mode] * pv).sum())

        results: dict[str, Any] = {"mrr": rr_sum / max(rr_count, 1.0)}
        for k in ks:
            results[f"hits@{k}"] = hits[k][0] / max(hits[k][1], 1.0)
        for mode, s in sgar_sums.items():
            results[f"sgar@{mode}"] = s / max(n_pairs, 1.0)
        return results
