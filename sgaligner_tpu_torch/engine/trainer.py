"""Epoch-based trainer: the training loop, its snapshots and resume.

Counterpart of ``sgaligner_tpu/engine/trainer.py::Trainer``: the model from
``build_model`` on the device the caller names (the card unless it asks for
``"cpu"``) with ``build_objective``'s objective (``overall``, or ``nca`` for
EVA), ``make_train_step`` per batch, the metrics read back every
``cfg.train.log_steps`` steps, a val pass per epoch (``eval_epoch``: loss,
MRR, Hits@k, SGAR), per-epoch and rolling snapshots, best-snapshot
tracking and resume. Snapshots are ``.pth.tar`` files in upstream's layout
(``core/checkpoint.py``) under ``cfg.snapshot_dir``:

* ``epoch-<N>.pth.tar`` and ``best_snapshot.pth.tar``: ``{"model",
  "epoch", "iteration"}``, which the tester reads;
* ``snapshot.pth.tar``: the same and the train state's other entries
  (``TrainState.state_dict``: the objective, Adam, the dropout generator,
  the counters, the accumulated gradient), which ``resume`` reads.

As in the JAX package, the loaders' shuffle and augmentation state is not
part of a snapshot: a resumed run draws its batch order afresh from the
loader's seed. The per-pair compacted layout (``cfg.tpu.compact_slots >
0``, ROADMAP §1 item 7) is not ported and raises.

Data parallel (``cfg.tpu.dp``, ``parallel.mesh.make_mesh``: the launched
process group's ranks): every rank runs a Trainer on the same loaders (the
same whole batches), takes its block of each (``shard_batch``) and steps
with the mesh, so the parameters stay equal on every rank. Rank 0 alone
writes the log, the TensorBoard scalars, the snapshots and the profiler
trace; the ranks meet after each save. The val metrics are the whole
batches' on every rank, and every rank reads the rolling snapshot on
resume. EVA's nca step under data parallel is not ported (ROADMAP §1 item
8) and raises.
"""

from __future__ import annotations

import math
import os
import os.path as osp
from collections.abc import Iterable
from typing import Any, Callable

import numpy as np
import torch

from sgaligner_tpu_torch.core import checkpoint as ckpt
from sgaligner_tpu_torch.core.config import Config
from sgaligner_tpu_torch.data.batch import to_device
from sgaligner_tpu_torch.engine.factory import (build_model, build_objective,
                                                loss_kind, resolve_device)
from sgaligner_tpu_torch.engine.train_step import (TrainState, create_train_state,
                                                   eval_epoch, make_eval_step,
                                                   make_train_step)
from sgaligner_tpu_torch.parallel.mesh import barrier, broadcast_, make_mesh, shard_batch
from sgaligner_tpu_torch.utils.logging import Logger, StepTimer, SummaryBoard

Loader = Callable[[], Iterable[dict[str, np.ndarray]]]


class Trainer:
    """``train_loader`` / ``val_loader``: callables that return an iterable
    of host batches for one epoch. ``best_on_last_batch`` keys the best
    snapshot on the last val batch's loss (upstream's rule) instead of
    ``cfg.train.best_metric`` / ``best_mode``. ``profile_dir``: a
    ``torch.profiler`` trace of epoch 2 is written there."""

    def __init__(self, cfg: Config, train_loader: Loader,
                 val_loader: Loader | None = None, best_on_last_batch: bool = False,
                 log_file: str | None = None, profile_dir: str | None = None,
                 device: str | torch.device = "cuda"):
        if cfg.tpu.compact_slots > 0:
            raise NotImplementedError("tpu.compact_slots > 0: the per-pair compacted "
                                      "layout is not ported yet (ROADMAP §1 item 7)")
        self.mesh = make_mesh(cfg.tpu.dp)
        if self.mesh.dp > 1 and loss_kind(cfg) == "nca":
            raise NotImplementedError(f"tpu.dp = {self.mesh.dp}: EVA's nca step under "
                                      "data parallel is not ported yet (ROADMAP §1 "
                                      "item 8)")
        self.lead = self.mesh.rank == 0
        self.cfg = cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.best_on_last_batch = best_on_last_batch
        self.profile_dir = profile_dir if self.lead else None
        if log_file is None and cfg.log_dir:
            log_file = osp.join(cfg.log_dir, "train.log")
        self.logger = Logger(log_file if self.lead else None)
        self.writer = self._make_event_writer(cfg.event_dir) if self.lead else None

        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device)
        self.objective = build_objective(cfg).to(self.device)
        self.modules = tuple(cfg.modules)
        self.train_step = make_train_step(self.modules, self.mesh)
        self.eval_step = make_eval_step(self.model, self.objective, self.modules,
                                        ks=tuple(cfg.metrics.all_k), mesh=self.mesh)
        self.state: TrainState | None = None
        self.epoch = 0
        self.best_val_loss = float("inf")

    @staticmethod
    def _make_event_writer(event_dir: str):
        """TensorBoard scalars per epoch, when ``torch.utils.tensorboard``
        imports (it needs the ``tensorboard`` package); else None."""
        if not event_dir:
            return None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
        return SummaryWriter(event_dir)

    def _write_scalars(self, phase: str, summary: dict, step: int) -> None:
        if self.writer is None:
            return
        for k, v in summary.items():
            self.writer.add_scalar(f"{phase}/{k}", v, step)
        self.writer.flush()

    # -- state ------------------------------------------------------------
    def init_state(self) -> None:
        """Adam, the dropout generator and the counters over the model's
        seeded weights (drawn by ``build_model``; under data parallel rank
        0's, broadcast)."""
        self.state = create_train_state(self.model, self.cfg, self.objective)
        broadcast_(self.mesh, [*self.state.parameters(), *self.model.buffers()])
        n_params = sum(p.numel() for p in self.state.parameters())
        self.logger.info(f"model '{self.cfg.model_name}' modules={self.cfg.modules} "
                         f"params={n_params:,} device={self.device} dp={self.mesh.dp}")

    def _path(self, name: str) -> str:
        return osp.join(self.cfg.snapshot_dir, f"{name}.pth.tar")

    def resume(self) -> bool:
        """Load the rolling snapshot if there is one; returns whether it
        did."""
        path = self._path("snapshot")
        if not osp.isfile(path):
            return False
        assert self.state is not None, "call init_state first"
        blob = ckpt.load_torch_snapshot(path)
        self.model.load_state_dict(blob["model"], strict=True)
        self.state.load_state_dict(blob)
        self.epoch = blob["epoch"]
        self.logger.info(f"resumed from {path} at epoch {self.epoch}")
        return True

    def load_pretrained(self, path: str) -> None:
        """Load the model's weights from a snapshot (``--snapshot``): a
        ``.pth.tar``, or a JAX-package snapshot directory. Upstream loads
        the whole model state_dict, running statistics included, and so
        does the port (the JAX package keeps its own batch statistics)."""
        assert self.state is not None
        state_dict, _, _ = ckpt.load_model_state(path, self.modules)
        self.model.load_state_dict(state_dict, strict=True)
        self.logger.info(f"loaded pretrained model from {path}")

    # -- loops ------------------------------------------------------------
    def train_epoch(self) -> dict[str, float]:
        assert self.state is not None
        board = SummaryBoard(last_n=None)
        timer = StepTimer()
        for it, host in enumerate(self.train_loader()):
            batch = to_device(shard_batch(host, self.mesh), self.device)
            timer.record_prepare()
            metrics = self.train_step(self.state, batch)
            if (it + 1) % self.cfg.train.log_steps == 0:
                metrics = {k: float(v) for k, v in metrics.items()}  # reads back
                timer.record_process()
                board.update_from_dict(metrics)
                if not math.isfinite(metrics["loss"]):
                    self._dump_debug_state(host, it)
            else:
                timer.record_process()
        if not board.meters:
            self.logger.warning(
                "train epoch produced ZERO batches — check dataset size vs "
                "train.batch_size (drop_last discards partial batches)")
        summary = board.summary()
        summary["time/prepare"] = timer.prepare_mean
        summary["time/process"] = timer.process_mean
        return summary

    def _dump_debug_state(self, host: dict, it: int) -> None:
        """Non-finite loss: write the batch and the model's weights to
        ``<output_dir>/nan_debug_e<epoch>_i<it>.pth`` (the step itself was
        already dropped by the train step's non-finite skip)."""
        self.logger.error(f"non-finite loss at epoch {self.epoch} iter {it}")
        if not self.cfg.output_dir or not self.lead:
            return
        path = osp.join(self.cfg.output_dir, f"nan_debug_e{self.epoch}_i{it}.pth")
        torch.save({"batch": {k: torch.as_tensor(np.asarray(v)) for k, v in host.items()},
                    "model": {k: v.detach().cpu()
                              for k, v in self.model.state_dict().items()}}, path)
        self.logger.error(f"dumped offending batch + weights to {path}")

    def inference_epoch(self) -> dict[str, float]:
        assert self.state is not None and self.val_loader is not None
        return eval_epoch(self.eval_step, self.val_loader(),
                          tuple(self.cfg.metrics.all_k), self.device, mesh=self.mesh)

    def _save(self, name: str, **extra) -> None:
        """Rank 0 writes; every rank returns once it has."""
        if self.lead:
            ckpt.save_torch_snapshot(self._path(name), self.model.state_dict(),
                                     epoch=self.epoch, iteration=self.state.step, **extra)
        barrier(self.mesh, self.device)

    def save_epoch_snapshot(self) -> None:
        assert self.state is not None
        self._save(f"epoch-{self.epoch}")
        self._save("snapshot", **(self.state.state_dict() if self.lead else {}))

    def run(self, resume: bool = False) -> dict[str, Any]:
        if resume:
            self.resume()
        history = []
        while self.epoch < self.cfg.optim.max_epoch:
            self.epoch += 1
            train_summary = self._profiled_epoch()
            self.logger.info(f"[epoch {self.epoch}] train: " + ", ".join(
                f"{k}: {v:.4f}" for k, v in train_summary.items()))
            self._write_scalars("train", train_summary, self.epoch)
            if self.cfg.snapshot_dir:
                self.save_epoch_snapshot()
            entry: dict[str, Any] = {"epoch": self.epoch, "train": train_summary}
            if self.val_loader is not None:
                val_summary = self.inference_epoch()
                self.logger.info(f"[epoch {self.epoch}] val: " + ", ".join(
                    f"{k}: {v:.4f}" for k, v in val_summary.items()))
                self._write_scalars("val", val_summary, self.epoch)
                key = ("last_batch_loss" if self.best_on_last_batch
                       else self.cfg.train.best_metric)
                sign = -1.0 if (self.cfg.train.best_mode == "max"
                                and not self.best_on_last_batch) else 1.0
                if sign * val_summary[key] < self.best_val_loss and self.cfg.snapshot_dir:
                    self.best_val_loss = sign * val_summary[key]
                    self._save("best_snapshot")
                entry["val"] = val_summary
            history.append(entry)
        if self.writer is not None:
            self.writer.close()
        return {"history": history, "epochs": self.epoch}

    def _profiled_epoch(self) -> dict[str, float]:
        """``train_epoch``, traced by ``torch.profiler`` into
        ``profile_dir/epoch-2.json`` when this is epoch 2 and a directory
        is set."""
        if self.profile_dir is None or self.epoch != 2:
            return self.train_epoch()
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            summary = self.train_epoch()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = osp.join(self.profile_dir, "epoch-2.json")
        prof.export_chrome_trace(path)
        self.logger.info(f"profiler trace written to {path}")
        return summary
