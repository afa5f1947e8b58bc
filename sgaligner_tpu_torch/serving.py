"""Exported serving artifacts: the serving step frozen once, loaded without
the model code or the config system.

Counterpart of ``sgaligner_tpu/serving.py``. The JAX artifact is a
``jax.export`` program; here it is a ``torch.export.ExportedProgram`` of
the serving step (``engine/train_step.py``: ``serving_metrics``, or
``queue_metrics`` for a queue), saved with ``torch.export.save``:

    # build box (the port, a trained model)
    from sgaligner_tpu_torch import serving
    serving.export_serving_artifact(cfg, model, "artifact/", batch_size=128)

    # serving box (torch and the port's kernels)
    art = serving.load_serving_artifact("artifact/")
    out = art(host_batch)          # host_batch: plain numpy PairBatch fields

The kernels of the serving path are ``torch.library`` custom ops
(``ops/library.py``), so the program holds each as one node: on the card
it launches the hand-written kernels, on the CPU their plain versions.

Artifact layout (one directory):

* ``serving.pt2`` - the exported program with the weights,
* ``meta.json``   - static shapes (B, N, P, pooled K), modules, dtypes, the
  device it was exported for.

Shapes are pinned at export. The pooled point axis K (``data/batch.py::
pool_compact``) depends on the data, so the exporter pins it and
``ServingArtifact.prepare`` pools every incoming batch to exactly that K,
raising when a batch has more real objects than the bound. The program is
traced on the device it serves on (tensors it makes carry that device):
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
import torch

from sgaligner_tpu_torch.data.batch import BatchSpec, pool_compact
from sgaligner_tpu_torch.data.synthetic import make_synthetic_batch
from sgaligner_tpu_torch.engine.factory import resolve_device
from sgaligner_tpu_torch.engine.train_step import queue_metrics, serving_metrics

PROGRAM = "serving.pt2"
POOLED_KEYS = ("obj_points_pooled", "pooled_flat_idx", "pooled_mask")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64, "int64": torch.int64, "bool": torch.bool}


class ServingProgram(torch.nn.Module):
    """The module ``torch.export`` traces: the model's serving step on one
    batch, or with ``queue`` > 1 on a stacked batch (every field with a
    leading ``[queue]`` axis)."""

    def __init__(self, model, modules, ks, queue: int = 1, with_sim: bool = False):
        super().__init__()
        self.model = model
        self.modal_names = tuple(modules)
        self.ks = tuple(ks)
        self.queue = queue
        self.with_sim = with_sim

    def forward(self, batch: dict) -> dict:
        if self.queue > 1:
            batches = [{k: v[q] for k, v in batch.items()}
                       for q in range(self.queue)]
            return queue_metrics(self.model, self.modal_names, self.ks, batches)
        return serving_metrics(self.model, self.modal_names, self.ks, batch,
                               self.with_sim)


def _host_to_program(batch: dict, dtypes: dict[str, str]) -> dict[str, torch.Tensor]:
    """numpy fields -> CPU tensors of the program's dtypes (integers as
    int64 index tensors, as ``data.batch.to_device`` gives them; a bfloat16
    field cast on the torch side)."""
    out = {}
    for key, dtype in dtypes.items():
        a = np.ascontiguousarray(batch[key])
        t = torch.from_numpy(a)
        out[key] = t.to(DTYPES[dtype])
    return out


def _example_batch(cfg, batch_size: int, k_pinned: int, points_dtype: str = ""):
    """A pooled synthetic batch at the artifact's shapes (a shape template:
    its pooled axis is cut or padded to the pinned K) and its fields'
    program dtypes."""
    spec = BatchSpec(batch_size=batch_size, max_objects=cfg.tpu.max_objects,
                     points_per_object=cfg.tpu.points_per_object,
                     rel_dim=cfg.model.rel_dim, attr_dim=cfg.model.attr_dim)
    example = pool_compact(make_synthetic_batch(spec, seed=0), bucket=k_pinned)
    for key in POOLED_KEYS:
        arr = example[key]
        if arr.shape[0] > k_pinned:
            example[key] = arr[:k_pinned]
        elif arr.shape[0] < k_pinned:
            pad = [(0, k_pinned - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
            example[key] = np.pad(arr, pad)
    dtypes = {}
    for key, arr in example.items():
        if np.issubdtype(arr.dtype, np.integer):
            dtypes[key] = "int64"
        else:
            dtypes[key] = str(arr.dtype)
    if points_dtype:
        dtypes["obj_points_pooled"] = points_dtype
    return example, dtypes


def export_serving_artifact(cfg, model, out_dir: str, *, batch_size: int,
                            pooled_bucket: int | None = None, queue: int = 1,
                            with_sim: bool = False, points_dtype: str = "",
                            ks: tuple[int, ...] = (1, 2, 3, 4, 5)) -> str:
    """Export the serving step of ``model`` (its weights included) to
    ``out_dir``, traced on the model's device.

    ``pooled_bucket``: the pinned pooled point axis K; None picks the dense
    bound B·2N (always enough). ``queue`` > 1 exports the queue form: the
    loaded artifact then takes a list of ``queue`` host batches a call and
    returns the components summed over them, ``alignment_score`` as
    ``[queue, B]``. ``with_sim`` (single batch only) also returns the per-
    pair similarity matrices. ``points_dtype="bfloat16"`` pins the points
    input in bfloat16 (``prepare`` casts; the model casts points to its
    compute dtype at ingest either way)."""
    if queue > 1 and with_sim:
        raise ValueError("with_sim is single-batch only (queue == 1)")
    if points_dtype not in ("", "float32", "bfloat16"):
        raise ValueError(f"points_dtype {points_dtype!r}: float32 or bfloat16")
    device = next(model.parameters()).device
    two_n = 2 * cfg.tpu.max_objects
    k_pinned = min(int(pooled_bucket or batch_size * two_n), batch_size * two_n)
    example, dtypes = _example_batch(cfg, batch_size, k_pinned, points_dtype)
    program_input = {k: v.to(device) for k, v in
                     _host_to_program(example, dtypes).items()}
    if queue > 1:
        program_input = {k: torch.stack([v] * queue)
                         for k, v in program_input.items()}
    model.train(False)
    wrapper = ServingProgram(model, cfg.modules, ks, queue, with_sim)
    with torch.no_grad():
        program = torch.export.export(wrapper, (program_input,))
    program.example_inputs = None      # the artifact keeps no batch

    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, osp.join(out_dir, PROGRAM))
    meta = {
        "param_dtypes": {k: str(v.dtype).removeprefix("torch.")
                         for k, v in model.state_dict().items()},
        "model_name": cfg.model_name,
        "modules": list(cfg.modules),
        "compute_dtype": cfg.tpu.compute_dtype,
        "batch_size": batch_size,
        "queue": queue,
        "max_objects": cfg.tpu.max_objects,
        "points_per_object": cfg.tpu.points_per_object,
        "pooled_k": k_pinned,
        "ks": list(ks),
        "with_sim": with_sim,
        "device": device.type,
        "batch_keys": {k: [list(example[k].shape), dtypes[k]] for k in example},
    }
    with open(osp.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


class ServingArtifact:
    """A loaded serving artifact: ``art(host_batch)`` runs inference.

    ``host_batch`` is a plain (unpooled) numpy PairBatch; ``prepare`` pools
    it to the artifact's pinned K and checks every static shape against
    meta.json, so shape drift fails at the host boundary, not inside the
    program."""

    def __init__(self, program, meta: dict, device: torch.device):
        self._program = program
        self._module = None
        self.meta = meta
        self.device = device

    def module(self):
        """The program as a module, its weights on the device: built at the
        first call and kept, so a call moves no weights."""
        if self._module is None:
            self._module = self._program.module().to(self.device)
        return self._module

    def prepare(self, host_batch: dict) -> dict[str, torch.Tensor]:
        """Pool to the pinned K, check every field's shape, and cast to the
        program's dtypes (CPU tensors); fields the program does not take
        are dropped."""
        k = self.meta["pooled_k"]
        batch = {kk: np.asarray(v) for kk, v in host_batch.items()}
        if "obj_points_pooled" not in batch:
            batch = pool_compact(batch, bucket=k)
        got_k = batch["obj_points_pooled"].shape[0]
        if got_k != k:
            raise ValueError(
                f"batch pools to K={got_k} but the artifact was exported "
                f"with K={k}: too many real objects for the pinned bound "
                f"(re-export with a larger pooled_bucket)")
        dtypes = {}
        for key, (shape, dtype) in self.meta["batch_keys"].items():
            if key not in batch:
                raise KeyError(f"serving batch missing field '{key}'")
            if list(batch[key].shape) != shape:
                raise ValueError(
                    f"field '{key}': shape {list(batch[key].shape)} != "
                    f"exported {shape}")
            dtypes[key] = dtype
        return _host_to_program(batch, dtypes)

    def __call__(self, host_batch) -> dict:
        """Single-batch artifact: one host PairBatch dict. Queue artifact
        (meta['queue'] > 1): a list of exactly that many host batches."""
        q = self.meta.get("queue", 1)
        if q > 1:
            if not isinstance(host_batch, (list, tuple)) or len(host_batch) != q:
                got = (len(host_batch) if isinstance(host_batch, (list, tuple))
                       else "n/a")
                raise ValueError(
                    f"queue artifact expects a list of {q} batches, got "
                    f"{type(host_batch).__name__} of length {got}")
            prepared = [self.prepare(b) for b in host_batch]
            batch = {k: torch.stack([p[k] for p in prepared])
                     for k in prepared[0]}
        else:
            batch = self.prepare(host_batch)
        module = self.module()
        batch = {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}
        with torch.inference_mode():
            return module(batch)


def load_serving_artifact(art_dir: str, device: str | torch.device | None = None
                          ) -> ServingArtifact:
    """Load an artifact to serve on ``device`` (default: the device it was
    exported for). The kernels' ops are registered first."""
    from sgaligner_tpu_torch.ops import library

    library.load()
    with open(osp.join(art_dir, "meta.json")) as f:
        meta = json.load(f)
    device = resolve_device(device if device is not None else meta["device"])
    if device.type != meta["device"]:
        raise ValueError(f"artifact was exported for {meta['device']}, not "
                         f"{device.type}: export it again on that device")
    program = torch.export.load(osp.join(art_dir, PROGRAM))
    return ServingArtifact(program, meta, device)
