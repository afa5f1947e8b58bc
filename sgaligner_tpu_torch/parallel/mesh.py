"""Data parallel over ranks: one process per rank, parameters replicated,
each rank one contiguous block of B/dp pairs.

Counterpart of ``sgaligner_tpu/parallel/mesh.py``. There one program spans
a 1-D ``dp`` device mesh and GSPMD inserts the reductions. Here each rank
is a process of a ``torch.distributed`` group (``torchrun``, or
``parallel.launch.run_ranks``; the caller picks the backend) that runs the
model on its block, and the port calls the collectives itself, always
between kernel launches:

* every batch-statistics BatchNorm sums its valid-row count and its masked
  Σ and Σ² over the ranks before the moments, the sums the kernels return
  included (``models/pct.py``; inside ``ops/pct_attention.py``
  ``BlockResidual``, between the block's forward kernel and its fold);
* the objective runs on every rank, on the embeddings of all ranks
  gathered in pair order (``engine/train_step.py``);
* the parameters' gradients are summed over the ranks once, after the
  backward.

So a dp = N step is the dp = 1 step on the same global batch. Each
collective's backward is its adjoint: ``all_reduce_sum`` answers with the
sum of the cotangents, ``gather_rows`` with the sum of the cotangents of
the rank's rows. Each rank back-propagates 1/dp of the loss, so what every
rank computes alike (the loss, the BatchNorm folds) counts once in the
summed gradients, and a backward that sums over its rank's rows (a kernel's
epilogue sums, a BatchNorm's parameter gradients) returns the rank's share.

Only ``all_reduce`` and ``broadcast`` are used: a gather is an
``all_reduce`` into a zeroed buffer in which each rank fills its own rows.
The same code then runs on NCCL across cards and on gloo, which takes CUDA
tensors for those two collectives, with ranks that share a card.

Every helper takes the mesh; ``None`` or ``Mesh()`` (one rank) makes it
the identity.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from sgaligner_tpu_torch.data.batch import POOLED_KEYS, pad_batch_to


@dataclass(frozen=True)
class Mesh:
    """``dp`` ranks of the process group ``group`` (None: the default
    group); ``rank`` is this process's."""

    dp: int = 1
    rank: int = 0
    group: Any = None

    def block(self, n: int) -> slice:
        """This rank's rows of an axis of ``dp · n`` rows."""
        return slice(self.rank * n, (self.rank + 1) * n)


def sharded(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.dp > 1


def dp_size(mesh: Mesh | None) -> int:
    return mesh.dp if mesh is not None else 1


def make_mesh(dp: int = 0) -> Mesh:
    """The default process group's ranks as a mesh. ``dp`` is its world
    size: ``dp = 0`` takes it, any other value must equal it (one rank
    without a group). ``dp > 1`` without a process group raises."""
    joined = dist.is_available() and dist.is_initialized()
    if dp > 1 and not joined:
        raise RuntimeError(f"tpu.dp = {dp} needs a torch.distributed process group: "
                           "launch one process per rank (torchrun)")
    world = dist.get_world_size() if joined else 1
    if dp <= 0:
        dp = world
    if dp != world:
        raise ValueError(f"tpu.dp = {dp}, but the process group has {world} ranks")
    return Mesh(dp, dist.get_rank()) if dp > 1 else Mesh()


def init_from_launcher(backend: str) -> int | None:
    """Under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment) join its
    process group over ``backend`` and return this rank's ``LOCAL_RANK``;
    otherwise None. The backend is the caller's choice."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None
    if not dist.is_initialized():
        dist.init_process_group(backend=backend)
    return int(os.environ.get("LOCAL_RANK", "0"))


def leave_launcher() -> None:
    """Leave the process group ``init_from_launcher`` joined, if any."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def rank_device(device: str, local_rank: int | None) -> str:
    """``cuda`` under a launcher is the card of this rank's ``LOCAL_RANK``;
    any other name (``cuda:0`` for ranks that share a card, ``cpu``) is
    taken as it is."""
    return f"cuda:{local_rank}" if device == "cuda" and local_rank is not None else device


def validate_compact_bound(batch: dict, compact_slots: int) -> None:
    """Per-pair compaction drops slots beyond the bound: raise instead."""
    if compact_slots <= 0:
        return
    per_pair = np.asarray(batch["obj_mask"]).sum(axis=1)
    worst = int(per_pair.max()) if len(per_pair) else 0
    if worst > compact_slots:
        raise ValueError(f"a pair has {worst} real objects > tpu.compact_slots="
                         f"{compact_slots}; raise the bound or disable compaction")


def shard_batch(batch: dict, mesh: Mesh | None, pad: bool = True) -> dict:
    """This rank's block of a host batch (numpy leaves): pairs
    ``[r·B/dp, (r+1)·B/dp)`` of every pair-axis leaf and, in the pooled
    layout, rows ``[r·K/dp, (r+1)·K/dp)`` of the pooled fields, with
    ``pooled_flat_idx`` local to the block (masked rows point at slot 0).
    An unpooled batch whose pair count dp does not divide is padded with
    empty pairs first (``pad`` False raises instead). The pooled rows must
    come from ``pool_compact_sharded(dp=mesh.dp)``: rows that reference
    another block's pairs raise."""
    if not sharded(mesh):
        return batch
    dp = mesh.dp
    b, two_n = np.asarray(batch["obj_mask"]).shape
    pooled = "obj_points_pooled" in batch
    if b % dp != 0:
        if pooled or not pad:
            raise ValueError(f"{b} pairs do not split over dp={dp}: build the batch "
                             "with data.batch.pool_compact_sharded(dp=dp)")
        batch = pad_batch_to(batch, -(-b // dp) * dp)
        b = batch["obj_mask"].shape[0]
    bs = b // dp
    out = {k: np.asarray(v)[mesh.block(bs)] for k, v in batch.items()
           if k not in POOLED_KEYS}
    if not pooled:
        return out
    k = batch["obj_points_pooled"].shape[0]
    if k % dp != 0:
        raise ValueError(f"pooled object axis ({k}) not divisible by dp={dp}: build "
                         "the batch with data.batch.pool_compact_sharded(dp=dp)")
    rows = mesh.block(k // dp)
    mask = np.asarray(batch["pooled_mask"])[rows]
    flat = np.asarray(batch["pooled_flat_idx"])
    idx = flat[rows].astype(np.int64) - mesh.rank * bs * two_n
    live = idx[mask]
    if len(live) and (live.min() < 0 or live.max() >= bs * two_n):
        raise ValueError(f"rank {mesh.rank}'s pooled rows reference pairs of another "
                         "rank: build the batch with data.batch.pool_compact_sharded"
                         f"(dp={dp})")
    out["obj_points_pooled"] = np.asarray(batch["obj_points_pooled"])[rows]
    out["pooled_flat_idx"] = np.where(mask, idx, 0).astype(flat.dtype)
    out["pooled_mask"] = mask
    return out


def shard_queue(stacked: dict, mesh: Mesh | None) -> dict:
    """This rank's block of a stacked serving queue (``[Q, ...]`` leaves
    from ``data.batch.stack_queue(batches, dp)``): ``shard_batch`` of each
    queued batch, stacked again."""
    if not sharded(mesh):
        return stacked
    q = len(next(iter(stacked.values())))
    parts = [shard_batch({k: v[i] for k, v in stacked.items()}, mesh, pad=False)
             for i in range(q)]
    return {k: np.stack([p[k] for p in parts]) for k in parts[0]}


# dtypes that travel as another: half-precision sums are taken at f32, and
# flags (which the backends do not sum) as integers
_WIRE = {torch.bfloat16: torch.float32, torch.float16: torch.float32,
         torch.bool: torch.int64}


def reduce_sum(mesh: Mesh | None, tensors) -> list[torch.Tensor]:
    """The sums over the ranks of ``tensors``, as new tensors of their
    dtypes and shapes: one ``all_reduce`` per device and wire dtype. Not
    differentiable (``all_reduce_sum`` is)."""
    tensors = list(tensors)
    if not sharded(mesh):
        return tensors
    out: list = [None] * len(tensors)
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((_WIRE.get(t.dtype, t.dtype), t.device), []).append(i)
    for (wire, _), idx in groups.items():
        flat = torch.cat([tensors[i].detach().reshape(-1).to(wire) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        parts = torch.split(flat, [tensors[i].numel() for i in idx])
        for i, part in zip(idx, parts):
            out[i] = part.view(tensors[i].shape).to(tensors[i].dtype)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        return tuple(reduce_sum(mesh, tensors))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *reduce_sum(ctx.mesh, grads))


def all_reduce_sum(mesh: Mesh | None, *tensors) -> tuple[torch.Tensor, ...]:
    """The sums over the ranks of ``tensors``, differentiable: the backward
    sums the cotangents over the ranks."""
    if not sharded(mesh):
        return tensors
    return _AllReduceSum.apply(mesh, *tensors)


def _gather(mesh: Mesh, tensors) -> list[torch.Tensor]:
    bufs = []
    for t in tensors:
        n = t.shape[0]
        buf = torch.zeros((mesh.dp * n,) + tuple(t.shape[1:]),
                          dtype=_WIRE.get(t.dtype, t.dtype), device=t.device)
        buf[mesh.block(n)] = t.detach()
        bufs.append(buf)
    return [s.to(t.dtype) for s, t in zip(reduce_sum(mesh, bufs), tensors)]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh, ctx.rows = mesh, [t.shape[0] for t in tensors]
        return tuple(_gather(mesh, tensors))

    @staticmethod
    def backward(ctx, *grads):
        summed = reduce_sum(ctx.mesh, grads)
        return (None, *(s[ctx.mesh.block(n)] for s, n in zip(summed, ctx.rows)))


def gather_rows(mesh: Mesh | None, *tensors) -> tuple[torch.Tensor, ...]:
    """Every rank's ``tensors`` concatenated along axis 0 in rank order
    (the whole batch in pair order), on every rank; differentiable for
    floating tensors, the backward the sum over the ranks of the cotangents
    of this rank's rows."""
    if not sharded(mesh):
        return tensors
    if all(t.is_floating_point() for t in tensors):
        return _GatherRows.apply(mesh, *tensors)
    return tuple(_gather(mesh, tensors))


def rand_rows(mesh: Mesh | None, shape, generator: torch.Generator | None,
              device) -> torch.Tensor:
    """``torch.rand`` of the whole batch's shape ``(dp·shape[0], ...)`` from
    ``generator``, this rank's rows: every rank draws the numbers one rank
    would draw for the whole batch."""
    if not sharded(mesh):
        return torch.rand(shape, generator=generator, device=device)
    full = torch.rand((mesh.dp * shape[0],) + tuple(shape[1:]), generator=generator,
                      device=device)
    return full[mesh.block(shape[0])]


@torch.no_grad()
def broadcast_(mesh: Mesh | None, tensors) -> None:
    """Overwrite ``tensors`` on every rank with rank 0's, in place."""
    if not sharded(mesh):
        return
    src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
    for t in tensors:
        wire = t.to(_WIRE.get(t.dtype, t.dtype))
        dist.broadcast(wire, src=src, group=mesh.group)
        t.copy_(wire)


def barrier(mesh: Mesh | None, device) -> None:
    """Return on every rank only once every rank has reached this call (an
    ``all_reduce`` of one value on ``device``)."""
    if sharded(mesh):
        reduce_sum(mesh, [torch.zeros(1, device=device)])
