"""Batch loaders: shuffled / sequential iterators over a dataset of padded pairs.

A copy of ``sgaligner_tpu/data/loaders.py`` (``BatchLoader``,
``get_train_val_data_loader``, ``get_val_dataloader``): a thread pool reads
items (npy / pkl reads and padding) ahead of the consumer, and batches come
out as numpy PairBatches; the tester moves each to the device with
``data.batch.to_device``. The train loader shuffles per epoch and drops the
last partial batch; val keeps order and yields the last batch short.

``cfg.tpu.pooled_bucket > 0`` pools each batch with
``data.batch.pool_compact_sharded`` at ``cfg.tpu.dp`` (``pool_compact``
for one rank): under data parallel every rank builds the same whole batch
from the same seed, pooled per rank's block, and takes its block with
``parallel.mesh.shard_batch``. The per-pair compacted layout
(``cfg.tpu.compact_slots > 0``) is not ported and raises.
"""

from __future__ import annotations

from collections.abc import Iterator
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from sgaligner_tpu_torch.core.config import Config
from sgaligner_tpu_torch.data.batch import collate, pool_compact_sharded
from sgaligner_tpu_torch.data.scan3r import Scan3RDataset


class BatchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 drop_last: bool, seed: int = 42, num_workers: int = 4,
                 transform=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.num_workers = max(1, num_workers)
        self.transform = transform  # post-collate host transform (pooling)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        if self.drop_last:
            order = order[: len(order) - len(order) % self.batch_size]

        chunks = [order[i : i + self.batch_size]
                  for i in range(0, len(order), self.batch_size)]
        if self.num_workers > 1:
            # bounded prefetch: about twice the workers' batches in flight
            depth = 2 * self.num_workers
            with ThreadPoolExecutor(self.num_workers) as pool:
                futures = [pool.submit(self._load_chunk, c)
                           for c in chunks[:depth]]
                next_chunk = depth
                for i in range(len(chunks)):
                    yield futures[i].result()
                    futures[i] = None  # release the batch
                    if next_chunk < len(chunks):
                        futures.append(pool.submit(self._load_chunk,
                                                   chunks[next_chunk]))
                        next_chunk += 1
        else:
            for c in chunks:
                yield self._load_chunk(c)

    def _load_chunk(self, idxs) -> dict[str, np.ndarray]:
        batch = collate([self.dataset[int(i)] for i in idxs])
        return self.transform(batch) if self.transform else batch


def _pool_transform(cfg: Config):
    """Batch-pooled compaction when ``cfg.tpu.pooled_bucket > 0``, per
    rank's block when ``cfg.tpu.dp > 1``."""
    if cfg.tpu.compact_slots > 0:
        raise NotImplementedError("tpu.compact_slots > 0: the per-pair compacted "
                                  "layout is not ported yet; use pooled_bucket")
    bucket = cfg.tpu.pooled_bucket
    if bucket <= 0:
        return None
    dp = max(cfg.tpu.dp, 1)
    return lambda b: pool_compact_sharded(b, bucket, dp)


def get_train_val_data_loader(cfg: Config, dataset_cls=Scan3RDataset):
    tf = _pool_transform(cfg)
    train_ds = dataset_cls(cfg, split="train")
    val_ds = dataset_cls(cfg, split="val")
    train = BatchLoader(train_ds, cfg.train.batch_size, shuffle=True,
                        drop_last=True, seed=cfg.seed,
                        num_workers=cfg.num_workers, transform=tf)
    val = BatchLoader(val_ds, cfg.val.batch_size, shuffle=False,
                      drop_last=False, seed=cfg.seed,
                      num_workers=cfg.num_workers, transform=tf)
    return train, val


def get_val_dataloader(cfg: Config, dataset_cls=Scan3RDataset):
    tf = _pool_transform(cfg)
    val_ds = dataset_cls(cfg, split="val")
    return BatchLoader(val_ds, cfg.val.batch_size, shuffle=False,
                       drop_last=False, seed=cfg.seed,
                       num_workers=cfg.num_workers, transform=tf)
