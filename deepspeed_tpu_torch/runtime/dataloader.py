"""Data loading of the training front door.

Counterpart of ``deepspeed_tpu/runtime/dataloader.py`` (``RepeatingLoader``,
``DeepSpeedDataLoader``), line for line: a dataset is any indexable of
``dict[str, array]`` samples; the loader batches ``batch_size`` of them (the
global micro batch: the micro batch a rank times the data ranks, whose rows
``DataParallelEngine`` splits), in an order shuffled by
``np.random.default_rng(seed + epoch)`` (``seed`` 0 by default, not the
engine's), dropping a short last batch by default, each batch a dict of
numpy arrays stacked with ``np.stack``, which ``DeepSpeedEngine``'s
``_prepare_batch`` takes.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Sequence

import numpy as np


class RepeatingLoader:
    """Wrap an iterable so that it restarts when it runs out."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class DeepSpeedDataLoader:

    def __init__(self, dataset: Sequence[Dict[str, Any]], batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 collate_fn=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn or self._default_collate
        self.epoch = 0

    @staticmethod
    def _default_collate(samples):
        keys = samples[0].keys()
        return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in keys}

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        for start in range(0, len(order) - (self.batch_size - 1 if self.drop_last else 0),
                           self.batch_size):
            idx = order[start:start + self.batch_size]
            if len(idx) == 0:
                break
            yield self.collate_fn([self.dataset[int(i)] for i in idx])
