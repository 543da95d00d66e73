"""Data loading (the port's copy of ``deepspeed_tpu/runtime/dataloader.py``,
after upstream ``DeepSpeedDataLoader`` and ``RepeatingLoader``).

A dataset is a dict of arrays, a sequence of samples (arrays or dicts of
arrays) or anything indexable with a length; a batch is a dict of numpy
arrays with the global batch as its leading dim, which the engine moves to
its device. The order is the JAX package's: a numpy ``default_rng(seed +
epoch)`` permutation, so the same dataset, seed, epoch and ``drop_last``
give the same batches in both packages.
"""

from typing import Callable, Optional

import numpy as np


class DeepSpeedDataLoader:

    def __init__(self, dataset, batch_size: int, collate_fn: Optional[Callable] = None,
                 shuffle: bool = True, drop_last: bool = False, seed: int = 1234):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        if isinstance(dataset, dict):
            self._n = len(next(iter(dataset.values())))
        else:
            self._n = len(dataset)
        self.len = self._n // batch_size if drop_last else (self._n + batch_size - 1) // batch_size

    def __len__(self):
        return self.len

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        order = np.arange(self._n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        for start in range(0, self._n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if len(idx) < self.batch_size:
                if self.drop_last:
                    return
                # the last batch wraps around, so every batch has the full size
                idx = np.concatenate([idx, order[:self.batch_size - len(idx)]])
            yield self._gather(idx)
        self.epoch += 1

    def _gather(self, idx):
        if isinstance(self.dataset, dict):
            batch = {k: np.asarray(v)[idx] for k, v in self.dataset.items()}
        else:
            samples = [self.dataset[int(i)] for i in idx]
            if self.collate_fn is not None:
                return self.collate_fn(samples)
            if isinstance(samples[0], dict):
                batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
            else:
                batch = {"input_ids": np.stack(samples)}
        if self.collate_fn is not None:
            return self.collate_fn(batch)
        return batch


class RepeatingLoader:
    """An iterator over ``loader`` that starts it again at its end."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        return batch
