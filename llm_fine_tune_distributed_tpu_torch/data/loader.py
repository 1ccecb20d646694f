"""Batch loader (counterpart of the JAX ``data/loader.py``
``SFTBatchLoader``): the epoch order is ``RandomState(seed +
epoch).permutation(n)`` (or ``arange`` without ``shuffle``), each optimizer
step takes the next ``batch * accum * dp`` rows laid out ``[accum, batch *
dp, ...]``, and a trailing partial batch is dropped (or, without
``drop_last``, wrap-padded).

Each process takes a contiguous block of columns of that layout: rows
``[row_start, row_start + row_count)`` when the trainer derives them from
the mesh, else the ``process_index``-th of ``process_count`` equal blocks,
exactly as the JAX loader does. ``global_epoch`` yields the whole
``[accum, batch * dp]`` batch, from which the trainer counts the global
microbatches' tokens without a collective; ``epoch`` yields this process's
columns of it.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


class SFTBatchLoader:
    def __init__(self, arrays: Dict[str, np.ndarray], *, per_device_batch_size: int,
                 grad_accum_steps: int = 1, data_parallel_size: int = 1, process_index: int = 0,
                 process_count: int = 1, seed: int = 42, drop_last: bool = True,
                 shuffle: bool = True, row_start: Optional[int] = None,
                 row_count: Optional[int] = None):
        self.arrays = arrays
        self.n = next(iter(arrays.values())).shape[0]
        self.per_device_batch_size = per_device_batch_size
        self.grad_accum = grad_accum_steps
        self.dp = data_parallel_size
        self.process_index = process_index
        self.process_count = process_count
        self.seed = seed
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.global_batch = per_device_batch_size * grad_accum_steps * data_parallel_size
        if self.global_batch > self.n:
            raise ValueError(f"global batch {self.global_batch} exceeds dataset size {self.n}")
        if row_count is not None:
            self.per_host_batch = row_count
            self.row_start = row_start or 0
        else:
            if (per_device_batch_size * data_parallel_size) % process_count:
                raise ValueError(f"batch {per_device_batch_size}x{data_parallel_size} not "
                                 f"divisible by {process_count} hosts")
            self.per_host_batch = per_device_batch_size * data_parallel_size // process_count
            self.row_start = process_index * self.per_host_batch

    @property
    def steps_per_epoch(self) -> int:
        if self.drop_last:
            return self.n // self.global_batch
        return int(np.ceil(self.n / self.global_batch))

    def global_epoch(self, epoch_idx: int) -> Iterator[Dict[str, np.ndarray]]:
        """Yield the global batches ``[grad_accum, batch * dp, ...]`` of
        every array but ``lengths``."""
        if self.shuffle:
            order = np.random.RandomState(self.seed + epoch_idx).permutation(self.n)
        else:
            order = np.arange(self.n)
        for s in range(self.steps_per_epoch):
            idx = order[s * self.global_batch:(s + 1) * self.global_batch]
            if len(idx) < self.global_batch:
                idx = np.concatenate([idx, order[: self.global_batch - len(idx)]])
            idx = idx.reshape(self.grad_accum, -1)
            yield {k: v[idx] for k, v in self.arrays.items() if k != "lengths"}

    def local_rows(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """This process's columns ``[:, row_start:row_start + row_count]``
        of a global batch."""
        lo, hi = self.row_start, self.row_start + self.per_host_batch
        return {k: v[:, lo:hi] for k, v in batch.items()}

    def epoch(self, epoch_idx: int) -> Iterator[Dict[str, np.ndarray]]:
        """Yield this process's batches ``[grad_accum, per_host_batch, ...]``."""
        for batch in self.global_epoch(epoch_idx):
            yield self.local_rows(batch)

    def __len__(self) -> int:
        return self.steps_per_epoch
