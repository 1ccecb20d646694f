"""Batch loader for one process (counterpart of the JAX ``data/loader.py``
``SFTBatchLoader``): the epoch order is ``RandomState(seed +
epoch).permutation(n)``, each optimizer step takes the next
``batch * accum`` rows laid out ``[accum, batch, ...]``, and a trailing
partial batch is dropped (or, without ``drop_last``, wrap-padded). The JAX
loader's multi-host sharding and ``shuffle=False`` are not ported."""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class SFTBatchLoader:
    def __init__(self, arrays: Dict[str, np.ndarray], *, per_device_batch_size: int,
                 grad_accum_steps: int = 1, seed: int = 42, drop_last: bool = True):
        self.arrays = arrays
        self.n = next(iter(arrays.values())).shape[0]
        self.grad_accum = grad_accum_steps
        self.seed = seed
        self.drop_last = drop_last
        self.global_batch = per_device_batch_size * grad_accum_steps
        if self.global_batch > self.n:
            raise ValueError(f"global batch {self.global_batch} exceeds dataset size {self.n}")

    @property
    def steps_per_epoch(self) -> int:
        if self.drop_last:
            return self.n // self.global_batch
        return int(np.ceil(self.n / self.global_batch))

    def epoch(self, epoch_idx: int) -> Iterator[Dict[str, np.ndarray]]:
        """Yield batches ``[grad_accum, batch, ...]`` of every array but
        ``lengths``."""
        order = np.random.RandomState(self.seed + epoch_idx).permutation(self.n)
        for s in range(self.steps_per_epoch):
            idx = order[s * self.global_batch:(s + 1) * self.global_batch]
            if len(idx) < self.global_batch:
                idx = np.concatenate([idx, order[: self.global_batch - len(idx)]])
            idx = idx.reshape(self.grad_accum, -1)
            yield {k: v[idx] for k, v in self.arrays.items() if k != "lengths"}

    def __len__(self) -> int:
        return self.steps_per_epoch
