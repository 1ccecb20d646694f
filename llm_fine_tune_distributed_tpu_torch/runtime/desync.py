"""Cross-rank parameter-desync detection (counterpart of the JAX
``runtime/desync.py``).

Every N steps each rank sums its trainable leaves in float64 into one
checksum, and the ranks all-gather them (one small tensor). Two invariants:

1. finiteness: a NaN or Inf in any rank's trainable leaves fails;
2. replication agreement: a trainable leaf that is whole on every rank
   must be bit-equal everywhere, so the ranks' checksums of those leaves
   must be; under ZeRO-3 (``parallel/optimizer.FsdpShards``) the fsdp
   slices are checksummed apart, and must agree between the ranks that
   hold the same slice (the replicas of a data axis beside fsdp). A
   mismatch means that replicas which should be identical diverged (input
   skew, a restore mixup, a bit flip).

The verdict is taken from the gathered checksums, the same on every rank,
so a fault on one rank fails every rank at the same step (the JAX check
returns early on a non-finite local sum, before its gather).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from llm_fine_tune_distributed_tpu_torch.runtime.distributed import all_gather_tensor

_CHUNK = 1 << 24  # elements per float64 partial sum


def local_checksum(trainable: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The float64 sum of every trainable leaf (sorted by name), on their
    device, chunk by chunk so that the float64 copy stays small. ``sum``,
    not ``nansum``: a NaN must propagate."""
    total = None
    for name in sorted(trainable):
        flat = trainable[name].detach().reshape(-1)
        for lo in range(0, flat.numel(), _CHUNK):
            s = flat[lo: lo + _CHUNK].double().sum()
            total = s if total is None else total + s
    if total is None:
        return torch.zeros(1, dtype=torch.float64)
    return total.reshape(1)


def _agree(sums: np.ndarray, rtol: float) -> bool:
    return bool(np.all(np.abs(sums - sums[0]) <= abs(sums[0]) * rtol))


def check_param_sync(trainable: Dict[str, torch.Tensor], shards=None,
                     rtol: float = 0.0) -> Tuple[bool, List[float]]:
    """(in_sync, every rank's checksum of its whole leaves). A collective:
    every rank calls it. With ``shards`` the slices' checksums must agree
    between the ranks of the same fsdp index."""
    sliced = set(shards.dims) if shards is not None else set()
    dev = next(iter(trainable.values())).device if trainable else torch.device("cpu")
    mine = local_checksum({k: v for k, v in trainable.items() if k not in sliced}).to(dev)
    if sliced:
        part = local_checksum({k: v for k, v in trainable.items() if k in sliced})
        mine = torch.cat([mine, part.to(dev)])
    sums = all_gather_tensor(mine).cpu().numpy()  # [world, 1 or 2]
    whole = sums[:, 0]
    if not np.isfinite(sums).all():
        return False, whole.tolist()
    ok = _agree(whole, rtol)
    if sliced:
        count = shards.count
        ok = ok and all(_agree(sums[f::count, 1], rtol) for f in range(count))
    return ok, whole.tolist()


class DesyncMonitor:
    """Step-cadenced wrapper used by the trainer (``desync_check_steps``)."""

    def __init__(self, every_n_steps: int):
        self.every = every_n_steps
        self.last_checksums: list = []
        self.checks = 0

    def maybe_check(self, step: int, trainable: Dict[str, torch.Tensor], shards=None) -> bool:
        if not self.every or step % self.every:
            return True
        ok, sums = check_param_sync(trainable, shards)
        self.last_checksums = sums
        self.checks += 1
        if not ok:
            raise RuntimeError(
                f"parameter desync/corruption detected at step {step}: per-rank checksums {sums}")
        return ok
