"""Cross-rank parameter-desync detection (counterpart of the JAX
``runtime/desync.py``).

Every N steps each rank sums its trainable leaves in float64 into one
checksum, and the ranks all-gather them (one small tensor). Two invariants:

1. finiteness: a NaN or Inf in any rank's trainable leaves fails;
2. replication agreement: every trainable leaf is whole and replicated on
   every rank (the fsdp axis shards only the optimizer state), so every
   rank's checksum must be bit-equal; a mismatch means that replicas which
   should be identical diverged (input skew, a restore mixup, a bit flip).

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


def check_param_sync(trainable: Dict[str, torch.Tensor], rtol: float = 0.0) -> Tuple[bool, List[float]]:
    """(in_sync, every rank's checksum). A collective: every rank calls it."""
    sums = all_gather_tensor(local_checksum(trainable)).reshape(-1).cpu().numpy()
    if not np.isfinite(sums).all():
        return False, sums.tolist()
    ref = sums[0]
    return bool(np.all(np.abs(sums - ref) <= abs(ref) * rtol)), sums.tolist()


class DesyncMonitor:
    """Step-cadenced wrapper used by the trainer (``desync_check_steps``)."""

    def __init__(self, every_n_steps: int):
        self.every = every_n_steps
        self.last_checksums: list = []
        self.checks = 0

    def maybe_check(self, step: int, trainable: Dict[str, torch.Tensor]) -> bool:
        if not self.every or step % self.every:
            return True
        ok, sums = check_param_sync(trainable)
        self.last_checksums = sums
        self.checks += 1
        if not ok:
            raise RuntimeError(
                f"parameter desync/corruption detected at step {step}: per-rank checksums {sums}")
        return ok
