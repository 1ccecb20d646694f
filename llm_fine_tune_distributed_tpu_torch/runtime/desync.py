"""Cross-rank parameter-desync detection (counterpart of the JAX
``runtime/desync.py``).

Every N steps each rank sums its trainable leaves in float64 into one
checksum, and the ranks all-gather them (one small tensor). Two invariants:

1. finiteness: a NaN or Inf in any rank's trainable leaves fails;
2. replication agreement: a trainable leaf that is whole on every rank
   must be bit-equal everywhere, so the ranks' checksums of those leaves
   must be; under ZeRO-3 (``parallel/optimizer.FsdpShards``) the fsdp
   slices are checksummed apart, and must agree between the ranks that
   hold the same slice (the replicas of a data axis beside fsdp); under
   tensor parallelism the tensor slices (fsdp-sliced or not) are a third
   checksum, which must agree between the ranks of one (fsdp, tensor)
   coordinate, while the leaves every rank holds whole (norms, LoRA
   factors) must agree across every rank. A mismatch means that replicas
   which should be identical diverged (input skew, a restore mixup, a bit
   flip).

The verdict is taken from the gathered checksums, the same on every rank,
so a fault on one rank fails every rank at the same step (the JAX check
returns early on a non-finite local sum, before its gather).
"""

from __future__ import annotations

from dataclasses import replace
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
                     rtol: float = 0.0, tensor=None, mesh=None) -> Tuple[bool, List[float]]:
    """(in_sync, every rank's checksum of its whole leaves). A collective:
    every rank calls it. With ``shards`` the fsdp slices' checksums must
    agree between the ranks of the same fsdp index, with ``tensor`` the
    tensor slices' between the ranks of the same fsdp and tensor indices:
    the ranks' coordinates are ``mesh``'s."""
    tsliced = set(tensor.shapes) if tensor is not None else set()
    fsliced = (set(shards.dims) if shards is not None else set()) - tsliced
    dev = next(iter(trainable.values())).device if trainable else torch.device("cpu")
    parts = [local_checksum({k: v for k, v in trainable.items()
                             if k not in fsliced and k not in tsliced}).to(dev)]
    for keys in (fsliced, tsliced):
        if keys:
            parts.append(local_checksum({k: v for k, v in trainable.items() if k in keys}).to(dev))
    sums = all_gather_tensor(torch.cat(parts)).cpu().numpy()  # [world, 1 to 3]
    whole = sums[:, 0]
    if not np.isfinite(sums).all():
        return False, whole.tolist()
    ok = _agree(whole, rtol)
    col = 1
    if fsliced:
        ok = ok and _agree_within(sums[:, col], mesh, ("fsdp",), rtol)
        col += 1
    if tsliced:
        ok = ok and _agree_within(sums[:, col], mesh, ("fsdp", "tensor"), rtol)
    return ok, whole.tolist()


def _agree_within(sums: np.ndarray, mesh, axes, rtol: float) -> bool:
    """Every set of ranks that share their coordinates on ``axes`` agrees."""
    keys: Dict[tuple, list] = {}
    for r in range(len(sums)):
        c = replace(mesh, rank=r).coords
        keys.setdefault(tuple(c[a] for a in axes), []).append(sums[r])
    return all(_agree(np.asarray(v), rtol) for v in keys.values())


class DesyncMonitor:
    """Step-cadenced wrapper used by the trainer (``desync_check_steps``)."""

    def __init__(self, every_n_steps: int):
        self.every = every_n_steps
        self.last_checksums: list = []
        self.checks = 0

    def maybe_check(self, step: int, trainable: Dict[str, torch.Tensor], shards=None,
                    tensor=None, mesh=None) -> bool:
        if not self.every or step % self.every:
            return True
        ok, sums = check_param_sync(trainable, shards, tensor=tensor, mesh=mesh)
        self.last_checksums = sums
        self.checks += 1
        if not ok:
            raise RuntimeError(
                f"parameter desync/corruption detected at step {step}: per-rank checksums {sums}")
        return ok
