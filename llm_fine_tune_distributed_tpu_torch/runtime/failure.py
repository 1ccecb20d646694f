"""Failure detector: the Python side of the native heartbeat mesh
(``native/heartbeat.cc``; counterpart of the JAX ``runtime/failure.py``).

Rank 0 runs a TCP coordinator, every rank heartbeats into it, and the
trainer polls ``dead_ranks()`` between steps, so a wedged or silent rank is
detected (and the run stops for the job manager to restart it) instead of
hanging in a collective until the process group's timeout.
``for_group`` starts one on every rank of the process group: rank 0's
coordinator may bind port 0 (an ephemeral port), which it broadcasts.
"""

from __future__ import annotations

import os
from typing import List, Optional

from llm_fine_tune_distributed_tpu_torch.runtime import native
from llm_fine_tune_distributed_tpu_torch.runtime.distributed import (
    agree,
    broadcast_int,
    process_count,
    process_index,
)


class FailureDetector:
    """Start on every rank; rank 0 also hosts the coordinator.
    ``coordinator_host`` plays MASTER_ADDR's role, ``port`` the heartbeat's
    (0: an ephemeral port, read back on ``self.port``)."""

    def __init__(self, *, rank: int, world_size: int, coordinator_host: str = "127.0.0.1",
                 port: int = 23457, interval_ms: int = 500, timeout_ms: int = 5000):
        self._lib = native.load()
        if self._lib is None:
            raise RuntimeError(f"native heartbeat unavailable: {native.build_error()}")
        self.rank, self.world_size, self.timeout_ms = rank, world_size, timeout_ms
        self._coord = self._worker = None
        if rank == 0:
            self._coord = self._lib.hb_start_coordinator(port, world_size)
            if not self._coord:
                raise RuntimeError(f"heartbeat coordinator failed to bind port {port}")
            port = self._lib.hb_coordinator_port(self._coord)
        self.port = port
        self._worker = self._lib.hb_start_worker(coordinator_host.encode(), port, rank,
                                                 interval_ms)

    @classmethod
    def for_group(cls, device, *, port: int = 23457, interval_ms: int = 500,
                  timeout_ms: int = 5000) -> "FailureDetector":
        """One detector on every rank of the process group (a collective:
        every rank calls it), its coordinator on rank 0 at ``port`` (0:
        ephemeral) and ``MASTER_ADDR``; every rank raises ``RuntimeError``
        together when any rank cannot build the library or rank 0 cannot
        bind."""
        rank, world = process_index(), process_count()
        built = agree([native.load() is not None], device, every=True)[0]
        if not built:
            raise RuntimeError(f"native heartbeat unavailable on a rank: {native.build_error()}")
        det, error = None, None
        if rank == 0:
            try:
                det = cls(rank=0, world_size=world, port=port, interval_ms=interval_ms,
                          timeout_ms=timeout_ms)
            except RuntimeError as e:
                error = e
        bound = broadcast_int(det.port if det is not None else None, device)
        if bound is None:
            raise error or RuntimeError(f"heartbeat coordinator failed to bind port {port}")
        if det is None:
            det = cls(rank=rank, world_size=world, port=bound, interval_ms=interval_ms,
                      timeout_ms=timeout_ms,
                      coordinator_host=os.environ.get("MASTER_ADDR", "127.0.0.1"))
        return det

    def dead_ranks(self, timeout_ms: Optional[int] = None) -> List[int]:
        """Ranks silent past the timeout (coordinator only; [] elsewhere)."""
        if self._coord is None:
            return []
        mask = self._lib.hb_dead_mask(self._coord, timeout_ms or self.timeout_ms)
        return [r for r in range(min(self.world_size, 64)) if mask & (1 << min(r, 63))]

    def rank_age_ms(self, rank: int) -> int:
        """ms since ``rank``'s last heartbeat (-1: never seen; coordinator
        only)."""
        if self._coord is None:
            return -1
        return int(self._lib.hb_rank_age_ms(self._coord, rank))

    def all_alive(self) -> bool:
        return not self.dead_ranks()

    def stop_worker(self) -> None:
        """Stop this rank's heartbeats (the coordinator, on rank 0, keeps
        listening)."""
        if self._worker:
            self._lib.hb_stop_worker(self._worker)
            self._worker = None

    def stop(self) -> None:
        self.stop_worker()
        if self._coord:
            self._lib.hb_stop_coordinator(self._coord)
            self._coord = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass
