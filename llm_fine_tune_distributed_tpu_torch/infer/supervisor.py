"""Engine supervision policy: restart backoff, the circuit breaker, and
deterministic fault injection (counterpart of the JAX
``infer/supervisor.py``).

The policy half of the self-healing loop of ``infer/engine.py``. The
engine's worker catches a failed tick, asks
``EngineSupervisor.record_failure()`` whether to restart or give up, sleeps
``backoff_delay()``, rebuilds its device state (the weights stay on the
card, so a restart is an allocation, not a reload) and bumps
``generation``. ``circuit_threshold`` failures inside a sliding window of
``circuit_window_s`` open the circuit: the worker stops restarting, fails
everything fast, and ``/healthz`` answers 503 so the orchestrator recycles
the process.

``FaultInjector`` is the deterministic chaos hook of the tests and of
``chip_smoke.py``: fail decode at an absolute tick index, fail the next k
decode ticks or prefills, or slow the next k decode ticks. Inert unless
armed; an armed fault raises ``InjectedFault`` inside the worker, so it
takes the classification path a real device error would.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

from llm_fine_tune_distributed_tpu_torch.infer.errors import InjectedFault


class EngineSupervisor:
    """Restart, backoff and circuit policy for one engine worker.

    Every mutation happens on the worker thread; ``generation``,
    ``circuit_open`` and ``recovering`` are read from server threads
    (single-word reads)."""

    def __init__(self, restart_backoff_s: float = 0.5, restart_backoff_max_s: float = 30.0,
                 circuit_threshold: int = 5, circuit_window_s: float = 60.0,
                 flight_dir: Optional[str] = None):
        self.restart_backoff_s = max(0.0, float(restart_backoff_s))
        self.restart_backoff_max_s = max(self.restart_backoff_s, float(restart_backoff_max_s))
        self.circuit_threshold = max(1, int(circuit_threshold))
        self.circuit_window_s = float(circuit_window_s)
        self.flight_dir = flight_dir
        self.generation = 0
        self.circuit_open = False
        # True from the decision to restart until the worker serves again
        self.recovering = False
        self._failures: "deque[float]" = deque()
        self._dump_seq = 0

    def record_failure(self, now: Optional[float] = None) -> str:
        """Record one retryable worker failure; ``"restart"``, or ``"open"``
        once ``circuit_threshold`` failures lie inside the window."""
        now = time.monotonic() if now is None else now
        self._failures.append(now)
        while self._failures and now - self._failures[0] > self.circuit_window_s:
            self._failures.popleft()
        if len(self._failures) >= self.circuit_threshold:
            self.circuit_open = True
            return "open"
        return "restart"

    def backoff_delay(self) -> float:
        """``restart_backoff_s`` after the first failure in the window,
        doubled for each further one, capped at ``restart_backoff_max_s``."""
        n = max(0, len(self._failures) - 1)
        return min(self.restart_backoff_s * (2.0 ** n), self.restart_backoff_max_s)

    def begin_recovery(self) -> None:
        """The worker decided to restart: backoff and rebuild follow."""
        self.recovering = True

    def restarted(self) -> None:
        """The worker is about to serve a new generation."""
        self.generation += 1
        self.recovering = False

    @property
    def failure_count(self) -> int:
        return len(self._failures)

    def dump_flight(self, recorder, reason: str, error: Optional[str] = None) -> Optional[str]:
        """Write the flight recorder's events to
        ``flight_<reason>_gen<generation>_<seq>.json`` in ``flight_dir`` and
        return the path; None without a ``flight_dir``. A write that fails
        is swallowed: the recorder must never take down a recovery that
        would otherwise succeed."""
        if not self.flight_dir or recorder is None:
            return None
        try:
            os.makedirs(self.flight_dir, exist_ok=True)
            self._dump_seq += 1
            path = os.path.join(self.flight_dir,
                                f"flight_{reason}_gen{self.generation}_{self._dump_seq}.json")
            payload = {
                "reason": reason,
                "error": error,
                "generation": self.generation,
                "failures_in_window": self.failure_count,
                "circuit_open": self.circuit_open,
                "dumped_at_unix": time.time(),
                "events": recorder.events(),
            }
            with open(path, "w") as f:
                json.dump(payload, f, indent=2)
            return path
        except OSError:
            return None


class FaultInjector:
    """Deterministic fault hooks that the engine's worker polls.

    Armed from any thread, fired on the worker thread; every fire raises
    ``InjectedFault`` and disarms itself, so "fail k times, then heal" is
    ``fail_decode_next(k)``. The engines call ``maybe_fail_prefill`` and
    ``maybe_fail_decode``; the spill, restore, migrate and handoff hooks
    belong to the host KV tier, slot migration and disaggregated prefill,
    which the port does not have yet, so nothing calls them."""

    def __init__(self):
        self._lock = threading.Lock()
        self._decode_at: set = set()  # absolute decode tick indices
        self._decode_next = 0
        self._prefill_next = 0
        self._spill_next = 0
        self._restore_next = 0
        self._migrate_next = 0
        self._handoff_next = 0
        # latency, not failure: (ticks left, seconds each)
        self._decode_delay = (0, 0.0)

    def fail_decode_at(self, *steps: int) -> None:
        """Fail the decode tick whose absolute index (1-based, counted over
        the engine's lifetime) matches."""
        with self._lock:
            self._decode_at.update(int(s) for s in steps)

    def fail_decode_next(self, k: int = 1) -> None:
        """Fail the next ``k`` decode ticks, then heal."""
        with self._lock:
            self._decode_next += int(k)

    def fail_prefill_next(self, k: int = 1) -> None:
        """Fail the next ``k`` prefills, then heal."""
        with self._lock:
            self._prefill_next += int(k)

    def fail_spill_next(self, k: int = 1) -> None:
        """Fail the next ``k`` host-tier spills, then heal."""
        with self._lock:
            self._spill_next += int(k)

    def fail_restore_next(self, k: int = 1) -> None:
        """Fail the next ``k`` host-tier restores, then heal."""
        with self._lock:
            self._restore_next += int(k)

    def fail_migrate_next(self, k: int = 1) -> None:
        """Fail the next ``k`` per-request migration export steps, then heal."""
        with self._lock:
            self._migrate_next += int(k)

    def fail_handoff_next(self, k: int = 1) -> None:
        """Fail the next ``k`` prefill-to-decode handoffs, then heal."""
        with self._lock:
            self._handoff_next += int(k)

    def delay_decode_next(self, k: int = 1, seconds: float = 0.05) -> None:
        """Slow (not fail) the next ``k`` decode ticks by ``seconds`` each."""
        with self._lock:
            self._decode_delay = (self._decode_delay[0] + int(k), float(seconds))

    def clear_delays(self) -> None:
        """Disarm any pending decode delays."""
        with self._lock:
            self._decode_delay = (0, 0.0)

    def maybe_fail_decode(self, step_index: int) -> None:
        delay = 0.0
        with self._lock:
            remaining, seconds = self._decode_delay
            if remaining > 0:
                self._decode_delay = (remaining - 1, seconds)
                delay = seconds
        if delay > 0.0:
            time.sleep(delay)
        with self._lock:
            if step_index in self._decode_at:
                self._decode_at.discard(step_index)
            elif self._decode_next > 0:
                self._decode_next -= 1
            else:
                return
        raise InjectedFault(f"injected decode failure at step {step_index}")

    def _fire(self, attr: str, message: str) -> None:
        with self._lock:
            if getattr(self, attr) <= 0:
                return
            setattr(self, attr, getattr(self, attr) - 1)
        raise InjectedFault(message)

    def maybe_fail_prefill(self) -> None:
        self._fire("_prefill_next", "injected prefill failure")

    def maybe_fail_spill(self) -> None:
        self._fire("_spill_next", "injected host-tier spill failure")

    def maybe_fail_restore(self) -> None:
        self._fire("_restore_next", "injected host-tier restore failure")

    def maybe_fail_migrate(self) -> None:
        self._fire("_migrate_next", "injected migration failure")

    def maybe_fail_handoff(self) -> None:
        self._fire("_handoff_next", "injected prefill->decode handoff failure")
