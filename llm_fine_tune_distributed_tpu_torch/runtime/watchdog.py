"""Single-process step watchdog: detect a wedged device (counterpart of the
JAX ``runtime/watchdog.py``).

A daemon thread that the training loop (once per optimizer step) or a
serving engine's worker (once per decode tick) pokes. If no poke arrives
within ``timeout_s`` it reports to stderr, with the silence and the last
step, and with ``action="abort"`` ends the process with ``os._exit(42)`` so
the job manager restarts it. ``os._exit`` is deliberate: a device
synchronisation that never returns cannot be interrupted from Python, so a
cooperative shutdown would hang too.

Cost: one thread waiting on an event; a poke stores a timestamp.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional


class StepWatchdog:
    def __init__(self, timeout_s: float, action: str = "warn", on_trip=None,
                 poll_s: Optional[float] = None, start_paused: bool = False, recorder=None):
        """``on_trip``: called in place of ``os._exit`` when ``abort``
        trips. ``start_paused``: disarmed until the first poke, so the
        startup (the first step's allocations and kernel builds) cannot
        trip it. ``recorder``: an optional ``FlightRecorder`` that gets a
        ``watchdog_trip`` event per trip and a ``watchdog_rearm`` event when
        a poke re-arms a paused watchdog."""
        if action not in ("warn", "abort"):
            raise ValueError(f"watchdog action must be warn|abort, got {action!r}")
        self.timeout_s = float(timeout_s)
        self.action = action
        self._on_trip = on_trip
        self._recorder = recorder
        self._poll_s = poll_s if poll_s is not None else min(self.timeout_s / 4, 10.0)
        self._last_poke = time.monotonic()
        self._last_step = 0
        self._tripped = 0
        self._paused = start_paused
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="step-watchdog", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ API

    def poke(self, step: int) -> None:
        """Progress at ``step``: stamp the time, and re-arm a paused
        watchdog."""
        self._last_poke = time.monotonic()
        self._last_step = step
        if self._paused:
            self._paused = False
            if self._recorder is not None:
                self._recorder.record("watchdog_rearm", step=step)

    def pause(self) -> None:
        """Disarm through a legitimately long phase (an eval sweep, a save,
        an idle engine); the next poke re-arms."""
        self._paused = True

    def resume(self) -> None:
        self._last_poke = time.monotonic()
        self._paused = False

    @property
    def trips(self) -> int:
        return self._tripped

    def stop(self) -> None:
        self._stop.set()

    # -------------------------------------------------------------- internal

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            if self._paused:
                continue
            silent = time.monotonic() - self._last_poke
            if silent < self.timeout_s:
                continue
            self._tripped += 1
            if self._recorder is not None:
                self._recorder.record("watchdog_trip", silent_s=round(silent, 1),
                                      last_step=self._last_step, action=self.action)
            print(f"[watchdog] no progress for {silent:.0f}s (last step {self._last_step}, "
                  f"timeout {self.timeout_s:.0f}s): the device may be wedged"
                  + ("; aborting for a restart" if self.action == "abort" else ""),
                  file=sys.stderr, flush=True)
            if self.action == "abort":
                if self._on_trip is not None:
                    self._on_trip()
                    return
                os._exit(42)
            # warn: re-arm, so a stall that persists warns once per timeout
            self._last_poke = time.monotonic()
