"""Device memory, roofline peaks, utilization gauges and on-demand profiler
captures for the serving engines (counterpart of ``device_memory_report``
in the JAX ``observe/profiler.py`` and of the cost-analysis gauges and
``ProfilerCapture`` in the JAX ``observe/xla.py``).

- ``device_memory_report()``: per-card bytes in use, peak and total, from
  the CUDA caching allocator; ``{}`` without a GPU (the JAX report is empty
  on its CPU devices too).
- ``device_peak_specs()`` and ``utilization_from_cost()``: the peak bf16
  FLOP/s and HBM bytes/s of the card by its name, and the MFU and
  HBM-bandwidth fractions of a dispatch whose work is known
  (``observe/flops.decode_tick_cost``) and whose mean time is measured.
- ``ProfilerCapture``: the ``POST /v1/profile`` capture on
  ``torch.profiler`` (CPU and CUDA activity), one at a time, each in a
  fresh ``capture_NNNN/`` directory, run on a thread of its own that stops
  it after the requested duration and exports a Chrome trace
  (``trace.json``). ``boundary`` (the engine's tick lock) makes the start
  and the stop fall between scheduler ticks, so a capture holds whole
  ticks.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

__all__ = ["CaptureBusyError", "ProfilerCapture", "device_memory_report", "device_peak_specs",
           "peaks_for_name", "utilization_from_cost"]


def device_memory_report() -> Dict[str, Dict[str, Optional[int]]]:
    """Live memory of each visible card, keyed by its index:
    ``bytes_in_use`` and ``peak_bytes_in_use`` (the caching allocator's
    allocated bytes, current and peak) and ``bytes_limit`` (the card's
    total memory)."""
    report = {}
    if not torch.cuda.is_available():
        return report
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if stats:
            report[str(i)] = {
                "bytes_in_use": stats.get("allocated_bytes.all.current"),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
                "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
            }
    return report


# (peak dense bf16 FLOP/s, peak HBM bytes/s) per card, matched in order by
# substring of ``torch.cuda.get_device_name()``: the data-sheet rates. The
# gauges they feed are roofline fractions, not absolute truth.
_DEVICE_PEAKS: Tuple[Tuple[str, Tuple[float, float]], ...] = (
    ("H100 NVL", (835e12, 3.9e12)),
    ("H100 PCIe", (756e12, 2.0e12)),
    ("H100 80GB HBM3", (989e12, 3.35e12)),  # SXM5
)


def device_peak_specs(device=None) -> Tuple[float, float]:
    """(peak FLOP/s, peak HBM bytes/s) of ``device`` (default: card 0).
    (0, 0) on the CPU or a card not in the table, so the gauges read 0.0
    rather than invent a roofline. ``SERVE_PEAK_FLOPS`` and
    ``SERVE_PEAK_HBM_BPS`` override the table."""
    env_f = os.environ.get("SERVE_PEAK_FLOPS")
    env_b = os.environ.get("SERVE_PEAK_HBM_BPS")
    if env_f or env_b:
        return float(env_f or 0.0), float(env_b or 0.0)
    if device is not None and torch.device(device).type != "cuda":
        return 0.0, 0.0
    if not torch.cuda.is_available():
        return 0.0, 0.0
    index = torch.device(device).index if device is not None else None
    return peaks_for_name(torch.cuda.get_device_name(index or 0))


def peaks_for_name(name: str) -> Tuple[float, float]:
    """The table's row for a card name; (0, 0) when none matches."""
    for sub, peaks in _DEVICE_PEAKS:
        if sub in name:
            return peaks
    return 0.0, 0.0


def utilization_from_cost(flops: float, bytes_accessed: float, mean_step_s: float,
                          peak_flops: float, peak_bw: float) -> Tuple[float, float]:
    """(model_flops_utilization, hbm_bandwidth_utilization) of a dispatch
    that does ``flops`` and moves ``bytes_accessed`` in a measured mean of
    ``mean_step_s``. Clamped to [0, 1]; 0.0 whenever an input is unknown."""

    def ratio(work, peak):
        if work <= 0.0 or peak <= 0.0 or mean_step_s <= 0.0:
            return 0.0
        return min(1.0, work / (mean_step_s * peak))

    return ratio(flops, peak_flops), ratio(bytes_accessed, peak_bw)


class CaptureBusyError(RuntimeError):
    """A profiler capture is already running (one at a time)."""


class ProfilerCapture:
    """On-demand ``torch.profiler`` capture for ``POST /v1/profile``: one
    at a time, a fresh ``capture_NNNN`` subdirectory each, exported as
    ``trace.json`` (Chrome trace format). The profiler must start and stop
    on one thread, so each capture runs on a thread of its own: it starts
    the profiler, waits out the requested duration (or an early ``stop``),
    stops it and writes the trace. CUDA kernels are recorded process-wide;
    the CPU ops are the capture thread's. ``on_event(kind, **fields)`` (the
    engine's flight recorder) sees ``profile_start`` and, once the file is
    written (or its export failed, with ``error``), ``profile_stop``.
    ``boundary()`` is a context manager held around the profiler's start
    and stop (the export runs outside it): the engine's tick lock, so
    neither lands inside a tick. ``warm_up`` pays the profiler's one-time
    set-up before serving."""

    TRACE_FILE = "trace.json"
    # tiny kernels launched (and waited for) under the boundary before a
    # CUDA stop: see ``_push_records``
    PUSH_LAUNCHES = 16384

    def __init__(self, base_dir: str, on_event: Optional[Callable[..., None]] = None,
                 boundary: Optional[Callable[[], object]] = None):
        self.base_dir = base_dir
        self._on_event = on_event
        self._boundary = boundary or contextlib.nullcontext
        self._lock = threading.Lock()
        self._active: Optional[str] = None
        self._prof = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._seq = itertools.count(1)

    @property
    def active(self) -> Optional[str]:
        return self._active

    def _begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()

    def _end(self) -> None:
        self._push_records()
        self._prof.stop()

    def _push_records(self) -> None:
        """With CUDA, launch ``PUSH_LAUNCHES`` one-element kernels and wait
        for them before the stop. A trace stopped right after a tick often
        lacked the tail of that tick's kernel and launch records on the
        H100, though the tick had finished (``chip_smoke.py --capture-check
        16 0``); records enough to fill the profiler's ~4 MB activity buffer
        after the tick (a kernel and a launch record per iteration) keep its
        records whole. The trace gains these kernels, and the stop waits for
        them (~0.1 s)."""
        if not torch.cuda.is_available():
            return
        x = torch.zeros(1, device=torch.cuda.current_device())
        for _ in range(self.PUSH_LAUNCHES):
            x.add_(1)
        torch.cuda.synchronize()

    def warm_up(self) -> float:
        """One empty capture on the calling thread, nothing exported: the
        profiler's one-time set-up in a process (seconds with CUDA
        activity) happens here, before serving, not inside the first
        capture's hold of the boundary. Returns its seconds."""
        t0 = time.monotonic()
        with self._lock:
            with self._boundary():
                self._begin()
                self._end()
            self._prof = None
        return time.monotonic() - t0

    def _export(self, trace_dir: str) -> None:
        prof, self._prof = self._prof, None
        prof.export_chrome_trace(os.path.join(trace_dir, self.TRACE_FILE))

    def start(self, duration_s: float) -> str:
        """Begin a capture; returns its directory once the profiler runs.
        Raises ``CaptureBusyError`` if one is already running."""
        if duration_s <= 0:
            raise ValueError(f"duration_s must be positive, got {duration_s}")
        with self._lock:
            if self._active is not None:
                raise CaptureBusyError(f"capture already running in {self._active}")
            trace_dir = os.path.join(self.base_dir, f"capture_{next(self._seq):04d}")
            os.makedirs(trace_dir, exist_ok=True)
            started, failed, timing = threading.Event(), [], {}
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._capture,
                args=(trace_dir, float(duration_s), started, failed, timing),
                name="profiler-capture", daemon=True)
            self._thread.start()
            started.wait()
            if failed:
                self._thread.join()
                raise failed[0]
            self._active = trace_dir
            self._event("profile_start", dir=trace_dir, duration_s=duration_s, **timing)
        return trace_dir

    def _capture(self, trace_dir: str, duration_s: float, started: threading.Event,
                 failed: list, timing: dict) -> None:
        """The capture thread: start, wait, stop, export, record the stop
        (after ``start`` recorded the start: it holds the lock until then).
        Each event carries how long the boundary was held (``lock_held_ms``:
        ticks wait at least that long); the stop adds the export's time
        (``export_ms``)."""
        try:
            with self._boundary():
                t0 = time.monotonic()
                self._begin()
                timing["lock_held_ms"] = round(1e3 * (time.monotonic() - t0), 3)
        except Exception as e:
            failed.append(e)
            started.set()
            return
        started.set()
        self._stop.wait(duration_s)
        fields = {"dir": trace_dir}
        try:
            with self._boundary():
                t0 = time.monotonic()
                self._end()
                # how long the stop held the boundary: ticks wait that long
                fields["lock_held_ms"] = round(1e3 * (time.monotonic() - t0), 3)
            t0 = time.monotonic()
            self._export(trace_dir)
            fields["export_ms"] = round(1e3 * (time.monotonic() - t0), 3)
        except Exception as e:  # the stop event says so: never a silent missing file
            fields["error"] = f"{type(e).__name__}: {e}"
        with self._lock:
            # before ``active`` reads None: a poller treats None as finished
            self._event("profile_stop", **fields)
            self._active = None

    def stop(self) -> Optional[str]:
        """End the running capture early and wait for its trace
        (idempotent); returns its directory."""
        with self._lock:
            trace_dir, thread = self._active, self._thread
            if trace_dir is None:
                return None
            self._stop.set()
        thread.join()
        return trace_dir

    def _event(self, kind: str, **fields) -> None:
        if self._on_event is not None:
            try:
                self._on_event(kind, **fields)
            except Exception:
                pass
