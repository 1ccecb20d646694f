"""Mergeable latency histograms, request traces and the engines' flight
recorder (counterparts of ``Histogram``, ``RequestTrace``,
``TraceJsonlWriter`` and ``FlightRecorder`` in the JAX
``observe/tracing.py``).

``Histogram``: fixed-bucket counts with a per-instance lock. One
``observe()`` is a ``bisect`` plus three adds, cheap next to a decode step,
so the serving engines leave it on. Fixed bounds make histograms mergeable:
same bounds, add the counts. Percentiles interpolate inside the winning
bucket. Bounds, interpolation and the Prometheus text are the JAX
package's, so both expose the same series for the same observations.

``RequestTrace``: an append-only list of ``(span, monotonic_t)`` marks.
Appends are GIL-atomic, so the scheduler thread marks a span without a
lock; readers look only after the request settled.

``TraceJsonlWriter``: one JSON line per settled request, with size-based
rotation that keeps the newest ``keep`` files.

``FlightRecorder``: a bounded ring of recent engine events (admissions,
sheds, tick summaries, crashes, restarts, circuit transitions) that the
supervisor dumps to JSON after a crash and ``GET /v1/flight`` reads live.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import uuid
from bisect import bisect_left
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple


class Histogram:
    """Thread-safe fixed-bucket histogram with mergeable counts.

    ``bounds`` are the inclusive upper edges of the finite buckets; one
    implicit overflow bucket catches everything above ``bounds[-1]``. An
    observation lands in the first bucket whose upper edge is >= value
    (Prometheus ``le`` semantics).
    """

    __slots__ = ("bounds", "counts", "total", "sum", "_lock")

    def __init__(self, bounds: Sequence[float]):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError("histogram bounds must be non-empty and ascending")
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.total = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    @classmethod
    def exponential(cls, lo: float = 1e-4, hi: float = 400.0, factor: float = 2.0) -> "Histogram":
        """Log-spaced bounds from ``lo`` doubling up past ``hi``: 0.1 ms at
        the bottom, ~7 min at the top, 22 buckets (the latency shape)."""
        bounds = []
        b = float(lo)
        while b <= hi:
            bounds.append(b)
            b *= factor
        return cls(bounds)

    @classmethod
    def linear(cls, lo: float = 0.0, hi: float = 16.0, step: float = 1.0) -> "Histogram":
        """Evenly spaced bounds, for small-integer quantities."""
        n = int(round((hi - lo) / step))
        return cls([lo + i * step for i in range(n + 1)])

    def observe(self, value: float) -> None:
        i = bisect_left(self.bounds, value)
        with self._lock:
            self.counts[i] += 1
            self.total += 1
            self.sum += value

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram's counts into this one (same bounds)."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different bounds")
        with other._lock:
            counts, total, s = list(other.counts), other.total, other.sum
        with self._lock:
            for i, c in enumerate(counts):
                self.counts[i] += c
            self.total += total
            self.sum += s

    def _state(self) -> Tuple[List[int], int, float]:
        with self._lock:
            return list(self.counts), self.total, self.sum

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]) by linear
        interpolation inside the winning bucket. The overflow bucket reports
        the last finite bound (a floor)."""
        counts, total, _ = self._state()
        if total == 0:
            return 0.0
        rank = q / 100.0 * total
        seen = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if seen + c >= rank:
                if i >= len(self.bounds):
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.bounds[-1]

    def summary(self) -> Dict[str, float]:
        _, total, s = self._state()
        if total == 0:
            return {"count": 0, "mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
        return {
            "count": total,
            "mean": s / total,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }

    def prometheus_lines(self, name: str, labels: str = "", include_type: bool = True) -> List[str]:
        """Prometheus text exposition: cumulative ``_bucket{le=...}`` lines
        plus ``_sum`` and ``_count``. ``labels`` (e.g. ``replica="0"``) joins
        each sample's label set; ``include_type=False`` leaves out the
        ``# TYPE`` line for another labelled series of the same metric."""
        counts, total, s = self._state()
        pre = f"{labels}," if labels else ""
        sfx = f"{{{labels}}}" if labels else ""
        lines = [f"# TYPE {name} histogram"] if include_type else []
        cum = 0
        for bound, c in zip(self.bounds, counts):
            cum += c
            lines.append(f'{name}_bucket{{{pre}le="{_fmt(bound)}"}} {cum}')
        lines.append(f'{name}_bucket{{{pre}le="+Inf"}} {total}')
        lines.append(f"{name}_sum{sfx} {_fmt(s)}")
        lines.append(f"{name}_count{sfx} {total}")
        return lines


def _fmt(v: float) -> str:
    if v != v or v in (math.inf, -math.inf):
        return "+Inf" if v > 0 else "-Inf"
    return f"{v:.10g}"


class RequestTrace:
    """Per-request lifecycle timeline: ordered ``(span, monotonic_t)`` marks.

    Made at submit and marked by whichever thread owns the request at that
    moment (the submit thread for received/queued, the scheduler thread
    for the rest). ``to_dict`` is called only after the request settled.
    ``trace_id`` is the identity a caller may hand in to have several hops
    share one record."""

    __slots__ = ("request_id", "trace_id", "t0", "events")

    def __init__(self, request_id: int = 0, t0: Optional[float] = None,
                 trace_id: Optional[str] = None):
        self.request_id = request_id
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.t0 = time.monotonic() if t0 is None else t0
        self.events: List[Tuple[str, float]] = []

    def mark(self, span: str, t: Optional[float] = None) -> None:
        self.events.append((span, time.monotonic() if t is None else t))

    def to_dict(self) -> Dict[str, Any]:
        events = list(self.events)
        out = {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "events": [{"span": span, "t_s": round(t - self.t0, 6)} for span, t in events],
        }
        if events:
            out["total_s"] = round(events[-1][1] - self.t0, 6)
        return out


class TraceJsonlWriter:
    """Appends one JSON line per settled request to ``path``.

    ``max_bytes`` > 0 bounds the file: when the next line would push the
    active file past it, the file moves to ``path.1`` (``path.N`` shift to
    ``path.N+1``) and only the newest ``keep`` rotated files survive. The
    size is tracked in-process (one ``tell()`` at open), so a write never
    stats the file."""

    def __init__(self, path: str, max_bytes: int = 0, keep: int = 5):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._path = path
        self._max_bytes = max(0, int(max_bytes))
        self._keep = max(1, int(keep))
        self._f = open(path, "a")
        self._size = self._f.tell()
        self._lock = threading.Lock()

    def write(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record) + "\n"
        with self._lock:
            if self._max_bytes and self._size > 0 and self._size + len(line) > self._max_bytes:
                self._rotate()
            self._f.write(line)
            self._f.flush()
            self._size += len(line)

    def _rotate(self) -> None:
        """Shift ``path.N`` -> ``path.N+1`` (dropping past ``keep``), move
        the active file to ``path.1`` and reopen it empty. The caller holds
        the lock."""
        self._f.close()
        for i in range(self._keep, 0, -1):
            src = f"{self._path}.{i}"
            if not os.path.exists(src):
                continue
            if i >= self._keep:
                os.remove(src)
            else:
                os.replace(src, f"{self._path}.{i + 1}")
        os.replace(self._path, f"{self._path}.1")
        self._f = open(self._path, "a")
        self._size = 0

    def close(self) -> None:
        with self._lock:
            self._f.close()


class FlightRecorder:
    """Bounded ring buffer of recent engine events.

    Each event is a dict with ``t_s`` (seconds since the recorder was made)
    and ``kind``, plus the caller's fields. The ``deque(maxlen=...)`` bound
    keeps each record O(1) and the memory fixed."""

    def __init__(self, capacity: int = 1024):
        self._events: "deque[Dict[str, Any]]" = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._t0 = time.monotonic()

    def record(self, kind: str, **fields: Any) -> None:
        event = {"t_s": round(time.monotonic() - self._t0, 6), "kind": kind}
        event.update(fields)
        with self._lock:
            self._events.append(event)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)
