"""Mergeable latency histograms (counterpart of ``Histogram`` in the JAX
``observe/tracing.py``; request traces and the flight recorder are not
ported).

``Histogram``: fixed-bucket counts with a per-instance lock. One
``observe()`` is a ``bisect`` plus three adds, cheap next to a decode step,
so the serving engines leave it on. Fixed bounds make histograms mergeable:
same bounds, add the counts. Percentiles interpolate inside the winning
bucket. Bounds, interpolation and the Prometheus text are the JAX
package's, so both expose the same series for the same observations.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left
from typing import Dict, List, Sequence, Tuple


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
