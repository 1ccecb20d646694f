"""SLO engine: in-process metric history, per-generation latency slices,
multi-window burn-rate objectives, and the canary verdict for deploys
(counterpart of the JAX ``observe/slo.py``, the same classes and the same
arithmetic, so both give equal reports for the same samples).

Everything here rides the serving observability the engine already pays
for, with no new clock reads on the token hot path:

- ``MetricRing``: a fixed-capacity time-series ring. The engine worker
  offers it the tick stamp ``_tick_done`` already took, and the ring
  samples at its own cadence: cumulative counters and gauges from
  ``ServingStats`` plus the delta of each latency histogram since the
  previous sample (fixed buckets make the deltas exact). Windowed queries
  (``window_counters``, ``window_histogram``, ``series``) are what the SLO
  evaluation and ``GET /v1/history`` read.
- ``GenerationSlices``: settled-request TTFT and inter-token histograms
  and completion/failure counts keyed by weight generation (always 0 until
  hot-swap is ported), so a deploy's tail latency can be compared with the
  generation it replaced.
- ``SloPolicy``: availability, error-rate and latency-percentile
  objectives evaluated as multi-window burn rates (burn = bad fraction /
  error-budget fraction; a breach needs every window hot, so a blip cannot
  page and a slow bleed cannot hide).
- ``CanaryJudge``: scores the first swapped replica of a fleet against its
  unswapped siblings over a confirmation window (hot-swap consults it).

This module depends only on ``observe.tracing``.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from llm_fine_tune_distributed_tpu_torch.observe.tracing import Histogram

# Counters the ring samples from ServingStats (cumulative; windowed deltas
# are computed at query time). Kept literal so the ring works over any
# object with a ``values(names)`` -> dict method.
RING_COUNTERS = (
    "tokens_served", "requests_admitted", "requests_completed",
    "requests_failed", "requests_abandoned", "decode_steps",
    "preemptions",
    "requests_shed_overflow", "requests_shed_deadline",
    "requests_shed_deadline_decode", "requests_shed_tenant_quota",
)
# Instantaneous gauges sampled as-is (the engine passes fresh reads).
RING_GAUGES = (
    "queue_depth", "live_slots", "brownout_stage", "weight_generation",
)
# Histograms delta-decoded between samples.
RING_HISTOGRAMS = ("ttft_s", "inter_token_s")

# Shed counters that burn the availability budget: requests the service
# turned away or cancelled rather than served.
_AVAILABILITY_BAD = (
    "requests_shed_overflow", "requests_shed_deadline",
    "requests_shed_deadline_decode", "requests_shed_tenant_quota",
)


def _frac_above(
    bounds: Tuple[float, ...], counts: Sequence[int], total: int,
    threshold: float,
) -> float:
    """Fraction of observations above ``threshold`` in a fixed-bucket
    histogram state, interpolating inside the bucket the threshold lands
    in (same honesty contract as ``Histogram.percentile``)."""
    if total <= 0:
        return 0.0
    i = bisect_left(bounds, threshold)
    if i >= len(bounds):
        # threshold beyond the last finite bound: only overflow is above
        return counts[-1] / total
    below = sum(counts[:i])
    lo = bounds[i - 1] if i > 0 else 0.0
    hi = bounds[i]
    frac_in = (threshold - lo) / (hi - lo) if hi > lo else 1.0
    below += counts[i] * min(max(frac_in, 0.0), 1.0)
    return max(0.0, (total - below)) / total


class MetricRing:
    """Fixed-capacity in-process time-series of serving stats samples.

    The engine worker calls ``due(now)`` with the tick stamp it already
    took (zero extra clock reads) and, when a sample interval has
    elapsed, ``sample(now, stats, gauges)``. Each sample stores the
    cumulative counters plus the DELTA of each tracked histogram since
    the previous sample, so any trailing window's histogram is the exact
    sum of its samples' deltas — mergeable math, no decay approximations.

    Writers: the engine worker thread only. Readers: HTTP handler
    threads (``/v1/history``, ``/v1/slo``, ``/v1/stats``) and the deploy
    manager. One lock around the deque; samples are immutable once
    appended.
    """

    def __init__(self, capacity: int = 512, interval_s: float = 1.0):
        self.capacity = max(2, int(capacity))
        self.interval_s = max(1e-3, float(interval_s))
        self._samples: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._last_t: Optional[float] = None
        # previous cumulative histogram counts, for delta decoding
        self._prev_hist: Dict[str, Tuple[List[int], int, float]] = {}

    # ------------------------------------------------------------- writer

    def due(self, now: float) -> bool:
        """Cheap per-tick check: has a sample interval elapsed? Reuses the
        caller's tick stamp — the ring never reads the clock itself."""
        return self._last_t is None or now - self._last_t >= self.interval_s

    def sample(
        self,
        now: float,
        stats,
        gauges: Optional[Dict[str, float]] = None,
    ) -> None:
        """Take one sample: cumulative counters from ``stats`` (a
        ``ServingStats``), fresh gauge reads from ``gauges``, and the
        per-histogram delta since the previous sample."""
        counters = stats.values(RING_COUNTERS)
        hist_deltas: Dict[str, Tuple[List[int], int, float]] = {}
        for name in RING_HISTOGRAMS:
            h = stats.hist.get(name)
            if h is None:
                continue
            counts, total, s = h._state()
            prev = self._prev_hist.get(name)
            if prev is None:
                delta = (list(counts), total, s)
            else:
                pcounts, ptotal, psum = prev
                delta = (
                    [c - p for c, p in zip(counts, pcounts)],
                    total - ptotal,
                    s - psum,
                )
            self._prev_hist[name] = (counts, total, s)
            hist_deltas[name] = delta
        rec: Dict[str, Any] = {
            "t": float(now),
            "counters": counters,
            "gauges": dict(gauges or {}),
            "hist": hist_deltas,
        }
        with self._lock:
            self._samples.append(rec)
        self._last_t = now

    # ------------------------------------------------------------- readers

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def samples(
        self, window_s: Optional[float] = None, now: Optional[float] = None
    ) -> List[Dict[str, Any]]:
        with self._lock:
            recs = list(self._samples)
        if window_s is None or not recs:
            return recs
        t = now if now is not None else recs[-1]["t"]
        cutoff = t - float(window_s)
        return [r for r in recs if r["t"] > cutoff]

    def metrics(self) -> List[str]:
        """Metric names ``series`` can answer for."""
        return list(RING_COUNTERS) + list(RING_GAUGES)

    def window_counters(
        self, window_s: float, now: Optional[float] = None
    ) -> Dict[str, int]:
        """Counter deltas over the trailing window: newest sample minus
        the last sample at or before the window start. With no sample
        that old (engine younger than the window, or ring wrapped) the
        oldest retained sample is the baseline — the window honestly
        truncates to the history we have. Counters start at zero with
        the engine, so a missing baseline before the first sample means
        the first sample's own deltas count too."""
        with self._lock:
            recs = list(self._samples)
        if not recs:
            return {k: 0 for k in RING_COUNTERS}
        t = now if now is not None else recs[-1]["t"]
        cutoff = t - float(window_s)
        newest = recs[-1]["counters"]
        baseline: Optional[Dict[str, int]] = None
        for r in recs:
            if r["t"] <= cutoff:
                baseline = r["counters"]
            else:
                break
        if baseline is None:
            # whole retained history is inside the window; the counters
            # before the first sample are the first sample's cumulative
            # values minus its own in-window activity — unknowable here,
            # so treat engine start (zero) as the baseline when the ring
            # hasn't wrapped, else the oldest sample.
            if len(recs) == self.capacity:
                baseline = recs[0]["counters"]
            else:
                baseline = {k: 0 for k in RING_COUNTERS}
        return {
            k: max(0, int(newest.get(k, 0)) - int(baseline.get(k, 0)))
            for k in RING_COUNTERS
        }

    def window_histogram(
        self, name: str, window_s: float, now: Optional[float] = None
    ) -> Tuple[List[int], int, float]:
        """Summed histogram deltas over the trailing window:
        ``(counts, total, sum)`` with the same bucket layout as the live
        histogram. Exact — each sample's delta covers the span since the
        previous sample."""
        recs = self.samples(window_s, now)
        counts: Optional[List[int]] = None
        total = 0
        s = 0.0
        for r in recs:
            d = r["hist"].get(name)
            if d is None:
                continue
            dcounts, dtotal, dsum = d
            if counts is None:
                counts = list(dcounts)
            else:
                for i, c in enumerate(dcounts):
                    counts[i] += c
            total += dtotal
            s += dsum
        return (counts or [], total, s)

    def series(
        self,
        metric: str,
        window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Time series of one counter or gauge over the trailing window
        (``GET /v1/history``). Counters come with per-sample deltas so a
        rate plot needs no client-side state. Raises ``ValueError`` for
        an unknown metric (the server's 400)."""
        is_counter = metric in RING_COUNTERS
        if not is_counter and metric not in RING_GAUGES:
            raise ValueError(
                f"unknown history metric {metric!r} "
                f"(expected one of {self.metrics()})"
            )
        recs = self.samples(window_s, now)
        t_ref = (
            now
            if now is not None
            else (recs[-1]["t"] if recs else time.monotonic())
        )
        out: List[Dict[str, float]] = []
        prev: Optional[int] = None
        for r in recs:
            src = r["counters"] if is_counter else r["gauges"]
            v = src.get(metric, 0)
            point = {"age_s": round(t_ref - r["t"], 3), "value": v}
            if is_counter:
                point["delta"] = int(v) - int(prev) if prev is not None else 0
                prev = int(v)
            out.append(point)
        return {
            "metric": metric,
            "kind": "counter" if is_counter else "gauge",
            "window_s": float(window_s) if window_s is not None else None,
            "interval_s": self.interval_s,
            "samples": out,
        }


class _Slice:
    """One weight generation's settled-request accounting. Histograms are
    internally locked; the count bumps go through the owning
    ``GenerationSlices`` lock (settles can come from submit threads)."""

    __slots__ = ("ttft", "inter_token", "completed", "failed")

    def __init__(self):
        self.ttft = Histogram.exponential()
        self.inter_token = Histogram.exponential()
        self.completed = 0
        self.failed = 0


class GenerationSlices:
    """Per-``weight_generation`` latency/error slices.

    The engine keeps a cached reference to the current generation's slice
    and observes TTFT/inter-token into it on the token hot path (reusing
    the values it already computed against the tick clock — no extra
    reads, no dict lookups per token). Settle counts key off the
    generation stamped on the request. Old generations are pruned to the
    last ``keep`` so a long-lived engine's memory stays bounded.
    """

    def __init__(self, keep: int = 8):
        self._keep = max(1, int(keep))
        self._lock = threading.Lock()
        self._slices: Dict[int, _Slice] = {}

    def slice_for(self, generation: int) -> _Slice:
        """Get-or-create the slice for one generation, pruning the oldest
        beyond ``keep`` (callers cache the return for hot-path observes)."""
        gen = int(generation)
        with self._lock:
            s = self._slices.get(gen)
            if s is None:
                s = self._slices[gen] = _Slice()
                while len(self._slices) > self._keep:
                    del self._slices[min(self._slices)]
            return s

    def note_settled(self, generation: int, failed: bool) -> None:
        gen = int(generation)
        with self._lock:
            s = self._slices.get(gen)
            if s is None:
                s = self._slices[gen] = _Slice()
                while len(self._slices) > self._keep:
                    del self._slices[min(self._slices)]
            if failed:
                s.failed += 1
            else:
                s.completed += 1

    def generations(self) -> List[int]:
        with self._lock:
            return sorted(self._slices)

    def state(
        self, generation: int
    ) -> Dict[str, Any]:
        """Cumulative slice state for baseline/delta math:
        ``{ttft: (counts,total,sum), inter_token: ..., completed, failed}``.
        Zeros for a generation with no slice yet (a fresh canary)."""
        with self._lock:
            s = self._slices.get(int(generation))
        if s is None:
            empty = Histogram.exponential()
            z = empty._state()
            return {"ttft": z, "inter_token": z, "completed": 0, "failed": 0}
        return {
            "ttft": s.ttft._state(),
            "inter_token": s.inter_token._state(),
            "completed": s.completed,
            "failed": s.failed,
        }

    @staticmethod
    def delta(
        now_state: Dict[str, Any], then_state: Dict[str, Any]
    ) -> Dict[str, Any]:
        """Per-generation activity between two ``state()`` snapshots:
        p99s over the delta histograms plus completed/failed deltas —
        the canary's confirmation-window view."""
        out: Dict[str, Any] = {}
        for name in ("ttft", "inter_token"):
            ncounts, ntotal, nsum = now_state[name]
            tcounts, ttotal, tsum = then_state[name]
            h = Histogram.exponential()
            if ncounts:
                h.counts = [
                    c - (tcounts[i] if i < len(tcounts) else 0)
                    for i, c in enumerate(ncounts)
                ]
            h.total = ntotal - ttotal
            h.sum = nsum - tsum
            out[name] = h.summary()
        out["completed"] = now_state["completed"] - then_state["completed"]
        out["failed"] = now_state["failed"] - then_state["failed"]
        done = out["completed"] + out["failed"]
        out["error_rate"] = out["failed"] / done if done else 0.0
        return out

    @staticmethod
    def merge_states(states: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
        """Fold several ``state()`` snapshots (same generation, sibling
        replicas) into one — fixed bounds make the sum exact."""
        acc: Optional[Dict[str, Any]] = None
        for st in states:
            if acc is None:
                acc = {
                    "ttft": (list(st["ttft"][0]), st["ttft"][1], st["ttft"][2]),
                    "inter_token": (
                        list(st["inter_token"][0]),
                        st["inter_token"][1],
                        st["inter_token"][2],
                    ),
                    "completed": st["completed"],
                    "failed": st["failed"],
                }
                continue
            for name in ("ttft", "inter_token"):
                counts, total, s = acc[name]
                ocounts, ototal, osum = st[name]
                if not counts:
                    counts = list(ocounts)
                else:
                    for i, c in enumerate(ocounts):
                        counts[i] += c
                acc[name] = (counts, total + ototal, s + osum)
            acc["completed"] += st["completed"]
            acc["failed"] += st["failed"]
        if acc is None:
            empty = Histogram.exponential()._state()
            acc = {
                "ttft": empty, "inter_token": empty,
                "completed": 0, "failed": 0,
            }
        return acc

    def summaries(self) -> Dict[str, Dict[str, Any]]:
        """JSON-ready per-generation summaries (``/v1/stats``,
        ``/metrics`` generation-labelled series)."""
        with self._lock:
            items = sorted(self._slices.items())
        out: Dict[str, Dict[str, Any]] = {}
        for gen, s in items:
            done = s.completed + s.failed
            out[str(gen)] = {
                "completed": s.completed,
                "failed": s.failed,
                "error_rate": s.failed / done if done else 0.0,
                "ttft": s.ttft.summary(),
                "inter_token": s.inter_token.summary(),
            }
        return out

    @staticmethod
    def merged_summaries(
        many: Iterable["GenerationSlices"],
    ) -> Dict[str, Dict[str, Any]]:
        """Fleet view: per-generation summaries with replica slices
        merged (histogram counts sum, counts sum)."""
        by_gen: Dict[int, Dict[str, Any]] = {}
        for slices in many:
            for gen in slices.generations():
                st = slices.state(gen)
                if gen in by_gen:
                    by_gen[gen] = GenerationSlices.merge_states(
                        [by_gen[gen], st]
                    )
                else:
                    by_gen[gen] = st
        out: Dict[str, Dict[str, Any]] = {}
        zero = Histogram.exponential()._state()
        for gen in sorted(by_gen):
            d = GenerationSlices.delta(
                by_gen[gen],
                {"ttft": zero, "inter_token": zero, "completed": 0, "failed": 0},
            )
            out[str(gen)] = d
        return out


class SloPolicy:
    """Serving objectives evaluated as multi-window burn rates.

    Objectives (targets are the service promise; the budget is how much
    of the traffic may break it):

    - ``ttft_p99``: at most ``budget`` (default 1%) of first tokens may
      take longer than ``ttft_p99_s``.
    - ``inter_token_p99``: same over inter-token gaps.
    - ``error_rate``: failed / settled must stay under the target; the
      budget IS the target.
    - ``availability``: turned-away requests (overflow, deadline, quota
      sheds) vs. admissions must stay under ``1 - availability``.

    ``burn_rate = bad_fraction / budget`` — 1.0 means exactly eating the
    budget, sustained. A breach requires burn > ``burn_threshold`` on
    EVERY window with at least ``min_events`` in each (fast window
    catches cliffs, slow window catches bleeds, their conjunction
    suppresses blips). ``evaluate`` is pure (any thread);
    ``observe_transitions`` keeps breach state and is worker-only.
    """

    def __init__(
        self,
        ttft_p99_s: float = 2.0,
        inter_token_p99_s: float = 0.5,
        error_rate: float = 0.01,
        availability: float = 0.999,
        fast_window_s: float = 60.0,
        slow_window_s: float = 600.0,
        burn_threshold: float = 1.0,
        min_events: int = 8,
        percentile_budget: float = 0.01,
    ):
        self.ttft_p99_s = float(ttft_p99_s)
        self.inter_token_p99_s = float(inter_token_p99_s)
        self.error_rate = float(error_rate)
        self.availability = float(availability)
        self.windows = (
            ("fast", max(1e-3, float(fast_window_s))),
            ("slow", max(1e-3, float(slow_window_s))),
        )
        self.burn_threshold = float(burn_threshold)
        self.min_events = max(1, int(min_events))
        self.percentile_budget = max(1e-9, float(percentile_budget))
        self._breached: set = set()  # worker-only (observe_transitions)

    # ----------------------------------------------------------- evaluation

    def _objective_specs(self) -> List[Tuple[str, float, float]]:
        """(name, target, budget_fraction) triples."""
        return [
            ("ttft_p99", self.ttft_p99_s, self.percentile_budget),
            ("inter_token_p99", self.inter_token_p99_s, self.percentile_budget),
            ("error_rate", self.error_rate, max(self.error_rate, 1e-9)),
            (
                "availability",
                self.availability,
                max(1.0 - self.availability, 1e-9),
            ),
        ]

    def _window_view(
        self, name: str, ring: MetricRing, window_s: float,
        now: Optional[float],
    ) -> Tuple[float, int]:
        """(bad_fraction, events) of one objective over one window."""
        if name in ("ttft_p99", "inter_token_p99"):
            hname = "ttft_s" if name == "ttft_p99" else "inter_token_s"
            counts, total, _ = ring.window_histogram(hname, window_s, now)
            target = (
                self.ttft_p99_s if name == "ttft_p99"
                else self.inter_token_p99_s
            )
            if total <= 0:
                return 0.0, 0
            bounds = Histogram.exponential().bounds
            return _frac_above(bounds, counts, total, target), total
        deltas = ring.window_counters(window_s, now)
        if name == "error_rate":
            done = deltas["requests_completed"] + deltas["requests_failed"]
            return (
                deltas["requests_failed"] / done if done else 0.0,
                done,
            )
        # availability
        bad = sum(deltas[k] for k in _AVAILABILITY_BAD)
        offered = deltas["requests_admitted"] + bad
        return (bad / offered if offered else 0.0, offered)

    def evaluate(
        self, ring: MetricRing, now: Optional[float] = None
    ) -> Dict[str, Any]:
        """Burn-rate report over the ring (pure; safe from any thread)."""
        objectives: Dict[str, Any] = {}
        compliant = True
        for name, target, budget in self._objective_specs():
            windows: Dict[str, Any] = {}
            breach = True
            for label, window_s in self.windows:
                bad_frac, events = self._window_view(name, ring, window_s, now)
                burn = bad_frac / budget
                hot = events >= self.min_events and burn > self.burn_threshold
                breach = breach and hot
                windows[label] = {
                    "window_s": window_s,
                    "bad_fraction": round(bad_frac, 6),
                    "burn_rate": round(burn, 4),
                    "events": events,
                }
            objectives[name] = {
                "target": target,
                "budget": budget,
                "compliant": not breach,
                "windows": windows,
            }
            compliant = compliant and not breach
        return {
            "compliant": compliant,
            "burn_threshold": self.burn_threshold,
            "objectives": objectives,
        }

    def observe_transitions(
        self, report: Dict[str, Any]
    ) -> List[Tuple[str, Dict[str, Any]]]:
        """Edge-detect breaches against the previous report (worker
        thread only): returns ``(kind, fields)`` flight-recorder events —
        ``slo_breach`` on entering breach, ``slo_recovered`` on leaving."""
        events: List[Tuple[str, Dict[str, Any]]] = []
        for name, obj in report["objectives"].items():
            breached = not obj["compliant"]
            was = name in self._breached
            if breached and not was:
                self._breached.add(name)
                burns = {
                    label: w["burn_rate"] for label, w in obj["windows"].items()
                }
                events.append(
                    ("slo_breach", {"objective": name, "target": obj["target"],
                                    "burn_rates": burns})
                )
            elif was and not breached:
                self._breached.discard(name)
                events.append(("slo_recovered", {"objective": name}))
        return events

    @staticmethod
    def merge_reports(reports: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        """Fleet aggregation: compliant iff every replica is; per
        objective/window the max burn and summed events (the hottest
        replica is the one paging matters for)."""
        reports = [r for r in reports if r]
        if not reports:
            return {"compliant": True, "objectives": {}}
        out: Dict[str, Any] = {
            "compliant": all(r.get("compliant", True) for r in reports),
            "burn_threshold": reports[0].get("burn_threshold", 1.0),
            "objectives": {},
        }
        for name, first in reports[0]["objectives"].items():
            windows: Dict[str, Any] = {}
            for label, w in first["windows"].items():
                burns, bads, events = [], [], 0
                for r in reports:
                    rw = r["objectives"].get(name, {}).get("windows", {}).get(label)
                    if not rw:
                        continue
                    burns.append(rw["burn_rate"])
                    bads.append(rw["bad_fraction"])
                    events += rw["events"]
                windows[label] = {
                    "window_s": w["window_s"],
                    "bad_fraction": max(bads) if bads else 0.0,
                    "burn_rate": max(burns) if burns else 0.0,
                    "events": events,
                }
            out["objectives"][name] = {
                "target": first["target"],
                "budget": first["budget"],
                "compliant": all(
                    r["objectives"].get(name, {}).get("compliant", True)
                    for r in reports
                ),
                "windows": windows,
            }
        return out


class CanaryJudge:
    """Scores the first swapped replica of a fleet roll against its
    unswapped siblings before the roll continues.

    The hot-swap manager calls ``judge`` right after engine 0 applies the
    new weights. The judge snapshots the canary's (empty) new-generation
    slice and each sibling's resident-generation slice, waits
    ``window_s`` while live traffic lands on both sides, then compares
    the confirmation-window DELTAS: canary p99 TTFT / inter-token vs.
    the merged sibling baseline, and the canary's error rate. Verdicts:

    - ``pass`` — canary within ratio bounds; the roll continues.
    - ``regression`` — canary p99 exceeds ``ratio * baseline_p99`` (with
      the baseline floored at ``min_baseline_s`` so microsecond noise
      can't fabricate ratios) or its error rate exceeds
      ``max_error_rate``; the manager rolls the canary back and blocks.
    - ``insufficient_traffic`` / ``insufficient_baseline`` — not enough
      settled requests on one side to judge; treated as pass-through
      (the hot-swap manager's error-rate backstop still guards).
    - ``no_siblings`` — single-replica target; nothing to compare.
    """

    def __init__(
        self,
        window_s: float = 30.0,
        min_requests: int = 8,
        poll_s: Optional[float] = None,
        ttft_ratio: float = 2.0,
        inter_token_ratio: float = 2.0,
        max_error_rate: float = 0.25,
        min_baseline_s: float = 0.005,
    ):
        self.window_s = max(0.05, float(window_s))
        self.min_requests = max(1, int(min_requests))
        self.poll_s = (
            float(poll_s) if poll_s else min(0.25, self.window_s / 4.0)
        )
        self.ttft_ratio = float(ttft_ratio)
        self.inter_token_ratio = float(inter_token_ratio)
        self.max_error_rate = float(max_error_rate)
        self.min_baseline_s = float(min_baseline_s)

    def judge(
        self, canary, siblings: Sequence[Any], generation: int
    ) -> Dict[str, Any]:
        """Blocking confirmation window (runs on the deploy manager's
        thread, never the engine worker). ``canary``/``siblings`` are
        engines exposing ``slo_slices``, ``weight_generation`` and
        ``recorder``."""
        recorder = getattr(canary, "recorder", None)
        if recorder is not None:
            recorder.record(
                "canary_begin", generation=int(generation),
                window_s=self.window_s, siblings=len(siblings),
            )
        verdict = self._judge_inner(canary, siblings, generation)
        if recorder is not None:
            fields = {
                k: v for k, v in verdict.items()
                if isinstance(v, (str, int, float, bool)) or v is None
            }
            fields.setdefault("generation", int(generation))
            recorder.record("canary_verdict", **fields)
        return verdict

    def _judge_inner(
        self, canary, siblings: Sequence[Any], generation: int
    ) -> Dict[str, Any]:
        siblings = [s for s in siblings if s is not canary]
        if not siblings:
            return {"verdict": "no_siblings", "reason": "single replica"}
        canary_then = canary.slo_slices.state(generation)
        sibling_then = [
            (sib, int(sib.weight_generation),
             sib.slo_slices.state(int(sib.weight_generation)))
            for sib in siblings
        ]
        deadline = time.monotonic() + self.window_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            time.sleep(min(self.poll_s, remaining))
        canary_delta = GenerationSlices.delta(
            canary.slo_slices.state(generation), canary_then
        )
        sib_now = GenerationSlices.merge_states(
            sib.slo_slices.state(gen) for sib, gen, _ in sibling_then
        )
        sib_then = GenerationSlices.merge_states(
            then for _, _, then in sibling_then
        )
        baseline = GenerationSlices.delta(sib_now, sib_then)
        result: Dict[str, Any] = {
            "generation": int(generation),
            "window_s": self.window_s,
            "canary_requests": canary_delta["completed"] + canary_delta["failed"],
            "baseline_requests": baseline["completed"] + baseline["failed"],
            "canary": canary_delta,
            "baseline": baseline,
        }
        if result["canary_requests"] < self.min_requests:
            result.update(
                verdict="insufficient_traffic",
                reason=(
                    f"canary settled {result['canary_requests']} < "
                    f"{self.min_requests} requests in {self.window_s}s"
                ),
            )
            return result
        if canary_delta["error_rate"] > self.max_error_rate:
            result.update(
                verdict="regression",
                reason=(
                    f"canary error rate {canary_delta['error_rate']:.3f} > "
                    f"{self.max_error_rate}"
                ),
            )
            return result
        if result["baseline_requests"] < self.min_requests:
            result.update(
                verdict="insufficient_baseline",
                reason=(
                    f"siblings settled {result['baseline_requests']} < "
                    f"{self.min_requests} requests in {self.window_s}s"
                ),
            )
            return result
        for name, ratio in (
            ("ttft", self.ttft_ratio), ("inter_token", self.inter_token_ratio)
        ):
            base_p99 = max(baseline[name]["p99"], self.min_baseline_s)
            if canary_delta[name]["count"] and (
                canary_delta[name]["p99"] > ratio * base_p99
            ):
                result.update(
                    verdict="regression",
                    reason=(
                        f"canary {name} p99 "
                        f"{canary_delta[name]['p99'] * 1000:.1f}ms > "
                        f"{ratio}x sibling baseline "
                        f"{base_p99 * 1000:.1f}ms"
                    ),
                )
                return result
        result.update(verdict="pass", reason="within ratio bounds")
        return result
