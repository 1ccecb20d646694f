"""Capacity observatory: turn the serving telemetry the engines already
collect into replica-count decisions (counterpart of the JAX
``observe/capacity.py``, the same classes and arithmetic).

Three layers, measurement before actuation:

- ``LoadForecaster``: rides the engine's MetricRing tick clock (one
  ``update`` per SLO sample, no new clock reads on the token hot path) and
  fits short- and long-horizon irregular-interval EWMAs plus a trend over
  arrival rate, admission rate and token throughput, beside queue depth,
  queue wait and live-slot smoothing. ``forecast(horizon_s)`` extrapolates
  demand along the trend.
- ``SaturationModel``: one replica's sustainable token throughput from its
  measured decode-tick time and slot count (tokens per tick per live slot x
  slots / tick seconds), derated when the MFU and HBM-bandwidth gauges say
  the device is near its ceiling.
- ``recommend_replicas`` and ``capacity_report``: pure decision functions.
  Demand outside the ``[down, up]`` utilization band moves the
  recommendation to ``ceil(demand / (target x per_replica))``; inside the
  band it holds. ``down < target < up`` makes the recommendation cross each
  band once per load direction (no flapping at a plateau).

``Autoscaler`` closes the loop against a fleet: bounded by min and max
replicas and a per-action cooldown, one replica step per decision, with a
``dry-run`` mode that records would-be decisions as ``scale_decision``
flight events without acting. The port serves one engine, so its server
answers ``GET /v1/capacity`` for a fleet of one with autoscaling off.

Everything here is host arithmetic over numbers the stats already keep.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Sequence


class LoadForecaster:
    """Short/long-horizon EWMA + trend over the serving load signals.

    Fed cumulative counters (arrivals, admissions, tokens served) plus
    instantaneous gauges once per MetricRing sample; converts counters to
    rates over the irregular sample interval and blends with
    ``w = 1 - exp(-dt/tau)`` so the horizons are real time constants no
    matter how the tick cadence wobbles. The trend is the smoothed slope
    of the SHORT token-rate EWMA — the signal ``forecast`` extrapolates.

    Pure host arithmetic, explicit ``now`` everywhere: deterministic under
    a synthetic clock.
    """

    RATES = (
        "arrival_rate", "admit_rate", "token_rate",
        # disaggregation split of token_rate: prompt positions ingested by
        # prefill forwards vs tokens emitted by decode ticks — the two
        # demand axes the prefill:decode ratio autoscaler balances
        "prefill_token_rate", "decode_token_rate",
    )

    def __init__(self, short_tau_s: float = 30.0, long_tau_s: float = 300.0):
        self.short_tau_s = float(short_tau_s)
        self.long_tau_s = float(long_tau_s)
        self._t: Optional[float] = None
        self._counters: Dict[str, int] = {}
        self._short: Dict[str, float] = {}
        self._long: Dict[str, float] = {}
        # smoothed d(short token_rate)/dt, tokens/s per second
        self._trend: Optional[float] = None
        self.queue_depth = 0.0
        self.queue_wait_s = 0.0
        self.live_slots_mean = 0.0
        self.samples = 0

    def update(
        self,
        now: float,
        *,
        arrivals: int,
        admitted: int,
        tokens: int,
        queue_depth: int = 0,
        queue_wait_s: float = 0.0,
        live_slots: int = 0,
        prefill_tokens: int = 0,
        decode_tokens: int = 0,
    ) -> None:
        """One sample: cumulative ``arrivals``/``admitted``/``tokens``
        totals plus instantaneous gauges, stamped ``now`` (the caller's
        tick clock). ``prefill_tokens``/``decode_tokens`` are the
        cumulative stage-split counters; callers that don't track the
        split may omit them (the split rates then read 0)."""
        if self._t is None:
            self._t = now
            self._counters = {
                "arrival_rate": int(arrivals),
                "admit_rate": int(admitted),
                "token_rate": int(tokens),
                "prefill_token_rate": int(prefill_tokens),
                "decode_token_rate": int(decode_tokens),
            }
            return
        dt = now - self._t
        if dt <= 1e-6:
            return
        self._t = now
        w_s = 1.0 - math.exp(-dt / self.short_tau_s)
        w_l = 1.0 - math.exp(-dt / self.long_tau_s)
        totals = {
            "arrival_rate": int(arrivals),
            "admit_rate": int(admitted),
            "token_rate": int(tokens),
            "prefill_token_rate": int(prefill_tokens),
            "decode_token_rate": int(decode_tokens),
        }
        prev_token_short = self._short.get("token_rate")
        for name, total in totals.items():
            inst = max(0, total - self._counters.get(name, total)) / dt
            self._counters[name] = total
            self._short[name] = (
                inst if name not in self._short
                else (1.0 - w_s) * self._short[name] + w_s * inst
            )
            self._long[name] = (
                inst if name not in self._long
                else (1.0 - w_l) * self._long[name] + w_l * inst
            )
        if prev_token_short is not None:
            slope = (self._short["token_rate"] - prev_token_short) / dt
            self._trend = (
                slope if self._trend is None
                else (1.0 - w_l) * self._trend + w_l * slope
            )
        self.queue_depth += w_s * (float(queue_depth) - self.queue_depth)
        self.queue_wait_s += w_s * (float(queue_wait_s) - self.queue_wait_s)
        self.live_slots_mean += w_s * (float(live_slots) - self.live_slots_mean)
        self.samples += 1

    @property
    def trend_tokens_per_s2(self) -> float:
        return self._trend or 0.0

    def _staleness(self, now: Optional[float], tau: float) -> float:
        """Read-side decay factor for a stale forecaster. ``update`` only
        runs when the engine ticks, so an idle replica's EWMAs freeze at
        whatever rate the last busy tick measured, and that frozen peak
        would keep a fleet's demand estimate high through a quiet phase so
        that the scale-down band never fires. Decaying by ``exp(-(now - last)/tau)`` at
        read is exactly the continuous limit of feeding zero-rate samples
        over the gap, so a silent forecaster reads the same as one that
        kept sampling an idle engine."""
        if now is None or self._t is None:
            return 1.0
        gap = now - self._t
        if gap <= 0.0:
            return 1.0
        return math.exp(-gap / tau)

    def rate(
        self, name: str, horizon: str = "short", now: Optional[float] = None
    ) -> float:
        table = self._short if horizon == "short" else self._long
        tau = self.short_tau_s if horizon == "short" else self.long_tau_s
        return table.get(name, 0.0) * self._staleness(now, tau)

    def forecast(self, horizon_s: float, now: Optional[float] = None) -> float:
        """Projected token demand ``horizon_s`` ahead: the short-horizon
        rate extrapolated along the smoothed trend, floored at the long-
        horizon baseline's decay toward zero (never negative)."""
        base = self.rate("token_rate", "short", now=now)
        trend = self.trend_tokens_per_s2 * self._staleness(now, self.long_tau_s)
        return max(0.0, base + trend * float(horizon_s))

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Decision-ready view. Pass ``now`` (the reader's clock) to apply
        staleness decay; omit it for the raw last-sample EWMAs."""
        decay_s = self._staleness(now, self.short_tau_s)
        return {
            "samples": self.samples,
            "short_tau_s": self.short_tau_s,
            "long_tau_s": self.long_tau_s,
            "rates_short": {
                n: self.rate(n, "short", now=now) for n in self.RATES
            },
            "rates_long": {
                n: self.rate(n, "long", now=now) for n in self.RATES
            },
            "trend_tokens_per_s2":
                self.trend_tokens_per_s2
                * self._staleness(now, self.long_tau_s),
            "queue_depth": self.queue_depth * decay_s,
            "queue_wait_s": self.queue_wait_s * decay_s,
            "live_slots_mean": self.live_slots_mean * decay_s,
        }


class SaturationModel:
    """Per-replica sustainable token throughput from measured decode ticks.

    One replica at full slots serves ``slots x tokens-per-tick-per-live-
    slot`` tokens per tick (the per-slot rate is 1.0 for plain decode,
    above 1.0 with accepted speculation), and a tick takes the MEASURED
    mean ``decode_tick_s``. When the roofline gauges say the device is
    already past ``derate_above`` utilization, the estimate is shaved
    linearly — a device at its bandwidth ceiling cannot be assumed to
    scale its tick rate with more resident slots.

    Returns 0.0 while no tick has been timed (cold replica): "unknown",
    which the report treats as no-signal rather than zero capacity.
    """

    def __init__(self, derate_above: float = 0.8):
        self.derate_above = float(derate_above)

    def sustainable_tokens_per_s(
        self,
        *,
        slots: int,
        mean_decode_tick_s: float,
        mean_tokens_per_step: float = 0.0,
        live_slots_mean: float = 0.0,
        mfu: float = 0.0,
        hbm_bw_util: float = 0.0,
    ) -> float:
        if mean_decode_tick_s <= 0.0 or slots <= 0:
            return 0.0
        per_slot = (
            mean_tokens_per_step / live_slots_mean
            if live_slots_mean > 0.0 and mean_tokens_per_step > 0.0
            else 1.0
        )
        per_slot = max(1.0, per_slot)  # plain decode floor: 1 token/tick
        rate = slots * per_slot / mean_decode_tick_s
        util = max(float(mfu), float(hbm_bw_util))
        if util > self.derate_above:
            rate *= max(0.0, 1.0 - (util - self.derate_above))
        return rate


def recommend_replicas(
    demand_tokens_per_s: float,
    per_replica_tokens_per_s: float,
    current: int,
    *,
    up: float = 0.85,
    down: float = 0.45,
    target: float = 0.65,
    role: Optional[str] = None,
) -> int:
    """Hysteresis-banded replica recommendation (pure).

    ``role`` scopes the recommendation to one stage of a disaggregated
    fleet: the demand/capacity arguments are then that role's share (the
    prefill-tokens/s or decode-tokens/s axis and the role-capable replica
    count) rather than fleet totals. The band math is identical either
    way — the label exists so per-role calls read as what they are.

    Utilization ``demand / (current x per_replica)`` inside ``[down, up]``
    holds the current count. Above ``up`` the recommendation jumps to
    ``ceil(demand / (target x per_replica))`` (always > current because
    ``up > target``); below ``down`` it shrinks to the same target (never
    below one) — and only if the shrunken fleet would still sit at or
    under ``up``, so a scale-down can never trigger an immediate
    scale-up, and a steady load crosses each band exactly once. The
    Autoscaler paces actuation at one replica step per tick regardless of
    how far the recommendation jumps.
    """
    if current <= 0:
        return max(1, current)
    if per_replica_tokens_per_s <= 0.0:
        return current  # capacity unknown: no signal, no move
    cap = current * per_replica_tokens_per_s
    if demand_tokens_per_s > up * cap:
        return max(
            current + 1,
            math.ceil(demand_tokens_per_s / (target * per_replica_tokens_per_s)),
        )
    if demand_tokens_per_s < down * cap and current > 1:
        n = min(
            current - 1,
            max(1, math.ceil(
                demand_tokens_per_s / (target * per_replica_tokens_per_s)
            )),
        )
        if demand_tokens_per_s <= up * n * per_replica_tokens_per_s:
            return n
    return current


def capacity_report(
    forecasts: Sequence[Dict[str, Any]],
    replica_capacities: Sequence[float],
    current_replicas: int,
    *,
    horizon_s: float = 60.0,
    up: float = 0.85,
    down: float = 0.45,
    target: float = 0.65,
    min_replicas: int = 1,
    max_replicas: Optional[int] = None,
) -> Dict[str, Any]:
    """One decision-ready report (pure) from per-replica forecaster
    snapshots and per-replica sustainable-throughput estimates.

    Fleet load is the SUM of replica rates (the router spreads arrivals,
    so replica arrival rates partition the fleet's); queue signals take
    the worst replica. Demand inflates the measured token rate by the
    backlog factor — a saturated fleet's token rate equals its capacity
    by definition, so the queue is where unmet demand is visible. Unknown
    capacity (no replica has timed a tick yet) recommends no change.
    """
    fleet_arrival = sum(
        f.get("rates_short", {}).get("arrival_rate", 0.0) for f in forecasts
    )
    fleet_admit = sum(
        f.get("rates_short", {}).get("admit_rate", 0.0) for f in forecasts
    )
    fleet_tokens = sum(
        f.get("rates_short", {}).get("token_rate", 0.0) for f in forecasts
    )
    fleet_trend = sum(
        f.get("trend_tokens_per_s2", 0.0) for f in forecasts
    )
    queue_depth = sum(f.get("queue_depth", 0.0) for f in forecasts)
    queue_wait_s = max(
        [f.get("queue_wait_s", 0.0) for f in forecasts], default=0.0
    )
    live_slots = sum(f.get("live_slots_mean", 0.0) for f in forecasts)
    # backlog inflation: queued work per busy slot beyond ~one queued
    # request per slot means the token rate understates offered load
    backlog_factor = 1.0 + max(
        0.0, (queue_depth - live_slots) / max(1.0, live_slots)
    ) if queue_depth > 0 else 1.0
    demand_now = fleet_tokens * backlog_factor
    forecast_demand = max(
        0.0, demand_now + fleet_trend * float(horizon_s)
    )
    known = [c for c in replica_capacities if c > 0.0]
    per_replica = sum(known) / len(known) if known else 0.0
    total_capacity = per_replica * current_replicas
    recommended = recommend_replicas(
        forecast_demand, per_replica, current_replicas,
        up=up, down=down, target=target,
    )
    lo = max(1, int(min_replicas))
    # no ceiling configured -> the recommendation stays unclamped above:
    # even a deployment that cannot grow should SEE the scale-up signal
    hi = int(max_replicas) if max_replicas else None
    recommended = max(recommended, lo)
    if hi is not None:
        recommended = min(recommended, max(hi, lo))
    return {
        "replicas": current_replicas,
        "current_load": {
            "arrival_rate": fleet_arrival,
            "admit_rate": fleet_admit,
            "token_rate": fleet_tokens,
            "queue_depth": queue_depth,
            "queue_wait_s": queue_wait_s,
            "live_slots_mean": live_slots,
            "backlog_factor": backlog_factor,
            "demand_tokens_per_s": demand_now,
        },
        "forecast": {
            "horizon_s": float(horizon_s),
            "demand_tokens_per_s": forecast_demand,
            "trend_tokens_per_s2": fleet_trend,
        },
        "capacity": {
            "per_replica_tokens_per_s": per_replica,
            "total_tokens_per_s": total_capacity,
            "replicas_measured": len(known),
        },
        "headroom": {
            "tokens_per_s": total_capacity - forecast_demand,
            "utilization": (
                forecast_demand / total_capacity if total_capacity else 0.0
            ),
        },
        "recommended_replicas": recommended,
        "bands": {"up": up, "down": down, "target": target},
        "bounds": {"min_replicas": lo, "max_replicas": hi},
    }


def role_sections(
    roles: Sequence[str],
    forecasts: Sequence[Dict[str, Any]],
    replica_capacities: Sequence[float],
    *,
    growth: float = 1.0,
    up: float = 0.85,
    down: float = 0.45,
    target: float = 0.65,
) -> Dict[str, Dict[str, Any]]:
    """Per-role demand/capacity/headroom view of a disaggregated fleet
    (pure). ``roles``/``forecasts``/``replica_capacities`` are parallel
    per-replica sequences; ``growth`` is the fleet forecast-to-now demand
    ratio, applied to each role's measured demand so the role forecasts
    sum to the fleet forecast.

    Demand per stage is summed over EVERY replica (a mixed replica
    contributes to both axes — its prefill tokens are prefill demand no
    matter who served them). Capacity per stage counts the replicas
    CAPABLE of that stage (dedicated + mixed) times the fleet's mean
    per-replica throughput, and the recommendation applies the same
    hysteresis bands as the fleet-level one to the role-scoped numbers.
    """
    known = [c for c in replica_capacities if c > 0.0]
    per_replica = sum(known) / len(known) if known else 0.0
    rate_key = {"prefill": "prefill_token_rate", "decode": "decode_token_rate"}
    out: Dict[str, Dict[str, Any]] = {}
    for stage in ("prefill", "decode"):
        capable = [
            i for i, r in enumerate(roles)
            if r == stage or r == "mixed"
        ]
        dedicated = sum(1 for r in roles if r == stage)
        demand_now = sum(
            f.get("rates_short", {}).get(rate_key[stage], 0.0)
            for f in forecasts
        )
        demand_fc = max(0.0, demand_now * growth)
        capacity = per_replica * len(capable)
        out[stage] = {
            "replicas": len(capable),
            "dedicated_replicas": dedicated,
            "demand_tokens_per_s": demand_now,
            "forecast_demand_tokens_per_s": demand_fc,
            "capacity_tokens_per_s": capacity,
            "headroom_tokens_per_s": capacity - demand_fc,
            "utilization": demand_fc / capacity if capacity else 0.0,
            "recommended_replicas": recommend_replicas(
                demand_fc, per_replica, len(capable),
                up=up, down=down, target=target, role=stage,
            ),
        }
    return out


def report_from_capacity_snapshots(
    snapshots: Sequence[Dict[str, Any]],
    current_replicas: int,
    *,
    model: Optional[SaturationModel] = None,
    horizon_s: float = 60.0,
    min_replicas: int = 1,
    max_replicas: Optional[int] = None,
) -> Dict[str, Any]:
    """``capacity_report`` straight from engine ``capacity_snapshot()``
    dicts: maps each snapshot through the saturation model and hands the
    forecaster views over. Shared by the fleet (N snapshots) and the
    single-engine ``/v1/capacity`` path (one snapshot, a fleet of one).
    Snapshots carrying a ``role`` add a per-role ``roles`` section —
    prefill vs decode demand, capacity, headroom, and a role-scoped
    recommendation — the ratio signal the role-aware Autoscaler acts on."""
    model = model or SaturationModel()
    forecasts = [s.get("forecaster") or {} for s in snapshots]
    capacities = [
        model.sustainable_tokens_per_s(
            slots=int(s.get("slots", 0)),
            mean_decode_tick_s=float(s.get("mean_decode_tick_s", 0.0)),
            mean_tokens_per_step=float(s.get("mean_tokens_per_step", 0.0)),
            live_slots_mean=float(s.get("live_slots_mean", 0.0)),
            mfu=float(s.get("model_flops_utilization", 0.0)),
            hbm_bw_util=float(s.get("hbm_bandwidth_utilization", 0.0)),
        )
        for s in snapshots
    ]
    report = capacity_report(
        forecasts,
        capacities,
        current_replicas,
        horizon_s=horizon_s,
        min_replicas=min_replicas,
        max_replicas=max_replicas,
    )
    roles = [str(s.get("role", "mixed")) for s in snapshots]
    demand_now = report["current_load"]["demand_tokens_per_s"]
    growth = (
        report["forecast"]["demand_tokens_per_s"] / demand_now
        if demand_now > 0.0 else 1.0
    )
    report["roles"] = role_sections(
        roles, forecasts, capacities,
        growth=growth,
        up=report["bands"]["up"],
        down=report["bands"]["down"],
        target=report["bands"]["target"],
    )
    return report


class Autoscaler:
    """Signal-driven elastic fleet control loop.

    ``tick(now)`` computes the fleet's ``capacity_report`` and, when the
    recommendation differs from the live replica count, takes ONE replica
    step toward it — bounded by ``[min_replicas, max_replicas]`` and a
    per-action ``cooldown_s`` (measured from the last APPLIED action, so
    a burst cannot ladder the fleet up faster than replicas warm).

    Modes: ``dry-run`` (default) records every would-be decision as a
    ``scale_decision`` flight event and in the bounded history without
    touching the fleet — run this first, read ``GET /v1/capacity``, then
    flip to ``on``. ``on`` additionally applies the step. ``off`` does
    nothing at all.

    ``tick`` is the deterministic test surface (explicit ``now``);
    ``start``/``stop`` run it on a daemon thread for the server.
    """

    MODES = ("dry-run", "on", "off")

    def __init__(
        self,
        fleet,
        mode: str = "dry-run",
        min_replicas: int = 1,
        max_replicas: int = 1,
        cooldown_s: float = 30.0,
        interval_s: float = 2.0,
        horizon_s: float = 60.0,
        history: int = 64,
        retire_timeout_s: float = 60.0,
        migrate_on_retire: Optional[bool] = None,
        ratio: bool = False,
    ):
        if mode not in self.MODES:
            raise ValueError(
                f"unknown autoscale mode {mode!r} (expected one of {self.MODES})"
            )
        self.fleet = fleet
        self.mode = mode
        # ratio mode (--autoscale-ratio): the prefill:decode ratio becomes
        # a scaling dimension. Scale-ups grow the most-pressured role,
        # scale-downs retire from the least-pressured one, and a role
        # imbalance with totals in-band still moves (grow the starved
        # role, or trade a surplus replica away when already at max).
        self.ratio = bool(ratio)
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self.interval_s = max(0.05, float(interval_s))
        self.horizon_s = float(horizon_s)
        self.retire_timeout_s = float(retire_timeout_s)
        # None defers to the fleet's own migrate_on_retire default; a bool
        # forces scale-down retirement to (not) live-migrate its streams
        self.migrate_on_retire = migrate_on_retire
        self._last_action_t: Optional[float] = None
        self._decisions: "deque[Dict[str, Any]]" = deque(maxlen=int(history))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def tick(self, now: float) -> Optional[Dict[str, Any]]:
        """One control step. Returns the decision record when the
        recommendation called for a change (acted on or dry-run), else
        None. Safe to call concurrently with traffic."""
        if self.mode == "off":
            return None
        report = self.fleet.capacity_report(
            horizon_s=self.horizon_s,
            min_replicas=self.min_replicas,
            max_replicas=self.max_replicas,
        )
        current = int(report["replicas"])
        recommended = int(report["recommended_replicas"])
        role: Optional[str] = None
        if recommended != current:
            direction = "up" if recommended > current else "down"
            role = self._pick_role(report, direction)
        else:
            ratio_move = self._ratio_move(report, current)
            if ratio_move is None:
                return None
            direction, role, recommended = ratio_move
        in_cooldown = (
            self._last_action_t is not None
            and (now - self._last_action_t) < self.cooldown_s
        )
        decision: Dict[str, Any] = {
            "t": now,
            "mode": self.mode,
            "replicas": current,
            "recommended_replicas": recommended,
            "direction": direction,
            "demand_tokens_per_s":
                report["forecast"]["demand_tokens_per_s"],
            "per_replica_tokens_per_s":
                report["capacity"]["per_replica_tokens_per_s"],
            "cooldown": bool(in_cooldown),
            "applied": False,
        }
        if self.ratio:
            decision["role"] = role
            roles = report.get("roles") or {}
            if roles:
                decision["role_demand_tokens_per_s"] = {
                    r: s["demand_tokens_per_s"] for r, s in roles.items()
                }
        if not in_cooldown and self.mode == "on":
            try:
                kwargs: Dict[str, Any] = {}
                if role is not None:
                    # only role-aware fleets see the kwarg: scripted stub
                    # fleets with the old signatures keep working when
                    # ratio mode is off
                    kwargs["role"] = role
                if direction == "up":
                    self.fleet.add_replica(**kwargs)
                else:
                    kwargs["timeout_s"] = self.retire_timeout_s
                    if self.migrate_on_retire is not None:
                        kwargs["migrate"] = self.migrate_on_retire
                    self.fleet.retire_replica(**kwargs)
                decision["applied"] = True
                self._last_action_t = now
            except Exception as e:  # fleet at bounds / factory failure
                decision["error"] = f"{type(e).__name__}: {e}"
        recorder = getattr(self.fleet, "recorder", None)
        if recorder is not None:
            recorder.record(
                "scale_decision",
                **{k: v for k, v in decision.items() if k != "t"},
            )
        with self._lock:
            self._decisions.append(decision)
        return decision

    def _pick_role(self, report: Dict[str, Any], direction: str) -> Optional[str]:
        """Which role a count-driven step should touch (None = fleet
        default, i.e. a mixed replica). Scale-ups grow the most-pressured
        stage; scale-downs give back a dedicated replica of the
        least-pressured stage, or defer to the fleet default when neither
        stage has a dedicated replica to spare."""
        roles = report.get("roles") or {}
        if not self.ratio or not roles:
            return None
        if direction == "up":
            return max(roles, key=lambda r: roles[r]["utilization"])
        cands = [r for r in roles if roles[r]["dedicated_replicas"] > 0]
        if not cands:
            return None
        return min(cands, key=lambda r: roles[r]["utilization"])

    def _ratio_move(
        self, report: Dict[str, Any], current: int
    ) -> Optional[tuple]:
        """A ratio-only step when the fleet total is already in-band:
        (direction, role, recommended) or None. A role whose scoped
        recommendation exceeds its capable count is starved — grow it if
        the fleet has headroom, otherwise trade away a dedicated replica
        of an over-provisioned role so the next tick's count recovery
        re-adds capacity where it's needed."""
        if not self.ratio:
            return None
        roles = report.get("roles") or {}
        if not roles or report["capacity"]["per_replica_tokens_per_s"] <= 0.0:
            return None
        over = [
            r for r, s in roles.items()
            if s["recommended_replicas"] > s["replicas"]
        ]
        under = [
            r for r, s in roles.items()
            if s["recommended_replicas"] < s["replicas"]
            and s["dedicated_replicas"] > 0
        ]
        if not over:
            return None
        starved = max(over, key=lambda r: roles[r]["utilization"])
        if current < self.max_replicas:
            return ("up", starved, current + 1)
        if under and current > self.min_replicas:
            surplus = min(under, key=lambda r: roles[r]["utilization"])
            return ("down", surplus, current - 1)
        return None

    def decisions(self, limit: int = 64) -> List[Dict[str, Any]]:
        """Most recent decisions, newest last (bounded history for
        ``GET /v1/capacity``)."""
        with self._lock:
            out = list(self._decisions)
        return out[-max(1, int(limit)):]

    # -------------------------------------------------- background loop

    def start(self) -> None:
        """Run ``tick`` every ``interval_s`` on a daemon thread (server
        mode; tests call ``tick`` directly)."""
        if self._thread is not None:
            return
        import time as _time

        def _loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick(_time.monotonic())
                except Exception:  # never kill the loop on a bad sample
                    pass

        self._thread = threading.Thread(target=_loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s * 4)
            self._thread = None
