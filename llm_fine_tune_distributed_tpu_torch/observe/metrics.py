"""Metrics of the port (counterpart of the JAX ``observe/metrics.py``):

- ``MetricLogger``, the trainer's part: an in-memory history of
  ``{"step", "epoch", **logs}`` records with perplexity beside each loss,
  one line per record on stdout, and the atomic ``training_history.json``
  writer. The Aim and JSONL sinks are not ported;
- ``ServingStats``, the serving engines' counters, gauges and latency
  histograms (``GET /v1/stats``), with the JAX package's whole schema
  (counters of features that are not ported, hot-swap's, exist and stay
  0), the per-tenant records and latency histograms included;
- ``prometheus_exposition``, the ``GET /metrics`` text of a snapshot.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from llm_fine_tune_distributed_tpu_torch.observe.tracing import Histogram


def inject_perplexity(logs: Dict[str, float]) -> Dict[str, float]:
    """Add perplexity next to any loss (exp capped at 700, as the JAX
    package caps it)."""
    out = dict(logs)
    if "loss" in out:
        out["perplexity"] = math.exp(min(out["loss"], 700.0))
    if "eval_loss" in out:
        out["eval_perplexity"] = math.exp(min(out["eval_loss"], 700.0))
    return out


class MetricLogger:
    def __init__(self, echo: bool = True):
        """``echo``: print each record (rank 0 of a multi-process run only;
        every rank keeps the history)."""
        self.history: List[Dict[str, float]] = []
        self.echo = echo

    def log(self, step: int, epoch: float, logs: Dict[str, float]) -> None:
        record = {"step": step, "epoch": round(epoch, 4), **inject_perplexity(logs)}
        self.history.append(record)
        if not self.echo:
            return
        rendered = ", ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in record.items()
        )
        print(f"[train] {rendered}", flush=True)

    def save_history(self, path: str) -> None:
        """``training_history.json``, written atomically (tmp + rename)."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.history, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)


class ServingStats:
    """Thread-safe serving counters and gauges (``GET /v1/stats``).

    The engine's worker thread updates them; HTTP handler threads read
    snapshots. Every mutation takes one lock (a handful of integer adds per
    token, nothing next to a decode step).

    Counters (monotonic): ``tokens_served`` (every emitted token, the first
    included), ``requests_admitted``, ``requests_completed``,
    ``requests_abandoned`` (the waiter gave up), ``requests_failed``,
    ``decode_steps``, ``prefill_tokens`` (prompt positions a prefill
    forward ingested), ``decode_tokens`` (tokens emitted by decode ticks),
    ``goodput_tokens`` (tokens of requests that completed); the paged
    engine adds ``prompt_tokens``, ``prefix_tokens_reused`` and
    ``prefill_chunks``. Gauges: ``queue_depth``, ``live_slots``, and the
    paged ``blocks_in_use`` / ``peak_blocks_in_use`` /
    ``prefix_cache_blocks``. Overload control moves
    ``requests_shed_overflow`` (429: a full queue, a displacement or a
    brownout shed), ``requests_shed_deadline`` (shed before prefill: the
    queue deadline or the client's), ``requests_shed_deadline_decode``
    (the client's deadline after admission), ``preemptions``, the
    tier-labelled sheds (``tier_shed_incr``), the waste reasons and the
    ``brownout_stage`` gauge. Multi-tenant LoRA moves ``adapter_loads``,
    ``adapter_evictions``, ``requests_shed_tenant_quota``, the
    ``adapters_resident`` gauge and one ``{requests, tokens, queue_depth}``
    record per tenant ever admitted (``tenant_incr``; the snapshot's
    ``per_tenant``), beside per-tenant TTFT and inter-token histograms
    (``tenant_observe``), created at a tenant's first observation. Supervision moves ``engine_restarts`` and the
    ``engine_generation`` gauge; the engines' snapshots add the string
    ``circuit_state`` and the bool ``draining``, which the exposition turns
    into an ``_info`` label and a 0/1 gauge, as the JAX package's does. The
    snapshot derives ``slot_occupancy``,
    ``prefix_hit_rate``, ``mean_tokens_per_step``, ``goodput_fraction``,
    the pool occupancies when a pool exists (``total_blocks``), a ~1 min
    EWMA of tokens/s (``tokens_per_s_1m``) and each histogram's summary.
    """

    COUNTERS = (
        "tokens_served", "requests_admitted", "requests_completed",
        "requests_abandoned", "decode_steps",
        "prompt_tokens", "prefix_tokens_reused", "prefill_chunks",
        "engine_restarts", "requests_failed",
        "requests_shed_overflow", "requests_shed_deadline",
        "draft_tokens_proposed", "draft_tokens_accepted",
        "adapter_loads", "adapter_evictions", "requests_shed_tenant_quota",
        "weight_swaps", "weight_rollbacks",
        "preemptions", "requests_shed_deadline_decode",
        "goodput_tokens",
        "prefix_blocks_spilled", "prefix_blocks_discarded",
        "host_tier_restore_hits", "host_tier_restore_misses",
        "slots_migrated",
        "prefill_tokens", "decode_tokens",
        "requests_handed_off", "requests_handoff_failed",
    )
    GAUGES = (
        "queue_depth", "live_slots", "engine_generation",
        "blocks_in_use", "peak_blocks_in_use", "prefix_cache_blocks",
        "adapters_resident", "weight_generation", "brownout_stage",
        "weight_bytes", "kv_pool_bytes", "host_tier_bytes",
    )
    # priority tiers and waste reasons of the JAX schema: every label is
    # always present so /v1/stats and /metrics keep one schema at any load
    SHED_TIERS = ("interactive", "batch", "best_effort")
    WASTE_REASONS = ("deadline", "abandoned", "failover", "shed")
    # the per-tenant record's key set, and the latency tails a tenant feels
    TENANT_KEYS = ("requests", "tokens", "queue_depth")
    TENANT_HIST_SPECS = ("ttft_s", "inter_token_s")
    # fixed log buckets (mergeable); spec_run_len counts tokens, so it gets
    # linear unit buckets
    HISTOGRAM_SPECS = (
        "ttft_s", "inter_token_s", "queue_wait_s",
        "decode_tick_s", "prefill_chunk_s", "spec_run_len",
    )

    def __init__(self, slots: int = 0, total_blocks: int = 0):
        self._lock = threading.Lock()
        self.slots = int(slots)
        self.total_blocks = int(total_blocks)
        self._values: Dict[str, int] = {k: 0 for k in self.COUNTERS + self.GAUGES}
        self._tier_shed: Dict[str, int] = {t: 0 for t in self.SHED_TIERS}
        self._waste: Dict[str, int] = {r: 0 for r in self.WASTE_REASONS}
        # tenant -> {TENANT_KEYS: int}, and tenant -> {TENANT_HIST_SPECS: Histogram}
        self._tenants: Dict[str, Dict[str, int]] = {}
        self._tenant_hist: Dict[str, Dict[str, Histogram]] = {}
        self.hist: Dict[str, Histogram] = {
            name: (Histogram.linear(0.0, 16.0, 1.0) if name == "spec_run_len"
                   else Histogram.exponential())
            for name in self.HISTOGRAM_SPECS
        }
        self.started_at = time.monotonic()
        # windowed throughput EWMA, advanced at snapshot time so the token
        # path reads no clock here
        self._rate_t = self.started_at
        self._rate_tokens = 0
        self._rate_ewma: Optional[float] = None

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._values[name] += n

    def gauge(self, name: str, value: int) -> None:
        with self._lock:
            self._values[name] = int(value)

    def gauge_max(self, name: str, value: int) -> None:
        """Ratcheting gauge: keep the high-water mark."""
        with self._lock:
            self._values[name] = max(self._values[name], int(value))

    def tenant_incr(self, tenant: str, name: str, n: int = 1) -> None:
        """Bump one tenant's counter (``TENANT_KEYS``). ``queue_depth`` also
        goes down (-1 at settle) and is floored at 0."""
        with self._lock:
            rec = self._tenants.setdefault(tenant, {k: 0 for k in self.TENANT_KEYS})
            rec[name] = max(rec[name] + n, 0)

    def tenant_merge(self, per_tenant: Dict[str, Dict[str, int]]) -> None:
        """Add another snapshot's ``per_tenant`` map into this one (a
        fleet's replicas sum)."""
        with self._lock:
            for tenant, rec in per_tenant.items():
                mine = self._tenants.setdefault(tenant, {k: 0 for k in self.TENANT_KEYS})
                for k in self.TENANT_KEYS:
                    mine[k] += int(rec.get(k, 0))

    def tenant_observe(self, tenant: str, name: str, value: float) -> None:
        """One observation into a tenant's latency histogram
        (``TENANT_HIST_SPECS``), its set made at the first one."""
        with self._lock:
            hists = self._tenant_hist.get(tenant)
            if hists is None:
                hists = self._tenant_hist[tenant] = {
                    k: Histogram.exponential() for k in self.TENANT_HIST_SPECS}
        hists[name].observe(value)

    def tenant_histograms(self) -> Dict[str, Dict[str, Histogram]]:
        """The per-tenant histograms (a shallow copy of the map; the
        histograms themselves are live and locked)."""
        with self._lock:
            return {t: dict(h) for t, h in self._tenant_hist.items()}

    def tier_shed_incr(self, tier: str, n: int = 1) -> None:
        """Bump one priority tier's shed counter (anything resolved with a
        tier-labelled 429: overflow, displacement, brownout)."""
        with self._lock:
            self._tier_shed[tier] += n

    def waste_incr(self, reason: str, n: int) -> None:
        """Charge ``n`` emitted but discarded tokens to one of
        ``WASTE_REASONS``."""
        with self._lock:
            self._waste[reason] += n

    def observe(self, name: str, value: float) -> None:
        """One histogram observation (under the histogram's own lock)."""
        self.hist[name].observe(value)

    def values(self, names) -> Dict[str, int]:
        """One consistent read of several counters and gauges, under one
        lock (the metric ring's sampler)."""
        with self._lock:
            return {n: self._values.get(n, 0) for n in names}

    def _tokens_rate(self, now: float, tokens_served: int) -> float:
        # irregular-interval EWMA, weight 1 - exp(-dt / 60 s); polls closer
        # than 200 ms reuse the last value
        dt = now - self._rate_t
        if dt >= 0.2:
            inst = max(0, tokens_served - self._rate_tokens) / dt
            w = 1.0 - math.exp(-dt / 60.0)
            self._rate_ewma = inst if self._rate_ewma is None else (1.0 - w) * self._rate_ewma + w * inst
            self._rate_t = now
            self._rate_tokens = tokens_served
        return self._rate_ewma if self._rate_ewma is not None else 0.0

    def snapshot(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            out: Dict[str, Any] = dict(self._values)
            out["tokens_per_s_1m"] = self._tokens_rate(now, out["tokens_served"])
            out["per_tenant"] = {tenant: dict(rec) for tenant, rec in self._tenants.items()}
            out["requests_shed_by_tier"] = dict(self._tier_shed)
            out["wasted_tokens_by_reason"] = dict(self._waste)
        emitted = out["goodput_tokens"] + sum(out["wasted_tokens_by_reason"].values())
        out["goodput_fraction"] = out["goodput_tokens"] / emitted if emitted else 1.0
        out["uptime_s"] = now - self.started_at
        out["slots"] = self.slots
        out["slot_occupancy"] = out["live_slots"] / self.slots if self.slots else 0.0
        if self.total_blocks:
            out["total_blocks"] = self.total_blocks
            out["block_pool_occupancy"] = out["blocks_in_use"] / self.total_blocks
            out["peak_block_pool_occupancy"] = out["peak_blocks_in_use"] / self.total_blocks
        out["prefix_hit_rate"] = (out["prefix_tokens_reused"] / out["prompt_tokens"]
                                  if out["prompt_tokens"] else 0.0)
        out["draft_acceptance_rate"] = (out["draft_tokens_accepted"] / out["draft_tokens_proposed"]
                                        if out["draft_tokens_proposed"] else 0.0)
        out["mean_tokens_per_step"] = (out["tokens_served"] / out["decode_steps"]
                                       if out["decode_steps"] else 0.0)
        out["histograms"] = {name: h.summary() for name, h in self.hist.items()}
        return out


def _prom_name(key: str, prefix: str) -> str:
    # Prometheus spells base units out: a trailing _s becomes _seconds
    base = key[:-2] + "_seconds" if key.endswith("_s") else key
    return f"{prefix}_{base}"


# router counters of the JAX fleet's snapshot, typed as counters
FLEET_COUNTERS = (
    "requests_routed_prefix_affinity",
    "requests_routed_adapter_affinity",
    "requests_routed_least_loaded",
    "requests_routed_round_robin",
    "requests_failed_over",
    "requests_rerouted_overflow",
    "requests_shed_fleet_saturated",
    "requests_shed_fleet_brownout",
)


def prometheus_exposition(snap: Dict[str, Any], histograms: Optional[Dict[str, Histogram]] = None,
                          memory: Optional[Dict[str, Dict[str, Optional[int]]]] = None,
                          prefix: str = "serving",
                          replicas: Optional[List[Tuple[str, Dict[str, Any],
                                                        Optional[Dict[str, Histogram]]]]] = None,
                          tenant_histograms: Optional[Dict[str, Dict[str, Histogram]]] = None,
                          counters: Optional[set] = None) -> str:
    """An engine's or a fleet's ``stats_snapshot()``, live histograms and
    optional ``observe/profiler.device_memory_report()`` as Prometheus text
    (format 0.0.4), line for line the JAX package's exposition of the same
    inputs. ``tenant_histograms`` (``ServingStats.tenant_histograms()`` or a
    fleet's merge) adds the tenant-labelled latency histograms, whose TYPE
    lines stand whenever a map (even empty) is given.

    ``replicas``: a fleet's ``(label, snapshot, histograms)`` per replica.
    Each aggregate sample is then followed by the same metric labelled
    ``replica="<label>"`` for every replica (one ``# TYPE`` per metric), and
    each replica's strings collapse into one ``<prefix>_replica_info`` line.

    Counter keys (``ServingStats.COUNTERS`` + ``FLEET_COUNTERS``, or
    ``counters``) get ``_total`` and ``# TYPE counter``; every other number
    is a gauge; string values collapse into one ``<prefix>_info{...} 1``
    line; a trailing ``_s`` becomes ``_seconds``. The labelled series
    (tenants, shed tiers, wasted tokens, compiles) keep their ``# TYPE``
    lines at zero traffic, so the schema does not change with load.
    """
    if counters is None:
        counters = set(ServingStats.COUNTERS) | set(FLEET_COUNTERS)
    replicas = replicas or []
    lines: List[str] = []
    labels = [f'{key}="{snap[key]}"' for key in sorted(snap) if isinstance(snap[key], str)]
    if labels:
        name = f"{prefix}_info"
        lines.append(f"# TYPE {name} gauge")
        lines.append(f'{name}{{{",".join(labels)}}} 1')
    if replicas:
        name = f"{prefix}_replica_info"
        lines.append(f"# TYPE {name} gauge")
        for label, rsnap, _ in replicas:
            rlabels = [f'replica="{label}"'] + [f'{key}="{rsnap[key]}"' for key in sorted(rsnap)
                                                 if isinstance(rsnap[key], str)]
            lines.append(f'{name}{{{",".join(rlabels)}}} 1')
    for key, value in snap.items():
        if isinstance(value, bool):
            value = int(value)
        if not isinstance(value, (int, float)):
            continue
        name = _prom_name(key, prefix)
        if key in counters:
            name += "_total"
            lines.append(f"# TYPE {name} counter")
        else:
            lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {value:.10g}")
        for label, rsnap, _ in replicas:
            rvalue = rsnap.get(key)
            if isinstance(rvalue, bool):
                rvalue = int(rvalue)
            if isinstance(rvalue, (int, float)):
                lines.append(f'{name}{{replica="{label}"}} {rvalue:.10g}')
    per_tenant = snap.get("per_tenant") or {}
    for key, kind in (("requests", "counter"), ("tokens", "counter"), ("queue_depth", "gauge")):
        name = f"{prefix}_tenant_{key}" + ("_total" if kind == "counter" else "")
        lines.append(f"# TYPE {name} {kind}")
        for tenant in sorted(per_tenant):
            lines.append(f'{name}{{tenant="{tenant}"}} {int(per_tenant[tenant].get(key, 0))}')
    by_tier = snap.get("requests_shed_by_tier") or {}
    name = f"{prefix}_requests_shed_tier_total"
    lines.append(f"# TYPE {name} counter")
    for tier in sorted(by_tier):
        lines.append(f'{name}{{tier="{tier}"}} {int(by_tier[tier])}')
    wasted = snap.get("wasted_tokens_by_reason")
    if wasted is not None:
        name = f"{prefix}_wasted_tokens_total"
        lines.append(f"# TYPE {name} counter")
        for reason in sorted(wasted):
            lines.append(f'{name}{{reason="{reason}"}} {int(wasted[reason])}')
            for label, rsnap, _ in replicas:
                rw = rsnap.get("wasted_tokens_by_reason") or {}
                if reason in rw:
                    lines.append(f'{name}{{replica="{label}",reason="{reason}"}} {int(rw[reason])}')
        name = f"{prefix}_replica_count"  # a single engine is a fleet of one
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {int(snap.get('replicas', 1))}")
    if "host_tier_restore_hits" in snap:
        name = f"{prefix}_host_tier_restores_total"
        lines.append(f"# TYPE {name} counter")
        for result, key in (("hit", "host_tier_restore_hits"), ("miss", "host_tier_restore_misses")):
            lines.append(f'{name}{{result="{result}"}} {int(snap.get(key, 0))}')
            for label, rsnap, _ in replicas:
                if key in rsnap:
                    lines.append(f'{name}{{replica="{label}",result="{result}"}} {int(rsnap[key])}')
    # a fleet's stage split of tokens by replica role
    by_role = snap.get("tokens_by_role")
    if by_role is not None:
        for key, kind in (("prefill_tokens", "counter"), ("decode_tokens", "counter"),
                          ("replicas", "gauge")):
            name = f"{prefix}_role_{key}" + ("_total" if kind == "counter" else "")
            lines.append(f"# TYPE {name} {kind}")
            for role in sorted(by_role):
                lines.append(f'{name}{{role="{role}"}} {int(by_role[role].get(key, 0))}')
    # compile-ledger series: the port compiles no programs, so they carry
    # no samples, but their TYPE lines keep the JAX schema
    for base in ("compiles_total", "compile_seconds_total"):
        lines.append(f"# TYPE {prefix}_{base} counter")
    name = f"{prefix}_recompiles_after_warmup_total"
    lines.append(f"# TYPE {name} counter")
    lines.append(f"{name} 0")
    # the SLO report: one compliance gauge and one burn-rate gauge per
    # (objective, window); the TYPE lines stand whenever the key does
    slo = snap.get("slo")
    if slo is not None:
        name = f"{prefix}_slo_compliant"
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {int(bool(slo.get('compliant', True)))}")
        name = f"{prefix}_slo_burn_rate"
        lines.append(f"# TYPE {name} gauge")
        for obj in sorted(slo.get("objectives") or {}):
            for label, w in sorted((slo["objectives"][obj].get("windows") or {}).items()):
                lines.append(f'{name}{{objective="{obj}",window="{label}"}} '
                             f'{float(w.get("burn_rate", 0.0)):.10g}')
    # settled-request counts and latency p99s by weight generation
    per_gen = snap.get("per_generation")
    if per_gen is not None:
        gen_series = (
            ("generation_requests_completed_total", "counter",
             lambda rec: int(rec.get("completed", 0))),
            ("generation_requests_failed_total", "counter", lambda rec: int(rec.get("failed", 0))),
            ("generation_ttft_p99_seconds", "gauge",
             lambda rec: float((rec.get("ttft") or {}).get("p99", 0.0))),
            ("generation_inter_token_p99_seconds", "gauge",
             lambda rec: float((rec.get("inter_token") or {}).get("p99", 0.0))),
        )
        for base, kind, get in gen_series:
            name = f"{prefix}_{base}"
            lines.append(f"# TYPE {name} {kind}")
            for gen in sorted(per_gen, key=int):
                lines.append(f'{name}{{generation="{gen}"}} {get(per_gen[gen]):.10g}')
    if tenant_histograms is not None:
        for key in ServingStats.TENANT_HIST_SPECS:
            name = _prom_name(f"tenant_{key}", prefix)
            lines.append(f"# TYPE {name} histogram")
            for tenant in sorted(tenant_histograms):
                h = tenant_histograms[tenant].get(key)
                if h is not None:
                    lines.extend(h.prometheus_lines(name, labels=f'tenant="{tenant}"',
                                                    include_type=False))
    for key in histograms or {}:
        name = _prom_name(key, prefix)
        lines.extend(histograms[key].prometheus_lines(name))
        for label, _, rhists in replicas:
            if rhists and key in rhists:
                lines.extend(rhists[key].prometheus_lines(name, labels=f'replica="{label}"',
                                                          include_type=False))
    if memory:
        by_field = {
            "bytes_in_use": "device_hbm_bytes_in_use",
            "peak_bytes_in_use": "device_hbm_peak_bytes_in_use",
            "bytes_limit": "device_hbm_bytes_limit",
        }
        for field, name in by_field.items():
            values = [(dev, memory[dev].get(field)) for dev in sorted(memory)]
            values = [(dev, v) for dev, v in values if v is not None]
            if values:
                lines.append(f"# TYPE {name} gauge")
            lines.extend(f'{name}{{device="{dev}"}} {int(v)}' for dev, v in values)
    return "\n".join(lines) + "\n"


PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
