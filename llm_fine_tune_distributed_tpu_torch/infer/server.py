"""HTTP serving of the port (counterpart of the JAX ``infer/server.py`` for
one engine on one card):

  GET  /healthz      -> 200 "ok" (also while a slot engine restarts);
                        503 {"status": "draining"} with Retry-After
                        during a drain; 503 {"status": "unhealthy",
                        "circuit_state", "error"} once a slot engine's
                        circuit opened or a fatal failure ended it
  POST /v1/generate  {"question": ..., optional "system_prompt", "greedy",
                      "seed", "max_new_tokens", "temperature", "top_p",
                      "top_k", "repetition_penalty", "speculative",
                      "priority", "deadline_ms", "trace", "adapter"}
                     -> {"answer": ...}, plus a "speculative" block (the
                     request's own acceptance rate and draft counts) when
                     it asked to speculate, and with "trace": true on a
                     slot engine the request's lifecycle spans ("trace")
  POST /v1/stream    the same body (plus "stream_chunk" for the window
                     engine) -> Server-Sent Events over chunked transfer:
                     one ``data: {"delta": ...}`` per decoded text delta,
                     then ``data: {"done": true, "n_tokens": N}``, or
                     ``event: error`` with the error's body if the request
                     fails mid-stream
  GET  /v1/stats     -> {"engine": ..., **engine.stats_snapshot(),
                        "device_memory": per-card bytes,
                        "device_memory_report": engine.memory_breakdown()}
  GET  /metrics      -> the same snapshot, the latency histograms and the
                        per-card memory gauges as Prometheus text
  GET  /v1/flight?limit=N -> {"events": [...]}: the last N (default 256)
                        events of a slot engine's flight recorder
  GET  /v1/slo       -> the SLO burn-rate report (``--slo-*`` objectives)
  GET  /v1/history?metric=NAME[&window=S] -> the metric ring's series of
                        one sampled counter or gauge
  GET  /v1/capacity  -> the capacity report (load, forecast, sustainable
                        tokens/s, headroom, the replica recommendation, and
                        per role for a disaggregated fleet), with the
                        autoscaler's mode and its recent decisions ("off"
                        and none for a single engine)
  POST /v1/fleet/scale {"replicas": N} -> add or retire replicas until the
                     fleet has N, within [--min-replicas, --max-replicas]
                     (404 without a fleet, 400 outside the bounds, 409 when
                     a step fails) -> {"replicas": N}
  POST /v1/deploy    -> hot-swap the newest verified publish of
                        --publish-watch-dir in (the deploy's result), or
                        {"kind": "noop", ...} when nothing is newer; 409 on
                        a refused or failed swap (the old weights keep
                        serving); 404 without --publish-watch-dir
  POST /v1/deploy/rollback -> swap the previous weights back in (409 when
                        there is nothing to roll back to)
  GET  /v1/lineage   -> the train→serve lineage: which run and step each
                        weight generation came from, the deploy history
                        (deploys, rollbacks, canary rejections) and the
                        per-generation serving slices (404 without
                        --publish-watch-dir)
  POST /v1/profile   {"duration_s": S (default 3)} -> a torch.profiler
                     capture into a fresh subdirectory of --profile-dir,
                     stopped after S seconds (404 without --profile-dir,
                     409 while one runs); decoding pauses while the
                     profiler stops and writes the trace (it holds the
                     GIL: seconds for a capture of a few seconds)
  The routes that read a slot engine (flight, slo, history, capacity)
  answer 404 on the window engine. A fleet answers ``/v1/stats`` with the
  merged view and a ``per_replica`` map, ``/metrics`` with each aggregate
  sample followed by one ``replica="<id>"`` sample per replica, ``/v1/slo``
  and ``/v1/history`` per replica too, and ``/v1/flight`` with
  ``{"fleet": [...], "replicas": {id: [...]}}``.

Engines (``--engine``): ``continuous`` (the default, as in the JAX server)
decodes every request in a persistent slot batch over a dense KV cache;
``paged`` does the same over a block-paged KV pool with a prefix cache and
chunked prefill, and with ``--quantize-kv int8`` its decode attention runs
the paged decode CUDA kernel; ``window`` groups requests that arrive within
``--batch-window-ms`` into one ``generate_batch``. On ``continuous`` and
``paged`` a stream rides the slot batch; on ``window`` it decodes on the
handler's thread (``Generator.generate_stream``).

Speculation: ``"speculative": K`` asks for K drafts per step. With
``--speculative K`` the continuous and paged engines run every tick as the
fused draft-verify step, drafting by prompt lookup or, with ``--draft-dir``,
by a draft model. A slot engine started without it hands speculative
requests to a window engine that the server keeps beside it, whose
``generate_batch`` speculates; ``--engine window`` serves them the same way.
``/v1/stream`` speculates only on a slot engine started with
``--speculative``, and answers 400 otherwise.

Overload control (the continuous and paged engines, as in the JAX server):
``"priority"`` names a tier (``interactive``, ``batch``, ``best_effort``;
``--priority-default`` otherwise) and ``"deadline_ms"`` the client's budget
for the whole request; ``--max-queue-depth`` bounds the queue (429 past
it), ``--queue-deadline-s`` sheds requests queued that long (503),
``--age-promote-s`` ages waiters up a tier, and ``--brownout-queue-wait-s``,
``--brownout-drain-s`` and ``--brownout-cap-tokens`` set the brownout
controller. Every failure of a request maps through
``infer/errors.error_payload`` to its status and a ``{"error": {...}}``
body, with ``Retry-After`` in whole seconds where the engine gives a hint.
The window engine admits in arrival order and refuses both fields.

Supervision (the slot engines, as in the JAX server): a failed tick answers
the requests in flight with 503 ``engine_restarting`` and restarts the
engine in-process after ``--restart-backoff-s`` (doubling up to
``--restart-backoff-max-s``); ``--circuit-threshold`` failures within
``--circuit-window-s`` open the circuit (``/healthz`` 503). Crash artifacts
go to ``--flight-dir``; ``--watchdog-timeout-s`` > 0 ends the process when
a worker makes no progress for that long. SIGTERM drains: admission closes
server-wide (503 ``draining`` with Retry-After), the work in flight
finishes within ``--drain-timeout-s``, then ``serve`` returns and the
process exits 0. ``build_server(control=...)`` hands ``begin_drain`` (what
SIGTERM calls) and ``httpd`` to an in-process caller.

Observability (the slot engines, as in the JAX server): ``--trace-log``
appends every settled request's trace to a JSONL file (rotated past
``--trace-log-max-mb``), ``--slo-*`` set the objectives and windows that
``/v1/slo`` and ``serving_slo_*`` report, ``--slo-sample-interval-s`` the
metric ring's cadence, and ``--profile-dir`` enables ``POST /v1/profile``
(the server warms the profiler up once at start, so CUPTI's set-up is not
paid inside the first capture).

Fleets (the slot engines, as in the JAX server): ``--replicas N`` serves N
supervised replicas of the engine over the one Generator behind the router
of ``infer/fleet.py`` (``--routing prefix|least-loaded|round-robin``).
``--host-tier-mb`` gives the paged replicas one shared host-RAM KV tier
(evicted and preempted blocks spill there and restore from it; live
migration and the prefill/decode handoff ship blocks through it).
``--replica-roles prefill,decode,...`` splits the fleet into pools (paged
with a tier only); ``--migrate-on-retire`` empties a retiring replica by
migrating its requests. ``--autoscale dry-run|on|off`` (default dry-run)
runs the autoscaler between ``--min-replicas`` and ``--max-replicas`` with
``--scale-cooldown-s`` between applied steps, ``--autoscale-ratio`` scaling
the prefill/decode pools; ``--max-replicas`` above ``--replicas`` makes a
fleet that can grow even from one replica. Each replica writes its flight
dumps to ``<--flight-dir>/replica<i>`` and its traces to
``<--trace-log>.replica<i>``. SIGTERM drains every replica.

Multi-tenant LoRA (the slot engines, as in the JAX server): ``--adapter-dir
DIR`` serves every PEFT-layout adapter under DIR beside the base model;
``"adapter": NAME`` on ``/v1/generate`` and ``/v1/stream`` runs the request
with that tenant's delta inside the shared batch (``infer/adapters.py``).
Each replica has its own registry of ``--max-adapters`` slots (slot 0 the
base model) and ``--adapter-capacity`` bounds each tenant's requests in
flight (0: unbounded). An unknown name answers 404 with the known list, a
full pool or a tenant over its quota 429 with Retry-After; a server without
``--adapter-dir`` answers 404, the window engine 400.

Live deployment (the slot engines, as in the JAX server):
``--publish-watch-dir DIR`` (env ``PUBLISH_DIR``) watches a trainer's
publish directory every ``--publish-poll-s`` and hot-swaps each new,
verified publish in at a tick boundary (``infer/deploy.py``), one replica at
a time; ``--canary-window-s`` > 0 judges replica 0 against its siblings for
that long (``--canary-min-requests`` settled requests on each side) before
the roll goes on, and ``--auto-rollback-window-s`` > 0 rolls back by itself
when the error rate in that window after a swap reaches
``--auto-rollback-error-rate``. The window engine is refused.

Run: ``python -m llm_fine_tune_distributed_tpu_torch.infer.server
--model-dir DIR [--engine continuous|paged|window] [--quantize-kv int8]
[--quantize int8|nf4] [--speculative K [--draft-dir DIR]]``. It serves on the
GPU; ``--device cpu`` runs on the CPU.
``--quantize int8`` stores the block linears as weight-only int8, ``nf4`` as
NF4 (``ops/int8.maybe_quantize``); adapter pools and a draft model stay in
full precision. ``build_server`` serves a Generator that is
already in memory (random weights, for instance) without a model directory.
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs

import torch

from llm_fine_tune_distributed_tpu_torch.data.prompts import WILDERNESS_EXPERT_SYSTEM_PROMPT
from llm_fine_tune_distributed_tpu_torch.device import resolve_device
from llm_fine_tune_distributed_tpu_torch.infer.adapters import AdapterRegistry
from llm_fine_tune_distributed_tpu_torch.infer.batching import PRIORITY_TIERS, BatchingEngine
from llm_fine_tune_distributed_tpu_torch.infer.deploy import CheckpointWatcher, HotSwapManager
from llm_fine_tune_distributed_tpu_torch.infer.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from llm_fine_tune_distributed_tpu_torch.infer.errors import (
    DrainingError,
    ServingError,
    error_payload,
)
from llm_fine_tune_distributed_tpu_torch.infer.fleet import EngineFleet
from llm_fine_tune_distributed_tpu_torch.infer.generate import (
    Generator,
    load_model_dir,
    load_tokenizer_dir,
)
from llm_fine_tune_distributed_tpu_torch.infer.paged import HostBlockTier
from llm_fine_tune_distributed_tpu_torch.infer.routing import REPLICA_ROLES, ROUTING_POLICIES
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.observe.capacity import (
    Autoscaler,
    report_from_capacity_snapshots,
)
from llm_fine_tune_distributed_tpu_torch.observe.metrics import (
    PROMETHEUS_CONTENT_TYPE,
    prometheus_exposition,
)
from llm_fine_tune_distributed_tpu_torch.observe.profiler import (
    CaptureBusyError,
    ProfilerCapture,
    device_memory_report,
)
from llm_fine_tune_distributed_tpu_torch.observe.slo import CanaryJudge, SloPolicy
from llm_fine_tune_distributed_tpu_torch.ops.int8 import (
    QUANTIZE_MODES,
    check_quantize_mode,
    maybe_quantize,
)

log = logging.getLogger(__name__)

ENGINES = ("continuous", "paged", "window")
_FIELD_CASTS = {
    "max_new_tokens": int,
    "temperature": float,
    "top_p": float,
    "top_k": int,
    "repetition_penalty": float,
}
# the JAX server's 404 bodies of the routes that need a slot engine or a
# feature the port has not
_NEEDS_SLOT_ENGINE = {
    "/v1/slo": "SLO evaluation needs a continuous/paged engine (the window engine has no "
               "metric ring)",
    "/v1/history": "metric history needs a continuous/paged engine (the window engine has no "
                   "metric ring)",
    "/v1/capacity": "capacity reporting needs a continuous/paged engine (the window engine "
                    "has no load forecaster)",
}
_LINEAGE_404 = "lineage needs live deployment: start the server with --publish-watch-dir"


def parse_overload_fields(req: dict, kind: str):
    """``priority`` (a tier name) and ``deadline_ms`` (the client's budget
    for the whole request) of a request body -> (priority, deadline_s), with
    the JAX server's 400 messages. Both need a slot engine: the window
    engine has no scheduler tick to enforce either."""
    priority = req.get("priority") or None
    if priority is not None:
        if priority not in PRIORITY_TIERS:
            raise ValueError(f"'priority' must be one of {PRIORITY_TIERS}, got {priority!r}")
        if kind == "window":
            raise ValueError("'priority' needs a continuous/paged engine; this server runs "
                             "the window engine, which admits FIFO")
    deadline_s = None
    if req.get("deadline_ms") is not None:
        deadline_s = float(req["deadline_ms"]) / 1000.0
        if not deadline_s > 0:
            raise ValueError("'deadline_ms' must be a positive number of milliseconds, "
                             f"got {req['deadline_ms']!r}")
        if kind == "window":
            raise ValueError("'deadline_ms' needs a continuous/paged engine; this server runs "
                             "the window engine, which cannot cancel mid-decode")
    return priority, deadline_s


def check_engine(engine: str, quantize_kv: str, speculative_k: int = 0,
                 draft_dir: Optional[str] = None) -> None:
    """Refuse an unknown engine, an int8 KV cache on an engine without
    blocks, a draft model without speculation, or engine-level speculation
    on the window engine, before any weight loads (the JAX server's
    refusals)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (expected one of {ENGINES})")
    if quantize_kv != "none" and engine != "paged":
        raise ValueError(
            "--quantize-kv quantizes the PAGED block pool (per-block int8 "
            "scales indexed by block id); the dense/window caches have no "
            "blocks to scale — pick --engine paged or drop --quantize-kv"
        )
    if draft_dir and not speculative_k:
        raise ValueError(
            "--draft-dir requires --speculative K (the draft model only "
            "runs inside the speculative decode loop)"
        )
    if speculative_k and engine == "window":
        raise ValueError(
            "--speculative K applies to the continuous/paged engines "
            "(engine-level fused draft+verify ticks); the window engine "
            "instead takes per-request speculation via POST /v1/generate "
            "with 'speculative': K — drop --speculative or pick "
            "--engine continuous|paged"
        )


def check_adapters(engine: str, adapter_dir: Optional[str]) -> None:
    """Refuse ``--adapter-dir`` on the window engine or when it is not a
    directory, before any weight loads (the JAX server's refusals)."""
    if adapter_dir and engine == "window":
        raise ValueError(
            "--adapter-dir (multi-tenant LoRA serving) needs a continuous/"
            "paged engine (per-request adapter deltas are gathered inside "
            "the fused slot batch, which the window batcher does not run); "
            "drop --adapter-dir or pick --engine continuous|paged"
        )
    if adapter_dir and not os.path.isdir(adapter_dir):
        raise ValueError(
            f"--adapter-dir not found: {adapter_dir!r} (expected a "
            "directory of PEFT-layout adapter subdirectories)"
        )


def check_deploy(engine: str, publish_watch_dir: Optional[str]) -> None:
    """Refuse ``--publish-watch-dir`` on the window engine, before any
    weight loads (the JAX server's refusal)."""
    if publish_watch_dir and engine == "window":
        raise ValueError(
            "--publish-watch-dir (checkpoint hot-swap) needs a continuous/"
            "paged engine — the swap lands at the slot scheduler's tick "
            "boundary, which the window batcher does not have; drop "
            "--publish-watch-dir or pick --engine continuous|paged"
        )


def check_fleet(engine: str, replicas: int = 1, routing: str = "prefix",
                autoscale: str = "dry-run", min_replicas: int = 1, max_replicas: int = 0,
                host_tier_mb: int = 0, migrate_on_retire: bool = False,
                replica_roles: Optional[str] = None, autoscale_ratio: bool = False) -> list:
    """Refuse a fleet setting that cannot work, before any weight loads
    (the JAX server's refusals, in its order). Returns the per-replica roles
    of ``replica_roles`` (a comma list; [] when not given)."""
    replicas = max(1, int(replicas or 1))
    if routing not in ROUTING_POLICIES:
        raise ValueError(f"unknown --routing {routing!r} (expected one of {ROUTING_POLICIES})")
    if replicas > 1 and engine == "window":
        raise ValueError(
            "--replicas N needs a continuous/paged engine (the fleet "
            "router places by queue depth and prefix residency, which the "
            "window batcher does not expose); drop --replicas or pick "
            "--engine continuous|paged"
        )
    autoscale = autoscale or "dry-run"
    if autoscale not in Autoscaler.MODES:
        raise ValueError(f"unknown --autoscale mode {autoscale!r} (expected one of "
                         f"{Autoscaler.MODES})")
    min_replicas = max(1, int(min_replicas or 1))
    max_replicas = max(0, int(max_replicas or 0))
    if max_replicas and max_replicas < replicas:
        raise ValueError(
            "--max-replicas must be >= --replicas (the fleet starts at "
            f"--replicas); got {max_replicas} < {replicas}"
        )
    if min_replicas > replicas:
        raise ValueError(
            "--min-replicas must be <= --replicas (the fleet starts at "
            f"--replicas); got {min_replicas} > {replicas}"
        )
    if max_replicas > replicas and engine == "window":
        raise ValueError(
            "--max-replicas (elastic fleet growth) needs a continuous/"
            "paged engine; drop --max-replicas or pick "
            "--engine continuous|paged"
        )
    if host_tier_mb and engine != "paged":
        raise ValueError(
            "--host-tier-mb spills paged KV BLOCKS to host RAM on eviction/"
            "preemption; the dense/window caches have no blocks to spill — "
            "pick --engine paged or drop --host-tier-mb"
        )
    fleet = replicas > 1 or max_replicas > replicas
    if migrate_on_retire and not fleet:
        raise ValueError(
            "--migrate-on-retire live-migrates a retiring replica's "
            "requests to SIBLING replicas; it needs a fleet — set "
            "--replicas > 1 (or --max-replicas above --replicas) or drop "
            "--migrate-on-retire"
        )
    roles: list = []
    if replica_roles:
        roles = [r.strip() for r in str(replica_roles).split(",") if r.strip()]
        bad = [r for r in roles if r not in REPLICA_ROLES]
        if bad:
            raise ValueError(f"unknown role(s) {bad} in --replica-roles (expected a comma list "
                             f"over {REPLICA_ROLES})")
        if len(roles) != replicas:
            raise ValueError(
                "--replica-roles must name one role per starting replica; "
                f"got {len(roles)} roles for --replicas {replicas}"
            )
        if not fleet:
            raise ValueError(
                "--replica-roles splits a FLEET into prefill/decode pools; "
                "set --replicas > 1 (or --max-replicas above --replicas) "
                "or drop --replica-roles"
            )
        if any(r != "mixed" for r in roles) and (engine != "paged" or not host_tier_mb):
            raise ValueError(
                "prefill/decode roles hand a request over by shipping its "
                "KV blocks through the shared host tier — they need "
                "--engine paged AND --host-tier-mb > 0; drop "
                "--replica-roles or add both"
            )
    if autoscale_ratio and not any(r != "mixed" for r in roles):
        raise ValueError(
            "--autoscale-ratio treats the prefill/decode pool ratio as a "
            "scaling dimension; it needs --replica-roles with at least one "
            "prefill or decode replica"
        )
    return roles


class _Server(ThreadingHTTPServer):
    """The HTTP server; closing it also stops the hot-swap manager's and the
    autoscaler's threads, a running profiler capture and the window engine
    it keeps beside a slot engine."""

    daemon_threads = True
    window_engine = None
    profiler_capture = None
    autoscaler = None
    deploy_manager = None

    def server_close(self) -> None:
        super().server_close()
        if self.deploy_manager is not None:
            self.deploy_manager.stop()
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.profiler_capture is not None:
            self.profiler_capture.stop()
        if self.window_engine is not None:
            self.window_engine.close()


class _ClientGone(Exception):
    """A write to the client failed: it closed the connection."""


def _pieces(first: Optional[int], tokens):
    """A slot engine's stream as one-token pieces, its first token already
    read (None: the request ended without one)."""
    if first is None:
        return
    yield [first]
    for t in tokens:
        yield [t]


def _stable_prefix(text: str) -> str:
    """``text`` without its trailing U+FFFD: a byte sequence cut mid
    character decodes to a replacement character that later bytes may
    complete, so a stream holds it back until the next token (or the end)."""
    return text.rstrip("\ufffd")


def build_server(
    generator: Generator,
    *,
    host: str = "127.0.0.1",
    port: int = 8080,
    engine: str = "continuous",
    quantize_kv: str = "none",
    slots: int = 8,
    kv_buf_len: int = 4096,
    kv_block_len: int = 256,
    prefill_chunk: int = 512,
    prompt_bucket: int = 64,
    max_batch: int = 8,
    batch_window_ms: float = 10.0,
    request_timeout_s: Optional[float] = 600.0,
    template_kwargs: Optional[dict] = None,
    speculative_k: int = 0,
    max_queue_depth: int = 256,
    queue_deadline_s: Optional[float] = None,
    priority_default: str = "interactive",
    age_promote_s: float = 5.0,
    brownout_queue_wait_s: float = 2.0,
    brownout_drain_s: float = 10.0,
    brownout_cap_tokens: int = 32,
    drain_timeout_s: float = 30.0,
    restart_backoff_s: float = 0.5,
    restart_backoff_max_s: float = 30.0,
    circuit_threshold: int = 5,
    circuit_window_s: float = 60.0,
    watchdog_timeout_s: float = 0.0,
    flight_dir: Optional[str] = None,
    trace_log: Optional[str] = None,
    trace_log_max_mb: float = 0.0,
    profile_dir: Optional[str] = None,
    slo_ttft_p99_s: float = 2.0,
    slo_inter_token_p99_s: float = 0.5,
    slo_error_rate: float = 0.01,
    slo_availability: float = 0.999,
    slo_fast_window_s: float = 60.0,
    slo_slow_window_s: float = 600.0,
    slo_sample_interval_s: float = 1.0,
    replicas: int = 1,
    routing: str = "prefix",
    replica_roles: Optional[str] = None,
    host_tier_mb: int = 0,
    migrate_on_retire: bool = False,
    autoscale: str = "dry-run",
    min_replicas: int = 1,
    max_replicas: int = 0,
    scale_cooldown_s: float = 30.0,
    autoscale_ratio: bool = False,
    adapter_dir: Optional[str] = None,
    max_adapters: int = 8,
    adapter_capacity: int = 0,
    publish_watch_dir: Optional[str] = None,
    publish_poll_s: float = 2.0,
    auto_rollback_window_s: float = 0.0,
    auto_rollback_error_rate: float = 0.5,
    canary_window_s: float = 0.0,
    canary_min_requests: int = 8,
    control: Optional[dict] = None,
):
    """Start an ``engine`` over ``generator`` and bind an HTTP server to it.
    Returns ``(httpd, engine)``; the caller runs ``run_server(httpd,
    engine)`` (or ``httpd.serve_forever`` and, when done,
    ``httpd.shutdown()``, ``httpd.server_close()``, which also stops the
    window engine kept beside a slot engine, ``httpd.window_engine``, and
    ``engine.close()``). ``speculative_k`` > 0 runs the slot engine's ticks
    as fused draft-verify steps (a draft model, if the generator has one).
    ``template_kwargs`` go to the chat template. The overload settings
    (``max_queue_depth`` ... ``brownout_cap_tokens``) and the supervision
    settings (``restart_backoff_s`` ... ``flight_dir``), the JAX server's
    defaults, go to the continuous and paged engines, and so do the
    observability settings (``trace_log`` ... ``slo_sample_interval_s``;
    ``profile_dir`` enables ``POST /v1/profile``). ``httpd.begin_drain``
    (also ``control["begin_drain"]``, beside ``control["httpd"]``) closes
    admission, waits up to ``drain_timeout_s`` for the engines to drain and
    then shuts the server down. ``replicas`` ... ``autoscale_ratio`` are the
    fleet settings of the JAX server (``check_fleet``); with a fleet the
    returned engine is the ``EngineFleet``, and ``httpd.autoscaler`` its
    autoscaler. ``adapter_dir`` serves the LoRA adapters under it, each
    replica through its own ``AdapterRegistry`` of ``max_adapters`` slots,
    with ``adapter_capacity`` requests in flight per tenant (0: unbounded).
    ``publish_watch_dir`` ... ``canary_min_requests`` are the live
    deployment settings: a ``HotSwapManager`` (``httpd.deploy_manager``,
    also ``control["deploy"]``) polls the directory, started once the
    engines are up and stopped with the server."""
    speculative_k = max(0, int(speculative_k or 0))
    check_engine(engine, quantize_kv, speculative_k)
    check_adapters(engine, adapter_dir)
    check_deploy(engine, publish_watch_dir)
    roles = check_fleet(engine, replicas, routing, autoscale, min_replicas, max_replicas,
                        host_tier_mb, migrate_on_retire, replica_roles, autoscale_ratio)
    replicas = max(1, int(replicas or 1))
    min_replicas = max(1, int(min_replicas or 1))
    max_replicas = max(0, int(max_replicas or 0))
    fleet = replicas > 1 or max_replicas > replicas
    kind = engine
    # the window engine always exists: under --engine window it serves
    # everything, beside a slot engine started without --speculative it
    # serves the speculative requests
    window = BatchingEngine(generator, max_batch=max_batch, window_ms=batch_window_ms)
    overload = dict(max_queue_depth=max_queue_depth, queue_deadline_s=queue_deadline_s,
                    priority_default=priority_default, age_promote_s=age_promote_s,
                    brownout_queue_wait_s=brownout_queue_wait_s,
                    brownout_drain_s=brownout_drain_s, brownout_cap_tokens=brownout_cap_tokens,
                    restart_backoff_s=restart_backoff_s,
                    restart_backoff_max_s=restart_backoff_max_s,
                    circuit_threshold=circuit_threshold, circuit_window_s=circuit_window_s,
                    watchdog_timeout_s=watchdog_timeout_s, flight_dir=flight_dir,
                    trace_log=trace_log or None, trace_log_max_mb=trace_log_max_mb,
                    slo_sample_interval_s=slo_sample_interval_s)
    # ONE host tier shared by every paged replica: migration and the
    # prefill/decode handoff ship blocks through it
    host_tier = None
    if host_tier_mb and kind == "paged":
        host_tier = HostBlockTier(int(host_tier_mb) * 1024 * 1024)
        log.info("host KV tier: %d MiB", host_tier_mb)

    def make_replica(i: int, role: Optional[str] = None):
        """One replica over the shared generator with its own pool,
        supervisor, stats and SloPolicy (the policy keeps breach state).
        ``role`` comes from the autoscaler growing a pool; otherwise
        ``replica_roles`` assigns by index and replicas past it are mixed.
        In a fleet each replica writes its flight dumps and traces apart."""
        kw = dict(overload, role=role or (roles[i] if i < len(roles) else "mixed"),
                  slo_policy=SloPolicy(ttft_p99_s=slo_ttft_p99_s,
                                       inter_token_p99_s=slo_inter_token_p99_s,
                                       error_rate=slo_error_rate, availability=slo_availability,
                                       fast_window_s=slo_fast_window_s,
                                       slow_window_s=slo_slow_window_s))
        if adapter_dir:
            # a registry per replica: residency is the replica's own (the
            # router sends a tenant where its adapter is), and the pools are
            # written in place, so a shared one would let one replica's
            # eviction pull a slot another decodes with
            kw["adapters"] = AdapterRegistry(generator.params, adapter_dir,
                                             max_adapters=max_adapters)
            kw["adapter_quota"] = adapter_capacity
        if fleet:
            if kw["flight_dir"]:
                kw["flight_dir"] = os.path.join(kw["flight_dir"], f"replica{i}")
            if kw["trace_log"]:
                kw["trace_log"] = f"{kw['trace_log']}.replica{i}"
        if kind == "continuous":
            return ContinuousBatchingEngine(generator, slots=slots, buf_len=kv_buf_len,
                                            prompt_bucket=prompt_bucket,
                                            speculative_k=speculative_k, **kw)
        return PagedContinuousBatchingEngine(
            generator, slots=slots, buf_len=kv_buf_len, prompt_bucket=prompt_bucket,
            block_len=kv_block_len, prefill_chunk=prefill_chunk, kv_quant=quantize_kv,
            speculative_k=speculative_k, host_tier=host_tier, **kw,
        )

    drain_state = {"draining": False}
    autoscaler = None
    if kind == "window":
        engine = window
    elif fleet:
        engine = EngineFleet([make_replica(i) for i in range(replicas)], routing=routing,
                             replica_factory=make_replica, migrate_on_retire=migrate_on_retire)
        # the elastic control loop: dry-run records would-be decisions
        # (GET /v1/capacity, the fleet's flight events) without acting
        autoscaler = Autoscaler(engine, mode=autoscale, min_replicas=min_replicas,
                                max_replicas=max_replicas or replicas, cooldown_s=scale_cooldown_s,
                                retire_timeout_s=drain_timeout_s, ratio=autoscale_ratio)
        if autoscale != "off":
            autoscaler.start()
            log.info("autoscaler (%s): replicas in [%d, %d], cooldown %gs", autoscale,
                     min_replicas, max_replicas or replicas, scale_cooldown_s)
    else:
        engine = make_replica(0)
    # the replica the profiler's events and tick boundary come from
    first = engine.replicas[0] if fleet and kind != "window" else engine

    # one capture per process (the profiler is process-wide), on the slot
    # engine's flight-recorder timeline and its tick boundaries (a fleet's
    # first replica's timeline; its ticks are not held)
    capture = None
    if profile_dir:
        slot = kind != "window"
        capture = ProfilerCapture(profile_dir,
                                  on_event=first.recorder.record if slot else None,
                                  boundary=first.tick_boundary if slot and not fleet else None)
        log.info("profiler warmed up for POST /v1/profile in %.1f s", capture.warm_up())

    # live deployment: the manager watches the publish directory and rolls
    # each verified publish over the replicas; the resident base it verifies
    # against is read off replica 0 when a publish arrives
    deploy_mgr = None
    if publish_watch_dir:
        canary = (CanaryJudge(window_s=canary_window_s, min_requests=canary_min_requests)
                  if canary_window_s > 0 else None)
        deploy_mgr = HotSwapManager(
            engine, CheckpointWatcher(publish_watch_dir, base_params=lambda: first.params),
            poll_s=publish_poll_s, auto_rollback_window_s=auto_rollback_window_s,
            auto_rollback_error_rate=auto_rollback_error_rate, canary=canary)
        deploy_mgr.start()
        print(f"[serve] watching {publish_watch_dir} for published checkpoints (poll every "
              f"{publish_poll_s:g}s"
              + (f", auto-rollback at {auto_rollback_error_rate:.0%} errors over "
                 f"{auto_rollback_window_s:g}s" if auto_rollback_window_s > 0 else "")
              + (f", canary window {canary_window_s:g}s" if canary else "") + ")", flush=True)

    def snapshot() -> dict:
        if kind == "window":
            return {"engine": kind, "queue_depth": engine.queue_depth, "max_batch": max_batch}
        return {"engine": kind, **engine.stats_snapshot()}

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 so /v1/stream may use chunked transfer encoding (every
        # other response carries a Content-Length)
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet: one line per request at debug
            log.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, code: int, payload, content_type: Optional[str] = None,
                  headers: Optional[dict] = None) -> None:
            body = (payload if isinstance(payload, str) else json.dumps(payload)).encode()
            self.send_response(code)
            self.send_header("Content-Type", content_type or (
                "text/plain" if isinstance(payload, str) else "application/json"))
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(body)

        def _send_error(self, exc: BaseException) -> None:
            """Any failure through the taxonomy: its status, the structured
            body, and Retry-After when the engine gave a hint (rounded up to
            a positive whole number of seconds)."""
            status, payload, retry_after = error_payload(exc)
            headers = {}
            if retry_after is not None:
                headers["Retry-After"] = max(1, int(-(-retry_after // 1)))
            self._send(status, payload, headers=headers)

        def do_GET(self):  # noqa: N802 (stdlib casing)
            path, _, query = self.path.partition("?")
            if path == "/healthz":
                if drain_state["draining"]:
                    # SIGTERM: stop routing here while the work in flight ends
                    self._send(503, {"status": "draining"},
                               headers={"Retry-After": max(1, int(drain_timeout_s))})
                elif kind != "window" and not engine.healthy:
                    # circuit open or fatal: in-process recovery is over, ask
                    # the orchestrator for a restart
                    self._send(503, {"status": "unhealthy", "circuit_state": engine.circuit_state,
                                     "error": engine.terminal_error.to_dict()})
                else:
                    self._send(200, "ok")
            elif path == "/v1/stats":
                stats = snapshot()
                stats["device_memory"] = device_memory_report()
                if kind != "window":
                    stats["device_memory_report"] = engine.memory_breakdown()
                self._send(200, stats)
            elif path == "/metrics":
                self._send(200, self._metrics(), content_type=PROMETHEUS_CONTENT_TYPE)
            elif path == "/v1/flight":
                self._flight(query)
            elif path == "/v1/lineage":
                self._lineage()
            elif path in _NEEDS_SLOT_ENGINE and kind == "window":
                self._send(404, {"error": _NEEDS_SLOT_ENGINE[path]})
            elif path == "/v1/slo":
                self._send(200, {"engine": kind, **engine.slo_report()})
            elif path == "/v1/history":
                self._history(query)
            elif path == "/v1/capacity":
                if fleet:
                    report = engine.capacity_report(horizon_s=autoscaler.horizon_s,
                                                    min_replicas=min_replicas,
                                                    max_replicas=autoscaler.max_replicas)
                else:  # a fleet of one
                    report = report_from_capacity_snapshots([engine.capacity_snapshot()], 1)
                report.update(engine=kind, autoscale=autoscaler.mode if autoscaler else "off",
                              decisions=autoscaler.decisions() if autoscaler else [])
                self._send(200, report)
            else:
                self._send(404, {"error": "not found"})

        def _lineage(self) -> None:
            """The manager's lineage, each generation joined with its
            serving slice (a fleet's merged per-generation view)."""
            if deploy_mgr is None:
                self._send(404, {"error": _LINEAGE_404})
                return
            payload = deploy_mgr.lineage()
            slices = (engine.stats_snapshot().get("per_generation") if fleet
                      else engine.slo_slices.summaries())
            if slices:
                payload["serving"] = slices
                for gen, rec in payload["generations"].items():
                    if gen in slices:
                        rec["slo"] = slices[gen]
            self._send(200, payload)

        def _deploy(self) -> None:
            """POST /v1/deploy and /v1/deploy/rollback (not behind the drain
            guard: a draining server may still be rolled back)."""
            if deploy_mgr is None:
                self._send(404, {"error": "live deployment disabled; start the server with "
                                          "--publish-watch-dir"})
                return
            try:
                if self.path.endswith("/rollback"):
                    result = deploy_mgr.rollback()
                else:
                    result = deploy_mgr.poll_once() or {
                        "kind": "noop",
                        "detail": "no publish newer than the deployed generation",
                        **deploy_mgr.status(),
                    }
            except RuntimeError as e:
                self._send(409, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — through the taxonomy
                self._send_error(e)
                return
            self._send(200, result)

        def _metrics(self) -> str:
            """Prometheus text; a fleet's aggregate samples are each followed
            by one sample per replica, labelled by its stable id."""
            if kind == "window":
                return prometheus_exposition(snapshot(), None, memory=device_memory_report())
            snap = snapshot()
            series = None
            if fleet:
                per = snap.pop("per_replica")
                by_id = dict(engine.replica_items())  # a replica retired since drops out
                series = [(label, per[label], by_id[int(label)].stats.hist)
                          for label in sorted(per, key=int) if int(label) in by_id]
                hists = engine.merged_histograms()
                tenant_hists = engine.merged_tenant_histograms()
            else:
                hists = engine.stats.hist
                tenant_hists = engine.stats.tenant_histograms()
            return prometheus_exposition(snap, hists, memory=device_memory_report(),
                                         replicas=series, tenant_histograms=tenant_hists)

        def _history(self, query: str) -> None:
            """The metric ring's trailing series of one sampled counter or
            gauge: ``?metric=<name>[&window=<seconds>]``."""
            qs = parse_qs(query)
            metric = (qs.get("metric") or [None])[0]
            if not metric:
                self._send(400, {"error": "missing ?metric=<name> "
                                          "(GET /v1/history?metric=queue_depth&window=60)"})
                return
            window_s = None
            try:
                if qs.get("window"):
                    window_s = float(qs["window"][0])
                    if not window_s > 0:
                        raise ValueError
            except ValueError:
                self._send(400, {"error": f"'window' must be a positive number of seconds, "
                                          f"got {qs['window'][0]!r}"})
                return
            try:
                self._send(200, engine.history(metric, window_s))
            except ValueError as e:
                self._send(400, {"error": str(e)})

        def _flight(self, query: str) -> None:
            """The slot engine's flight recorder, live: the ring the
            supervisor dumps after a crash."""
            if kind == "window":
                self._send(404, {"error": "flight events need a continuous/paged engine (the "
                                          "window engine has no flight recorder)"})
                return
            qs = parse_qs(query)
            try:
                limit = int((qs.get("limit") or [256])[0])
                if limit <= 0:
                    raise ValueError
            except ValueError:
                self._send(400, {"error": f"'limit' must be a positive integer, "
                                          f"got {qs['limit'][0]!r}"})
                return
            if fleet:  # the fleet's own timeline and each replica's, by id
                self._send(200, {"fleet": engine.recorder.events()[-limit:],
                                 "replicas": {str(rid): rep.recorder.events()[-limit:]
                                              for rid, rep in engine.replica_items()}})
            else:
                self._send(200, {"events": engine.recorder.events()[-limit:]})

        def _parse(self):
            """The request body -> (prompt ids, GenerationConfig, seed, the
            body, priority, deadline_s, trace wanted, adapter); ValueError,
            KeyError or TypeError for a bad body."""
            length = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(req, dict):
                raise TypeError("body must be a JSON object")
            want_trace = bool(req.get("trace", False))
            question = req["question"]
            gen_kwargs = {k: cast(req[k]) for k, cast in _FIELD_CASTS.items() if k in req}
            if "greedy" in req:
                gen_kwargs["do_sample"] = not req["greedy"]
            if "speculative" in req:
                gen_kwargs["speculative_lookup"] = int(req["speculative"])
            adapter = req.get("adapter") or None
            if adapter is not None and not isinstance(adapter, str):
                raise ValueError("'adapter' must be a string adapter name")
            if adapter and kind == "window":
                # the window batcher has no adapter pool: per-request deltas
                # ride the slot batch only
                raise ValueError(
                    "'adapter' needs a continuous/paged engine started "
                    "with --adapter-dir; this server runs the window "
                    "engine — supported: requests without 'adapter' "
                    "(base model), or a server started with "
                    "--engine continuous|paged --adapter-dir DIR"
                )
            if adapter and gen_kwargs.get("speculative_lookup", 0) > 0 and not speculative_k:
                # a speculative request on a K=0 slot engine falls back to
                # the window engine, which has no adapter pool
                raise ValueError(
                    "'adapter' with 'speculative' needs the server "
                    "started with --speculative K (on a K=0 engine "
                    "speculative requests fall back to the window "
                    "engine, which has no adapter pool); drop "
                    "'speculative' or restart with --speculative K"
                )
            priority, deadline_s = parse_overload_fields(req, kind)
            if ((priority is not None or deadline_s is not None)
                    and gen_kwargs.get("speculative_lookup", 0) > 0 and not speculative_k):
                # a speculative request on a slot engine without
                # --speculative rides the window engine, which has no
                # scheduler to honour either field
                raise ValueError(
                    "'priority'/'deadline_ms' with 'speculative' needs the server started "
                    "with --speculative K (on a K=0 engine speculative requests fall back to "
                    "the window engine); drop 'speculative' or restart with --speculative K"
                )
            messages = [
                {"role": "system",
                 "content": req.get("system_prompt", WILDERNESS_EXPERT_SYSTEM_PROMPT)},
                {"role": "user", "content": question},
            ]
            prompt_ids = generator.encode_chat(messages, **(template_kwargs or {}))
            return (prompt_ids, GenerationConfig(**gen_kwargs), int(req.get("seed", 0)), req,
                    priority, deadline_s, want_trace, adapter)

        def _profile(self) -> None:
            """POST /v1/profile: start a bounded capture (404 without
            --profile-dir, 409 while one runs, 400 on a bad body)."""
            if capture is None:
                self._send(404, {"error": "profiling disabled; start the server with "
                                          "--profile-dir"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise TypeError("body must be a JSON object")
                duration_s = float(req.get("duration_s", 3.0))
                trace_dir = capture.start(duration_s)
            except CaptureBusyError as e:
                self._send(409, {"error": str(e)})
                return
            except (ValueError, TypeError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            self._send(200, {"profiling": True, "trace_dir": trace_dir, "duration_s": duration_s})

        def _scale(self) -> None:
            """POST /v1/fleet/scale: step the fleet to an absolute replica
            count within the autoscaler's bounds. Not behind the drain
            guard: an operator may shed replicas while work finishes."""
            if not fleet:
                self._send(404, {"error": "fleet scaling needs --replicas > 1 or --max-replicas "
                                          "above --replicas"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                target = int(json.loads(self.rfile.read(length) or b"{}")["replicas"])
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": "bad request: body must be a JSON object with an "
                                          f"integer 'replicas' ({e})"})
                return
            lo, hi = min_replicas, autoscaler.max_replicas
            if not lo <= target <= hi:
                self._send(400, {"error": f"'replicas' must be within [{lo}, {hi}], got {target}"})
                return
            try:
                while len(engine.replicas) < target:
                    engine.add_replica()
                while len(engine.replicas) > target:
                    engine.retire_replica(timeout_s=drain_timeout_s)
            except (RuntimeError, ValueError) as e:
                self._send(409, {"error": str(e)})
                return
            self._send(200, {"replicas": len(engine.replicas)})

        def do_POST(self):  # noqa: N802
            if self.path == "/v1/fleet/scale":
                self._scale()
                return
            if self.path in ("/v1/deploy", "/v1/deploy/rollback"):
                self._deploy()
                return
            if self.path not in ("/v1/generate", "/v1/stream", "/v1/profile"):
                self._send(404, {"error": "not found"})
                return
            if drain_state["draining"]:
                # admission is closed server-wide; the work in flight runs on
                self._send_error(DrainingError("server draining; retry against another replica",
                                               retry_after_s=float(drain_timeout_s)))
                return
            if self.path == "/v1/profile":
                self._profile()
                return
            try:
                prompt_ids, gen, seed, req, priority, deadline_s, want_trace, adapter = self._parse()
                stream_chunk = int(req.get("stream_chunk", 8))
                if stream_chunk < 1:
                    raise ValueError(f"stream_chunk must be >= 1, got {stream_chunk}")
                if self.path == "/v1/stream" and gen.speculative_lookup:
                    self._check_stream_speculation()
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            overload = {} if kind == "window" else dict(priority=priority, deadline_s=deadline_s)
            if adapter is not None:
                overload["adapter"] = adapter
            if self.path == "/v1/stream":
                self._stream(prompt_ids, gen, seed, stream_chunk, overload)
                return
            # speculative requests ride the slot batch of an engine started
            # with --speculative K; otherwise the window engine speculates
            # in generate_batch
            if kind != "window" and (gen.speculative_lookup == 0 or speculative_k):
                submit = functools.partial(engine.submit_full, **overload)
            else:
                submit = window.submit_full
            try:
                done = submit(prompt_ids, gen, seed=seed, timeout=request_timeout_s)
                answer = generator.decode_reply(done.result)
            except Exception as e:  # request boundary: report, keep serving
                if not isinstance(e, (ServingError, TimeoutError)):
                    log.exception("generate failed")
                self._send_error(e)
                return
            resp = {"answer": answer}
            if gen.speculative_lookup > 0 and done.spec_acceptance is not None:
                # this request's own draft counts, not its batch's
                resp["speculative"] = {
                    "acceptance_rate": round(done.spec_acceptance, 3),
                    "draft_tokens_proposed": done.draft_tokens_proposed,
                    "draft_tokens_accepted": done.draft_tokens_accepted,
                }
                if done.spec_steps is not None:  # the window engine's whole batch
                    resp["speculative"]["sequential_forwards"] = done.spec_steps
            if want_trace and done.trace is not None:  # the window engine does not trace
                resp["trace"] = done.trace.to_dict()
            self._send(200, resp)

        def _check_stream_speculation(self) -> None:
            """A stream speculates only on a slot engine started with
            --speculative K (the JAX server's 400s)."""
            if kind == "window":
                raise ValueError(
                    "'speculative' on /v1/stream needs a continuous/"
                    "paged engine started with --speculative K; with "
                    "--engine window the supported alternatives are: "
                    "POST /v1/generate with 'speculative': K "
                    "(non-streaming speculative decode), or /v1/stream "
                    "without 'speculative' (plain streaming)"
                )
            if not speculative_k:
                raise ValueError(
                    "'speculative' on /v1/stream needs the server "
                    "started with --speculative K (engine-level fused "
                    "verify); supported now: POST /v1/generate with "
                    "'speculative': K (non-streaming speculative "
                    "decode), or /v1/stream without 'speculative' "
                    "(plain streaming)"
                )

        def _stream(self, prompt_ids, gen, seed: int, stream_chunk: int, overload: dict) -> None:
            """Server-Sent Events, one per decoded text delta. On the slot
            engines the request is admitted before the headers go out, so a
            refusal (overflow, brownout, a dead engine) gets its status code
            and Retry-After. A request shed before its first token (a queue
            or client deadline) gets them too: the headers wait for the
            first token. A client that disconnects abandons the request: its
            slot stops decoding for nobody."""
            if kind == "window":
                source = generator.generate_stream(prompt_ids, gen, seed=seed, chunk=stream_chunk)
            else:
                try:
                    tokens = engine.stream(prompt_ids, gen, seed=seed, timeout=request_timeout_s,
                                           **overload)
                    first = next(tokens, None)
                except Exception as e:  # request boundary: report, keep serving
                    if not isinstance(e, (ServingError, TimeoutError)):
                        log.exception("stream admission failed")
                    self._send_error(e)
                    return
                source = _pieces(first, tokens)
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                self._events(source)
            except (_ClientGone, OSError):
                self.close_connection = True
            finally:
                source.close()
                if kind != "window":
                    tokens.close()

        def _events(self, source) -> None:
            def chunk_out(data: bytes) -> None:
                try:
                    self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                except OSError as e:
                    raise _ClientGone from e

            def event(payload: dict, name: Optional[str] = None) -> None:
                head = f"event: {name}\n" if name else ""
                chunk_out(f"{head}data: {json.dumps(payload)}\n\n".encode())

            ids, sent = [], ""
            try:
                for piece in source:
                    ids.extend(piece)
                    text = _stable_prefix(generator.tokenizer.decode(ids, skip_special_tokens=True))
                    if len(text) > len(sent):
                        event({"delta": text[len(sent):]})
                        sent = text
                text = generator.tokenizer.decode(ids, skip_special_tokens=True)
                if len(text) > len(sent):
                    event({"delta": text[len(sent):]})
                event({"done": True, "n_tokens": len(ids)})
            except _ClientGone:
                raise
            except Exception as e:  # the request failed mid-stream: say so, then end
                if not isinstance(e, (ServingError, TimeoutError)):
                    log.exception("stream failed")
                event(error_payload(e)[1]["error"], name="error")
            try:
                self.wfile.write(b"0\r\n\r\n")
            except OSError as e:
                raise _ClientGone from e

    httpd = _Server((host, port), Handler)
    httpd.profiler_capture = capture
    httpd.autoscaler = autoscaler
    httpd.deploy_manager = deploy_mgr
    if window is not engine:
        httpd.window_engine = window

    def begin_drain(signum=None, frame=None) -> None:
        """SIGTERM: close admission, let the work in flight finish within
        ``drain_timeout_s``, then stop the server loop so ``serve`` returns
        and the process exits 0."""
        if drain_state["draining"]:
            return
        drain_state["draining"] = True
        print(f"[serve] drain: admission closed, finishing in-flight work "
              f"(timeout {drain_timeout_s}s)", flush=True)
        engines = [engine] if window is engine else [engine, window]
        for eng in engines:
            eng.begin_drain()

        def finish() -> None:
            if deploy_mgr is not None:
                deploy_mgr.stop()  # no swap starts while the work drains
            deadline = time.monotonic() + float(drain_timeout_s)
            clean = True
            for eng in engines:
                clean = eng.wait_drained(max(0.0, deadline - time.monotonic())) and clean
            print("[serve] drain complete; shutting down" if clean else
                  "[serve] drain timeout: shutting down with requests unresolved", flush=True)
            httpd.shutdown()

        threading.Thread(target=finish, name="drain", daemon=True).start()

    httpd.begin_drain = begin_drain
    httpd.drain_state = drain_state
    if control is not None:
        control["begin_drain"] = begin_drain
        control["httpd"] = httpd
        control["autoscaler"] = autoscaler
        control["deploy"] = deploy_mgr
    return httpd, engine


def run_server(httpd, engine) -> None:
    """Serve until interrupted or drained. On the main thread SIGTERM runs
    ``httpd.begin_drain``; elsewhere callers drain through it themselves.
    The server and the engines are closed on the way out."""
    prev = None
    try:
        prev = signal.signal(signal.SIGTERM, httpd.begin_drain)
    except ValueError:
        pass  # not the main thread
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        httpd.server_close()
        engine.close()
        if httpd.drain_state["draining"]:
            print("[serve] drained; exiting", flush=True)


def serve(model_dir: str, *, device=None, host: str = "0.0.0.0", port: int = 8080,
          quantize: str = "none", engine: str = "continuous", quantize_kv: str = "none",
          speculative_k: int = 0, draft_dir: Optional[str] = None,
          adapter_dir: Optional[str] = None, **engine_kw) -> None:
    """Load ``model_dir`` onto ``device`` and serve it until interrupted or
    drained (SIGTERM). ``adapter_dir`` serves the LoRA adapters under it.
    Weights and compute are bf16 on the GPU and f32 on the CPU (which has no
    fast bf16, and where the tests compare with the JAX package in f32);
    ``quantize="int8"`` or ``"nf4"`` then stores the block linears as int8
    or NF4 codes.
    ``draft_dir`` (with ``speculative_k``) loads a draft model of the same
    vocabulary beside the target."""
    check_quantize_mode(quantize)  # before the model loads
    check_engine(engine, quantize_kv, speculative_k, draft_dir)
    check_adapters(engine, adapter_dir)
    check_deploy(engine, engine_kw.get("publish_watch_dir"))
    check_fleet(engine, **{k: engine_kw[k] for k in _FLEET_FLAGS if k in engine_kw})
    device = resolve_device(device)
    compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params, model_config = load_model_dir(model_dir, device=device, dtype=compute_dtype)
    params = maybe_quantize(params, quantize)
    draft = {}
    if draft_dir:
        draft_params, draft_config = load_model_dir(draft_dir, device=device, dtype=compute_dtype)
        draft = {"draft_params": draft_params, "draft_config": draft_config}
    generator = Generator(
        params, model_config, load_tokenizer_dir(model_dir),
        compute_dtype=compute_dtype, device=device, **draft,
    )
    httpd, eng = build_server(generator, host=host, port=port, engine=engine,
                              quantize_kv=quantize_kv, speculative_k=speculative_k,
                              adapter_dir=adapter_dir, **engine_kw)
    spec = f", speculative {speculative_k}" + (f" drafting with {draft_dir}" if draft_dir else "")
    fleet = (f", {len(eng.replicas)} replicas ({eng.routing})"
             if isinstance(eng, EngineFleet) else "")
    print(f"[serve] listening on http://{host}:{httpd.server_address[1]} "
          f"(engine {engine}, device {device}, {compute_dtype}, weights {quantize}"
          f"{spec if speculative_k else ''}{fleet})", flush=True)
    run_server(httpd, eng)


# build_server's fleet settings, in check_fleet's order
_FLEET_FLAGS = ("replicas", "routing", "autoscale", "min_replicas", "max_replicas", "host_tier_mb",
                "migrate_on_retire", "replica_roles", "autoscale_ratio")


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description="Serve a model over HTTP")
    parser.add_argument("--model-dir", default=os.environ.get("MODEL_DIR", "outputs/best_model"))
    parser.add_argument("--engine", choices=ENGINES, default="continuous",
                        help="continuous: persistent slot batch over a dense KV cache (default); "
                             "paged: the same over a block-paged KV pool with a prefix cache; "
                             "window: drain-a-window batching of whole requests")
    parser.add_argument("--replicas", type=int, default=1, metavar="N",
                        help="continuous/paged engines: run N supervised engine replicas behind "
                             "the in-process fleet router (weights shared; each replica owns "
                             "its KV pool, supervisor and stats). 1 = single engine, no router")
    parser.add_argument("--routing", choices=ROUTING_POLICIES, default="prefix",
                        help="fleet placement policy (--replicas > 1): prefix = prompt-prefix "
                             "cache affinity, ties least-loaded; least-loaded = smallest backlog "
                             "per slot; round-robin = strict rotation")
    parser.add_argument("--replica-roles", default=None, metavar="R1,R2,...",
                        help="disaggregated serving: a comma list assigning each starting "
                             "replica a pool role (mixed|prefill|decode), e.g. 'prefill,decode'. "
                             "New requests route to prefill-capable replicas; after its first "
                             "token a request hands over to a decode replica through the shared "
                             "host KV tier (any failure decodes in place). Needs --engine paged, "
                             "--host-tier-mb > 0 and a fleet")
    parser.add_argument("--autoscale", choices=Autoscaler.MODES, default="dry-run",
                        help="elastic fleet control loop: dry-run (default) records every "
                             "would-be scale decision on GET /v1/capacity and the flight "
                             "recorder WITHOUT acting; on also adds/retires replicas within "
                             "--min-replicas/--max-replicas; off disables the loop")
    parser.add_argument("--min-replicas", type=int, default=1, metavar="N",
                        help="autoscaler floor: never retire below N replicas")
    parser.add_argument("--max-replicas", type=int, default=0, metavar="N",
                        help="autoscaler ceiling: never grow past N replicas. 0 = --replicas "
                             "(no elastic growth); a value above --replicas builds a growable "
                             "fleet even from --replicas 1")
    parser.add_argument("--scale-cooldown-s", type=float, default=30.0,
                        help="autoscaler: seconds between APPLIED scale actions")
    parser.add_argument("--autoscale-ratio", action="store_true",
                        help="autoscaler (--replica-roles): treat the prefill/decode pool ratio "
                             "as a scaling dimension")
    parser.add_argument("--host-tier-mb", type=int, default=0, metavar="MB",
                        help="paged engine: host-RAM KV tier budget in MiB (LRU over bytes). "
                             "Evicted prefix-cache blocks and preempted requests' banked blocks "
                             "spill here, and admission restores them instead of prefilling "
                             "again (int8 codes and scales as a unit). 0 = off")
    parser.add_argument("--migrate-on-retire", action="store_true",
                        help="fleet: retire_replica and the autoscaler's scale-down empty a "
                             "replica by live-migrating its requests to siblings through the "
                             "host tier instead of waiting for the longest one to finish")
    parser.add_argument("--quantize-kv", choices=["none", "int8"], default="none",
                        help="store the KV block pool as int8 with per-block absmax scales "
                             "(--engine paged); decode then reads it through the fused CUDA "
                             "kernel")
    parser.add_argument("--quantize-weights", "--quantize", dest="quantize",
                        choices=QUANTIZE_MODES, default="none",
                        help="weight-only quantization of the block linears (int8 or nf4; "
                             "adapter pools and the draft model stay full precision)")
    parser.add_argument("--slots", type=int, default=8,
                        help="persistent decode slots (continuous, paged)")
    parser.add_argument("--kv-buf-len", type=int, default=4096,
                        help="positions per request, prompt + generated (continuous, paged)")
    parser.add_argument("--kv-block-len", type=int, default=256,
                        help="tokens per KV block (paged)")
    parser.add_argument("--prefill-chunk", type=int, default=512,
                        help="max prompt tokens prefilled per scheduler tick (paged)")
    parser.add_argument("--max-batch", type=int, default=8,
                        help="window engine: max concurrent requests grouped into one batch")
    parser.add_argument("--batch-window-ms", type=float, default=10.0,
                        help="window engine: how long the first request waits for company")
    parser.add_argument("--speculative", type=int, default=0, metavar="K",
                        help="continuous/paged engines: every tick drafts up to K tokens per "
                             "slot whose request asks for speculation and verifies them in one "
                             "forward (requests opt in with 'speculative': K)")
    parser.add_argument("--draft-dir", default=None, metavar="DIR",
                        help="model directory of a draft model of the same vocabulary for "
                             "--speculative (default: prompt lookup)")
    parser.add_argument("--adapter-dir", default=None,
                        help="continuous/paged engines: directory of PEFT-layout LoRA adapter "
                             "subdirectories for multi-tenant serving; requests name one with "
                             "'adapter' and co-batch against the shared base model")
    parser.add_argument("--max-adapters", type=int, default=8,
                        help="adapter pool depth: up to N-1 adapters resident at once (slot 0 is "
                             "the base model); idle adapters are evicted LRU, pinned ones never")
    parser.add_argument("--adapter-capacity", type=int, default=0, metavar="N",
                        help="per-tenant admission quota: max in-flight requests per adapter "
                             "name before a tenant-scoped 429 + Retry-After (0 = unlimited)")
    parser.add_argument("--publish-watch-dir", default=os.environ.get("PUBLISH_DIR") or None,
                        help="live deployment: watch this trainer publish directory (train "
                             "publish_dir) and hot-swap each new verified checkpoint in at a "
                             "tick boundary without dropping a request; enables POST "
                             "/v1/deploy, POST /v1/deploy/rollback and GET /v1/lineage. Off by "
                             "default")
    parser.add_argument("--publish-poll-s", type=float, default=2.0,
                        help="seconds between publish-directory polls (--publish-watch-dir)")
    parser.add_argument("--auto-rollback-window-s", type=float, default=0.0,
                        help="after each hot-swap, watch the error rate for this many seconds "
                             "and roll back automatically if it trips "
                             "--auto-rollback-error-rate (0 = manual rollback only)")
    parser.add_argument("--auto-rollback-error-rate", type=float, default=0.5,
                        help="failed-request fraction within the post-swap window that "
                             "triggers the automatic rollback")
    parser.add_argument("--canary-window-s", type=float, default=0.0,
                        help="canary-scored deploys (needs --replicas > 1): after swapping the "
                             "FIRST replica, compare its per-generation latency/error deltas "
                             "against the unswapped siblings for this many seconds; a "
                             "regression verdict rolls the canary back and blocks the publish. "
                             "0 = roll all replicas without a canary window")
    parser.add_argument("--canary-min-requests", type=int, default=8,
                        help="settled requests the canary (and the sibling baseline) must see "
                             "inside --canary-window-s for the verdict to bind; below it the "
                             "roll proceeds (the error-rate backstop still guards)")
    parser.add_argument("--max-queue-depth", type=int, default=256,
                        help="bounded admission: requests beyond this many waiters are shed "
                             "with 429 + Retry-After (0 = unbounded)")
    parser.add_argument("--queue-deadline-s", type=float, default=0.0,
                        help="shed requests still queued after this many seconds BEFORE "
                             "prefill (503, retryable; 0 = no deadline)")
    parser.add_argument("--priority-default", choices=PRIORITY_TIERS, default="interactive",
                        help="continuous/paged engines: priority tier assumed for requests "
                             "that send no 'priority' field (admission orders by aged tier; "
                             "under pressure the lowest tier sheds and preempts first)")
    parser.add_argument("--age-promote-s", type=float, default=5.0,
                        help="anti-starvation: every this-many seconds a queued request "
                             "waits, it is ordered as one tier more important (raw tier "
                             "still governs shedding/preemption)")
    parser.add_argument("--brownout-queue-wait-s", type=float, default=2.0,
                        help="brownout pressure budget: queue-wait EWMA at this many "
                             "seconds counts as pressure 1.0")
    parser.add_argument("--brownout-drain-s", type=float, default=10.0,
                        help="brownout pressure budget: predicted queue drain time at this "
                             "many seconds counts as pressure 1.0")
    parser.add_argument("--brownout-cap-tokens", type=int, default=32,
                        help="brownout stage >= 2: max_new_tokens cap applied to "
                             "best_effort requests admitted during the brownout")
    parser.add_argument("--request-timeout-s", type=float, default=600.0,
                        help="max seconds a request waits for the device before a 503 "
                             "(0 = wait forever)")
    parser.add_argument("--drain-timeout-s", type=float, default=30.0,
                        help="SIGTERM grace: how long in-flight requests may finish before "
                             "the server exits anyway")
    parser.add_argument("--restart-backoff-s", type=float, default=0.5,
                        help="supervisor: delay before the first in-process engine restart "
                             "(doubles per failure in the circuit window)")
    parser.add_argument("--restart-backoff-max-s", type=float, default=30.0,
                        help="supervisor: cap on the exponential restart backoff")
    parser.add_argument("--circuit-threshold", type=int, default=5,
                        help="supervisor: retryable failures within --circuit-window-s that "
                             "open the circuit (engine stops restarting, /healthz goes 503)")
    parser.add_argument("--circuit-window-s", type=float, default=60.0,
                        help="supervisor: sliding window for the circuit-breaker count")
    parser.add_argument("--watchdog-timeout-s", type=float, default=0.0,
                        help="hard-exit if the decode worker makes no progress for this many "
                             "seconds (a wedged device; runtime/watchdog.py). Must exceed the "
                             "worst prefill and the kernels' first build. 0 = off")
    parser.add_argument("--flight-dir", default="outputs/flight_recorder",
                        help="directory for flight-recorder JSON dumps (recent engine events, "
                             "written on a restart and on circuit-open). Empty string disables")
    parser.add_argument("--trace-log", default=None,
                        help="JSONL file appending every settled request's lifecycle trace "
                             "(span + request-relative time + propagated trace id). Off by "
                             "default")
    parser.add_argument("--trace-log-max-mb", type=float, default=0.0,
                        help="rotate --trace-log when it exceeds this many MB (keeping the last "
                             "5 rotated files); 0 = unbounded append")
    parser.add_argument("--profile-dir", default=None,
                        help="enable POST /v1/profile: on-demand torch.profiler captures written "
                             "to fresh subdirectories of this path as Chrome traces "
                             "(trace.json). Off by default")
    parser.add_argument("--slo-ttft-p99-s", type=float, default=2.0,
                        help="SLO objective: p99 time-to-first-token target in seconds "
                             "(GET /v1/slo burn rates, serving_slo_* gauges)")
    parser.add_argument("--slo-inter-token-p99-s", type=float, default=0.5,
                        help="SLO objective: p99 inter-token gap target in seconds")
    parser.add_argument("--slo-error-rate", type=float, default=0.01,
                        help="SLO objective: max failed-request fraction (the error budget "
                             "burned by requests_failed)")
    parser.add_argument("--slo-availability", type=float, default=0.999,
                        help="SLO objective: availability target; sheds (overflow, deadline, "
                             "quota) burn the 1 - target budget")
    parser.add_argument("--slo-fast-window-s", type=float, default=60.0,
                        help="fast burn-rate window in seconds (a breach needs BOTH windows "
                             "hot: fast catches cliffs, slow catches bleeds)")
    parser.add_argument("--slo-slow-window-s", type=float, default=600.0,
                        help="slow burn-rate window in seconds")
    parser.add_argument("--slo-sample-interval-s", type=float, default=1.0,
                        help="seconds between metric-ring samples (taken on the scheduler tick "
                             "clock — zero extra clock reads on the token hot path)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080, help="0 picks a free port")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    fleet_kw = {k: getattr(args, k) for k in _FLEET_FLAGS}
    try:
        check_engine(args.engine, args.quantize_kv, args.speculative, args.draft_dir)
        check_adapters(args.engine, args.adapter_dir)
        check_deploy(args.engine, args.publish_watch_dir)
        check_fleet(args.engine, **fleet_kw)
    except ValueError as e:
        parser.error(str(e))
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}")
    serve(
        args.model_dir, device=device, host=args.host, port=args.port, quantize=args.quantize,
        engine=args.engine, quantize_kv=args.quantize_kv, slots=args.slots,
        kv_buf_len=args.kv_buf_len, kv_block_len=args.kv_block_len,
        prefill_chunk=args.prefill_chunk, max_batch=args.max_batch,
        batch_window_ms=args.batch_window_ms, speculative_k=args.speculative,
        draft_dir=args.draft_dir, max_queue_depth=args.max_queue_depth,
        queue_deadline_s=args.queue_deadline_s or None, priority_default=args.priority_default,
        age_promote_s=args.age_promote_s, brownout_queue_wait_s=args.brownout_queue_wait_s,
        brownout_drain_s=args.brownout_drain_s, brownout_cap_tokens=args.brownout_cap_tokens,
        request_timeout_s=args.request_timeout_s or None, drain_timeout_s=args.drain_timeout_s,
        restart_backoff_s=args.restart_backoff_s, restart_backoff_max_s=args.restart_backoff_max_s,
        circuit_threshold=args.circuit_threshold, circuit_window_s=args.circuit_window_s,
        watchdog_timeout_s=args.watchdog_timeout_s, flight_dir=args.flight_dir or None,
        trace_log=args.trace_log, trace_log_max_mb=args.trace_log_max_mb,
        profile_dir=args.profile_dir, slo_ttft_p99_s=args.slo_ttft_p99_s,
        slo_inter_token_p99_s=args.slo_inter_token_p99_s, slo_error_rate=args.slo_error_rate,
        slo_availability=args.slo_availability, slo_fast_window_s=args.slo_fast_window_s,
        slo_slow_window_s=args.slo_slow_window_s,
        slo_sample_interval_s=args.slo_sample_interval_s,
        scale_cooldown_s=args.scale_cooldown_s, adapter_dir=args.adapter_dir,
        max_adapters=args.max_adapters, adapter_capacity=args.adapter_capacity,
        publish_watch_dir=args.publish_watch_dir, publish_poll_s=args.publish_poll_s,
        auto_rollback_window_s=args.auto_rollback_window_s,
        auto_rollback_error_rate=args.auto_rollback_error_rate,
        canary_window_s=args.canary_window_s, canary_min_requests=args.canary_min_requests,
        **fleet_kw,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
