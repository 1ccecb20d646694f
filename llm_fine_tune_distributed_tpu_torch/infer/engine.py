"""Continuous batching: a persistent decode batch of ``slots`` rows that
requests join and leave between steps (counterpart of the core of the JAX
``infer/engine.py``).

``ContinuousBatchingEngine`` keeps a dense ``[slots, buf_len]`` KV cache.
A request is admitted into a free slot by a prefill of its prompt, padded
to a multiple of ``prompt_bucket``, in a private batch-1 cache whose K/V
are copied into the slot's row (``Generator.slot_prefill``); every
scheduler tick then runs one decode step over all slots
(``Generator.slot_step``), so each request's tokens surface as they decode,
alongside everything else in flight (``stream``).

``PagedContinuousBatchingEngine`` is the same scheduler over a block-paged
KV pool addressed through per-slot block tables, so

- a decode step attends over ``nb * block_len`` positions, where ``nb`` is
  the power-of-two bucket over the widest live slot's blocks in use;
- admission maps blocks instead of copying rows: a prompt's leading FULL
  blocks are looked up in a refcounted prefix cache and shared
  copy-on-write, and prefill resumes at the divergence point;
- prompts prefill in ``prefill_chunk``-token chunks interleaved with decode
  steps (one chunk and one decode step per scheduler tick).

Both engines: one worker thread owns the cache, the tables and the slot
state; a request whose waiter gave up (``Request.abandoned``) is shed,
queued or mid-decode; counters, gauges and latency histograms go to one
``ServingStats`` (``stats_snapshot``). Greedy tokens equal a solo
``Generator.generate_ids`` of the same prompt, and sampled ones depend only
on (request, seed).

Overload control, as in the JAX engines (every failure is a class of
``infer/errors.py``):

- admission: a request names a priority tier (``PRIORITY_TIERS``); a full
  queue (``max_queue_depth``) sheds the arrival with a 429, or displaces the
  newest waiter of a strictly lower tier instead; ``Retry-After`` comes from
  an EWMA of service time with a deterministic +-20% jitter;
- deadlines: a request still queued after ``queue_deadline_s`` is shed
  before prefill (503); one whose client deadline (``deadline_s``) expires
  is cancelled wherever it is (504, carrying its tokens so far);
- scheduling: waiters are admitted by (aged tier, arrival), every
  ``age_promote_s`` of waiting promoting a request one tier;
- preemption: with every slot busy (or, on the paged engine, no blocks
  free), an arrival preempts the youngest live request of the worst
  strictly lower tier. Its tokens are banked and it requeues; the resume is
  one prefill over prompt + banked tokens, and its result starts with them.
  The paged engine banks the victim's full context blocks in the prefix
  cache, so the resume prefills only the tail;
- brownout: a pressure signal (queue-wait EWMA, pool occupancy, predicted
  drain time) moves a stage 0-3 with hysteresis: stage 1 stops drafting,
  stage 2 caps ``best_effort`` output at ``brownout_cap_tokens``, stage 3
  sheds ``best_effort`` at admission unless the engine is idle.

Supervision, as in the JAX engines (``infer/supervisor.py``): the worker
runs ``_startup`` (the device state of one generation) and then the serve
loop, and any exception in a tick or in a rebuild goes to ``_recover``. A
retryable failure (``errors.is_retryable_failure``) with the circuit closed
answers every request in flight with a ``RetryableEngineError`` (503, with
``Retry-After`` and the generation), keeps the queued ones, sleeps an
exponential backoff, drops the crashed generation's cache and builds a new
one (the paged engine: a new pool, allocator and an empty prefix cache),
and serves again under ``generation`` + 1. ``circuit_threshold`` failures
within ``circuit_window_s`` open the circuit, and any other failure is
fatal: the engine then reports ``healthy`` False, ``circuit_state`` "open"
or "fatal" and the ``CircuitOpenError`` or ``FatalEngineError`` as
``terminal_error``, resolves every request in flight or queued with it and
refuses later submits with it. ``begin_drain`` closes admission
(``DrainingError``) while the work already submitted runs to completion,
and ``wait_drained`` waits for the last of it. ``faults``
(``FaultInjector``) fails or slows chosen ticks; a ``StepWatchdog`` is
poked per tick and paused while the engine waits for traffic or backs off;
``recorder`` (``FlightRecorder``) keeps the recent admissions, sheds, ticks
and lifecycle events, and is written to ``flight_dir`` at a restart and
when the engine goes terminal.

With ``speculative_k = K > 0`` every tick is the fused draft-verify step
(``Generator.spec_slot_step`` / ``spec_paged_step``): each live slot whose
request asks for speculation proposes up to K drafts (prompt lookup over
its own context, ``_prompt_lookup``, or the Generator's draft model), one
forward verifies all slots' K+1 positions, and each slot emits its accepted
run plus one token of the model's own. Slots without drafts take the plain
step inside the same tick. Per-request draft counts and the engine's
``draft_tokens_proposed`` / ``draft_tokens_accepted`` record it.

Observability, as in the JAX engines: every request carries a
``RequestTrace`` (received, queued, admitted, prefill or prefill_chunk,
first_token, then completed, failed or abandoned; preempted on the way),
written at settle to ``trace_log`` (JSONL, rotated past
``trace_log_max_mb``). On the tick stamp ``_tick_done`` already takes, the
worker samples a ``MetricRing`` every ``slo_sample_interval_s``, evaluates
the ``SloPolicy`` burn rates (breaches and recoveries go to the flight
recorder) and feeds the ``LoadForecaster``; TTFT and inter-token gaps are
also kept per weight generation (``GenerationSlices``). Each decode
dispatch records the live rows' positions and query counts (and the
distinct adapters they gather, each read as one pool slot: the base weights
are read every tick, the idle pools never); ``_tick_done`` adds them to running sums beside the tick's time, from which
``decode_cost`` gives the timed ticks' FLOPs and bytes
(``observe/flops.decode_tick_cost`` per dispatch, added up) and
``stats_snapshot`` the MFU and HBM-bandwidth gauges over the summed
``decode_tick_s``. The worker also samples the ring when it goes idle with
counters moved since the newest sample, so the ring holds the last tick's
tokens (the JAX engine's ring waits for the next tick).
``tick_boundary()`` is the lock each scheduler pass holds: a profiler
capture starts and stops under it, between ticks.

Fleets (``infer/fleet.py``), as in the JAX engines: ``export_requests``
takes every request in flight or queued off the engine at its next tick
boundary, each with its tokens so far banked on it (``preempted_tokens``;
the paged engine also spills its ingested blocks to the host tier), and
``adopt_request`` takes such a request over on a sibling, which resumes it
with one prefill over prompt + banked tokens (restoring what the tier
holds). A ``role`` of ``"prefill"`` with a fleet-installed ``handoff`` hook
hands each request to a decode replica right after its first token the
same way; any failure of it decodes in place. The paged engine's
``host_tier`` (``infer/paged.HostBlockTier``) also takes the blocks the
prefix cache evicts and the blocks a preemption banks, and admission
restores a prompt's leading blocks from it before it allocates the rest.

Multi-tenant LoRA, as in the JAX engines: with ``adapters`` (an
``infer/adapters.AdapterRegistry``, one per engine) a request may name an
``adapter``. Admission pins its slot (``acquire``: a 404 for an unknown
name, a 429 when every slot is pinned) under the tenant's quota
(``adapter_quota`` requests in flight, a 429 past it), the slot's rows
forward through the registry's pooled view with the request's adapter, and
the settle releases the pin. ``_startup`` rebuilds the resident adapters,
export and adoption move the pin with the request, and the snapshot adds
``per_tenant`` and ``adapters_resident``. The paged engine salts the prefix
keys of an adapter's request with its name (``infer/routing.
prefix_block_keys``): the adapters change ``k_proj`` and ``v_proj``, so K/V
cached under the base model or another tenant must not be reused (the JAX
engine keys by tokens alone and does reuse them). Base requests keep the
JAX keys.

Live deployment (``infer/deploy.py``), as in the JAX engines:
``request_weight_swap`` stages new values for some parameter leaves and
blocks until the worker applies them. While a swap is staged, admission
pauses and the slots in flight finish on the old weights; at the drained
tick boundary the worker builds the new parameter dict copy-on-write (a
published ``kernel`` re-quantized into a resident ``kernel_int8`` and its
scale), then re-points every holder at once: the slots' view
(``state["params"]``), the adapter registry's pooled view (``rebind``) and
the Generator's own ``params`` (and its self-draft) when they were this
engine's. ``weight_generation`` goes up by one, and the paged engine drops
its prefix cache when the payload's fingerprint changed, zeroing the int8
pool's block scales too, so that the drained pool serves as a new one
would (the JAX pool keeps stale scales). A failed apply leaves the old
weights serving and raises to the caller; a retryable restart keeps the
staged swap, a terminal failure fails it. Host-tier entries are stamped
with the fingerprint, so an entry of another generation misses. Not
ported: the multi-host swap bridge.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
import traceback
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from llm_fine_tune_distributed_tpu_torch.infer.batching import PRIORITY_TIERS, Request
from llm_fine_tune_distributed_tpu_torch.infer.errors import (
    AdapterPoolFullError,
    BrownoutShedError,
    CircuitOpenError,
    DeadlineExceededError,
    DrainingError,
    FatalEngineError,
    QueueDeadlineError,
    QueueOverflowError,
    RetryableEngineError,
    ServingError,
    TenantQuotaError,
    UnknownAdapterError,
    is_retryable_failure,
)
from llm_fine_tune_distributed_tpu_torch.infer.paged import NULL_BLOCK, BlockAllocator, PrefixCache
from llm_fine_tune_distributed_tpu_torch.infer.routing import REPLICA_ROLES
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.infer.supervisor import EngineSupervisor, FaultInjector
from llm_fine_tune_distributed_tpu_torch.observe.capacity import LoadForecaster
from llm_fine_tune_distributed_tpu_torch.observe.flops import DecodeWork, decode_work_cost
from llm_fine_tune_distributed_tpu_torch.observe.metrics import ServingStats
from llm_fine_tune_distributed_tpu_torch.observe.profiler import (
    device_peak_specs,
    utilization_from_cost,
)
from llm_fine_tune_distributed_tpu_torch.observe.slo import (
    RING_COUNTERS,
    GenerationSlices,
    MetricRing,
    SloPolicy,
)
from llm_fine_tune_distributed_tpu_torch.observe.tracing import (
    FlightRecorder,
    RequestTrace,
    TraceJsonlWriter,
)
from llm_fine_tune_distributed_tpu_torch.ops.flash_attention import reset_paged_decode_tickets
from llm_fine_tune_distributed_tpu_torch.ops.int8 import INT8_SUFFIXES, quantize_int8
from llm_fine_tune_distributed_tpu_torch.ops.nf4 import QUANT_SUFFIXES, quantize_nf4
from llm_fine_tune_distributed_tpu_torch.runtime.watchdog import StepWatchdog

log = logging.getLogger(__name__)

__all__ = ["ContinuousBatchingEngine", "PagedContinuousBatchingEngine", "PRIORITY_TIERS",
           "Request"]
_BEST_EFFORT = PRIORITY_TIERS.index("best_effort")
# a queue item that wakes an idle worker so that it applies a staged export
# or weight swap; dropped wherever requests leave the queue
_POKE = object()


class _PendingSwap:
    """One staged weight hot-swap: the host copies of the updated leaves and
    a completion latch. Made on the deploy thread, applied once by the
    worker at a drained tick boundary; ``result`` or ``error`` is set before
    ``done``."""

    __slots__ = ("updates", "fingerprint", "step", "done", "result", "error")

    def __init__(self, updates, fingerprint, step):
        self.updates = updates  # [(leaf name, host tensor)]
        self.fingerprint = fingerprint
        self.step = step
        self.done = threading.Event()
        self.result: Optional[dict] = None
        self.error: Optional[BaseException] = None


def _cow_swap_tree(params: dict, updates) -> Tuple[dict, int]:
    """A NEW flat dict sharing every untouched leaf with ``params``, each
    updated leaf a new tensor of the resident leaf's device, dtype and
    strides holding the published values. A raise part-way leaves
    ``params`` untouched (all-or-nothing); fleet siblings still holding the
    old dict are unaffected. A swap may change values, never shapes."""
    out = dict(params)
    for name, value in updates:
        if name not in out:
            raise KeyError(f"published leaf not in resident params: {name!r}")
        old = out[name]
        if tuple(old.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {name!r}: resident {tuple(old.shape)} vs "
                             f"published {tuple(value.shape)} — a hot-swap may change values, "
                             "never shapes")
        new = torch.empty_like(old)
        new.copy_(value)
        out[name] = new
    return out, len(updates)


def _requantize_updates(params: dict, updates) -> list:
    """Published full-precision ``<module>.kernel`` leaves whose resident
    form is quantized (``--quantize int8``: ``kernel_int8`` +
    ``kernel_int8_scale``; ``--quantize nf4``: ``kernel_nf4`` and its absmax
    siblings) are re-quantized into it on the resident codes' device, NF4 at
    the resident block size (in-dim over the absmax rows) and double-quant
    setting; the shapes come out equal to the resident ones. A leaf that
    cannot be reconciled raises ``ServingError`` naming the mode. Updates of
    plain resident leaves pass through."""
    out = []
    for name, value in updates:
        fmt = ("int8" if f"{name}_int8" in params
               else "nf4" if f"{name}_nf4" in params else None)
        if name in params or fmt is None:
            out.append((name, value))  # plain leaf, or a bad name _cow_swap_tree reports
            continue
        codes = params[f"{name}_{fmt}"]
        try:
            if fmt == "int8":
                q, suffixes = quantize_int8(value.to(codes.device)), INT8_SUFFIXES
            else:
                am = params.get(f"{name}_absmax_q", params.get(f"{name}_absmax"))
                block_size = value.shape[0] // int(am.shape[-2])
                q = quantize_nf4(value.to(codes.device), block_size=block_size,
                                 double_quant=f"{name}_absmax_q" in params)
                suffixes = QUANT_SUFFIXES
        except Exception as e:
            raise ServingError(f"cannot re-quantize published leaf {name!r} into the resident "
                               f"{fmt} serving format (--quantize {fmt}): "
                               f"{type(e).__name__}: {e}")
        for suffix in suffixes:
            if suffix not in q:
                continue
            sib, new = f"{name}_{suffix}", q[suffix]
            if sib not in params or tuple(params[sib].shape) != tuple(new.shape):
                have = tuple(params[sib].shape) if sib in params else "absent"
                raise ServingError(
                    f"re-quantized leaf {name!r} does not match the resident {fmt} layout at "
                    f"{sib!r} (resident {have} vs produced {tuple(new.shape)}) — the published "
                    f"checkpoint and --quantize {fmt} cannot reconcile")
            out.append((sib, new))
    return out


class _PendingExport:
    """One staged export (``export_requests``): the worker detaches every
    request in flight and queued at its next tick boundary and sets
    ``result`` (the requests) or ``error`` (every request already detached
    was re-adopted), then ``done``."""

    __slots__ = ("done", "result", "error")

    def __init__(self):
        self.done = threading.Event()
        self.result: Optional[List[Request]] = None
        self.error: Optional[BaseException] = None


def _prompt_lookup(ctx: np.ndarray, k: int) -> np.ndarray:
    """Prompt-lookup draft proposal on the host: the continuation of an
    earlier occurrence of the context's trailing bigram. Among the matches
    it takes the most recent one whose continuation holds a full ``k``
    tokens (a loop shorter than ``k`` gives the same continuation at full
    length one period earlier), else the latest match, truncated; an empty
    array when no bigram repeats. Any draft is safe: verification
    re-derives every token."""
    n = ctx.size
    if n < 3:
        return ctx[:0]
    l0, l1 = ctx[-2], ctx[-1]
    starts = np.flatnonzero((ctx[:-2] == l0) & (ctx[1:-1] == l1))
    if starts.size == 0:
        return ctx[:0]
    full = starts[starts + 2 + k <= n]
    j = int(full[-1]) if full.size else int(starts[-1])
    return ctx[j + 2: j + 2 + k]


class _TokenStream:
    """``stream``'s iterator: a request's tokens as the slot emits them.
    Each token waits at most ``timeout`` seconds; a timeout or ``close()``
    (the client went away) before the end abandons the request, and the
    worker sheds its slot."""

    def __init__(self, req: Request, timeout: Optional[float], engine):
        self._req = req
        self._timeout = timeout
        self._engine = engine

    def __iter__(self):
        return self

    def __next__(self) -> int:
        req = self._req
        try:
            tok = req.tokens_q.get(timeout=self._timeout)
        except queue.Empty:
            req.abandoned = True
            raise TimeoutError(f"stream starved for {self._timeout}s "
                               f"(queue depth {self._engine.queue_depth})") from None
        if tok is None:
            if req.error is not None:
                raise req.error
            raise StopIteration
        return tok

    def close(self) -> None:
        if not self._req.done.is_set():
            self._req.abandoned = True


class ContinuousBatchingEngine:
    """``slots``-row persistent decode over a dense KV cache, admission by
    (aged tier, arrival) with the overload control of the JAX engine."""

    # the pressure at which brownout stages 1-3 begin, and the band below a
    # stage's threshold that the pressure must clear to step down (the JAX
    # engine's defaults, which no caller changes)
    BROWNOUT_THRESHOLDS = (0.7, 0.85, 0.95)
    BROWNOUT_HYSTERESIS = 0.1
    FLIGHT_EVENTS = 1024  # the flight recorder's ring (the JAX engine's default)
    SUPPORTS_TRACE = True  # submit/stream adopt a caller's RequestTrace (the fleet's)
    SLO_RING_CAPACITY = 512  # metric ring samples kept (the JAX engine's default)
    SLO_GENERATIONS_KEPT = 8  # weight generations with latency slices (the JAX default)

    def __init__(self, generator, slots: int = 8, buf_len: int = 4096, prompt_bucket: int = 64,
                 stats: Optional[ServingStats] = None, speculative_k: int = 0,
                 max_queue_depth: int = 0, queue_deadline_s: Optional[float] = None,
                 priority_default: str = "interactive", age_promote_s: float = 5.0,
                 brownout_queue_wait_s: float = 2.0, brownout_drain_s: float = 10.0,
                 brownout_cap_tokens: int = 32, restart_backoff_s: float = 0.5,
                 restart_backoff_max_s: float = 30.0, circuit_threshold: int = 5,
                 circuit_window_s: float = 60.0, watchdog_timeout_s: float = 0.0,
                 watchdog: Optional[StepWatchdog] = None, faults: Optional[FaultInjector] = None,
                 flight_dir: Optional[str] = None, trace_log: Optional[str] = None,
                 trace_log_max_mb: float = 0.0, slo_policy: Optional[SloPolicy] = None,
                 slo_sample_interval_s: float = 1.0, role: str = "mixed", adapters=None,
                 adapter_quota: int = 0):
        """The supervision settings are the JAX engine's: ``restart_backoff_s``
        (doubling per failure in the window, capped at
        ``restart_backoff_max_s``), ``circuit_threshold`` failures within
        ``circuit_window_s`` to open the circuit, ``flight_dir`` for the
        flight recorder's dumps (None: no dumps). ``watchdog`` is poked per
        tick; without one, ``watchdog_timeout_s`` > 0 makes a
        ``StepWatchdog(watchdog_timeout_s, "abort", start_paused=True)``.
        ``trace_log`` (JSONL of settled requests' traces, rotated past
        ``trace_log_max_mb``; None: none), ``slo_policy`` (default
        ``SloPolicy()``) and ``slo_sample_interval_s`` are the JAX engine's
        observability settings. ``role`` (``REPLICA_ROLES``) is the replica's
        pool in a disaggregated fleet. ``adapters`` (an ``AdapterRegistry``
        over this generator's weights, owned by this engine) serves tenants'
        LoRA adapters; ``adapter_quota`` bounds each tenant's requests in
        flight (0: unbounded). The first generation's device state is built
        here, so the cache exists when the constructor returns."""
        if role not in REPLICA_ROLES:
            raise ValueError(f"unknown replica role {role!r} (expected one of {REPLICA_ROLES})")
        if priority_default not in PRIORITY_TIERS:
            raise ValueError(f"unknown priority_default {priority_default!r} "
                             f"(expected one of {PRIORITY_TIERS})")
        self._generator = generator
        # the weights this engine serves: the generator's at first, a new
        # dict after each hot-swap (fleet siblings keep theirs until they
        # swap too)
        self._params = generator.params
        # speculation: the engine's draft depth K; with K > 0 every tick is
        # the fused draft-verify step, so a sampled slot's draws per tick do
        # not depend on who speculates beside it
        self._spec_k = max(0, int(speculative_k))
        self._use_draft = self._spec_k > 0 and bool(getattr(generator, "has_draft", False))
        self._slots = max(1, int(slots))
        self._buf_len = int(buf_len)
        self._bucket = max(1, int(prompt_bucket))
        self.stats = stats or ServingStats(self._slots)
        # multi-tenant LoRA: the registry (its pooled view is what the slots
        # forward through), each tenant's quota and its requests in flight
        # (under _plock)
        self._mt = adapters
        if adapters is not None:
            adapters.attach_stats(self.stats)
        self._adapter_quota = max(0, int(adapter_quota))
        self._tenant_inflight: dict = {}
        self._eos = set(generator.eos_token_ids)
        self._q: "queue.Queue[Optional[Request]]" = queue.Queue()
        # the priority buffer: the worker drains the queue into it and admits
        # by (aged tier, arrival id); submit threads only read it
        self._waiting: List[Request] = []
        self._req_seq = itertools.count(1)
        self._now = time.monotonic()  # the tick clock every emit of a tick reuses
        self._terminal: Optional[ServingError] = None  # set once the worker is dead for good
        self._closing = False  # close() was called (worker thread only)
        self._draining = False
        # the no-hung-waiter ledger: +1 at admission, -1 at each settle
        self._pending = 0
        self._plock = threading.Lock()
        # supervision: restart policy, fault hooks, the event ring and the
        # watchdog (poked per tick, paused while idle or backing off)
        self.supervisor = EngineSupervisor(
            restart_backoff_s=restart_backoff_s, restart_backoff_max_s=restart_backoff_max_s,
            circuit_threshold=circuit_threshold, circuit_window_s=circuit_window_s,
            flight_dir=flight_dir)
        self.faults = faults if faults is not None else FaultInjector()
        self.recorder = FlightRecorder(self.FLIGHT_EVENTS)
        if watchdog is None and watchdog_timeout_s and watchdog_timeout_s > 0:
            watchdog = StepWatchdog(watchdog_timeout_s, action="abort", start_paused=True)
        self._watchdog = watchdog
        self._decode_index = 0  # decode ticks over the engine's lifetime
        # admission policy (read on submit threads, set once here)
        self._max_queue_depth = max(0, int(max_queue_depth))  # 0: unbounded
        self._queue_deadline_s = float(queue_deadline_s) if queue_deadline_s else None
        self._priority_default = priority_default
        # every age_promote_s of waiting orders a request one tier higher
        # (its raw tier still decides shedding and preemption); <= 0: off
        self._age_promote_s = float(age_promote_s)
        # EWMA of queue-entry -> completion seconds behind the Retry-After
        # hints, seeded finite so the first 429 carries one too
        self._avg_service_s = 1.0
        self._retry_seq = itertools.count(1)  # the hints' jitter sequence
        # brownout: the budgets that scale queue wait and drain time to
        # pressure 1.0, and best_effort's output cap at stage 2
        self._brownout_queue_wait_s = max(1e-6, float(brownout_queue_wait_s))
        self._brownout_drain_s = max(1e-6, float(brownout_drain_s))
        self._brownout_cap_tokens = max(1, int(brownout_cap_tokens))
        self._brownout_stage = 0
        self._queue_wait_ewma = 0.0
        # observability: the settled-request trace log; the SLO state (the
        # ring samples on the tick stamp, the slices key latencies by weight
        # generation, which each hot-swap moves on) and the load
        # forecaster fed at each ring sample
        self._trace_writer = (
            TraceJsonlWriter(trace_log,
                             max_bytes=int(max(0.0, float(trace_log_max_mb)) * 1024 * 1024))
            if trace_log else None)
        self.slo_policy = slo_policy if slo_policy is not None else SloPolicy()
        self.metric_ring = MetricRing(capacity=self.SLO_RING_CAPACITY,
                                      interval_s=slo_sample_interval_s)
        self.slo_slices = GenerationSlices(keep=self.SLO_GENERATIONS_KEPT)
        self._weight_generation = 0
        self._gen_slice = self.slo_slices.slice_for(self._weight_generation)
        self.load_forecaster = LoadForecaster()
        # disaggregation: a "prefill" replica hands each request to a decode
        # replica after its first token through ``handoff``, a hook the
        # fleet installs (None: decode in place). It runs on the worker and
        # returns True once another replica adopted the request.
        self.role = role
        self.handoff = None
        # migration: the export staged for the worker's next tick boundary
        self._export_lock = threading.Lock()
        self._export_pending: Optional[_PendingExport] = None
        # live deployment: at most one staged weight swap, applied by the
        # worker at a drained tick boundary; the resident payload's
        # fingerprint (None until the first swap) stamps host-tier entries
        # and keys the prefix cache's invalidation
        self._swap_lock = threading.Lock()
        self._swap_pending: Optional[_PendingSwap] = None
        self._weight_fingerprint = None
        # held by each scheduler pass (admission and tick): a profiler
        # capture starts and stops between ticks
        self._tick_lock = threading.Lock()
        # the decode dispatch in flight: its live rows' (positions,
        # queries), host integers added to the work sums when the tick is
        # timed (decode_cost)
        self._dispatched: Optional[tuple] = None
        self._decode_work = DecodeWork()
        # the device state (the cache, the slot state and the draft model's
        # dense per-slot cache) and the slot bookkeeping, all worker-thread
        # only: generation 0 is built here, later ones by the worker
        self._cache = self._state = self._dcache = None
        self._startup()
        # the decode byte model reads the base weights every tick and one
        # pool slot per distinct adapter a tick gathers, never the idle pools
        self._weight_bytes = self._weight_breakdown(self._generator.params)[0]
        self._adapter_slot_bytes = (self._mt.pool_bytes() // self._mt.max_adapters
                                    if self._mt is not None else 0)
        # (K/V element bytes, block length, scale element bytes): fixed by
        # the engine's settings, so every generation's cache has the same
        self._kv_geometry = self._kv_cost_geometry(self._cache)
        self._worker = threading.Thread(target=self._run, name=type(self).__name__, daemon=True)
        self._worker.start()

    def _init_state(self):
        return self._generator.init_slot_state(self._slots, self._buf_len)

    # ---------------------------------------------------------------- public

    def submit(self, prompt_ids: Sequence[int], gen: GenerationConfig, seed: int = 0,
               timeout: Optional[float] = None, priority: Optional[str] = None,
               deadline_s: Optional[float] = None,
               trace: Optional[RequestTrace] = None, adapter: Optional[str] = None) -> List[int]:
        """Blocking: enqueue one request, wait for its generated token ids."""
        return self.submit_full(prompt_ids, gen, seed, timeout, priority=priority,
                                deadline_s=deadline_s, trace=trace, adapter=adapter).result

    def submit_full(self, prompt_ids: Sequence[int], gen: GenerationConfig, seed: int = 0,
                    timeout: Optional[float] = None, priority: Optional[str] = None,
                    deadline_s: Optional[float] = None,
                    trace: Optional[RequestTrace] = None,
                    adapter: Optional[str] = None) -> Request:
        """``submit`` returning the whole request record (the window
        batcher's call shape). On ``timeout`` the request is abandoned (the
        worker sheds it) and TimeoutError raised. ``priority`` names a tier
        of ``PRIORITY_TIERS`` (None: the engine's default); ``deadline_s``
        is the client's budget for the whole request, past which it is
        cancelled with a DeadlineExceededError carrying its tokens so far.
        ``trace`` is a caller's RequestTrace (the fleet's timeline across
        replicas) that the request marks instead of one of its own.
        ``adapter`` names the tenant's LoRA adapter in the engine's
        registry (None: the base model)."""
        req = self._make_request(prompt_ids, gen, seed, priority=priority, deadline_s=deadline_s,
                                 trace=trace, adapter=adapter)
        self._q.put(req)
        if not req.done.wait(timeout):
            req.abandoned = True
            raise TimeoutError(f"request not served within {timeout}s "
                               f"(queue depth {self.queue_depth})")
        if req.error is not None:
            raise req.error
        return req

    def stream(self, prompt_ids: Sequence[int], gen: GenerationConfig, seed: int = 0,
               timeout: Optional[float] = None, priority: Optional[str] = None,
               deadline_s: Optional[float] = None,
               trace: Optional[RequestTrace] = None,
               adapter: Optional[str] = None) -> _TokenStream:
        """Enqueue one request and return an iterator over its tokens as the
        slot decodes them, while it shares the batch with everything else in
        flight. ``timeout`` bounds the wait for each next token. Admission
        (overflow, brownout, a dead engine) is decided here, before the
        caller commits to a response."""
        req = self._make_request(prompt_ids, gen, seed, tokens_q=queue.Queue(),
                                 priority=priority, deadline_s=deadline_s, trace=trace,
                                 adapter=adapter)
        self._q.put(req)
        return _TokenStream(req, timeout, self)

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop the worker once the requests already submitted are served."""
        self._q.put(None)
        self._worker.join(timeout)

    def begin_drain(self) -> None:
        """Close admission (later submits get ``DrainingError``); the
        requests already queued or in flight decode to completion. The
        server's SIGTERM path follows with ``wait_drained``."""
        self._draining = True
        self.recorder.record("drain_begin", queued=self.queue_depth)

    def wait_drained(self, timeout_s: float, poll_s: float = 0.05) -> bool:
        """Block until every submitted request has settled (True), or until
        ``timeout_s`` passes with work pending (False)."""
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        while True:
            with self._plock:
                pending = self._pending
            if pending <= 0:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)

    def export_requests(self, timeout: Optional[float] = None) -> List[Request]:
        """Take every request in flight and queued off this engine and return
        them unresolved, for a sibling to ``adopt_request`` (live migration).
        The worker applies the export at its next tick boundary without
        waiting for anything to finish. Each request has its tokens so far
        banked in ``preempted_tokens`` (the paged engine also spills its
        ingested blocks to the host tier), leaves this engine's pending
        ledger and keeps its waiter or stream. If the export fails midway,
        the requests already detached are re-adopted here and RuntimeError
        is raised: the caller falls back to waiting for the drain."""
        if self._terminal is not None:
            raise self._terminal
        exp = _PendingExport()
        with self._export_lock:
            if self._export_pending is not None:
                raise RuntimeError("an export is already staged on this engine")
            self._export_pending = exp
        self.recorder.record("export_begin", live=int(self._live.sum()), queued=self.queue_depth)
        self._q.put(_POKE)  # wake an idle worker
        if not exp.done.wait(timeout):
            raise TimeoutError(f"request export not applied within {timeout}s")
        if exp.error is not None:
            raise RuntimeError("request export failed; the engine re-adopted its requests: "
                               f"{type(exp.error).__name__}: {exp.error}") from exp.error
        return list(exp.result or [])

    def adopt_request(self, req: Request) -> None:
        """Take over a request a sibling exported (or re-adopt one of this
        engine's). It bypasses the admission gates (drain, brownout, queue
        cap, deadlines): the request was admitted once, and refusing it
        would strand its waiter. Its resume prefills prompt + banked tokens,
        restoring what the host tier holds, so greedy tokens equal an
        uninterrupted run."""
        if self._terminal is not None:
            raise self._terminal
        self._attach_request(req)
        req.trace.mark("migrated")
        self.recorder.record("adopt", request=req.id, tokens_banked=len(req.preempted_tokens))
        self._q.put(req)

    def predicted_drain_s(self) -> float:
        """Seconds until this engine's backlog drains through its slots (the
        Retry-After estimate); the fleet's all-saturated 429 quotes the
        smallest over its replicas."""
        return self._retry_after()

    def prefix_match_len(self, keys: Sequence[bytes]) -> int:
        """Leading prompt blocks resident here, for the fleet router: 0 on
        the dense engine, which has no prefix cache."""
        return 0

    def adapter_resident(self, name: Optional[str]) -> bool:
        """True when the named tenant's adapter is resident in this engine's
        pool: the router's adapter affinity (a resident hit skips the load
        and cannot evict another tenant)."""
        if name is None or self._mt is None:
            return False
        return self._mt.is_resident(name)

    # ------------------------------------------------------- live deployment

    @property
    def swap_pending(self) -> bool:
        """True while a weight swap is staged or draining: the fleet router
        sheds this replica to its siblings meanwhile."""
        return self._swap_pending is not None

    @property
    def weight_generation(self) -> int:
        """Applied weight swaps so far (a rollback is a swap too)."""
        return self._weight_generation

    @property
    def weight_fingerprint(self) -> Optional[str]:
        """The fingerprint of the last payload swapped in (None before)."""
        return self._weight_fingerprint

    @property
    def params(self) -> dict:
        """The flat parameter dict this engine serves now (the base weights,
        without the adapter pools)."""
        return self._params

    def request_weight_swap(self, weights: dict, *, fingerprint: Optional[str] = None,
                            step: Optional[int] = None, timeout: Optional[float] = None) -> dict:
        """Stage ``weights`` (``{leaf name: host tensor or array}``) for an
        atomic swap and block until the worker applies it at a drained tick
        boundary: the requests in flight finish on the current weights,
        admission pauses meanwhile, and queued requests start on the new
        ones. Shapes never change, so no kernel is rebuilt. The paged prefix
        cache is dropped iff ``fingerprint`` differs from the resident one.
        Returns ``{"weight_generation", "updated_leaves",
        "cache_invalidated", "duration_s", "memory_delta_bytes"}`` (the
        card's allocated bytes across the apply; None off the card). Raises
        on a terminal engine, a swap already staged, a ``timeout`` or a
        failed apply (the old weights keep serving)."""
        if self._terminal is not None:
            raise self._terminal
        updates = [(k, v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v)))
                   for k, v in weights.items()]
        if not updates:
            raise ValueError("request_weight_swap needs at least one leaf")
        swap = _PendingSwap(updates, fingerprint, step)
        with self._swap_lock:
            if self._swap_pending is not None:
                raise RuntimeError("a weight swap is already staged on this engine")
            self._swap_pending = swap
        self.recorder.record("weight_swap_begin", step=step, fingerprint=fingerprint,
                             live=int(self._live.sum()), queued=self.queue_depth)
        self._q.put(_POKE)  # wake an idle worker
        if not swap.done.wait(timeout):
            raise TimeoutError(f"weight swap not applied within {timeout}s (engine still "
                               f"draining {int(self._live.sum())} live slot(s))")
        if swap.error is not None:
            raise RuntimeError("weight swap failed; the engine kept the old generation: "
                               f"{type(swap.error).__name__}: {swap.error}") from swap.error
        return dict(swap.result)

    def stats_snapshot(self) -> dict:
        """``ServingStats.snapshot()`` with fresh ``weight_bytes``,
        ``kv_pool_bytes``, ``queue_depth``, ``live_slots``,
        ``engine_generation``, ``weight_generation`` and ``brownout_stage``
        gauges, plus ``circuit_state``, ``role``, ``draining``, the MFU and
        HBM-bandwidth gauges, the SLO report and the per-generation slices
        (``GET /v1/stats``; the JAX keys but ``compile``: the port compiles
        no programs), ``adapters_resident`` and ``per_tenant``."""
        mem = self.memory_breakdown()
        self.stats.gauge("weight_bytes", mem["weight_bytes"])
        self.stats.gauge("kv_pool_bytes", mem["kv_pool_bytes"])
        self.stats.gauge("queue_depth", self.queue_depth)
        self.stats.gauge("live_slots", self.live_slots)
        self.stats.gauge("engine_generation", self.supervisor.generation)
        self.stats.gauge("weight_generation", self._weight_generation)
        self.stats.gauge("adapters_resident",
                         len(self._mt.resident()) if self._mt is not None else 0)
        self.stats.gauge("brownout_stage", self._brownout_stage)
        snap = self.stats.snapshot()
        snap["circuit_state"] = self.circuit_state
        snap["role"] = self.role
        snap["draining"] = self._draining
        mfu, bw = self._utilization()
        snap["model_flops_utilization"] = mfu
        snap["hbm_bandwidth_utilization"] = bw
        snap["slo"] = self.slo_report()
        snap["per_generation"] = self.slo_slices.summaries()
        return snap

    @staticmethod
    def _weight_breakdown(params: dict) -> tuple:
        """(bytes of ``params`` as stored, bytes they save against bf16):
        int8 codes with their scales, each tensor counted once (a tied table
        is one tensor)."""
        weight_bytes = saved = 0
        seen = set()
        for name, t in params.items():
            key = (t.data_ptr(), t.nbytes)
            if key in seen:
                continue
            seen.add(key)
            nb = t.nbytes
            weight_bytes += nb
            if name.endswith("_int8_scale"):
                saved -= nb  # pure quantization overhead
            elif name.endswith("_int8"):
                saved += 2 * t.numel() - nb
        return weight_bytes, saved

    def memory_breakdown(self) -> dict:
        """Where the resident device memory goes (the JAX engine's report):
        ``weight_bytes``, ``kv_pool_bytes`` (the K/V buffers),
        ``kv_scale_bytes`` (an int8 pool's per-block scales) and
        ``bytes_saved_vs_bf16``, which counts only quantized artifacts (int8
        weight leaves, int8 KV pools)."""
        # with a registry, the pooled view: the base and the adapter pools
        # (the JAX engine walks its pooled view)
        params = self._mt.params if self._mt is not None else self._generator.params
        weight_bytes, saved = self._weight_breakdown(params)
        kv_pool_bytes = kv_scale_bytes = 0
        for entry in (self._cache or {}).get("layers", {}).values():
            quantized = "k_scale" in entry
            for name, leaf in entry.items():
                nb = leaf.nbytes
                if name.endswith("_scale"):
                    kv_scale_bytes += nb
                    saved -= nb
                elif name in ("k", "v"):
                    kv_pool_bytes += nb
                    if quantized:
                        saved += 2 * leaf.numel() - nb
        return {"weight_bytes": weight_bytes, "kv_pool_bytes": kv_pool_bytes,
                "kv_scale_bytes": kv_scale_bytes, "bytes_saved_vs_bf16": saved}

    def slo_report(self) -> dict:
        """Burn rates of the SLO policy over the metric ring (``GET
        /v1/slo``; pure, safe from any thread)."""
        return self.slo_policy.evaluate(self.metric_ring)

    def history(self, metric: str, window_s: Optional[float] = None) -> dict:
        """The trailing series of one sampled counter or gauge (``GET
        /v1/history``); ``ValueError`` for an unknown metric (a 400)."""
        return self.metric_ring.series(metric, window_s)

    def _kv_cost_geometry(self, cache: dict) -> tuple:
        """(K/V element bytes, block length, scale element bytes) of
        ``cache``, for ``decode_work_cost``: a dense cache has no scales."""
        return cache["layers"]["0"]["k"].element_size(), 0, 0

    def decode_cost(self) -> tuple:
        """``(ticks, seconds, flops, bytes)`` of the decode dispatches timed
        so far: their count, their summed ``decode_tick_s`` and the useful
        work of their live rows (``observe/flops.decode_tick_cost`` per
        dispatch, added up), the counterpart of the JAX engine's cost
        analysis of its decode program; zeros before the first tick."""
        sums = self._decode_work.sums  # one read: whole ticks
        itemsize, _, scale_itemsize = self._kv_geometry
        flops, nbytes = decode_work_cost(self._generator.config, sums,
                                         weight_bytes=self._weight_bytes, kv_itemsize=itemsize,
                                         scale_itemsize=scale_itemsize,
                                         adapter_bytes=self._adapter_slot_bytes)
        return sums[0], sums[-1], flops, nbytes

    def _utilization(self) -> tuple:
        """(MFU, HBM-bandwidth utilization) of the decode ticks: the work of
        every timed tick over their summed time, against the card's peaks.
        0.0 before a tick was timed and on the CPU (no peaks)."""
        ticks, seconds, flops, nbytes = self.decode_cost()
        if ticks <= 0:
            return 0.0, 0.0
        peak_flops, peak_bw = device_peak_specs(self._generator.device)
        return utilization_from_cost(flops, nbytes, seconds, peak_flops, peak_bw)

    def capacity_snapshot(self) -> dict:
        """What the capacity observatory reads (``observe/capacity``): the
        forecaster's load view at the reader's clock (an idle engine's rates
        decay) and the saturation model's inputs: slots, the measured mean
        decode tick, tokens per step and the utilization gauges."""
        _, ticks, tick_sum = self.stats.hist["decode_tick_s"]._state()
        vals = self.stats.values(("tokens_served", "decode_steps"))
        steps = vals["decode_steps"]
        mfu, bw = self._utilization()
        return {
            "slots": int(self._slots),
            "role": self.role,
            "decode_ticks": ticks,
            "mean_decode_tick_s": tick_sum / ticks if ticks else 0.0,
            "mean_tokens_per_step": vals["tokens_served"] / steps if steps else 0.0,
            "live_slots_mean": self.load_forecaster.live_slots_mean,
            "model_flops_utilization": mfu,
            "hbm_bandwidth_utilization": bw,
            "forecaster": self.load_forecaster.snapshot(now=time.monotonic()),
        }

    def tick_boundary(self):
        """The lock every scheduler pass (admission and tick) holds: taking
        it waits for the pass in progress to end."""
        return self._tick_lock

    @property
    def healthy(self) -> bool:
        """False once the worker is dead for good, fatal or circuit open
        (``/healthz`` answers 503)."""
        return self._terminal is None

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def terminal_error(self) -> Optional[ServingError]:
        return self._terminal

    @property
    def circuit_state(self) -> str:
        """"closed" while the worker serves (or restarts), "open" once the
        circuit opened, "fatal" after a failure no restart can help."""
        if isinstance(self._terminal, CircuitOpenError):
            return "open"
        return "closed" if self._terminal is None else "fatal"

    @property
    def recovering(self) -> bool:
        """True while the worker is mid-restart (backoff and rebuild)."""
        return self.supervisor.recovering

    @property
    def brownout_stage(self) -> int:
        """The degradation stage, 0 (healthy) to 3 (shedding best_effort)."""
        return self._brownout_stage

    @property
    def queue_depth(self) -> int:
        """Requests submitted and not yet admitted."""
        return self._q.qsize() + len(self._waiting)

    @property
    def live_slots(self) -> int:
        """Slots decoding now."""
        return int(self._live.sum())

    @property
    def slot_count(self) -> int:
        return self._slots

    # ------------------------------------------------------------- admission

    def _retry_after(self) -> float:
        """A finite Retry-After hint: about how long the backlog ahead of a
        retry takes to drain through the slots, from the service-time EWMA,
        with a +-20% deterministic jitter (a multiplicative hash over a
        sequence) so clients shed in one burst do not retry in lockstep;
        clamped to [0.5 s, 600 s]."""
        backlog = self.queue_depth + max(1, int(self._live.sum()))
        est = self._avg_service_s * backlog / self._slots
        seq = next(self._retry_seq)
        est *= 0.8 + 0.4 * ((seq * 2654435761) % 1000) / 1000.0
        return float(min(max(est, 0.5), 600.0))

    def _waiting_snapshot(self) -> List[Request]:
        """Every request queued and not yet admitted, seen from a submit
        thread (a stale view only mis-picks a displacement victim)."""
        with self._q.mutex:
            queued = [r for r in self._q.queue if r is not None and r is not _POKE]
        return list(self._waiting) + queued

    def _make_request(self, prompt_ids, gen: GenerationConfig, seed: int,
                      tokens_q: Optional["queue.Queue"] = None, priority: Optional[str] = None,
                      deadline_s: Optional[float] = None,
                      trace: Optional[RequestTrace] = None,
                      adapter: Optional[str] = None) -> Request:
        """The admission gate shared by submit and stream: refuse a dead
        engine, a drain, a brownout shed, an overflow, an unknown adapter, a
        tenant over its quota and a full adapter pool before the request
        enters the queue, pin its adapter and stamp its deadlines. From here
        on the request is in the pending ledger, and exactly one ``_settle``
        resolves it (which also releases the adapter pin and the tenant
        bookkeeping taken here)."""
        if priority is None:
            priority = self._priority_default
        if priority not in PRIORITY_TIERS:
            raise ValueError(f"unknown priority {priority!r} (expected one of {PRIORITY_TIERS})")
        tier = PRIORITY_TIERS.index(priority)
        if self._terminal is not None:
            raise self._terminal
        if not self._worker.is_alive():
            raise RuntimeError("engine stopped: close() was called")
        if self._draining:
            raise DrainingError("engine draining; admission closed — retry against another "
                                "replica", retry_after_s=self._retry_after())
        if (self._brownout_stage >= 3 and tier >= _BEST_EFFORT
                # never shed into an idle engine: the worker re-evaluates the
                # stage only on its next pass, so a stale stage must not
                # starve a best_effort-only client after a burst drains
                and (self.queue_depth > 0 or bool(self._live.any()))):
            self.stats.incr("requests_shed_overflow")
            self.stats.tier_shed_incr(priority)
            self.recorder.record("shed_brownout", tier=priority, stage=self._brownout_stage)
            raise BrownoutShedError(
                f"brownout stage {self._brownout_stage}: shedding {priority!r} traffic "
                "until pressure clears", retry_after_s=self._retry_after(), tier=priority)
        if self._max_queue_depth and self.queue_depth >= self._max_queue_depth:
            # a full queue that holds a strictly lower tier sheds that
            # waiter (the newest of the lowest tier) instead of the arrival;
            # the worker resolves it at its next pass, so the queue may
            # overshoot by one request per displacement
            victim = None
            for cand in self._waiting_snapshot():
                if cand.shed_by_pressure or cand.abandoned or cand.tier <= tier:
                    continue
                if victim is None or (cand.tier, cand.id) > (victim.tier, victim.id):
                    victim = cand
            if victim is not None:
                victim.shed_by_pressure = True
                self.recorder.record("shed_displaced", request=victim.id, tier=victim.priority,
                                     displaced_by=priority)
            else:
                self.stats.incr("requests_shed_overflow")
                self.stats.tier_shed_incr(priority)
                self.recorder.record("shed_overflow", queued=self.queue_depth, tier=priority)
                raise QueueOverflowError(
                    f"admission queue full ({self.queue_depth} waiting >= max_queue_depth "
                    f"{self._max_queue_depth})", retry_after_s=self._retry_after(), tier=priority)
        adapter_idx = 0
        if adapter is not None:
            if self._mt is None:
                raise UnknownAdapterError(
                    f"adapter {adapter!r} requested but this engine has no "
                    "adapter registry (start the server with --adapter-dir)"
                )
            # the quota check and the tenant's in-flight count move together,
            # before the acquire (a hot-load), so concurrent requests of one
            # tenant cannot all pass the check
            with self._plock:
                inflight = self._tenant_inflight.get(adapter, 0)
                over_quota = self._adapter_quota > 0 and inflight >= self._adapter_quota
                if not over_quota:
                    self._tenant_inflight[adapter] = inflight + 1
            if over_quota:
                self.stats.incr("requests_shed_tenant_quota")
                self.recorder.record("shed_tenant_quota", tenant=adapter)
                raise TenantQuotaError(
                    f"tenant {adapter!r} already has {self._adapter_quota} "
                    "request(s) in flight (--adapter-capacity); retry when "
                    "one completes",
                    retry_after_s=self._retry_after(),
                )
            try:
                adapter_idx = self._mt.acquire(adapter)
            except Exception as e:
                self._tenant_done(adapter)
                if isinstance(e, AdapterPoolFullError):
                    e.retry_after_s = self._retry_after()
                raise
        req = Request([int(t) for t in prompt_ids], gen, int(seed), tokens_q=tokens_q)
        req.adapter = adapter
        req.adapter_idx = int(adapter_idx)
        if adapter is not None:
            self.stats.tenant_incr(adapter, "requests")
            self.stats.tenant_incr(adapter, "queue_depth")
        req.id = next(self._req_seq)
        req.enqueued_at = time.monotonic()
        if trace is not None:  # the fleet's timeline, across its hops
            req.trace = trace
            trace.request_id = req.id
        else:
            req.trace = RequestTrace(req.id, t0=req.enqueued_at)
        req.trace.mark("received", req.enqueued_at)
        if self._queue_deadline_s is not None:
            req.queue_deadline = req.enqueued_at + self._queue_deadline_s
        req.priority = priority
        req.tier = tier
        if deadline_s is not None:
            req.deadline = req.enqueued_at + float(deadline_s)
        with self._plock:
            self._pending += 1
        req.trace.mark("queued", req.enqueued_at)
        return req

    def _expired(self, req: Request) -> bool:
        return req.queue_deadline is not None and time.monotonic() > req.queue_deadline

    def _deadline_expired(self, req: Request, now: Optional[float] = None) -> bool:
        """The client's deadline: callers before prefill read the clock, the
        decode tick passes its tick clock (no clock read per token)."""
        if req.deadline is None:
            return False
        return (time.monotonic() if now is None else now) > req.deadline

    # ------------------------------------------------------------ resolution

    def _settle(self, req: Request) -> None:
        """The one place a request leaves the pending ledger and wakes its
        waiter. Every token it emitted (banked ones included) is charged
        once, here: to goodput when it completed, else to the reason it
        ended. It is stamped with the weight generation it settled under,
        that generation's slice counts it, and its trace, whose
        terminal span is marked by now, goes to the trace log."""
        # a request that drains ahead of a staged swap settles before the
        # apply: it visibly finished on the old generation
        req.weight_generation = self._weight_generation
        self.slo_slices.note_settled(req.weight_generation, failed=req.error is not None)
        n = req.tokens_emitted
        if n:
            if req.abandoned:
                self.stats.waste_incr("abandoned", n)
            elif req.error is None:
                self.stats.incr("goodput_tokens", n)
            elif isinstance(req.error, DeadlineExceededError):
                self.stats.waste_incr("deadline", n)
            elif isinstance(req.error, (RetryableEngineError, CircuitOpenError,
                                        FatalEngineError, DrainingError)):
                # a restart or the circuit took it: a retry redoes the work
                self.stats.waste_incr("failover", n)
            else:  # shed after work was done (a preempted request's banked tokens)
                self.stats.waste_incr("shed", n)
        with self._plock:
            self._pending -= 1
        self._leave_tenant(req)
        if self._trace_writer is not None and req.trace is not None:
            self._trace_writer.write({
                "request_id": req.id,
                "prompt_tokens": len(req.prompt),
                "generated_tokens": len(req.result or ()),
                "error": type(req.error).__name__ if req.error else None,
                "weight_generation": self._weight_generation,
                **req.trace.to_dict(),
            })
        req.done.set()

    def _resolve_error(self, req: Request, err: BaseException) -> None:
        if req.done.is_set():
            return
        req.error = err
        if req.trace is not None:
            req.trace.mark("failed")
        if req.tokens_q is not None:
            req.tokens_q.put(None)
        self.stats.incr("requests_failed")
        self._settle(req)

    def _settle_abandoned(self, req: Request) -> None:
        self.stats.incr("requests_abandoned")
        if req.trace is not None:
            req.trace.mark("abandoned")
        self._settle(req)

    def _shed_deadline(self, req: Request) -> None:
        waited = time.monotonic() - req.enqueued_at if req.enqueued_at else 0.0
        self.stats.incr("requests_shed_deadline")
        self.recorder.record("shed_deadline", request=req.id, waited_s=round(waited, 4))
        self._resolve_error(req, QueueDeadlineError(
            f"request waited {waited:.2f}s queued, over the {self._queue_deadline_s}s "
            "deadline; shed before prefill", retry_after_s=self._retry_after()))

    def _resolve_displaced(self, req: Request) -> None:
        """Settle a queued request that a higher-tier arrival displaced from
        the full queue: a tier-labelled 429."""
        self.stats.incr("requests_shed_overflow")
        self.stats.tier_shed_incr(req.priority)
        self.recorder.record("shed_displaced_resolved", request=req.id, tier=req.priority)
        self._resolve_error(req, QueueOverflowError(
            f"request (tier {req.priority!r}) displaced from the full queue by a "
            "higher-priority arrival", retry_after_s=self._retry_after(), tier=req.priority))

    def _cancel_deadline_queued(self, req: Request) -> None:
        """The client's deadline expired before prefill: 504 with the tokens
        an earlier preempted run banked (usually none)."""
        waited = time.monotonic() - req.enqueued_at if req.enqueued_at else 0.0
        self.stats.incr("requests_shed_deadline")
        self.recorder.record("deadline_cancel", request=req.id, where="queued",
                             waited_s=round(waited, 4), tokens_generated=len(req.preempted_tokens))
        self._resolve_error(req, DeadlineExceededError(
            f"deadline expired after {waited:.2f}s, before prefill",
            tokens=tuple(req.preempted_tokens)))

    def _cancel_deadline_decode(self, slot: int, req: Request) -> None:
        """The client's deadline expired while the request held a slot:
        504 with the tokens so far, and the slot (and its blocks) free this
        tick."""
        tokens = req.preempted_tokens + self._slot_tokens[slot]
        self.stats.incr("requests_shed_deadline_decode")
        self.recorder.record("deadline_cancel", request=req.id, where="decode", slot=slot,
                             tokens_generated=len(tokens))
        self._resolve_error(req, DeadlineExceededError(
            f"deadline expired mid-decode after {len(tokens)} token(s)", tokens=tuple(tokens)))
        self._release(slot)

    def _pre_admit_resolve(self, req: Request) -> bool:
        """Settle a waiter that must not be admitted (its waiter gave up, it
        was displaced, or a deadline passed); True when it was."""
        if req.abandoned:
            self._settle_abandoned(req)
        elif req.shed_by_pressure:
            self._resolve_displaced(req)
        elif self._expired(req):
            self._shed_deadline(req)
        elif self._deadline_expired(req):
            self._cancel_deadline_queued(req)
        else:
            return False
        return True

    # ---------------------------------------------------------------- worker

    def _run(self) -> None:
        """The supervised worker: build a generation's device state, serve
        until a tick fails, then restart in-process (``_recover``) or die.
        Once dead it keeps resolving the requests that raced the failure,
        until ``close()``."""
        while True:
            try:
                if self._cache is None:  # a restart dropped the crashed generation's state
                    self._startup()
                self._serve_loop()
                if self._watchdog is not None:
                    self._watchdog.stop()
                return  # close() was called and the work queued before it served
            except BaseException as e:  # supervision boundary
                if not self._recover(e):
                    break
        while not self._closing:
            req = self._q.get()
            if req is None:
                return
            if req is _POKE:
                self._resolve_export_terminal()
                self._resolve_swap_terminal()
                continue
            self._resolve_error(req, self._terminal)

    def _startup(self) -> None:
        """(Re)build one generation's device state from the weights still on
        the card: the slot cache and state, the draft model's cache, and the
        slot bookkeeping. Any earlier cache is dropped first, so the card
        never holds two at once."""
        self._drop_device_state()
        self._slot_req: List[Optional[Request]] = [None] * self._slots
        self._slot_tokens: List[List[int]] = [[] for _ in range(self._slots)]
        self._slot_budget = [0] * self._slots
        self._slot_plen = [0] * self._slots  # prompt + banked tokens
        self._live = np.zeros((self._slots,), bool)
        self._cache, self._state = self._init_state()
        # the slots forward through this engine's weights (with a registry,
        # its pooled view of them)
        self._state["params"] = self._mt.params if self._mt is not None else self._params
        if self._mt is not None:
            self._mt.rebuild()  # the resident adapters survive a restart
        self._startup_draft()

    def _startup_draft(self) -> None:
        """The draft model's dense per-slot cache dies with the target's; a
        request prefills both again at its next admission."""
        if self._use_draft:
            self._dcache = self._generator.init_draft_slot_cache(self._slots, self._buf_len)

    def _drop_device_state(self) -> None:
        self._cache = self._state = self._dcache = None

    def _recover(self, cause: BaseException) -> bool:
        """Classify a worker failure (the JAX engine's policy): True when the
        state was dropped for a restart and the worker should serve again,
        False when the engine is now terminal."""
        if self._watchdog is not None:
            self._watchdog.pause()  # the backoff is not a wedge
        log.error("%s worker failed", type(self).__name__, exc_info=cause)
        # the failed tick's frames may hold tensors of the crashed
        # generation's cache; the error outlives them as the waiters' cause
        traceback.clear_frames(cause.__traceback__)
        sup = self.supervisor
        self.recorder.record("crash", step=self._decode_index,
                             error=f"{type(cause).__name__}: {cause}", live=int(self._live.sum()))
        if is_retryable_failure(cause) and sup.record_failure() == "restart":
            sup.begin_recovery()
            err = RetryableEngineError(
                f"engine worker failed mid-flight ({type(cause).__name__}: {cause}); in-flight "
                "state lost, engine restarting — safe to retry",
                retry_after_s=self._retry_after(), generation=sup.generation)
            err.__cause__ = cause
            self._fail_inflight(err)
            self._drop_device_state()
            delay = sup.backoff_delay()
            if delay > 0:
                time.sleep(delay)
            sup.restarted()
            self.stats.incr("engine_restarts")
            self.recorder.record("restart", generation=sup.generation, backoff_s=round(delay, 4),
                                 failures_in_window=sup.failure_count)
            # dumped after the restart event: the artifact holds the ticks
            # before the crash, the crash and the restart
            dump = sup.dump_flight(self.recorder, "crash_restart", error=str(cause))
            log.warning("recovered from %s: generation %d (%d failure(s) in the window, backoff "
                        "%.2fs)%s", type(cause).__name__, sup.generation, sup.failure_count, delay,
                        f"; flight recorder dumped to {dump}" if dump else "")
            return True
        if sup.circuit_open:
            err = CircuitOpenError(
                f"{sup.failure_count} engine failures within {sup.circuit_window_s:.0f}s — "
                f"circuit open, not restarting (last: {type(cause).__name__}: {cause}); the pod "
                "needs a recycle")
        else:
            err = FatalEngineError(f"fatal engine failure: {type(cause).__name__}: {cause}")
        err.__cause__ = cause
        self._terminal = err  # before resolving, so every waiter sees it
        self._resolve_export_terminal()  # a staged export must not hang its caller
        self._resolve_swap_terminal()  # nor a staged swap (a restart keeps it)
        reason = "circuit_open" if sup.circuit_open else "fatal"
        self.recorder.record(reason, error=str(err))
        dump = sup.dump_flight(self.recorder, reason, error=str(cause))
        self._fail_inflight(err)
        self._fail_queued(err)
        if self._watchdog is not None:
            self._watchdog.stop()
        log.error("worker terminal: %s%s", err,
                  f" (flight recorder dumped to {dump})" if dump else "")
        return False

    def _fail_inflight(self, err: ServingError) -> None:
        """Resolve every admitted request and free its slot: its KV state
        does not survive the rebuild."""
        for slot, req in enumerate(self._slot_req):
            if req is not None:
                self._resolve_error(req, err)
                self._release(slot)

    def _fail_queued(self, err: ServingError) -> None:
        """Resolve everything still queued (terminal only: a restart keeps
        the queue)."""
        while self._waiting:
            self._resolve_error(self._waiting.pop(0), err)
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            if req is None:
                self._closing = True
            elif req is not _POKE:
                self._resolve_error(req, err)

    # ------------------------------------------------------ live migration

    def _resolve_export_terminal(self) -> None:
        """Fail a staged export with the terminal error, so that the fleet's
        call returns (and falls back to the drain, which a dead engine
        resolves at once)."""
        with self._export_lock:
            exp, self._export_pending = self._export_pending, None
        if exp is not None:
            exp.error = self._terminal
            exp.done.set()

    def _apply_export(self) -> None:
        """Detach every request in flight and queued (worker thread). A slot's
        request gets its tokens banked (and, paged, its ingested blocks
        spilled), frees its slot and leaves the pending ledger; a queued one
        just leaves the ledger. The migrate fault fires before a request is
        touched, so a failure leaves each request either wholly exported or
        wholly here, and the exported ones are then re-adopted: each still
        has exactly one settle ahead of it, on one engine."""
        exp = self._export_pending
        exported: List[Request] = []
        try:
            self._drain_queue(block=False)
            for slot in range(self._slots):
                req = self._slot_req[slot]
                if req is None:
                    continue
                if req.abandoned:
                    self._forget_prefill(slot)
                    self._settle_abandoned(req)
                    self._release(slot)
                    continue
                self.faults.maybe_fail_migrate()
                self._bank_and_spill(slot, req)
                self._release(slot)
                self._detach_request(req)
                exported.append(req)
            while self._waiting:
                req = self._waiting[0]
                if not req.done.is_set() and not self._pre_admit_resolve(req):
                    self.faults.maybe_fail_migrate()  # before it leaves the buffer
                    self._detach_request(req)
                    exported.append(req)
                self._waiting.pop(0)
            exp.result = exported
            self.recorder.record("export", requests=len(exported))
        except Exception as e:  # reported to the caller
            for req in exported:
                self._readopt(req)
            exp.error = e
            self.recorder.record("export_failed", error=f"{type(e).__name__}: {e}",
                                 readopted=len(exported))
        finally:
            with self._export_lock:
                self._export_pending = None
            exp.done.set()

    # ------------------------------------------------------- live deployment

    def _resolve_swap_terminal(self) -> None:
        """Fail a staged swap with the terminal error, so its caller never
        hangs (a retryable restart keeps it: it applies after recovery)."""
        with self._swap_lock:
            swap, self._swap_pending = self._swap_pending, None
        if swap is not None:
            swap.error = self._terminal
            swap.done.set()

    def _apply_swap(self) -> None:
        """Apply the staged swap (worker thread, no slot in use). The new
        dict is built off to the side first, then every holder is re-pointed
        at once, so a failure leaves the old weights serving untouched."""
        swap = self._swap_pending
        t0 = time.monotonic()
        device = self._generator.device
        cuda = device.type == "cuda"
        mem0 = torch.cuda.memory_allocated(device) if cuda else None
        try:
            updates = _requantize_updates(self._params, swap.updates)
            new_params, updated = _cow_swap_tree(self._params, updates)
            if cuda:
                torch.cuda.synchronize(device)  # the copies are on the card before it is live
            old, self._params = self._params, new_params
            self._generator.adopt_params(old, new_params)
            if self._mt is not None:
                # the registry's pooled view holds the old base leaves
                self._mt.rebind(new_params)
            self._state["params"] = self._mt.params if self._mt is not None else new_params
            del old, updates, new_params
            changed = swap.fingerprint is None or swap.fingerprint != self._weight_fingerprint
            if changed:
                self._invalidate_prefix_cache()
            self._weight_fingerprint = swap.fingerprint
            self._weight_generation += 1
            self._gen_slice = self.slo_slices.slice_for(self._weight_generation)
            dt = time.monotonic() - t0
            self.stats.incr("weight_swaps")
            self.stats.gauge("weight_generation", self._weight_generation)
            for waiter in self._swap_waiters():
                if waiter.trace is not None:
                    waiter.trace.mark("weight_swap")
            self.recorder.record("weight_swap", generation=self._weight_generation,
                                 step=swap.step, fingerprint=swap.fingerprint,
                                 updated_leaves=updated, cache_invalidated=changed,
                                 dt_ms=round(dt * 1000.0, 3))
            # the card's allocated bytes across the apply: 0 when nothing but
            # this engine held the replaced leaves (None off the card)
            swap.result = {"weight_generation": self._weight_generation,
                           "updated_leaves": updated, "cache_invalidated": changed,
                           "duration_s": dt,
                           "memory_delta_bytes": (torch.cuda.memory_allocated(device) - mem0
                                                  if cuda else None)}
        except BaseException as e:  # reported to the caller
            swap.error = e
            self.recorder.record("weight_swap_failed", step=swap.step,
                                 error=f"{type(e).__name__}: {e}")
        finally:
            with self._swap_lock:
                self._swap_pending = None
            swap.done.set()

    def _swap_waiters(self) -> List[Request]:
        """The requests that queued while the swap was staged: they start on
        the new weights, so the swap is part of their latency story."""
        with self._q.mutex:
            queued = [r for r in list(self._q.queue) if isinstance(r, Request)]
        return list(self._waiting) + queued

    def _invalidate_prefix_cache(self) -> None:
        """New weights make cached K/V stale; the dense engine keeps none
        across requests. The paged engine overrides."""

    def _attach_request(self, req: Request) -> None:
        """Enter an exported request into this engine's ledgers (the inverse
        of ``_detach_request``): pin its adapter here (raising as admission
        does when it cannot), count it in flight for its tenant and pending.
        The tenant's ``requests`` counted it once, at its first admission."""
        if req.adapter is not None:
            if self._mt is None:
                raise UnknownAdapterError(
                    f"adapter {req.adapter!r} not available on the adopting "
                    "engine (no adapter registry)"
                )
            req.adapter_idx = int(self._mt.acquire(req.adapter))
            with self._plock:
                self._tenant_inflight[req.adapter] = self._tenant_inflight.get(req.adapter, 0) + 1
            self.stats.tenant_incr(req.adapter, "queue_depth")
        else:
            req.adapter_idx = 0
        with self._plock:
            self._pending += 1

    def _detach_request(self, req: Request) -> None:
        """Take an exported request out of this engine's ledgers without
        settling it: its waiter stays attached for the adopter, and its
        adapter pin is released here."""
        with self._plock:
            self._pending -= 1
        self._leave_tenant(req)

    def _tenant_done(self, adapter: str) -> None:
        """One request of tenant ``adapter`` is no longer in flight here."""
        with self._plock:
            n = self._tenant_inflight.get(adapter, 1) - 1
            if n <= 0:
                self._tenant_inflight.pop(adapter, None)
            else:
                self._tenant_inflight[adapter] = n

    def _leave_tenant(self, req: Request) -> None:
        """The request leaves this engine: its tenant's in-flight count and
        queue depth drop and its adapter pin is released."""
        if req.adapter is None:
            return
        self._tenant_done(req.adapter)
        self.stats.tenant_incr(req.adapter, "queue_depth", -1)
        if self._mt is not None:
            self._mt.release(req.adapter)

    def _readopt(self, req: Request) -> None:
        """Take back a request this engine detached (a failed export or
        handoff). If its adapter cannot be pinned again (the pool filled
        meanwhile), the waiter fails with that error instead of hanging."""
        try:
            self._attach_request(req)
        except Exception as e:  # the pin was released at the detach
            req.adapter = None
            with self._plock:
                self._pending += 1
            self._resolve_error(req, e)
            return
        self._waiting.append(req)

    def _bank_and_spill(self, slot: int, req: Request) -> None:
        """Bank a leaving slot's tokens on its request, as a preemption does
        but not counted as one. The paged engine also spills the slot's
        ingested blocks to the host tier."""
        req.preempted_tokens.extend(self._slot_tokens[slot])

    def _forget_prefill(self, slot: int):
        """Drop the pending prefill of ``slot``: the dense engine prefills
        at admission and has none."""
        return None

    def _handoff_slot(self, slot: int, req: Request) -> None:
        """Hand a request that just got its first token to a decode replica
        (worker thread; a prefill replica with a fleet-installed hook): bank
        it as an export does, free the slot, detach it and ask the hook to
        place it. Every failure decodes in place: a fault before the spill
        leaves the slot live, and a hook that places it nowhere re-queues it
        here, where its blocks are still in the prefix cache. Greedy tokens
        are the same on every path."""
        try:
            self.faults.maybe_fail_handoff()
            self._bank_and_spill(slot, req)
            self._release(slot)
            self._detach_request(req)
        except Exception as e:  # degrade, never drop
            req.handoff_failed = True
            self.stats.incr("requests_handoff_failed")
            self.recorder.record("handoff_failed", request=req.id, where="spill",
                                 error=f"{type(e).__name__}: {e}")
            return
        adopted, err = False, None
        try:
            adopted = bool(self.handoff(req))
        except Exception as e:  # degrade, never drop
            err = f"{type(e).__name__}: {e}"
        if adopted:
            self.stats.incr("requests_handed_off")
            req.trace.mark("handoff")
            self.recorder.record("handoff", request=req.id,
                                 tokens_banked=len(req.preempted_tokens))
            return
        # no decode replica took it: it resumes here, and the flag keeps it
        # from being handed off again
        req.handoff_failed = True
        self._readopt(req)
        self.stats.incr("requests_handoff_failed")
        self.recorder.record("handoff_failed", request=req.id, where="adopt",
                             error=err or "no decode-capable replica accepted")

    def _handoff_due(self, slot: int, req: Request) -> bool:
        """A prefill replica hands a request off after its first token,
        unless that token ended it or an earlier handoff of it failed."""
        return (self.role == "prefill" and self.handoff is not None
                and not req.handoff_failed and self._slot_req[slot] is req)

    def _serve_loop(self) -> None:
        while True:
            self._drain_queue(block=False)
            with self._tick_lock:
                if self._export_pending is not None:
                    # applied at once: emptying the slots without waiting
                    # for them is the point
                    self._apply_export()
                if self._swap_pending is not None:
                    # admission pauses: the slots in flight finish on the
                    # old weights, and the swap applies once they are gone
                    if any(r is not None for r in self._slot_req):
                        self._tick()
                        continue
                    self._apply_swap()
                self._admit()
                busy = self._tick()
            if not busy and not self._waiting:
                if self._closing:
                    return
                self._sample_idle()
                self._drain_queue(block=True)  # idle: wait for traffic

    def _tick(self) -> bool:
        """One scheduler tick's device work; False when there was none."""
        if not self._live.any():
            return False
        if self._spec_k:
            self._decode_once_spec()
        else:
            self._decode_once()
        return True

    def _drain_queue(self, block: bool) -> None:
        """Move queued requests to the priority buffer; a ``close()`` sets
        ``_closing`` (the work already queued is still served). A blocking
        wait pauses the watchdog: an empty queue is silence, not a wedge."""
        if block and self._watchdog is not None:
            self._watchdog.pause()
        while True:
            try:
                req = self._q.get(block=block)
            except queue.Empty:
                return
            if req is None:
                self._closing = True
            elif req is not _POKE:
                self._waiting.append(req)
            block = False

    # ------------------------------------------------------ overload control

    def _shed_marked(self) -> None:
        """Resolve the waiters a submit thread marked for displacement."""
        for i in range(len(self._waiting) - 1, -1, -1):
            if self._waiting[i].shed_by_pressure:
                self._resolve_displaced(self._waiting.pop(i))

    def _effective_tier(self, req: Request, now: float) -> int:
        """The tier that orders admission: every ``age_promote_s`` of
        waiting promotes a request one tier, so a flood of a higher tier
        cannot park it forever."""
        if self._age_promote_s <= 0:
            return req.tier
        waited = now - req.enqueued_at if req.enqueued_at else 0.0
        return max(0, req.tier - int(waited / self._age_promote_s))

    def _select_waiting(self) -> int:
        """Index of the next waiter to admit: lowest (aged tier, arrival)."""
        now = time.monotonic()
        return min(range(len(self._waiting)),
                   key=lambda i: (self._effective_tier(self._waiting[i], now), self._waiting[i].id))

    def _effective_prompt(self, req: Request) -> List[int]:
        """What to prefill: the prompt plus any tokens a preemption banked;
        decode then goes on where the preempted run stopped."""
        return list(req.prompt) + list(req.preempted_tokens)

    def _budget_cap(self, req: Request) -> int:
        """The new tokens still owed: banked tokens count against
        ``max_new_tokens``, and brownout stage 2+ caps best_effort output.
        At least 1 (the prefill emits one token)."""
        cap = int(req.gen.max_new_tokens)
        if self._brownout_stage >= 2 and req.tier >= _BEST_EFFORT:
            cap = min(cap, self._brownout_cap_tokens)
        return max(1, cap - len(req.preempted_tokens))

    def _preempt_victim(self, tier: int) -> Optional[int]:
        """The slot to preempt for an arrival of raw tier ``tier``: the
        youngest live request of the worst strictly lower tier (equal tiers
        never preempt each other); None when there is none. Slots still
        prefilling are never preempted, and neither is a request that aging
        admitted over better-tier waiters (``Request.promoted``): promotion
        bounds a lower tier's wait only if the slot it wins stays its own."""
        victim, vkey = None, None
        for slot in range(self._slots):
            req = self._slot_req[slot]
            if req is None or not self._live[slot] or req.tier <= tier or req.promoted:
                continue
            if vkey is None or (req.tier, req.id) > vkey:
                victim, vkey = slot, (req.tier, req.id)
        return victim

    def _preempt_slot(self, slot: int) -> None:
        """Bank the slot's tokens on its request, free the slot now and
        requeue the request; it resumes with one prefill over prompt +
        banked tokens and the remaining budget."""
        req = self._slot_req[slot]
        req.preempted_tokens.extend(self._slot_tokens[slot])
        req.preemptions += 1
        self.stats.incr("preemptions")
        if req.trace is not None:
            req.trace.mark("preempted")
        self.recorder.record("preempt", request=req.id, slot=slot, tier=req.priority,
                             tokens_banked=len(req.preempted_tokens))
        self._release(slot)
        self._waiting.append(req)

    def _occupancy(self) -> float:
        """KV pool occupancy in [0, 1]; the dense cache is allocated per
        slot up front, so only the paged engine reports one."""
        return 0.0

    def _pressure(self) -> float:
        """The overload signal: the largest of the queue-wait EWMA over its
        budget, the pool's occupancy and the predicted drain time of the
        backlog over its budget, each near 1.0 at the edge of trouble."""
        backlog = self.queue_depth + int(self._live.sum())
        drain = self._avg_service_s * backlog / self._slots
        return max(self._queue_wait_ewma / self._brownout_queue_wait_s, self._occupancy(),
                   drain / self._brownout_drain_s)

    def _update_brownout(self) -> None:
        """Move the stage toward the pressure, stepping down only once the
        pressure is a hysteresis band below the threshold that raised it."""
        if self.queue_depth == 0:
            # an empty queue observes zero wait: without it a drained burst
            # would leave the EWMA at its peak
            self._queue_wait_ewma += 0.2 * (0.0 - self._queue_wait_ewma)
        p = self._pressure()
        stage, th = self._brownout_stage, self.BROWNOUT_THRESHOLDS
        while stage < len(th) and p >= th[stage]:
            stage += 1
        while stage > 0 and p < th[stage - 1] - self.BROWNOUT_HYSTERESIS:
            stage -= 1
        if stage != self._brownout_stage:
            prev, self._brownout_stage = self._brownout_stage, stage
            self.stats.gauge("brownout_stage", stage)
            self.recorder.record("brownout", stage=stage, prev=prev, pressure=round(p, 4))

    def _observe_admission(self, req: Request, now: float) -> None:
        """Queue wait at a request's first admission only: a resumed
        request's time since enqueue mixes decode and queue time."""
        if req.enqueued_at and req.preemptions == 0:
            wait = now - req.enqueued_at
            self.stats.observe("queue_wait_s", wait)
            self._queue_wait_ewma += 0.2 * (wait - self._queue_wait_ewma)

    def _admit(self) -> None:
        """Fill free slots in (aged tier, arrival) order. When no slot is
        free (or, paged, no blocks) and the chosen waiter outranks a live
        request, preempt the youngest live request of the worst tier: it
        requeues behind the admission, and the waiter that asked for the
        preemption takes the freed slot: selecting again by aged tier could
        pick the victim, aged past the arrival, which then preempts it back
        (the JAX engine's churn). A request that aging admits over waiters
        of a better raw tier is marked ``promoted`` and is not preempted by
        them."""
        self._shed_marked()
        self._update_brownout()
        preemptor = None
        while self._waiting:
            idx = (self._waiting.index(preemptor) if preemptor is not None
                   else self._select_waiting())
            preemptor = None
            req = self._waiting[idx]
            if self._pre_admit_resolve(req):
                del self._waiting[idx]
                continue
            free = [s for s in range(self._slots) if self._slot_req[s] is None]
            plan = None
            if free:
                try:
                    plan = self._plan(req)
                except (ValueError, RuntimeError) as e:  # cannot fit: reject this request only
                    del self._waiting[idx]
                    self._resolve_error(req, e)
                    continue
            if plan is None:
                victim = self._preempt_victim(req.tier)
                if victim is None:
                    return  # nothing live ranks below it: it waits for retirements
                self._preempt_slot(victim)
                preemptor = req
                continue
            del self._waiting[idx]
            req.promoted = any(w.tier < req.tier for w in self._waiting)
            try:
                self._insert(req, free[0], plan)
            except BaseException:
                # a device failure inside the prefill: the request goes back
                # to the buffer; a restart admits it into the new generation
                if self._slot_req[free[0]] is not req:
                    self._waiting.append(req)
                raise

    def _plan(self, req: Request) -> Optional[dict]:
        """Check that the prompt (with any banked tokens) fits: the prefill
        bucket and the token budget. The budget stops decode before the
        buffer's end, so slot == position holds for every token emitted."""
        prompt = self._effective_prompt(req)
        plen = len(prompt)
        if plen == 0:
            raise ValueError("the continuous engine needs a non-empty prompt")
        if plen >= self._buf_len:
            raise ValueError(
                f"prompt of {plen} tokens does not fit the engine's "
                f"{self._buf_len}-slot KV buffer (need >= 1 decode slot)"
            )
        return {"prompt": prompt, "plen": plen,
                "bucket": min(-(-plen // self._bucket) * self._bucket, self._buf_len),
                "budget": min(self._budget_cap(req), self._buf_len - plen)}

    def _insert(self, req: Request, slot: int, plan: dict) -> None:
        """Prefill the prompt into ``slot`` and emit its first token."""
        self.faults.maybe_fail_prefill()
        t0 = time.monotonic()
        if req.trace is not None:
            req.trace.mark("admitted", t0)
        self._observe_admission(req, t0)
        plen = plan["plen"]
        self.recorder.record("admit", request=req.id, slot=slot, prompt_tokens=plen)
        padded = np.zeros((1, plan["bucket"]), np.int64)
        padded[0, :plen] = plan["prompt"]
        first = self._generator.slot_prefill(self._cache, self._state, padded, plen, slot,
                                             req.gen, req.seed, **self._adapter_kw(req))
        self._now = time.monotonic()  # slot_prefill read its token: synced
        self.stats.observe("prefill_chunk_s", self._now - t0)
        if req.trace is not None:
            req.trace.mark("prefill", self._now)
        if self._watchdog is not None:
            self._watchdog.poke(self._decode_index)
        if self._use_draft and req.gen.speculative_lookup > 0:
            # the draft's row sees the prompt before the slot's first tick
            self._generator.draft_slot_prefill(self._dcache, padded, slot)
        self._slot_req[slot] = req
        self._slot_tokens[slot] = []
        self._slot_budget[slot] = plan["budget"]
        self._slot_plen[slot] = plen
        self._live[slot] = True
        self.stats.incr("requests_admitted")
        self.stats.incr("prefill_tokens", plen)
        self._emit_token(slot, req, first, from_decode=False)
        if self._handoff_due(slot, req):
            self._handoff_slot(slot, req)

    def _tick_done(self, t0: float) -> None:
        """After a decode step: stamp the tick clock, observe the tick and
        add its dispatch to the work sums, poke the watchdog, record the
        tick and move the brownout stage."""
        self._now = time.monotonic()
        dt = self._now - t0
        self.stats.observe("decode_tick_s", dt)
        positions, queries, adapters = self._dispatched
        self._decode_work.add(positions, queries, self._kv_geometry[1], dt, adapters)
        if self._watchdog is not None:
            self._watchdog.poke(self._decode_index)
        self.stats.incr("decode_steps")
        self.recorder.record("tick", step=self._decode_index, live=int(self._live.sum()),
                             dt_ms=round((self._now - t0) * 1000.0, 3))
        self._update_brownout()
        # the SLO sample rides the tick stamp taken above: no clock read
        if self.metric_ring.due(self._now):
            self._sample_slo(self._now)

    def _sample_idle(self) -> None:
        """Going idle: one more sample when the counters moved since the
        newest one, so that the ring holds the last tick's tokens (a sample
        rides ``_tick_done``, before that tick's tokens are emitted). One
        clock read per idle transition, none per token."""
        newest = self.metric_ring.samples()[-1:]
        if newest and self.stats.values(RING_COUNTERS) != newest[0]["counters"]:
            self._sample_slo(time.monotonic())

    def _sample_slo(self, now: float) -> None:
        """One metric-ring sample, the SLO transitions it causes (to the
        flight recorder) and one load-forecaster update (worker thread)."""
        live = int(self._live.sum())
        self.metric_ring.sample(now, self.stats, gauges={
            "queue_depth": self.queue_depth,
            "live_slots": live,
            "brownout_stage": self._brownout_stage,
            "weight_generation": self._weight_generation,
        })
        report = self.slo_policy.evaluate(self.metric_ring, now=now)
        for kind, fields in self.slo_policy.observe_transitions(report):
            self.recorder.record(kind, **fields)
        # arrivals approximate offered load: admissions plus sheds at the door
        vals = self.stats.values((
            "requests_admitted", "requests_shed_overflow", "requests_shed_deadline",
            "requests_shed_tenant_quota", "tokens_served", "prefill_tokens", "decode_tokens",
        ))
        self.load_forecaster.update(
            now,
            arrivals=(vals["requests_admitted"] + vals["requests_shed_overflow"]
                      + vals["requests_shed_deadline"] + vals["requests_shed_tenant_quota"]),
            admitted=vals["requests_admitted"],
            tokens=vals["tokens_served"],
            queue_depth=self.queue_depth,
            queue_wait_s=self._queue_wait_ewma,
            live_slots=live,
            prefill_tokens=vals["prefill_tokens"],
            decode_tokens=vals["decode_tokens"],
        )

    def _next_decode(self) -> None:
        """Count a decode tick, then fire the fault armed for it (host
        only: it adds no device work to the tick)."""
        self._decode_index += 1
        self.faults.maybe_fail_decode(self._decode_index)

    def _record_dispatch(self, n_draft: Optional[np.ndarray] = None) -> None:
        """Keep the live rows' (positions, queries, distinct adapters) of
        the decode dispatch about to run, for ``_tick_done``: each row
        attends its own length and feeds one query, plus its drafts on a
        verify; the adapters are its live rows' non-zero pool slots."""
        live = np.flatnonzero(self._live)
        positions = [self._slot_plen[s] + len(self._slot_tokens[s]) for s in live]
        queries = [1] * len(live) if n_draft is None else [1 + int(n_draft[s]) for s in live]
        adapters = 0
        if self._mt is not None:
            slots = self._state["adapter_idx"][live]
            adapters = len(np.unique(slots[slots > 0]))
        self._dispatched = (positions, queries, adapters)

    def _decode_once(self) -> None:
        t0 = time.monotonic()
        self._next_decode()
        self._record_dispatch()
        toks = self._generator.slot_step(self._cache, self._state, self._live.copy())
        self._tick_done(t0)  # slot_step returns tokens on the host: synced
        self._emit_tokens(toks)

    # ------------------------------------------------------------ speculative

    def _slot_ctx(self, slot: int) -> np.ndarray:
        """The slot's tokens, prompt (with banked tokens) and generated; its
        length - 1 is the slot's position on the device."""
        req = self._slot_req[slot]
        return np.asarray(self._effective_prompt(req) + self._slot_tokens[slot], np.int64)

    def _spec_want(self, slot: int) -> int:
        """The drafts this slot asks for this tick: its request's K capped by
        the engine's; 0 for dead slots, requests that do not speculate, and
        at brownout stage 1+ (the fused tick still runs, with no drafts)."""
        req = self._slot_req[slot]
        if req is None or not self._live[slot] or self._brownout_stage >= 1:
            return 0
        return min(int(req.gen.speculative_lookup), self._spec_k)

    def _propose_drafts(self):
        """One tick's drafts: ``(drafts [S, K], n_draft [S])``, by prompt
        lookup on the host, or by the draft model (drafts then stay on the
        device). A row's drafts past ``n_draft`` are ignored by verify."""
        k = self._spec_k
        drafts = np.zeros((self._slots, k), np.int64)
        n_draft = np.zeros((self._slots,), np.int64)
        if not self._use_draft:
            for slot in range(self._slots):
                want = self._spec_want(slot)
                if want > 0:
                    found = _prompt_lookup(self._slot_ctx(slot), want)
                    drafts[slot, : found.size] = found
                    n_draft[slot] = found.size
            return drafts, n_draft
        window = np.zeros((self._slots, k + 1), np.int64)
        start = np.zeros((self._slots,), np.int64)
        for slot in range(self._slots):
            want = self._spec_want(slot)
            if want > 0:
                ctx = self._slot_ctx(slot)
                s0 = max(ctx.size - 1 - k, 0)
                win = ctx[s0: s0 + k + 1]
                window[slot, : win.size] = win
                start[slot] = s0
                n_draft[slot] = want
        if n_draft.any():
            return self._generator.draft_slot_step(self._dcache, self._state, window, start), n_draft
        return drafts, n_draft

    def _decode_once_spec(self) -> None:
        """One fused speculative tick: draft, then one verify forward over
        every slot's K+1 positions."""
        t0 = time.monotonic()
        self._next_decode()
        drafts, n_draft = self._propose_drafts()
        self._record_dispatch(n_draft)
        toks, n_emit = self._generator.spec_slot_step(self._cache, self._state, self._live.copy(),
                                                      drafts, n_draft)
        self._tick_done(t0)  # the step read its tokens back: synced
        self._emit_spec(toks, n_emit, n_draft)

    def _emit_spec(self, toks: np.ndarray, n_emit: np.ndarray, n_draft: np.ndarray) -> None:
        """Emit each live slot's verified run in order, shared by both
        engines. A live slot always emits one token of the model's own (the
        replacement of a rejected draft, or the bonus), so its accepted
        drafts this tick are ``n_emit - 1``."""
        tick_proposed = tick_accepted = 0
        for slot in range(self._slots):
            req = self._slot_req[slot]
            if req is None or not self._live[slot]:
                continue
            if req.abandoned:
                self._settle_abandoned(req)
                self._release(slot)
                continue
            if self._deadline_expired(req, self._now):
                self._cancel_deadline_decode(slot, req)
                continue
            proposed, m = int(n_draft[slot]), int(n_emit[slot])
            if proposed:
                accepted = max(m - 1, 0)
                req.draft_tokens_proposed += proposed
                req.draft_tokens_accepted += accepted
                self.stats.incr("draft_tokens_proposed", proposed)
                self.stats.incr("draft_tokens_accepted", accepted)
                self.stats.observe("spec_run_len", accepted)
                tick_proposed += proposed
                tick_accepted += accepted
            for j in range(m):
                self._emit_token(slot, req, int(toks[slot, j]))
                if self._slot_req[slot] is not req:
                    break  # EOS or the budget finished the request mid-run
        if tick_proposed:
            self.recorder.record("spec", step=self._decode_index, proposed=tick_proposed,
                                 accepted=tick_accepted)

    def _emit_tokens(self, toks: np.ndarray) -> None:
        """Hand each live slot its token of this tick; shed the slots whose
        waiter is gone or whose deadline passed."""
        for slot in range(self._slots):
            req = self._slot_req[slot]
            if req is None or not self._live[slot]:
                continue  # free, or admitted but still prefilling
            if req.abandoned:
                self._settle_abandoned(req)
                self._release(slot)
                continue
            if self._deadline_expired(req, self._now):
                self._cancel_deadline_decode(slot, req)
                continue
            self._emit_token(slot, req, int(toks[slot]))

    def _emit_token(self, slot: int, req: Request, tok: int, from_decode: bool = True) -> None:
        if tok in self._eos:
            self._finish(slot, req)
            return
        self._slot_tokens[slot].append(tok)
        req.tokens_emitted += 1
        self.stats.incr("tokens_served")
        if from_decode:
            self.stats.incr("decode_tokens")
        if req.adapter is not None:
            self.stats.tenant_incr(req.adapter, "tokens")
        # latencies against the tick clock: no clock read per token
        now = self._now
        if req.first_token_t is None:
            req.first_token_t = now
            if req.enqueued_at:
                ttft = now - req.enqueued_at
                self.stats.observe("ttft_s", ttft)
                self._gen_slice.ttft.observe(ttft)
                if req.adapter is not None:
                    self.stats.tenant_observe(req.adapter, "ttft_s", ttft)
            if req.trace is not None:
                req.trace.mark("first_token", now)
        elif req.last_token_t is not None:
            gap = now - req.last_token_t
            self.stats.observe("inter_token_s", gap)
            self._gen_slice.inter_token.observe(gap)
            if req.adapter is not None:
                self.stats.tenant_observe(req.adapter, "inter_token_s", gap)
        req.last_token_t = now
        if req.tokens_q is not None:
            req.tokens_q.put(tok)
        if len(self._slot_tokens[slot]) >= self._slot_budget[slot]:
            self._finish(slot, req)

    def _finish(self, slot: int, req: Request) -> None:
        # banked tokens lead the result: the client sees one sequence
        # however often the request was preempted
        req.result = req.preempted_tokens + self._slot_tokens[slot]
        if req.trace is not None:
            req.trace.mark("completed", self._now)
        if req.draft_tokens_proposed:
            req.spec_acceptance = req.draft_tokens_accepted / req.draft_tokens_proposed
        elif self._spec_k > 0 and req.gen.speculative_lookup > 0:
            req.spec_acceptance = 0.0  # asked to speculate, nothing was drafted
        if req.tokens_q is not None:
            req.tokens_q.put(None)
        if req.enqueued_at:  # the service-time EWMA behind the Retry-After hints
            self._avg_service_s += 0.2 * (time.monotonic() - req.enqueued_at - self._avg_service_s)
        self.stats.incr("requests_completed")
        self._settle(req)
        self._release(slot)

    def _adapter_kw(self, req: Request) -> dict:
        """The prefill's adapter arguments: none for a base request, so the
        call is the same as without a registry."""
        return {"adapter_idx": req.adapter_idx} if req.adapter_idx else {}

    def _release(self, slot: int) -> None:
        self._slot_req[slot] = None
        self._slot_tokens[slot] = []
        self._slot_budget[slot] = 0
        self._slot_plen[slot] = 0
        self._live[slot] = False


class _PrefillTask:
    """One admitted request's remaining prefill work."""

    __slots__ = ("req", "slot", "prompt", "keys", "plen", "next")

    def __init__(self, req: Request, slot: int, prompt: List[int], keys, plen: int, next_: int):
        self.req = req
        self.slot = slot
        self.prompt = prompt  # the prompt plus any banked tokens
        self.keys = keys  # full-block prefix keys (PrefixCache.block_keys)
        self.plen = plen
        self.next = next_  # first logical position not yet prefilled


class PagedContinuousBatchingEngine(ContinuousBatchingEngine):
    """The continuous engine over a block-paged KV pool. A request that
    cannot get blocks yet preempts a live request of a strictly lower tier,
    or keeps its turn until a retirement frees some. Dead rows decode with
    all-null tables, so their writes land in the null block. ``kv_quant="int8"`` stores the pool as int8 codes with
    per-block scales, and every decode step's attention then runs the paged
    decode kernel.

    ``host_tier`` (``infer/paged.HostBlockTier``, shared by a fleet's
    replicas) keeps the blocks the prefix cache evicts, the blocks a
    preemption banks and the blocks an export or a handoff ships; admission
    restores a prompt's leading blocks from it. A spill that fails counts as
    a discard and a restore that fails or misses prefills those positions
    again (``prefix_blocks_discarded``, ``host_tier_restore_misses``): the
    JAX engine's degrade paths, slower and never wrong."""

    def __init__(
        self,
        generator,
        slots: int = 8,
        buf_len: int = 4096,
        prompt_bucket: int = 64,
        block_len: int = 256,
        prefill_chunk: int = 512,
        num_blocks: Optional[int] = None,
        kv_quant: str = "none",
        stats: Optional[ServingStats] = None,
        speculative_k: int = 0,
        host_tier=None,
        **overload,
    ):
        """``overload``: the base engine's admission, deadline, priority,
        brownout, supervision, observability and role settings."""
        slots = max(1, int(slots))
        self._host_tier = host_tier
        self._block_len = max(1, int(block_len))
        self._prefill_chunk = max(1, int(prefill_chunk))
        self._kv_quant = kv_quant
        # table width: buf_len plus the final prefill chunk's pad bucket
        bucket = max(1, int(prompt_bucket))
        self._table_blocks = -(-(int(buf_len) + bucket) // self._block_len)
        if num_blocks is None:
            # full tables for every slot, one table of prefix-cache headroom,
            # and the null block
            num_blocks = 1 + (slots + 1) * self._table_blocks
        self._num_blocks = int(num_blocks)
        self._table = np.zeros((slots, self._table_blocks), np.int32)
        self._prefills: List[_PrefillTask] = []
        self._prefix_hits = 0  # admissions that mapped >= 1 cached block
        # the base builds generation 0 (``_startup``: the pool, the
        # allocator, the prefix cache) and starts the worker last
        super().__init__(generator, slots=slots, buf_len=buf_len, prompt_bucket=prompt_bucket,
                         stats=stats or ServingStats(slots, total_blocks=self._num_blocks - 1),
                         speculative_k=speculative_k, **overload)

    def _startup(self) -> None:
        """Rebuild the pool-backed state wholesale: a fresh allocator, an
        EMPTY prefix cache (its blocks' contents die with the old pool, and
        with them the blocks a preempted request banked: it resumes with a
        full prefill), all-null tables, no slot blocks, zeroed paged decode
        tickets and a new pool, allocated after the old one is dropped."""
        self._allocator = BlockAllocator(self._num_blocks)
        self._prefix = PrefixCache(self._allocator, self._block_len)
        self._table[:, :] = NULL_BLOCK
        self._slot_blocks: List[List[int]] = [[] for _ in range(self._slots)]
        self._prefills.clear()
        super()._startup()
        reset_paged_decode_tickets(self._generator.device)

    def _init_state(self):
        return self._generator.init_paged_state(self._slots, self._num_blocks, self._block_len,
                                                kv_quant=self._kv_quant)

    def _kv_cost_geometry(self, cache: dict) -> tuple:
        entry = cache["layers"]["0"]
        if "k_scale" in entry:  # int8 codes, one scale per (block, kv head)
            return entry["k"].element_size(), self._block_len, entry["k_scale"].element_size()
        return entry["k"].element_size(), 0, 0

    def stats_snapshot(self) -> dict:
        """The base snapshot with the pool's and the host tier's gauges, and
        ``prefix_hits``."""
        self.stats.gauge("blocks_in_use", self._allocator.used_count)
        self.stats.gauge("prefix_cache_blocks", len(self._prefix))
        self.stats.gauge("host_tier_bytes",
                         self._host_tier.bytes_used if self._host_tier is not None else 0)
        snap = super().stats_snapshot()
        snap["prefix_hits"] = self._prefix_hits
        return snap

    @property
    def pool(self) -> dict:
        return self._cache

    @property
    def block_len(self) -> int:
        """The prefix cache's block length (the fleet router's key size)."""
        return self._block_len

    def prefix_match_len(self, keys: Sequence[bytes]) -> int:
        """Leading prompt blocks resident in this replica's prefix cache: the
        router's affinity signal, read-only and safe from router threads."""
        return self._prefix.resident_run(keys)

    # ---------------------------------------------------------------- worker

    def _tick(self) -> bool:
        busy = False
        if self._prefills:
            self._prefill_tick()
            busy = True
        if self._live.any():
            self._decode_tick()
            busy = True
        return busy

    def _chunk_plan(self, plen: int, shared_len: int):
        """(nchunks, last_len, last_bucket, write_end) for a prompt whose
        first ``shared_len`` positions come from the prefix cache; the final
        chunk is padded to a multiple of ``prompt_bucket``."""
        suffix = plen - shared_len
        nchunks = -(-suffix // self._prefill_chunk)
        last = suffix - (nchunks - 1) * self._prefill_chunk
        last_bucket = -(-last // self._bucket) * self._bucket
        write_end = shared_len + (nchunks - 1) * self._prefill_chunk + last_bucket
        return nchunks, last, last_bucket, write_end

    def _plan(self, req: Request) -> Optional[dict]:
        """Match the prefix cache and reserve every block the request can
        touch (prefill pads included, all or nothing). None: no blocks now.
        A preempted request plans over prompt + banked tokens with its
        remaining budget, so its block total never grows across resumes."""
        prompt = self._effective_prompt(req)
        plen = len(prompt)
        if plen == 0:
            raise ValueError("the paged engine needs a non-empty prompt")
        if plen >= self._buf_len:
            raise ValueError(
                f"prompt of {plen} tokens does not fit the engine's "
                f"{self._buf_len}-position budget (need >= 1 decode position)"
            )
        L = self._block_len
        budget_end = min(plen + self._budget_cap(req), self._buf_len)
        keys = self._prefix.block_keys(prompt, req.adapter)
        # at least one suffix token must prefill: the first sampled token
        # needs the last prompt token's logits
        shared = self._prefix.match(keys, (plen - 1) // L)
        shared = self._restore_shared(req, keys, shared, (plen - 1) // L)
        shared_len = len(shared) * L
        _, _, _, write_end = self._chunk_plan(plen, shared_len)
        # speculation's headroom: a verify tick at the last in-budget
        # position writes drafts and the bonus up to budget_end + K - 1, so
        # reserve K + 1 positions past the budget (all or nothing here, so a
        # live slot's verify never clips into a block that is not its own)
        spec_pad = self._spec_k + 1 if self._spec_k else 0
        total = -(-max(budget_end + spec_pad, write_end) // L)
        usable = self._allocator.num_blocks - 1
        if total > usable:
            for bid in shared:
                self._allocator.free(bid)
            raise ValueError(
                f"request needs {total} KV blocks ({plen} prompt + "
                f"{req.gen.max_new_tokens} new @ block_len={L}) but the pool only has {usable}"
            )
        nprivate = total - len(shared)
        private = self._allocator.alloc(nprivate)
        if private is None:
            dropped: List[Tuple[bytes, int]] = []
            self._prefix.evict(nprivate, collect=dropped)
            self._spill_to_tier(dropped)
            self.recorder.record("prefix_evict", request=req.id, blocks_needed=nprivate)
            private = self._allocator.alloc(nprivate)
        if private is None:
            for bid in shared:
                self._allocator.free(bid)
            if self._prefills or self._live.any():
                return None
            raise RuntimeError(
                f"block pool exhausted with no traffic in flight "
                f"({self._allocator.free_count}/{usable} free, need {nprivate})"
            )
        return {"prompt": prompt, "keys": keys, "shared": shared, "private": private,
                "plen": plen, "budget": budget_end - plen}

    def _insert(self, req: Request, slot: int, plan: dict) -> None:
        """Map the reserved blocks into the slot's table and queue the
        prefill; the slot goes live when its final chunk lands."""
        now = time.monotonic()
        if req.trace is not None:
            req.trace.mark("admitted", now)
        self._observe_admission(req, now)
        ids = plan["shared"] + plan["private"]
        self._table[slot, : len(ids)] = ids
        self._table[slot, len(ids):] = NULL_BLOCK
        self._slot_blocks[slot] = ids
        self._slot_plen[slot] = plan["plen"]
        self._slot_req[slot] = req
        self._slot_tokens[slot] = []
        self._slot_budget[slot] = plan["budget"]
        shared_len = len(plan["shared"]) * self._block_len
        self.recorder.record("admit", request=req.id, slot=slot, prompt_tokens=plan["plen"],
                             prefix_tokens_reused=shared_len)
        self.stats.incr("requests_admitted")
        self.stats.incr("prompt_tokens", plan["plen"])
        self.stats.incr("prefix_tokens_reused", shared_len)
        if shared_len:
            self._prefix_hits += 1
        self._prefills.append(_PrefillTask(req, slot, plan["prompt"], plan["keys"], plan["plen"],
                                           shared_len))

    def _prefill_tick(self) -> None:
        """Run ONE prefill chunk of the oldest pending prompt."""
        gen = self._generator
        task = self._prefills[0]
        req = task.req
        if req.abandoned:
            self._prefills.pop(0)
            self._settle_abandoned(req)
            self._release(task.slot)
            return
        if self._deadline_expired(req):
            # at prefill start and at every chunk boundary: an expired
            # request stops ingesting and frees its blocks this tick
            self._prefills.pop(0)
            self.stats.incr("requests_shed_deadline_decode")
            self.recorder.record("deadline_cancel", request=req.id, where="prefill",
                                 slot=task.slot, tokens_generated=len(req.preempted_tokens),
                                 positions_ingested=task.next)
            self._resolve_error(req, DeadlineExceededError(
                f"deadline expired during prefill ({task.next}/{task.plen} positions "
                "ingested)", tokens=tuple(req.preempted_tokens)))
            self._release(task.slot)
            return
        prompt = task.prompt
        self.faults.maybe_fail_prefill()
        t0 = time.monotonic()
        C = self._prefill_chunk
        remaining = task.plen - task.next
        table = self._table[task.slot: task.slot + 1]
        if remaining > C:
            chunk = np.asarray(prompt[task.next: task.next + C], np.int64)[None, :]
            gen.paged_prefill_chunk(self._cache, self._state, table, chunk, task.next,
                                    **self._adapter_kw(req))
            task.next += C
            self.stats.incr("prefill_chunks")
            self.stats.incr("prefill_tokens", C)
            self.stats.observe("prefill_chunk_s", time.monotonic() - t0)
            if req.trace is not None:
                req.trace.mark("prefill_chunk")
            if self._watchdog is not None:
                self._watchdog.poke(self._decode_index)
            return
        # The final chunk is padded to the prompt bucket with token id 0, and
        # the pads are written into the pool like real tokens. In the int8
        # pool their K/V raise the block's absmax, which changes the codes of
        # the real tokens beside them: skipping them would break parity with
        # the JAX engine.
        bucket = -(-remaining // self._bucket) * self._bucket
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :remaining] = prompt[task.next:]
        seen_row = np.zeros((1, gen.config.vocab_size), bool)
        seen_row[0, np.asarray(prompt, np.intp)] = True
        first = gen.paged_prefill_final(
            self._cache, self._state, table, padded, task.next, task.plen,
            seen_row, task.slot, req.gen, req.seed, **self._adapter_kw(req),
        )
        self._now = time.monotonic()  # paged_prefill_final read its token: synced
        self._prefills.pop(0)
        self.stats.incr("prefill_chunks")
        self.stats.incr("prefill_tokens", remaining)
        self.stats.observe("prefill_chunk_s", self._now - t0)
        if req.trace is not None:
            req.trace.mark("prefill", self._now)
        if self._watchdog is not None:
            self._watchdog.poke(self._decode_index)
        if self._use_draft and req.gen.speculative_lookup > 0:
            # the draft keeps a dense row even here: mirror the whole prompt
            dbucket = min(-(-task.plen // self._bucket) * self._bucket, self._buf_len)
            dpad = np.zeros((1, dbucket), np.int64)
            dpad[0, : task.plen] = prompt
            gen.draft_slot_prefill(self._dcache, dpad, task.slot)
        # register the prompt's FULL blocks for reuse before emitting (the
        # first token may already finish the request and free the slot)
        full = task.plen // self._block_len
        self._prefix.insert(task.keys[:full], self._slot_blocks[task.slot][:full])
        self._live[task.slot] = True
        self._emit_token(task.slot, req, first, from_decode=False)
        if self._handoff_due(task.slot, req):
            self._handoff_slot(task.slot, req)

    def _decode_bucket(self, lookahead: int = 0) -> int:
        """Power-of-two block count covering every live slot's blocks in use,
        up to ``lookahead`` positions past its position (a spec tick writes
        and reads pos..pos+K)."""
        L = self._block_len
        in_use = 1
        for slot in range(self._slots):
            if self._live[slot]:
                pos = self._slot_plen[slot] + len(self._slot_tokens[slot]) - 1
                in_use = max(in_use, (pos + lookahead) // L + 1)
        nb = 1
        while nb < in_use:
            nb *= 2
        return min(nb, self._table_blocks)

    def _decode_tables(self, nb: int) -> np.ndarray:
        # dead rows decode with all-null tables: their frozen-position
        # writes land in the null block, never in a reassigned block
        return np.ascontiguousarray(np.where(self._live[:, None], self._table, NULL_BLOCK)[:, :nb])

    def _decode_tick(self) -> None:
        if self._spec_k:
            self._decode_tick_spec()
            return
        tables = self._decode_tables(self._decode_bucket())
        t0 = time.monotonic()
        self._next_decode()
        self._record_dispatch()
        toks = self._generator.paged_step(self._cache, self._state, self._live.copy(), tables)
        self._tick_done(t0)  # paged_step returns tokens on the host: synced
        self.stats.gauge_max("peak_blocks_in_use", self._allocator.used_count)
        self._emit_tokens(toks)

    def _decode_tick_spec(self) -> None:
        """The fused draft-verify tick through the block tables, whose view
        covers K positions past each live slot's position."""
        tables = self._decode_tables(self._decode_bucket(self._spec_k))
        t0 = time.monotonic()
        self._next_decode()
        drafts, n_draft = self._propose_drafts()
        self._record_dispatch(n_draft)
        toks, n_emit = self._generator.spec_paged_step(self._cache, self._state, self._live.copy(),
                                                       tables, drafts, n_draft)
        self._tick_done(t0)  # the step read its tokens back: synced
        self.stats.gauge_max("peak_blocks_in_use", self._allocator.used_count)
        self._emit_spec(toks, n_emit, n_draft)

    # ------------------------------------------------------ overload control

    def _fail_inflight(self, err: ServingError) -> None:
        self._prefills.clear()  # their requests resolve through _slot_req
        super()._fail_inflight(err)

    def _invalidate_prefix_cache(self) -> None:
        """New weights make every cached prefix's K/V stale: the cache is
        emptied (not spilled; the host tier's fingerprint stamps already
        make its old entries miss). The swap runs with no slot in use, so
        every block is then free, and an int8 pool's block scales are
        zeroed: a block's scale only grows, so a stale one would quantize
        the new weights' K/V differently from a new pool's (the JAX engine
        keeps them)."""
        dropped = len(self._prefix)
        self._prefix.evict(self._num_blocks)
        if dropped:
            self.stats.incr("prefix_blocks_discarded", dropped)
        for entry in self._cache["layers"].values():
            for name in ("k_scale", "v_scale"):
                if name in entry:
                    entry[name].zero_()
        self.recorder.record("prefix_cache_invalidated", entries=dropped)

    def _occupancy(self) -> float:
        return self._allocator.used_count / max(1, self._num_blocks - 1)

    def _preempt_slot(self, slot: int) -> None:
        """Bank the victim's full context blocks in the prefix cache before
        the slot is released, keyed by prompt + banked + generated tokens:
        the resume's ``_plan`` computes the same keys, matches them, and
        prefills only the tail. The last emitted token's K/V is not written
        yet (the next step would write it), so ``(ctx - 1) // block_len``
        blocks are bankable. Under continued pressure the cache's LRU may
        evict them; the resume then prefills everything."""
        req = self._slot_req[slot]
        ctx = list(req.prompt) + list(req.preempted_tokens) + self._slot_tokens[slot]
        full = (len(ctx) - 1) // self._block_len
        if full > 0:
            keys = self._prefix.block_keys(ctx, req.adapter)
            self._prefix.insert(keys[:full], self._slot_blocks[slot][:full])
            # and to the host tier now: under the pressure that preempted
            # it, the LRU may well reclaim them before the resume
            self._spill_to_tier(list(zip(keys[:full], self._slot_blocks[slot][:full])))
        super()._preempt_slot(slot)

    def _forget_prefill(self, slot: int):
        for i, task in enumerate(self._prefills):
            if task.slot == slot:
                return self._prefills.pop(i)
        return None

    def _bank_and_spill(self, slot: int, req: Request) -> None:
        """Bank the tokens, then spill every INGESTED full block to the host
        tier so that the adopter restores them instead of prefilling. A slot
        still prefilling has ingested ``task.next`` positions (the rest of
        its blocks is unwritten); a live slot has all but its last emitted
        token's K/V. The blocks also enter this prefix cache, so a failed
        migration that re-adopts here re-matches them without the tier."""
        task = self._forget_prefill(slot)
        if task is not None:
            ingested = task.next
        else:
            ingested = self._slot_plen[slot] + len(self._slot_tokens[slot]) - 1
        super()._bank_and_spill(slot, req)
        full = ingested // self._block_len
        if full > 0:
            keys = self._prefix.block_keys(list(req.prompt) + list(req.preempted_tokens),
                                           req.adapter)[:full]
            blocks = self._slot_blocks[slot][:full]
            self._prefix.insert(keys, blocks)
            self._spill_to_tier(list(zip(keys, blocks)))

    # ------------------------------------------------------------ host tier

    def _gather_blocks(self, bids: List[int]) -> List[List]:
        """``bids``'s pool rows on the host: per block, its leaves in the JAX
        flatten order (``infer/generate.pool_leaves``)."""
        return self._generator.paged_block_gather(self._cache, bids)

    def _scatter_blocks(self, bids: List[int], entries: List[List]) -> None:
        """Write host-tier ``entries`` into pool rows ``bids``."""
        self._generator.paged_block_scatter(self._cache, bids, entries)

    def _spill_to_tier(self, pairs: List[Tuple[bytes, int]]) -> None:
        """Copy the named blocks into the host tier before their ids can be
        reallocated (the worker enqueues no write to them first). Every block
        that does not land in the tier counts as a discard: a failed or
        refused spill is a plain eviction, never an error."""
        if not pairs:
            return
        if self._host_tier is None:
            self.stats.incr("prefix_blocks_discarded", len(pairs))
            return
        try:
            self.faults.maybe_fail_spill()
            arrays = self._gather_blocks([bid for _, bid in pairs])
            spilled = sum(
                1 for (key, _), rows in zip(pairs, arrays)
                if self._host_tier.put(key, rows, fingerprint=self._weight_fingerprint))
            if spilled:
                self.stats.incr("prefix_blocks_spilled", spilled)
            if spilled < len(pairs):
                self.stats.incr("prefix_blocks_discarded", len(pairs) - spilled)
            self.recorder.record("spill", blocks=spilled)
        except Exception as e:  # a spill is best effort
            self.stats.incr("prefix_blocks_discarded", len(pairs))
            self.recorder.record("spill_failed", blocks=len(pairs),
                                 error=f"{type(e).__name__}: {e}")

    def _restore_shared(self, req: Request, keys: List[bytes], shared: List[int],
                        cap: int) -> List[int]:
        """Extend an admission's prefix-cache run with blocks restored from
        the host tier into freshly allocated rows. Any failure (a miss, no
        free blocks, a fault in the copy) returns the run the cache had, and
        the plan prefills the rest: slower, never wrong."""
        if self._host_tier is None:
            return shared
        want = keys[len(shared):cap]
        if not want:
            return shared
        run = self._host_tier.resident_run(want, fingerprint=self._weight_fingerprint)
        if run == 0:
            if req.preempted_tokens:
                # a resume expected its banked blocks
                self.stats.incr("host_tier_restore_misses")
            return shared
        entries = []
        for key in want[:run]:
            got = self._host_tier.get(key, fingerprint=self._weight_fingerprint)
            if got is None:
                break  # evicted since the probe: restore what is left
            entries.append(got)
        if not entries:
            self.stats.incr("host_tier_restore_misses")
            return shared
        blocks = self._allocator.alloc(len(entries))
        if blocks is None:
            dropped: List[Tuple[bytes, int]] = []
            self._prefix.evict(len(entries), collect=dropped)
            self._spill_to_tier(dropped)
            blocks = self._allocator.alloc(len(entries))
        if blocks is None:
            self.stats.incr("host_tier_restore_misses", len(entries))
            return shared
        try:
            self.faults.maybe_fail_restore()
            self._scatter_blocks(blocks, entries)
        except Exception as e:  # prefill these positions instead
            for bid in blocks:
                self._allocator.free(bid)
            self.stats.incr("host_tier_restore_misses", len(entries))
            self.recorder.record("restore_failed", request=req.id, blocks=len(entries),
                                 error=f"{type(e).__name__}: {e}")
            return shared
        # the cache takes its own reference; the plan keeps the allocation's
        self._prefix.insert(want[: len(entries)], blocks)
        self.stats.incr("host_tier_restore_hits", len(entries))
        self.recorder.record("restore", request=req.id, blocks=len(entries))
        return shared + blocks

    def _release(self, slot: int) -> None:
        for bid in self._slot_blocks[slot]:
            self._allocator.free(bid)
        self._slot_blocks[slot] = []
        self._table[slot, :] = NULL_BLOCK
        super()._release(slot)
