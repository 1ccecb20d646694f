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

Not ported from the JAX engines: the host KV tier, hot-swap, adapters and
fleets.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
import traceback
from typing import List, Optional, Sequence

import numpy as np

from llm_fine_tune_distributed_tpu_torch.infer.batching import PRIORITY_TIERS, Request
from llm_fine_tune_distributed_tpu_torch.infer.errors import (
    BrownoutShedError,
    CircuitOpenError,
    DeadlineExceededError,
    DrainingError,
    FatalEngineError,
    QueueDeadlineError,
    QueueOverflowError,
    RetryableEngineError,
    ServingError,
    is_retryable_failure,
)
from llm_fine_tune_distributed_tpu_torch.infer.paged import NULL_BLOCK, BlockAllocator, PrefixCache
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.infer.supervisor import EngineSupervisor, FaultInjector
from llm_fine_tune_distributed_tpu_torch.observe.metrics import ServingStats
from llm_fine_tune_distributed_tpu_torch.observe.tracing import FlightRecorder
from llm_fine_tune_distributed_tpu_torch.ops.flash_attention import reset_paged_decode_tickets
from llm_fine_tune_distributed_tpu_torch.runtime.watchdog import StepWatchdog

log = logging.getLogger(__name__)

__all__ = ["ContinuousBatchingEngine", "PagedContinuousBatchingEngine", "PRIORITY_TIERS",
           "Request"]
_BEST_EFFORT = PRIORITY_TIERS.index("best_effort")


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

    def __init__(self, generator, slots: int = 8, buf_len: int = 4096, prompt_bucket: int = 64,
                 stats: Optional[ServingStats] = None, speculative_k: int = 0,
                 max_queue_depth: int = 0, queue_deadline_s: Optional[float] = None,
                 priority_default: str = "interactive", age_promote_s: float = 5.0,
                 brownout_queue_wait_s: float = 2.0, brownout_drain_s: float = 10.0,
                 brownout_cap_tokens: int = 32, restart_backoff_s: float = 0.5,
                 restart_backoff_max_s: float = 30.0, circuit_threshold: int = 5,
                 circuit_window_s: float = 60.0, watchdog_timeout_s: float = 0.0,
                 watchdog: Optional[StepWatchdog] = None, faults: Optional[FaultInjector] = None,
                 flight_dir: Optional[str] = None):
        """The supervision settings are the JAX engine's: ``restart_backoff_s``
        (doubling per failure in the window, capped at
        ``restart_backoff_max_s``), ``circuit_threshold`` failures within
        ``circuit_window_s`` to open the circuit, ``flight_dir`` for the
        flight recorder's dumps (None: no dumps). ``watchdog`` is poked per
        tick; without one, ``watchdog_timeout_s`` > 0 makes a
        ``StepWatchdog(watchdog_timeout_s, "abort", start_paused=True)``.
        The first generation's device state is built here, so the cache
        exists when the constructor returns."""
        if priority_default not in PRIORITY_TIERS:
            raise ValueError(f"unknown priority_default {priority_default!r} "
                             f"(expected one of {PRIORITY_TIERS})")
        self._generator = generator
        # speculation: the engine's draft depth K; with K > 0 every tick is
        # the fused draft-verify step, so a sampled slot's draws per tick do
        # not depend on who speculates beside it
        self._spec_k = max(0, int(speculative_k))
        self._use_draft = self._spec_k > 0 and bool(getattr(generator, "has_draft", False))
        self._slots = max(1, int(slots))
        self._buf_len = int(buf_len)
        self._bucket = max(1, int(prompt_bucket))
        self.stats = stats or ServingStats(self._slots)
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
        # the device state (the cache, the slot state and the draft model's
        # dense per-slot cache) and the slot bookkeeping, all worker-thread
        # only: generation 0 is built here, later ones by the worker
        self._cache = self._state = self._dcache = None
        self._startup()
        self._worker = threading.Thread(target=self._run, name=type(self).__name__, daemon=True)
        self._worker.start()

    def _init_state(self):
        return self._generator.init_slot_state(self._slots, self._buf_len)

    # ---------------------------------------------------------------- public

    def submit(self, prompt_ids: Sequence[int], gen: GenerationConfig, seed: int = 0,
               timeout: Optional[float] = None, priority: Optional[str] = None,
               deadline_s: Optional[float] = None) -> List[int]:
        """Blocking: enqueue one request, wait for its generated token ids."""
        return self.submit_full(prompt_ids, gen, seed, timeout, priority=priority,
                                deadline_s=deadline_s).result

    def submit_full(self, prompt_ids: Sequence[int], gen: GenerationConfig, seed: int = 0,
                    timeout: Optional[float] = None, priority: Optional[str] = None,
                    deadline_s: Optional[float] = None) -> Request:
        """``submit`` returning the whole request record (the window
        batcher's call shape). On ``timeout`` the request is abandoned (the
        worker sheds it) and TimeoutError raised. ``priority`` names a tier
        of ``PRIORITY_TIERS`` (None: the engine's default); ``deadline_s``
        is the client's budget for the whole request, past which it is
        cancelled with a DeadlineExceededError carrying its tokens so far."""
        req = self._make_request(prompt_ids, gen, seed, priority=priority, deadline_s=deadline_s)
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
               deadline_s: Optional[float] = None) -> _TokenStream:
        """Enqueue one request and return an iterator over its tokens as the
        slot decodes them, while it shares the batch with everything else in
        flight. ``timeout`` bounds the wait for each next token. Admission
        (overflow, brownout, a dead engine) is decided here, before the
        caller commits to a response."""
        req = self._make_request(prompt_ids, gen, seed, tokens_q=queue.Queue(),
                                 priority=priority, deadline_s=deadline_s)
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

    def stats_snapshot(self) -> dict:
        """``ServingStats.snapshot()`` with fresh ``queue_depth``,
        ``live_slots``, ``engine_generation`` and ``brownout_stage`` gauges,
        plus ``circuit_state`` and ``draining`` (``GET /v1/stats``)."""
        self.stats.gauge("queue_depth", self.queue_depth)
        self.stats.gauge("live_slots", self.live_slots)
        self.stats.gauge("engine_generation", self.supervisor.generation)
        self.stats.gauge("brownout_stage", self._brownout_stage)
        snap = self.stats.snapshot()
        snap["circuit_state"] = self.circuit_state
        snap["draining"] = self._draining
        return snap

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
            queued = [r for r in self._q.queue if r is not None]
        return list(self._waiting) + queued

    def _make_request(self, prompt_ids, gen: GenerationConfig, seed: int,
                      tokens_q: Optional["queue.Queue"] = None, priority: Optional[str] = None,
                      deadline_s: Optional[float] = None) -> Request:
        """The admission gate shared by submit and stream: refuse a dead
        engine, a drain, a brownout shed and an overflow before the request
        enters the queue, and stamp its deadlines. From here on the request
        is in the pending ledger, and exactly one ``_settle`` resolves it."""
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
        req = Request([int(t) for t in prompt_ids], gen, int(seed), tokens_q=tokens_q)
        req.id = next(self._req_seq)
        req.enqueued_at = time.monotonic()
        if self._queue_deadline_s is not None:
            req.queue_deadline = req.enqueued_at + self._queue_deadline_s
        req.priority = priority
        req.tier = tier
        if deadline_s is not None:
            req.deadline = req.enqueued_at + float(deadline_s)
        with self._plock:
            self._pending += 1
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
        ended."""
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
        req.done.set()

    def _resolve_error(self, req: Request, err: BaseException) -> None:
        if req.done.is_set():
            return
        req.error = err
        if req.tokens_q is not None:
            req.tokens_q.put(None)
        self.stats.incr("requests_failed")
        self._settle(req)

    def _settle_abandoned(self, req: Request) -> None:
        self.stats.incr("requests_abandoned")
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
        self._live = np.zeros((self._slots,), bool)
        self._cache, self._state = self._init_state()
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
            else:
                self._resolve_error(req, err)

    def _serve_loop(self) -> None:
        while True:
            self._drain_queue(block=False)
            self._admit()
            if not self._tick() and not self._waiting:
                if self._closing:
                    return
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
            else:
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
        prefilling are never preempted."""
        victim, vkey = None, None
        for slot in range(self._slots):
            req = self._slot_req[slot]
            if req is None or not self._live[slot] or req.tier <= tier:
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
        requeues behind the admission."""
        self._shed_marked()
        self._update_brownout()
        while self._waiting:
            idx = self._select_waiting()
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
                continue
            del self._waiting[idx]
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
        self._observe_admission(req, t0)
        plen = plan["plen"]
        self.recorder.record("admit", request=req.id, slot=slot, prompt_tokens=plen)
        padded = np.zeros((1, plan["bucket"]), np.int64)
        padded[0, :plen] = plan["prompt"]
        first = self._generator.slot_prefill(self._cache, self._state, padded, plen, slot,
                                             req.gen, req.seed)
        self._now = time.monotonic()  # slot_prefill read its token: synced
        self.stats.observe("prefill_chunk_s", self._now - t0)
        if self._watchdog is not None:
            self._watchdog.poke(self._decode_index)
        if self._use_draft and req.gen.speculative_lookup > 0:
            # the draft's row sees the prompt before the slot's first tick
            self._generator.draft_slot_prefill(self._dcache, padded, slot)
        self._slot_req[slot] = req
        self._slot_tokens[slot] = []
        self._slot_budget[slot] = plan["budget"]
        self._live[slot] = True
        self.stats.incr("requests_admitted")
        self.stats.incr("prefill_tokens", plen)
        self._emit_token(slot, req, first, from_decode=False)

    def _tick_done(self, t0: float) -> None:
        """After a decode step: stamp the tick clock, observe the tick, poke
        the watchdog, record the tick and move the brownout stage."""
        self._now = time.monotonic()
        self.stats.observe("decode_tick_s", self._now - t0)
        if self._watchdog is not None:
            self._watchdog.poke(self._decode_index)
        self.stats.incr("decode_steps")
        self.recorder.record("tick", step=self._decode_index, live=int(self._live.sum()),
                             dt_ms=round((self._now - t0) * 1000.0, 3))
        self._update_brownout()

    def _next_decode(self) -> None:
        """Count a decode tick, then fire the fault armed for it (host
        only: it adds no device work to the tick)."""
        self._decode_index += 1
        self.faults.maybe_fail_decode(self._decode_index)

    def _decode_once(self) -> None:
        t0 = time.monotonic()
        self._next_decode()
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
        # latencies against the tick clock: no clock read per token
        now = self._now
        if req.first_token_t is None:
            req.first_token_t = now
            if req.enqueued_at:
                self.stats.observe("ttft_s", now - req.enqueued_at)
        elif req.last_token_t is not None:
            self.stats.observe("inter_token_s", now - req.last_token_t)
        req.last_token_t = now
        if req.tokens_q is not None:
            req.tokens_q.put(tok)
        if len(self._slot_tokens[slot]) >= self._slot_budget[slot]:
            self._finish(slot, req)

    def _finish(self, slot: int, req: Request) -> None:
        # banked tokens lead the result: the client sees one sequence
        # however often the request was preempted
        req.result = req.preempted_tokens + self._slot_tokens[slot]
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

    def _release(self, slot: int) -> None:
        self._slot_req[slot] = None
        self._slot_tokens[slot] = []
        self._slot_budget[slot] = 0
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
    decode kernel."""

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
        **overload,
    ):
        """``overload``: the base engine's admission, deadline, priority and
        brownout settings."""
        slots = max(1, int(slots))
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
        self._slot_plen = [0] * self._slots
        self._prefills.clear()
        super()._startup()
        reset_paged_decode_tickets(self._generator.device)

    def _init_state(self):
        return self._generator.init_paged_state(self._slots, self._num_blocks, self._block_len,
                                                kv_quant=self._kv_quant)

    def stats_snapshot(self) -> dict:
        """The base snapshot with the pool's gauges, and ``prefix_hits``."""
        self.stats.gauge("blocks_in_use", self._allocator.used_count)
        self.stats.gauge("prefix_cache_blocks", len(self._prefix))
        snap = super().stats_snapshot()
        snap["prefix_hits"] = self._prefix_hits
        return snap

    @property
    def pool(self) -> dict:
        return self._cache

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
        keys = self._prefix.block_keys(prompt)
        # at least one suffix token must prefill: the first sampled token
        # needs the last prompt token's logits
        shared = self._prefix.match(keys, (plen - 1) // L)
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
            self._prefix.evict(nprivate)
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
        self._observe_admission(req, time.monotonic())
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
            gen.paged_prefill_chunk(self._cache, table, chunk, task.next)
            task.next += C
            self.stats.incr("prefill_chunks")
            self.stats.incr("prefill_tokens", C)
            self.stats.observe("prefill_chunk_s", time.monotonic() - t0)
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
            seen_row, task.slot, req.gen, req.seed,
        )
        self._now = time.monotonic()  # paged_prefill_final read its token: synced
        self._prefills.pop(0)
        self.stats.incr("prefill_chunks")
        self.stats.incr("prefill_tokens", remaining)
        self.stats.observe("prefill_chunk_s", self._now - t0)
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
        toks, n_emit = self._generator.spec_paged_step(self._cache, self._state, self._live.copy(),
                                                       tables, drafts, n_draft)
        self._tick_done(t0)  # the step read its tokens back: synced
        self.stats.gauge_max("peak_blocks_in_use", self._allocator.used_count)
        self._emit_spec(toks, n_emit, n_draft)

    # ------------------------------------------------------ overload control

    def _fail_inflight(self, err: ServingError) -> None:
        self._prefills.clear()  # their requests resolve through _slot_req
        super()._fail_inflight(err)

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
            keys = self._prefix.block_keys(ctx)
            self._prefix.insert(keys[:full], self._slot_blocks[slot][:full])
        super()._preempt_slot(slot)

    def _release(self, slot: int) -> None:
        for bid in self._slot_blocks[slot]:
            self._allocator.free(bid)
        self._slot_blocks[slot] = []
        self._slot_plen[slot] = 0
        self._table[slot, :] = NULL_BLOCK
        super()._release(slot)
