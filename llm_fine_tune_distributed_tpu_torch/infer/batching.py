"""The serving engines' shared request record, and the window batcher
(counterpart of the JAX ``infer/batching.py``).

Batch-1 decode reads every weight once per token; a batch of B concurrent
requests reads them once per token for all B. ``BatchingEngine`` gives the
HTTP server that without an async framework:

- handlers run on threads and block on ``submit``;
- one worker thread owns the Generator: it takes the oldest request, drains
  compatible ones for a short window, pads the group to a power-of-two size,
  runs ``generate_batch`` and resolves each request;
- only greedy requests with equal ``GenerationConfig`` co-batch (the seed
  does not matter without sampling). A sampled request runs as its own
  batch, so its tokens depend on (request, seed) alone, not on who arrived
  with it;
- incompatible requests drained during a window wait on a deferred list
  that is served before the queue, so mixed traffic keeps FIFO order;
- a request whose waiter timed out is shed before it reaches the device.

Under a multi-process ``--tp`` mesh rank 0's engine runs over
``infer/multihost.MultihostCoordinator`` in place of the Generator: each
``generate_batch`` is broadcast to the follower ranks (``follow``) before it
runs, and the server's ``/healthz`` reads the coordinator's ``wedged``.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from llm_fine_tune_distributed_tpu_torch.infer.errors import DrainingError
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig

# priority tiers of the continuous engines' overload control: index = tier
# number, lower is more important. Admission orders by (aged tier, arrival);
# under pressure the highest-numbered tier sheds and is preempted first.
PRIORITY_TIERS = ("interactive", "batch", "best_effort")


@dataclass
class Request:
    """One submitted request, shared by the window batcher and the
    continuous engines (``infer/engine.py``), so that submit, timeout and
    abandonment mean the same in all of them."""

    prompt: List[int]
    gen: GenerationConfig
    seed: int
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[List[int]] = None
    error: Optional[BaseException] = None
    # set when the waiter gave up (timeout, client gone): the worker drops
    # the request instead of decoding for nobody
    abandoned: bool = False
    # continuous engines only: every emitted token is also put here, then
    # None at the end (``stream``)
    tokens_q: Optional["queue.Queue"] = None
    # continuous engines only: when the request was queued (monotonic), its
    # engine-assigned id, the times of its first and last tokens (TTFT and
    # inter-token histograms) and how many tokens it caused the device to
    # emit (goodput or waste at settle)
    enqueued_at: float = 0.0
    id: int = 0
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None
    tokens_emitted: int = 0
    # speculation, per request: its own drafts proposed and accepted, and
    # their ratio (None unless it asked to speculate); ``spec_steps`` is the
    # window engine's batch-wide count of sequential forwards (None on the
    # continuous engines)
    spec_acceptance: Optional[float] = None
    spec_steps: Optional[int] = None
    draft_tokens_proposed: int = 0
    draft_tokens_accepted: int = 0
    # overload control (continuous engines only): the monotonic time past
    # which a still-queued request is shed before prefill (the engine's
    # queue deadline), its priority tier by name and number (an index into
    # PRIORITY_TIERS), and the client's deadline (monotonic) past which it
    # is cancelled wherever it is
    queue_deadline: Optional[float] = None
    priority: str = "interactive"
    tier: int = 0
    deadline: Optional[float] = None
    # preemption: the tokens emitted before its slot was reclaimed (the
    # resume prefills prompt + these, and they lead the result), and how
    # many times it was preempted
    preempted_tokens: List[int] = field(default_factory=list)
    preemptions: int = 0
    # set at an admission that aging won over waiters of a better raw tier:
    # those waiters may not preempt it back (the slot stays its own until
    # it finishes or is preempted for another reason)
    promoted: bool = False
    # set by a submit thread that displaced this queued lower-tier request
    # from a full queue; the worker resolves it with a tier-labelled 429
    shed_by_pressure: bool = False
    # continuous engines only: the lifecycle trace (observe/tracing
    # RequestTrace: received, queued, admitted, prefill, first_token, ...)
    trace: Optional[object] = None
    # disaggregated serving: set once a prefill replica's handoff of this
    # request failed, so that it decodes where it is and is not handed off
    # again at its re-admission
    handoff_failed: bool = False
    # multi-tenant LoRA (continuous engines only): the tenant's adapter name
    # and its slot in the engine's adapter pool (0: the base model)
    adapter: Optional[str] = None
    adapter_idx: int = 0
    # live deployment (continuous engines only): the weight generation the
    # request settled under, stamped at its settle
    weight_generation: int = 0


def _pad_batch_size(n: int, max_batch: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return min(p, max_batch)


class BatchingEngine:
    """Groups concurrent generate requests into device batches."""

    def __init__(self, generator, max_batch: int = 8, window_ms: float = 10.0):
        self._generator = generator
        self._max_batch = max(1, int(max_batch))
        self._window_s = window_ms / 1000.0
        self._q: "queue.Queue[Request]" = queue.Queue()
        # incompatible requests parked between cycles (worker thread only)
        self._deferred: List[Request] = []
        self._draining = False
        self._closing = False  # close() was called (worker thread only)
        self._pending = 0
        self._plock = threading.Lock()
        self._worker = threading.Thread(target=self._run, name="window-engine", daemon=True)
        self._worker.start()

    # ---------------------------------------------------------------- public

    def submit(self, prompt_ids: Sequence[int], gen: GenerationConfig, seed: int = 0,
               timeout: Optional[float] = None) -> List[int]:
        """Blocking: enqueue one request, wait for its batch. On
        ``timeout`` (seconds) the request is abandoned and TimeoutError
        raised."""
        return self.submit_full(prompt_ids, gen, seed, timeout).result

    def submit_full(self, prompt_ids: Sequence[int], gen: GenerationConfig, seed: int = 0,
                    timeout: Optional[float] = None) -> Request:
        """``submit`` returning the whole request record."""
        if self._draining:
            raise DrainingError("engine draining; admission closed — retry against another "
                                "replica", retry_after_s=5.0)
        p = Request([int(t) for t in prompt_ids], gen, int(seed))
        with self._plock:
            self._pending += 1
        self._q.put(p)
        if not p.done.wait(timeout):
            p.abandoned = True
            raise TimeoutError(f"generate request not served within {timeout}s "
                               f"(queue depth {self._q.qsize()})")
        if p.error is not None:
            raise p.error
        return p

    @property
    def queue_depth(self) -> int:
        return self._q.qsize()

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop the worker once the requests already submitted are served."""
        self._q.put(None)
        self._worker.join(timeout)

    def begin_drain(self) -> None:
        """Close admission; queued and running batches finish."""
        self._draining = True

    def wait_drained(self, timeout_s: float, poll_s: float = 0.05) -> bool:
        """Block until every submitted request has resolved (True) or the
        timeout expires with work pending (False)."""
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        while True:
            with self._plock:
                pending = self._pending
            if pending <= 0:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)

    def _settle(self, p: Request) -> None:
        """The one place a request leaves the pending count and wakes its
        waiter."""
        with self._plock:
            self._pending -= 1
        p.done.set()

    # ---------------------------------------------------------------- worker

    def _compatible(self, a: Request, b: Request) -> bool:
        return a.gen == b.gen and not a.gen.do_sample

    def _next_live(self) -> Optional[Request]:
        """The request that seeds the next group: deferred requests are
        older than anything queued. Abandoned ones are dropped. None once
        ``close`` was called and nothing is left."""
        while True:
            if self._deferred:
                p = self._deferred.pop(0)
            elif self._closing:
                try:
                    p = self._q.get_nowait()
                except queue.Empty:
                    return None
            else:
                p = self._q.get()
            if p is None:
                self._closing = True
            elif not p.abandoned:
                return p
            else:
                self._settle(p)

    def _run(self) -> None:
        while True:
            first = self._next_live()
            if first is None:
                return
            batch = [first]
            still_deferred: List[Request] = []
            for p in self._deferred:
                if p.abandoned:
                    self._settle(p)
                elif len(batch) < self._max_batch and self._compatible(first, p):
                    batch.append(p)
                else:
                    still_deferred.append(p)
            self._deferred = still_deferred
            deadline = time.monotonic() + self._window_s
            while len(batch) < self._max_batch and not first.gen.do_sample:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._closing = True
                    break
                if nxt.abandoned:
                    self._settle(nxt)
                elif self._compatible(first, nxt):
                    batch.append(nxt)
                else:
                    self._deferred.append(nxt)
            # a request that timed out while its group formed is shed too;
            # one that gives up after this point decodes with its batch
            for p in batch:
                if p.abandoned:
                    self._settle(p)
            batch = [p for p in batch if not p.abandoned]
            if not batch:
                continue
            prompts = [p.prompt for p in batch]
            # pad by repeating the first prompt to a power of two, as the
            # JAX batcher pads to bound its compiled batch sizes
            n_live = len(prompts)
            prompts += [prompts[0]] * (_pad_batch_size(n_live, self._max_batch) - n_live)
            try:
                gen = self._generator
                results = gen.generate_batch(prompts, first.gen, seed=first.seed,
                                             live_rows=n_live)
                # live request i rode row i (the pads come after): each gets
                # its own row's draft counts
                row_prop = getattr(gen, "last_row_draft_proposed", None)
                row_acc = getattr(gen, "last_row_draft_accepted", None)
                for i, (p, r) in enumerate(zip(batch, results)):
                    p.result = r
                    p.spec_steps = getattr(gen, "last_spec_steps", None)
                    if row_prop is not None:
                        p.draft_tokens_proposed = int(row_prop[i])
                        p.draft_tokens_accepted = int(row_acc[i])
                        p.spec_acceptance = (p.draft_tokens_accepted / p.draft_tokens_proposed
                                             if p.draft_tokens_proposed else 0.0)
            except Exception as e:  # worker boundary: fail this batch, keep serving
                for p in batch:
                    p.error = e
            finally:
                for p in batch:
                    self._settle(p)
