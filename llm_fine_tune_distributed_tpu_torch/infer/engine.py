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
state; admission is strict FIFO; a request whose waiter gave up
(``Request.abandoned``) is shed, queued or mid-decode; counters, gauges and
latency histograms go to one ``ServingStats`` (``stats_snapshot``). Greedy
tokens equal a solo ``Generator.generate_ids`` of the same prompt, and
sampled ones depend only on (request, seed).

With ``speculative_k = K > 0`` every tick is the fused draft-verify step
(``Generator.spec_slot_step`` / ``spec_paged_step``): each live slot whose
request asks for speculation proposes up to K drafts (prompt lookup over
its own context, ``_prompt_lookup``, or the Generator's draft model), one
forward verifies all slots' K+1 positions, and each slot emits its accepted
run plus one token of the model's own. Slots without drafts take the plain
step inside the same tick. Per-request draft counts and the engine's
``draft_tokens_proposed`` / ``draft_tokens_accepted`` record it.

Not ported from the JAX engines: the host KV tier, preemption and
priorities, deadlines, brownout, supervision and restarts, hot-swap,
adapters, fleets and overload control.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from llm_fine_tune_distributed_tpu_torch.infer.batching import Request
from llm_fine_tune_distributed_tpu_torch.infer.paged import NULL_BLOCK, BlockAllocator, PrefixCache
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.observe.metrics import ServingStats

log = logging.getLogger(__name__)

__all__ = ["ContinuousBatchingEngine", "PagedContinuousBatchingEngine", "Request"]


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
    """``slots``-row persistent decode over a dense KV cache, FIFO admission."""

    def __init__(self, generator, slots: int = 8, buf_len: int = 4096, prompt_bucket: int = 64,
                 stats: Optional[ServingStats] = None, speculative_k: int = 0):
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
        self._slot_req: List[Optional[Request]] = [None] * self._slots
        self._slot_tokens: List[List[int]] = [[] for _ in range(self._slots)]
        self._slot_budget = [0] * self._slots
        self._live = np.zeros((self._slots,), bool)
        self._q: "queue.Queue[Optional[Request]]" = queue.Queue()
        self._waiting: List[Request] = []
        self._req_seq = itertools.count(1)
        self._now = time.monotonic()  # the tick clock every emit of a tick reuses
        self._error: Optional[BaseException] = None
        self._cache, self._state = self._init_state()
        # the draft model's dense per-slot cache (worker thread only)
        self._dcache = (generator.init_draft_slot_cache(self._slots, self._buf_len)
                        if self._use_draft else None)
        self._worker = threading.Thread(target=self._run, name=type(self).__name__, daemon=True)
        self._worker.start()

    def _init_state(self):
        return self._generator.init_slot_state(self._slots, self._buf_len)

    # ---------------------------------------------------------------- public

    def submit(self, prompt_ids: Sequence[int], gen: GenerationConfig, seed: int = 0,
               timeout: Optional[float] = None) -> List[int]:
        """Blocking: enqueue one request, wait for its generated token ids."""
        return self.submit_full(prompt_ids, gen, seed, timeout).result

    def submit_full(self, prompt_ids: Sequence[int], gen: GenerationConfig, seed: int = 0,
                    timeout: Optional[float] = None) -> Request:
        """``submit`` returning the whole request record (the window
        batcher's call shape). On ``timeout`` the request is abandoned (the
        worker sheds it) and TimeoutError raised."""
        req = self._make_request(prompt_ids, gen, seed)
        self._q.put(req)
        if not req.done.wait(timeout):
            req.abandoned = True
            raise TimeoutError(f"request not served within {timeout}s "
                               f"(queue depth {self.queue_depth})")
        if req.error is not None:
            raise req.error
        return req

    def stream(self, prompt_ids: Sequence[int], gen: GenerationConfig, seed: int = 0,
               timeout: Optional[float] = None) -> _TokenStream:
        """Enqueue one request and return an iterator over its tokens as the
        slot decodes them, while it shares the batch with everything else in
        flight. ``timeout`` bounds the wait for each next token. The request
        is checked here, before the caller commits to a response."""
        req = self._make_request(prompt_ids, gen, seed, tokens_q=queue.Queue())
        self._q.put(req)
        return _TokenStream(req, timeout, self)

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop the worker once the requests already submitted are served."""
        self._q.put(None)
        self._worker.join(timeout)

    def stats_snapshot(self) -> dict:
        """``ServingStats.snapshot()`` with fresh ``queue_depth`` and
        ``live_slots`` gauges (``GET /v1/stats``)."""
        self.stats.gauge("queue_depth", self.queue_depth)
        self.stats.gauge("live_slots", self.live_slots)
        return self.stats.snapshot()

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

    def _make_request(self, prompt_ids, gen: GenerationConfig, seed: int,
                      tokens_q: Optional["queue.Queue"] = None) -> Request:
        if self._error is not None or not self._worker.is_alive():
            raise RuntimeError(f"engine stopped: {self._error!r}")
        req = Request([int(t) for t in prompt_ids], gen, int(seed), tokens_q=tokens_q)
        req.id = next(self._req_seq)
        req.enqueued_at = time.monotonic()
        return req

    # ------------------------------------------------------------ resolution

    def _settle(self, req: Request) -> None:
        """The one place a request wakes its waiter. Every token it emitted
        is charged once, here: to goodput when it completed, else to the
        reason it ended."""
        n = req.tokens_emitted
        if n:
            if req.abandoned:
                self.stats.waste_incr("abandoned", n)
            elif req.error is None:
                self.stats.incr("goodput_tokens", n)
            else:  # the worker failed under it
                self.stats.waste_incr("failover", n)
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

    # ---------------------------------------------------------------- worker

    def _run(self) -> None:
        try:
            self._serve_loop()
            return
        except Exception as e:  # worker boundary: fail every request, then stop
            log.exception("%s worker failed", type(self).__name__)
            self._error = e
        err = RuntimeError(f"engine failed: {self._error!r}")
        for req in [r for r in self._slot_req if r is not None] + self._waiting:
            self._resolve_error(req, err)
        while True:  # and every request that raced the failure, until close()
            req = self._q.get()
            if req is None:
                return
            self._resolve_error(req, err)

    def _serve_loop(self) -> None:
        closing = False
        while True:
            closing |= self._drain_queue(block=False)
            self._admit()
            if not self._tick() and not self._waiting:
                if closing:
                    return
                closing = self._drain_queue(block=True)  # idle: wait for traffic

    def _tick(self) -> bool:
        """One scheduler tick's device work; False when there was none."""
        if not self._live.any():
            return False
        if self._spec_k:
            self._decode_once_spec()
        else:
            self._decode_once()
        return True

    def _drain_queue(self, block: bool) -> bool:
        """Move queued requests to the waiting list; True once ``close``
        was called (the work already queued is still served)."""
        closing = False
        while True:
            try:
                req = self._q.get(block=block)
            except queue.Empty:
                return closing
            if req is None:
                closing = True
            else:
                self._waiting.append(req)
            block = False

    def _admit(self) -> None:
        """Admit in arrival order while a slot is free (and the request's
        ``_plan`` can be met); shed abandoned waiters on the way."""
        while self._waiting:
            req = self._waiting[0]
            if req.abandoned:
                self._waiting.pop(0)
                self._settle_abandoned(req)
                continue
            free = [s for s in range(self._slots) if self._slot_req[s] is None]
            if not free:
                return
            try:
                plan = self._plan(req)
            except (ValueError, RuntimeError) as e:  # cannot fit: reject this request only
                self._waiting.pop(0)
                self._resolve_error(req, e)
                continue
            if plan is None:
                return  # room frees as slots retire; the head waits
            self._waiting.pop(0)
            self._insert(req, free[0], plan)

    def _plan(self, req: Request) -> Optional[dict]:
        """Check that the prompt fits: the prefill bucket and the token
        budget. The budget stops decode before the buffer's end, so
        slot == position holds for every token the slot emits."""
        plen = len(req.prompt)
        if plen == 0:
            raise ValueError("the continuous engine needs a non-empty prompt")
        if plen >= self._buf_len:
            raise ValueError(
                f"prompt of {plen} tokens does not fit the engine's "
                f"{self._buf_len}-slot KV buffer (need >= 1 decode slot)"
            )
        return {"plen": plen,
                "bucket": min(-(-plen // self._bucket) * self._bucket, self._buf_len),
                "budget": min(req.gen.max_new_tokens, self._buf_len - plen)}

    def _insert(self, req: Request, slot: int, plan: dict) -> None:
        """Prefill the prompt into ``slot`` and emit its first token."""
        t0 = time.monotonic()
        if req.enqueued_at:
            self.stats.observe("queue_wait_s", t0 - req.enqueued_at)
        plen = plan["plen"]
        padded = np.zeros((1, plan["bucket"]), np.int64)
        padded[0, :plen] = req.prompt
        first = self._generator.slot_prefill(self._cache, self._state, padded, plen, slot,
                                             req.gen, req.seed)
        self._now = time.monotonic()  # slot_prefill read its token: synced
        self.stats.observe("prefill_chunk_s", self._now - t0)
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
        """After a decode step: stamp the tick clock, observe the tick."""
        self._now = time.monotonic()
        self.stats.observe("decode_tick_s", self._now - t0)
        self.stats.incr("decode_steps")

    def _decode_once(self) -> None:
        t0 = time.monotonic()
        toks = self._generator.slot_step(self._cache, self._state, self._live.copy())
        self._tick_done(t0)  # slot_step returns tokens on the host: synced
        self._emit_tokens(toks)

    # ------------------------------------------------------------ speculative

    def _slot_ctx(self, slot: int) -> np.ndarray:
        """The slot's tokens, prompt and generated; its length - 1 is the
        slot's position on the device."""
        return np.asarray(self._slot_req[slot].prompt + self._slot_tokens[slot], np.int64)

    def _spec_want(self, slot: int) -> int:
        """The drafts this slot asks for this tick: its request's K capped by
        the engine's; 0 for dead slots and requests that do not speculate."""
        req = self._slot_req[slot]
        if req is None or not self._live[slot]:
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
        for slot in range(self._slots):
            req = self._slot_req[slot]
            if req is None or not self._live[slot]:
                continue
            if req.abandoned:
                self._settle_abandoned(req)
                self._release(slot)
                continue
            proposed, m = int(n_draft[slot]), int(n_emit[slot])
            if proposed:
                accepted = max(m - 1, 0)
                req.draft_tokens_proposed += proposed
                req.draft_tokens_accepted += accepted
                self.stats.incr("draft_tokens_proposed", proposed)
                self.stats.incr("draft_tokens_accepted", accepted)
                self.stats.observe("spec_run_len", accepted)
            for j in range(m):
                self._emit_token(slot, req, int(toks[slot, j]))
                if self._slot_req[slot] is not req:
                    break  # EOS or the budget finished the request mid-run

    def _emit_tokens(self, toks: np.ndarray) -> None:
        """Hand each live slot its token of this tick; shed the slots whose
        waiter is gone."""
        for slot in range(self._slots):
            req = self._slot_req[slot]
            if req is None or not self._live[slot]:
                continue  # free, or admitted but still prefilling
            if req.abandoned:
                self._settle_abandoned(req)
                self._release(slot)
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
        req.result = list(self._slot_tokens[slot])
        if req.draft_tokens_proposed:
            req.spec_acceptance = req.draft_tokens_accepted / req.draft_tokens_proposed
        elif self._spec_k > 0 and req.gen.speculative_lookup > 0:
            req.spec_acceptance = 0.0  # asked to speculate, nothing was drafted
        if req.tokens_q is not None:
            req.tokens_q.put(None)
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

    __slots__ = ("req", "slot", "keys", "plen", "next")

    def __init__(self, req: Request, slot: int, keys, plen: int, next_: int):
        self.req = req
        self.slot = slot
        self.keys = keys  # full-block prefix keys (PrefixCache.block_keys)
        self.plen = plen
        self.next = next_  # first logical position not yet prefilled


class PagedContinuousBatchingEngine(ContinuousBatchingEngine):
    """The continuous engine over a block-paged KV pool. A request that
    cannot get blocks yet waits at the head of the queue until a retirement
    frees some. Dead rows decode with all-null tables, so their writes land
    in the null block. ``kv_quant="int8"`` stores the pool as int8 codes with
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
    ):
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
        self._allocator = BlockAllocator(self._num_blocks)
        self._prefix = PrefixCache(self._allocator, self._block_len)
        self._table = np.zeros((slots, self._table_blocks), np.int32)
        self._slot_blocks: List[List[int]] = [[] for _ in range(slots)]
        self._slot_plen = [0] * slots
        self._prefills: List[_PrefillTask] = []
        self._prefix_hits = 0  # admissions that mapped >= 1 cached block
        # the base starts the worker last: every paged field exists by then
        super().__init__(generator, slots=slots, buf_len=buf_len, prompt_bucket=prompt_bucket,
                         stats=stats or ServingStats(slots, total_blocks=self._num_blocks - 1),
                         speculative_k=speculative_k)

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
        touch (prefill pads included, all or nothing). None: wait."""
        prompt = req.prompt
        plen = len(prompt)
        if plen == 0:
            raise ValueError("the paged engine needs a non-empty prompt")
        if plen >= self._buf_len:
            raise ValueError(
                f"prompt of {plen} tokens does not fit the engine's "
                f"{self._buf_len}-position budget (need >= 1 decode position)"
            )
        L = self._block_len
        budget_end = min(plen + max(1, int(req.gen.max_new_tokens)), self._buf_len)
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
        return {"keys": keys, "shared": shared, "private": private, "plen": plen,
                "budget": budget_end - plen}

    def _insert(self, req: Request, slot: int, plan: dict) -> None:
        """Map the reserved blocks into the slot's table and queue the
        prefill; the slot goes live when its final chunk lands."""
        if req.enqueued_at:
            self.stats.observe("queue_wait_s", time.monotonic() - req.enqueued_at)
        ids = plan["shared"] + plan["private"]
        self._table[slot, : len(ids)] = ids
        self._table[slot, len(ids):] = NULL_BLOCK
        self._slot_blocks[slot] = ids
        self._slot_plen[slot] = plan["plen"]
        self._slot_req[slot] = req
        self._slot_tokens[slot] = []
        self._slot_budget[slot] = plan["budget"]
        shared_len = len(plan["shared"]) * self._block_len
        self.stats.incr("requests_admitted")
        self.stats.incr("prompt_tokens", plan["plen"])
        self.stats.incr("prefix_tokens_reused", shared_len)
        if shared_len:
            self._prefix_hits += 1
        self._prefills.append(_PrefillTask(req, slot, plan["keys"], plan["plen"], shared_len))

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
        t0 = time.monotonic()
        C = self._prefill_chunk
        remaining = task.plen - task.next
        table = self._table[task.slot: task.slot + 1]
        if remaining > C:
            chunk = np.asarray(req.prompt[task.next: task.next + C], np.int64)[None, :]
            gen.paged_prefill_chunk(self._cache, table, chunk, task.next)
            task.next += C
            self.stats.incr("prefill_chunks")
            self.stats.incr("prefill_tokens", C)
            self.stats.observe("prefill_chunk_s", time.monotonic() - t0)
            return
        # The final chunk is padded to the prompt bucket with token id 0, and
        # the pads are written into the pool like real tokens. In the int8
        # pool their K/V raise the block's absmax, which changes the codes of
        # the real tokens beside them: skipping them would break parity with
        # the JAX engine.
        bucket = -(-remaining // self._bucket) * self._bucket
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :remaining] = req.prompt[task.next:]
        seen_row = np.zeros((1, gen.config.vocab_size), bool)
        seen_row[0, np.asarray(req.prompt, np.intp)] = True
        first = gen.paged_prefill_final(
            self._cache, self._state, table, padded, task.next, task.plen,
            seen_row, task.slot, req.gen, req.seed,
        )
        self._now = time.monotonic()  # paged_prefill_final read its token: synced
        self._prefills.pop(0)
        self.stats.incr("prefill_chunks")
        self.stats.incr("prefill_tokens", remaining)
        self.stats.observe("prefill_chunk_s", self._now - t0)
        if self._use_draft and req.gen.speculative_lookup > 0:
            # the draft keeps a dense row even here: mirror the whole prompt
            dbucket = min(-(-task.plen // self._bucket) * self._bucket, self._buf_len)
            dpad = np.zeros((1, dbucket), np.int64)
            dpad[0, : task.plen] = req.prompt
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
        toks = self._generator.paged_step(self._cache, self._state, self._live.copy(), tables)
        self._tick_done(t0)  # paged_step returns tokens on the host: synced
        self.stats.gauge_max("peak_blocks_in_use", self._allocator.used_count)
        self._emit_tokens(toks)

    def _decode_tick_spec(self) -> None:
        """The fused draft-verify tick through the block tables, whose view
        covers K positions past each live slot's position."""
        tables = self._decode_tables(self._decode_bucket(self._spec_k))
        t0 = time.monotonic()
        drafts, n_draft = self._propose_drafts()
        toks, n_emit = self._generator.spec_paged_step(self._cache, self._state, self._live.copy(),
                                                       tables, drafts, n_draft)
        self._tick_done(t0)  # the step read its tokens back: synced
        self.stats.gauge_max("peak_blocks_in_use", self._allocator.used_count)
        self._emit_spec(toks, n_emit, n_draft)

    def _release(self, slot: int) -> None:
        for bid in self._slot_blocks[slot]:
            self._allocator.free(bid)
        self._slot_blocks[slot] = []
        self._slot_plen[slot] = 0
        self._table[slot, :] = NULL_BLOCK
        super()._release(slot)
