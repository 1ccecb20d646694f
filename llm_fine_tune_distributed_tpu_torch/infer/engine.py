"""Continuous batching over a block-paged KV pool (counterpart of the core of
the JAX ``infer/engine.PagedContinuousBatchingEngine``).

KV lives in one global pool of ``block_len``-token blocks addressed through
per-slot block tables, so

- a decode step attends over ``nb * block_len`` positions, where ``nb`` is
  the power-of-two bucket over the widest live slot's blocks in use;
- admission maps blocks instead of copying rows: a prompt's leading FULL
  blocks are looked up in a refcounted prefix cache and shared
  copy-on-write, and prefill resumes at the divergence point;
- prompts prefill in ``prefill_chunk``-token chunks interleaved with decode
  steps (one chunk and one decode step per scheduler tick).

One worker thread owns the pool, the tables and the slot state. Admission is
strict FIFO: a request that cannot get blocks yet waits at the head of the
queue until a retirement frees some. Dead rows decode with all-null tables,
so their writes land in the null block.

Not ported from the JAX engine: speculation, the host KV tier, preemption
and priorities, deadlines, supervision and restarts, hot-swap, adapters,
fleets and overload control.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from llm_fine_tune_distributed_tpu_torch.infer.paged import NULL_BLOCK, BlockAllocator, PrefixCache
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig

log = logging.getLogger(__name__)


class Request:
    """One submitted request and its result."""

    def __init__(self, prompt: Sequence[int], gen: GenerationConfig, seed: int):
        self.prompt = list(int(t) for t in prompt)
        self.gen = gen
        self.seed = int(seed)
        self.done = threading.Event()
        self.result: Optional[List[int]] = None
        self.error: Optional[BaseException] = None
        self.enqueued_at = time.monotonic()
        self.first_token_t: Optional[float] = None


class _PrefillTask:
    """One admitted request's remaining prefill work."""

    __slots__ = ("req", "slot", "keys", "plen", "next")

    def __init__(self, req: Request, slot: int, keys, plen: int, next_: int):
        self.req = req
        self.slot = slot
        self.keys = keys  # full-block prefix keys (PrefixCache.block_keys)
        self.plen = plen
        self.next = next_  # first logical position not yet prefilled


class PagedContinuousBatchingEngine:
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
    ):
        self._generator = generator
        self._slots = max(1, int(slots))
        self._buf_len = int(buf_len)
        self._bucket = max(1, int(prompt_bucket))
        self._block_len = max(1, int(block_len))
        self._prefill_chunk = max(1, int(prefill_chunk))
        # table width: buf_len plus the final prefill chunk's pad bucket
        self._table_blocks = -(-(self._buf_len + self._bucket) // self._block_len)
        if num_blocks is None:
            # full tables for every slot, one table of prefix-cache headroom,
            # and the null block
            num_blocks = 1 + (self._slots + 1) * self._table_blocks
        self._num_blocks = int(num_blocks)
        self._allocator = BlockAllocator(self._num_blocks)
        self._prefix = PrefixCache(self._allocator, self._block_len)
        self._table = np.zeros((self._slots, self._table_blocks), np.int32)
        self._slot_blocks: List[List[int]] = [[] for _ in range(self._slots)]
        self._slot_plen = [0] * self._slots
        self._slot_req: List[Optional[Request]] = [None] * self._slots
        self._slot_tokens: List[List[int]] = [[] for _ in range(self._slots)]
        self._slot_budget = [0] * self._slots
        self._live = np.zeros((self._slots,), bool)
        self._eos = set(generator.eos_token_ids)
        self._pool, self._state = generator.init_paged_state(
            self._slots, self._num_blocks, self._block_len, kv_quant=kv_quant
        )
        self._q: "queue.Queue[Optional[Request]]" = queue.Queue()
        self._waiting: List[Request] = []
        self._prefills: List[_PrefillTask] = []
        self._stats_lock = threading.Lock()
        self._stats = {
            "requests_admitted": 0,
            "requests_completed": 0,
            "prompt_tokens": 0,
            "prefix_hits": 0,
            "prefix_tokens_reused": 0,
            "prefill_chunks": 0,
            "prefill_tokens": 0,
            "decode_steps": 0,
            "decode_tokens": 0,
            "decode_s": 0.0,
            "tokens_served": 0,
            "ttft_s": [],
        }
        self._error: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, name="paged-engine", daemon=True)
        self._worker.start()

    # ---------------------------------------------------------------- public

    def submit(self, prompt_ids: Sequence[int], gen: GenerationConfig, seed: int = 0,
               timeout: Optional[float] = None) -> List[int]:
        """Blocking: enqueue one request, wait for its generated token ids."""
        if gen.speculative_lookup:
            raise NotImplementedError(
                "speculative decoding is not ported "
                "(llm_fine_tune_distributed_tpu.infer.engine has it)"
            )
        if self._error is not None or not self._worker.is_alive():
            raise RuntimeError(f"engine stopped: {self._error!r}")
        req = Request(prompt_ids, gen, seed)
        self._q.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError(f"request not served within {timeout}s")
        if req.error is not None:
            raise req.error
        return req.result

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop the worker once the requests already submitted are served."""
        self._q.put(None)
        self._worker.join(timeout)

    def stats_snapshot(self) -> dict:
        with self._stats_lock:
            snap = {k: (list(v) if isinstance(v, list) else v) for k, v in self._stats.items()}
        snap["blocks_in_use"] = self._allocator.used_count
        snap["prefix_cache_blocks"] = len(self._prefix)
        snap["live_slots"] = int(self._live.sum())
        return snap

    @property
    def pool(self) -> dict:
        return self._pool

    # ---------------------------------------------------------------- worker

    def _incr(self, key: str, n=1) -> None:
        with self._stats_lock:
            self._stats[key] += n

    def _run(self) -> None:
        try:
            self._serve_loop()
        except Exception as e:  # worker boundary: fail every request, then stop
            log.exception("paged engine worker failed")
            self._error = e
            pending = [r for r in self._slot_req if r is not None] + self._waiting
            while True:
                try:
                    req = self._q.get_nowait()
                except queue.Empty:
                    break
                if req is not None:
                    pending.append(req)
            for req in pending:
                if not req.done.is_set():
                    req.error = RuntimeError(f"engine failed: {e!r}")
                    req.done.set()

    def _serve_loop(self) -> None:
        closing = False
        while True:
            closing |= self._drain_queue(block=False)
            self._admit()
            busy = False
            if self._prefills:
                self._prefill_tick()
                busy = True
            if self._live.any():
                self._decode_tick()
                busy = True
            if not busy and not self._waiting:
                if closing:
                    return
                closing = self._drain_queue(block=True)  # idle: wait for traffic

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
        """Admit in arrival order while a slot AND blocks are available."""
        while self._waiting:
            req = self._waiting[0]
            free = [s for s in range(self._slots) if self._slot_req[s] is None]
            if not free:
                return
            try:
                plan = self._plan(req)
            except (ValueError, RuntimeError) as e:  # cannot fit: reject this request only
                self._waiting.pop(0)
                req.error = e
                req.done.set()
                continue
            if plan is None:
                return  # blocks free as slots retire; the head waits
            self._waiting.pop(0)
            self._insert_paged(req, free[0], plan)

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
        total = -(-max(budget_end, write_end) // L)
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

    def _insert_paged(self, req: Request, slot: int, plan: dict) -> None:
        """Map the reserved blocks into the slot's table and queue the
        prefill; the slot goes live when its final chunk lands."""
        ids = plan["shared"] + plan["private"]
        self._table[slot, : len(ids)] = ids
        self._table[slot, len(ids):] = NULL_BLOCK
        self._slot_blocks[slot] = ids
        self._slot_plen[slot] = plan["plen"]
        self._slot_req[slot] = req
        self._slot_tokens[slot] = []
        self._slot_budget[slot] = plan["budget"]
        shared_len = len(plan["shared"]) * self._block_len
        self._incr("requests_admitted")
        self._incr("prompt_tokens", plan["plen"])
        if shared_len:
            self._incr("prefix_hits")
            self._incr("prefix_tokens_reused", shared_len)
        self._prefills.append(_PrefillTask(req, slot, plan["keys"], plan["plen"], shared_len))

    def _prefill_tick(self) -> None:
        """Run ONE prefill chunk of the oldest pending prompt."""
        gen = self._generator
        task = self._prefills[0]
        req = task.req
        C = self._prefill_chunk
        remaining = task.plen - task.next
        table = self._table[task.slot: task.slot + 1]
        if remaining > C:
            chunk = np.asarray(req.prompt[task.next: task.next + C], np.int64)[None, :]
            gen.paged_prefill_chunk(self._pool, table, chunk, task.next)
            task.next += C
            self._incr("prefill_chunks")
            self._incr("prefill_tokens", C)
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
            self._pool, self._state, table, padded, task.next, task.plen,
            seen_row, task.slot, req.gen, req.seed,
        )
        self._prefills.pop(0)
        self._incr("prefill_chunks")
        self._incr("prefill_tokens", remaining)
        # register the prompt's FULL blocks for reuse before emitting (the
        # first token may already finish the request and free the slot)
        full = task.plen // self._block_len
        self._prefix.insert(task.keys[:full], self._slot_blocks[task.slot][:full])
        self._live[task.slot] = True
        self._emit_token(task.slot, req, first, from_decode=False)

    def _decode_bucket(self) -> int:
        """Power-of-two block count covering every live slot's blocks in use."""
        L = self._block_len
        in_use = 1
        for slot in range(self._slots):
            if self._live[slot]:
                pos = self._slot_plen[slot] + len(self._slot_tokens[slot]) - 1
                in_use = max(in_use, pos // L + 1)
        nb = 1
        while nb < in_use:
            nb *= 2
        return min(nb, self._table_blocks)

    def _decode_tables(self, nb: int) -> np.ndarray:
        # dead rows decode with all-null tables: their frozen-position
        # writes land in the null block, never in a reassigned block
        return np.ascontiguousarray(np.where(self._live[:, None], self._table, NULL_BLOCK)[:, :nb])

    def _decode_tick(self) -> None:
        nb = self._decode_bucket()
        tables = self._decode_tables(nb)
        t0 = time.monotonic()
        toks = self._generator.paged_step(self._pool, self._state, self._live.copy(), tables)
        dt = time.monotonic() - t0  # paged_step returns tokens on the host: synced
        with self._stats_lock:
            self._stats["decode_steps"] += 1
            self._stats["decode_s"] += dt
        for slot in range(self._slots):
            req = self._slot_req[slot]
            if req is None or not self._live[slot]:
                continue  # free, or admitted but still prefilling
            self._emit_token(slot, req, int(toks[slot]))

    def _emit_token(self, slot: int, req: Request, tok: int, from_decode: bool = True) -> None:
        if tok in self._eos:
            self._finish(slot, req)
            return
        self._slot_tokens[slot].append(tok)
        self._incr("tokens_served")
        if from_decode:
            self._incr("decode_tokens")
        if req.first_token_t is None:
            req.first_token_t = time.monotonic()
            with self._stats_lock:
                self._stats["ttft_s"].append(req.first_token_t - req.enqueued_at)
        if len(self._slot_tokens[slot]) >= self._slot_budget[slot]:
            self._finish(slot, req)

    def _finish(self, slot: int, req: Request) -> None:
        req.result = list(self._slot_tokens[slot])
        self._incr("requests_completed")
        req.done.set()
        self._release(slot)

    def _release(self, slot: int) -> None:
        for bid in self._slot_blocks[slot]:
            self._allocator.free(bid)
        self._slot_blocks[slot] = []
        self._slot_plen[slot] = 0
        self._table[slot, :] = NULL_BLOCK
        self._slot_req[slot] = None
        self._slot_tokens[slot] = []
        self._slot_budget[slot] = 0
        self._live[slot] = False
