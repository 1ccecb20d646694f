"""Host-side bookkeeping for the block-paged KV pool (counterpart of the JAX
``infer/paged.py``): a refcounted block allocator over one global pool, a
prefix cache that maps token-block prefixes to prefilled blocks (pure Python
over integers, owned by the engine's worker thread), and the host-RAM tier
behind the pool (``HostBlockTier``, shared by the replicas of a fleet).

Pool layout contract (``models/transformer.init_paged_cache``): block id 0
is the NULL block, never allocated, mapped into every unused block-table
entry. Writes routed to it land in cells whose positions are always masked.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

from llm_fine_tune_distributed_tpu_torch.infer.routing import prefix_block_keys

NULL_BLOCK = 0


class BlockAllocator:
    """Refcounted free-list allocator over ``num_blocks`` KV blocks.

    ``alloc(n)`` is all-or-nothing (a partially admitted request would hold
    blocks it can never use while blocking the FIFO head); every returned
    block carries ONE reference owned by the caller. ``ref``/``free`` move
    the count; a block returns to the free list only at refcount zero — the
    mechanism that lets one prefilled system-prompt block sit in many slot
    tables and the prefix cache at once.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (1 null + 1 usable), got {num_blocks}"
            )
        self.num_blocks = int(num_blocks)
        # pop() hands out ascending ids starting at 1; id 0 stays NULL forever
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._refs: dict = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_blocks - 1 - len(self._free)

    def refcount(self, block_id: int) -> int:
        return self._refs.get(block_id, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh blocks (refcount 1 each), or None if fewer than n free."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def ref(self, block_id: int) -> None:
        if block_id == NULL_BLOCK:
            raise ValueError("the null block is never referenced")
        if block_id not in self._refs:
            raise ValueError(f"block {block_id} is not allocated")
        self._refs[block_id] += 1

    def free(self, block_id: int) -> None:
        """Drop one reference; the block rejoins the free list at zero."""
        if block_id == NULL_BLOCK:
            raise ValueError("the null block is never freed")
        left = self._refs[block_id] - 1
        if left == 0:
            del self._refs[block_id]
            self._free.append(block_id)
        else:
            self._refs[block_id] = left


class PrefixCache:
    """Block-granularity shared-prefix cache: exact token-prefix -> block id.

    Keys are the raw bytes of the prompt's leading ``(i+1) * block_len``
    tokens (exact match — a hash collision here would silently reuse the
    WRONG K/V), so two prompts share block i iff they agree on every token
    through the end of block i; the common system prompt makes that the hot
    case. The cache owns one allocator reference per entry; admission takes
    its own reference per matched block (``match``), so an entry may be
    evicted (LRU) while slots still decode against its block — the block
    simply stops being discoverable and frees when its last slot retires.

    COW discipline (enforced by the engine's layout, relied on here): cached
    blocks are FULL prompt blocks, and a consumer's writes start at its
    block-aligned divergence point — shared blocks are immutable, divergent
    suffixes land in freshly allocated blocks.

    Preemption banks the victim's full context blocks here under the keys
    its resume will compute over prompt + banked tokens; LRU may reclaim
    them under continued pressure (a slower resume, never a wrong one).
    """

    def __init__(self, allocator: BlockAllocator, block_len: int):
        self._alloc = allocator
        self.block_len = int(block_len)
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def block_keys(self, prompt: Sequence[int], adapter: Optional[str] = None) -> List[bytes]:
        """One key per FULL prompt block (cumulative token bytes, salted
        with a tenant's adapter name): the same keys the fleet router scores
        affinity with (``infer/routing``)."""
        return prefix_block_keys(prompt, self.block_len, adapter)

    def resident_run(self, keys: Sequence[bytes]) -> int:
        """How many LEADING keys are cached: a read-only probe for the
        fleet router. It takes no references and does not touch the LRU
        order, and it may run on a router thread while the worker mutates
        the cache: each lookup is one dict read under the GIL, and a stale
        answer only costs placement quality."""
        n = 0
        for key in keys:
            if key not in self._entries:
                break
            n += 1
        return n

    def match(self, keys: Sequence[bytes], limit: int) -> List[int]:
        """Block ids for the longest cached run of leading keys (at most
        ``limit`` — the engine caps it so at least one suffix token always
        remains to prefill, since the first sampled token needs the last
        prompt token's logits). Takes one reference per returned block;
        the caller owns them."""
        out: List[int] = []
        for key in keys[: max(limit, 0)]:
            bid = self._entries.get(key)
            if bid is None:
                break
            self._entries.move_to_end(key)
            self._alloc.ref(bid)
            out.append(bid)
        return out

    def insert(self, keys: Sequence[bytes], block_ids: Sequence[int]) -> None:
        """Register freshly prefilled full blocks (cache takes its own ref).
        Re-inserting a cached key only refreshes its LRU position."""
        for key, bid in zip(keys, block_ids):
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            self._alloc.ref(bid)
            self._entries[key] = bid

    def evict(self, want_free: int, collect: Optional[List[Tuple[bytes, int]]] = None) -> int:
        """Drop LRU entries until the allocator has ``want_free`` free blocks
        or the cache is empty; returns entries dropped. Dropping an entry
        whose block is still mapped in a slot table releases only the cache's
        reference (lost reuse, never lost data).

        ``collect`` receives the dropped ``(key, block_id)`` pairs in
        eviction order, so the engine can spill their contents to the host
        tier before a later allocation overwrites them (the worker enqueues
        the spill's gather before any such write)."""
        dropped = 0
        while self._entries and self._alloc.free_count < want_free:
            key, bid = self._entries.popitem(last=False)
            if collect is not None:
                collect.append((key, bid))
            self._alloc.free(bid)
            dropped += 1
        return dropped


class HostBlockTier:
    """Byte-bounded host-RAM tier behind the device block pool.

    One entry per prefix-cache key: the host copies of ONE block's pool
    leaves in the JAX package's flatten order (layers by sorted string key;
    within a layer ``k``, ``k_scale``, ``v``, ``v_scale`` for an int8 pool,
    ``k``, ``v`` otherwise), so int8 codes and their scales travel as a unit
    and a restored block is bit-identical to the spilled one. On the card
    the engine fills an entry with pinned host tensors.

    LRU over total bytes (``capacity_bytes``; 0 disables the tier: every
    ``put`` is refused and eviction degrades to a discard). Entries carry
    the spiller's weight fingerprint, and a lookup under another
    fingerprint misses: KV computed by other weights is never data.

    Thread-safe (one lock): the replicas of a fleet share one tier, and
    that sharing is what live migration and the prefill/decode handoff
    ship blocks through. Entries outlive an engine restart (the device
    pool dies, host memory does not).
    """

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = max(0, int(capacity_bytes))
        self._lock = threading.Lock()
        # key -> (arrays, fingerprint, nbytes); insertion order = LRU order
        self._entries: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._bytes = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def put(self, key: bytes, arrays: List, fingerprint=None) -> bool:
        """Insert one block's host arrays under ``key``, evicting LRU entries
        until it fits. False when the tier is disabled or the entry alone
        exceeds its capacity (the caller counts a discard). Re-putting a
        resident key refreshes its content and LRU position."""
        nbytes = int(sum(int(getattr(a, "nbytes", 0) or 0) for a in arrays))
        with self._lock:
            if self.capacity_bytes <= 0 or nbytes > self.capacity_bytes:
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[2]
            while self._entries and self._bytes + nbytes > self.capacity_bytes:
                _, (_, _, old_nb) = self._entries.popitem(last=False)
                self._bytes -= old_nb
            self._entries[key] = (list(arrays), fingerprint, nbytes)
            self._bytes += nbytes
        return True

    def get(self, key: bytes, fingerprint=None) -> Optional[List]:
        """The block's host arrays (LRU-touched), or None when absent or
        spilled under another weight fingerprint."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry[1] != fingerprint:
                return None
            self._entries.move_to_end(key)
            return entry[0]

    def resident_run(self, keys: Sequence[bytes], fingerprint=None) -> int:
        """How many LEADING keys are restorable under ``fingerprint``: the
        engine's probe before it allocates (no LRU touch, nothing copied)."""
        with self._lock:
            n = 0
            for key in keys:
                entry = self._entries.get(key)
                if entry is None or entry[1] != fingerprint:
                    break
                n += 1
            return n

    def discard(self, key: bytes) -> None:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._bytes -= entry[2]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
