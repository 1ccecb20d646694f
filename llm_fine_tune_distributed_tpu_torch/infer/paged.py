"""Host-side bookkeeping for the block-paged KV pool (counterpart of the JAX
``infer/paged.py``): a refcounted block allocator over one global pool and a
prefix cache that maps token-block prefixes to prefilled blocks. Pure Python
over integers, owned by the engine's worker thread.

Pool layout contract (``models/transformer.init_paged_cache``): block id 0
is the NULL block, never allocated, mapped into every unused block-table
entry. Writes routed to it land in cells whose positions are always masked.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np

def prefix_block_keys(prompt: Sequence[int], block_len: int) -> List[bytes]:
    """One key per FULL leading prompt block: the raw bytes of the prompt's
    first ``(i+1) * block_len`` tokens as int32 (cumulative, so key i
    matches iff every token through the end of block i matches — exact
    match, never a hash); a partial trailing block gets no key.
    """
    L = int(block_len)
    if L <= 0:
        raise ValueError(f"block_len must be positive, got {block_len}")
    n = len(prompt) // L
    arr = np.asarray(list(prompt[: n * L]), np.int32)
    return [arr[: (i + 1) * L].tobytes() for i in range(n)]


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
    """

    def __init__(self, allocator: BlockAllocator, block_len: int):
        self._alloc = allocator
        self.block_len = int(block_len)
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def block_keys(self, prompt: Sequence[int]) -> List[bytes]:
        """One key per FULL prompt block (cumulative token bytes)."""
        return prefix_block_keys(prompt, self.block_len)

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

    def evict(self, want_free: int) -> int:
        """Drop LRU entries until the allocator has ``want_free`` free blocks
        or the cache is empty; returns entries dropped. Dropping an entry
        whose block is still mapped in a slot table releases only the cache's
        reference (lost reuse, never lost data)."""
        dropped = 0
        while self._entries and self._alloc.free_count < want_free:
            _, bid = self._entries.popitem(last=False)
            self._alloc.free(bid)
            dropped += 1
        return dropped
