"""Multi-tenant LoRA serving: the adapter registry and its pooled leaves
(counterpart of the JAX ``infer/adapters.py``).

The reference's end product is a LoRA fine-tune (r 16, alpha 8, seven
projection targets) of a shared base model. The registry lets one engine
serve many such adapters in ONE fused batch: each row of a decode tick or
a prefill gathers its own low-rank delta, instead of one merged checkpoint
per tenant.

``AdapterRegistry.params`` is a pooled view of the generator's flat
parameters: the same base tensors (shared, not copied) plus, after every
target kernel, three f32 leaves on the engine's device

    <module>.lora_a_pool     [max_adapters, in, rank]
    <module>.lora_b_pool     [max_adapters, rank, out]
    <module>.lora_scale_pool [max_adapters]

with **slot 0 the identity adapter** (all zeros: an exactly-zero delta, so
base rows co-batch bit for bit). The engines hand the view to the
Generator (``state["params"]``) and give each slot its request's
``adapter_idx``; ``models/transformer._linear`` gathers each row's A, B
and scale. The pools never change shape: loading or evicting an adapter
writes values into one slot.

Lifecycle, refcount + LRU, as in the JAX registry:

- ``acquire(name)`` resolves a tenant to a slot, loading the PEFT directory
  ``<adapter_dir>/<name>`` on first touch (validated by
  ``parallel/lora.peft_adapter_state``: a config or tensor that does not
  fit raises a ValueError naming the field; an unknown name raises the
  404-mapped ``UnknownAdapterError`` with the known list), and pins it for
  the request's life;
- ``release(name)`` unpins; an idle adapter stays resident (warm) in LRU
  order and is evicted only when a load needs its slot. A pinned slot is
  never evicted: with every slot pinned a load raises the 429-mapped
  ``AdapterPoolFullError``;
- ``rebuild()`` writes every resident adapter back from its host copy: the
  engines call it in their supervised ``_startup``, so a restart keeps the
  resident set and its slots.

Where the JAX registry rebuilds a pool leaf functionally
(``.at[slot].set``), the port writes the slot's rows in place
(``pool[slot].copy_``). That is as safe: a slot being loaded is referenced
only by the request that asked for it (not yet admitted, so no forward
reads it), an evicted slot is idle (refcount 0, so no live row points at
it), and dead rows decode with slot 0 (``infer/generate``). The registry's
bookkeeping is serialized by one lock; a load reserves its slot under it
and reads, pads and writes outside it (the JAX registry holds its lock
across the load), so one tenant's hot-load stalls neither the engine's
releases nor the router's probes. The host copies are f32 CPU tensors.

``rebind(base)`` re-points the view at a hot-swapped base dict: the pools
ride over by reference, so the resident adapters and their slots stay as
they were.

Under tensor parallelism (``mesh``, ``model_config``: the serving mesh of
``--tp N`` and the whole model's config) the view is over the rank's
slices, so each pool holds its kernel's share: a column-parallel kernel's
B by output columns, a row-parallel kernel's A by input rows
(``parallel/sharding.shard_lora_factors``). Adapters are validated and
padded at the whole model's shapes, kept whole on the host and sliced at
each write. On rank 0 ``on_write`` (the engine sets it to
``multihost.SlotBridge.adapter_write``) announces every slot write, with
the whole factors, before any pool is touched; a follower rank's registry
applies it with ``apply_remote_write`` (no disk, no name bookkeeping), as
in the JAX package.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

from llm_fine_tune_distributed_tpu_torch.infer.errors import (
    AdapterPoolFullError,
    UnknownAdapterError,
)
from llm_fine_tune_distributed_tpu_torch.models.transformer import param_shapes
from llm_fine_tune_distributed_tpu_torch.parallel.lora import peft_adapter_state
from llm_fine_tune_distributed_tpu_torch.parallel.sharding import shard_lora_factors

# Pools sit beside the reference's seven projection targets. An adapter
# that targets anything else (the lm_head, say) is refused at load rather
# than silently losing part of its delta.
POOL_TARGET_MODULES = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
)
POOL_LEAVES = ("lora_a_pool", "lora_b_pool", "lora_scale_pool")


class AdapterRegistry:
    """Fixed-capacity pooled adapters over a shared base model.

    ``max_adapters`` is the pool depth: slot 0 is the identity adapter, so
    up to ``max_adapters - 1`` tenants are resident at once. The pool's
    rank ceiling is the largest ``r`` among the adapters on disk at build
    (else 16); a smaller adapter is zero-padded (an exact no-op on its
    delta), a larger one refused."""

    def __init__(self, base_params: Dict[str, torch.Tensor], adapter_dir: str, *,
                 max_adapters: int = 8, mesh=None, model_config=None):
        if max_adapters < 2:
            raise ValueError(
                f"max_adapters must be >= 2 (slot 0 is the identity adapter), "
                f"got {max_adapters}"
            )
        self.adapter_dir = adapter_dir
        self.max_adapters = int(max_adapters)
        self.mesh = mesh
        self._tp = mesh.tensor_size if mesh is not None else 1
        self._tp_index = mesh.tensor_index if mesh is not None else 0
        if self._tp > 1 and model_config is None:
            raise ValueError("an AdapterRegistry over a --tp > 1 mesh needs the whole model's "
                             "model_config (its kv heads' mapping)")
        self._config = model_config
        # the whole model's kernel shapes (meta tensors), which adapters are
        # validated and padded against when the view holds a rank's slices
        self._whole = ({n: torch.empty(shape, device="meta")
                        for n, shape in param_shapes(model_config).items()}
                       if self._tp > 1 else None)
        # rank 0's announcement of every slot write (the engine's bridge)
        self.on_write = None
        self.stats = None  # the serving engine's ServingStats (attach_stats)
        self._lock = threading.RLock()
        self._names: List[Optional[str]] = [None] * self.max_adapters
        self._idx: Dict[str, int] = {}
        self._refs: Dict[str, int] = {}
        self._lru: "OrderedDict[str, None]" = OrderedDict()  # idle residents
        # loads in progress: name -> (its reserved slot, set when it ends)
        self._loading: Dict[str, Tuple[int, threading.Event]] = {}
        # host copies per resident adapter, for the rebuild:
        # name -> ({module: (A [in, rank], B [rank, out])}, scale)
        self._host: Dict[str, Tuple[dict, float]] = {}
        self.rank = self._scan_rank()
        # module -> (pool_a, pool_b, pool_scale), the leaves of the view
        self._sites: Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
        self.params = self._build_view(base_params)
        if not self._sites:
            raise ValueError(
                "the model has no linear module matching the adapter pool "
                f"targets {POOL_TARGET_MODULES}"
            )

    # ----------------------------------------------------------- construction

    def _scan_rank(self) -> int:
        """Pool rank = the largest ``r`` of the adapters on disk (default 16)."""
        best = 0
        for name in self.known():
            try:
                with open(os.path.join(self.adapter_dir, name, "adapter_config.json")) as f:
                    best = max(best, int(json.load(f).get("r", 0)))
            except (OSError, ValueError, TypeError):
                continue
        return best or 16

    def _build_view(self, base_params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The base leaves in their order, each target kernel followed by its
        three zeroed pools (on the kernel's device). A module whose kernel is
        not a plain 2-D ``kernel`` (int8 codes, say) gets no pool."""
        view: Dict[str, torch.Tensor] = {}
        for name, t in base_params.items():
            view[name] = t
            module, _, leaf = name.rpartition(".")
            if leaf != "kernel" or module.rpartition(".")[2] not in POOL_TARGET_MODULES:
                continue
            if t.dim() != 2:
                continue
            d_in, d_out = t.shape
            n, r = self.max_adapters, self.rank
            pools = (torch.zeros((n, d_in, r), dtype=torch.float32, device=t.device),
                     torch.zeros((n, r, d_out), dtype=torch.float32, device=t.device),
                     torch.zeros((n,), dtype=torch.float32, device=t.device))
            for leaf_name, pool in zip(POOL_LEAVES, pools):
                view[f"{module}.{leaf_name}"] = pool
            self._sites[module] = pools
        return view

    # ---------------------------------------------------------------- surface

    def attach_stats(self, stats) -> None:
        """Count ``adapter_loads`` / ``adapter_evictions`` into the
        ``ServingStats`` of the engine that serves this registry."""
        self.stats = stats

    def pool_bytes(self) -> int:
        """Bytes of every pool leaf on the device."""
        return sum(p.nbytes for pools in self._sites.values() for p in pools)

    def known(self) -> List[str]:
        """Adapter names on disk (subdirectories with an adapter_config.json)."""
        try:
            return sorted(
                d for d in os.listdir(self.adapter_dir)
                if os.path.exists(os.path.join(self.adapter_dir, d, "adapter_config.json"))
            )
        except OSError:
            return []

    def resident(self) -> List[str]:
        with self._lock:
            return [n for n in self._names if n is not None]

    def is_resident(self, name: str) -> bool:
        with self._lock:
            return name in self._idx

    def slot_of(self, name: str) -> Optional[int]:
        with self._lock:
            return self._idx.get(name)

    def refcount(self, name: str) -> int:
        with self._lock:
            return self._refs.get(name, 0)

    def acquire(self, name: str) -> int:
        """Resolve ``name`` to a pool slot and pin it (refcount + 1). Loads
        from disk on first touch, evicting the least recently used idle
        resident when the pool is full. Raises ``UnknownAdapterError`` (404)
        for a name that does not resolve, ``AdapterPoolFullError`` (429)
        when every slot is pinned, and ValueError for an adapter that does
        not fit the model or the pool rank.

        The load itself (the file read, the validation and the slot writes)
        runs outside the lock, on a slot reserved under it, so a release, a
        residency probe or another tenant's pin never waits for a hot-load;
        a second request for the adapter being loaded waits for that load."""
        path = os.path.join(self.adapter_dir, name)
        while True:
            with self._lock:
                if name in self._idx:
                    self._refs[name] += 1
                    self._lru.pop(name, None)
                    return self._idx[name]
                if name not in self._loading:
                    if (
                        not name
                        or os.sep in name
                        or not os.path.exists(os.path.join(path, "adapter_config.json"))
                    ):
                        raise UnknownAdapterError(
                            f"unknown adapter {name!r}: no such adapter under "
                            f"{self.adapter_dir}",
                            known=tuple(self.known()),
                        )
                    slot = self._free_slot()
                    done = threading.Event()
                    self._loading[name] = (slot, done)
                    break
                done = self._loading[name][1]
            done.wait()  # another request is loading it: pin it once loaded
        try:
            entries, scale, _ = peft_adapter_state(self._whole or self.params, path)
            padded = self._pad(name, entries)
            self._write_slot(slot, padded, scale)
        except BaseException:
            with self._lock:
                del self._loading[name]  # the slot is free again
            done.set()
            raise
        with self._lock:
            del self._loading[name]
            self._host[name] = (padded, scale)
            self._names[slot] = name
            self._idx[name] = slot
            self._refs[name] = 1
            if self.stats is not None:
                self.stats.incr("adapter_loads")
        done.set()
        return slot

    def release(self, name: str) -> None:
        """Unpin one request's hold. At refcount 0 the adapter stays warm
        but becomes evictable (it joins the LRU tail)."""
        with self._lock:
            if name not in self._refs:
                return
            self._refs[name] -= 1
            if self._refs[name] <= 0:
                self._refs[name] = 0
                self._lru[name] = None
                self._lru.move_to_end(name)

    def rebind(self, base_params: Dict[str, torch.Tensor]) -> None:
        """Re-point the pooled view at a new base dict (an engine's weight
        hot-swap builds one copy-on-write): the base leaves are the new
        dict's, each target kernel followed by its existing pools, so the
        resident adapters need no re-upload."""
        with self._lock:
            view: Dict[str, torch.Tensor] = {}
            for name, t in base_params.items():
                view[name] = t
                module, _, leaf = name.rpartition(".")
                if leaf == "kernel" and module in self._sites:
                    for leaf_name, pool in zip(POOL_LEAVES, self._sites[module]):
                        view[f"{module}.{leaf_name}"] = pool
            self.params = view

    def rebuild(self) -> None:
        """Write every resident adapter back from its host copy (the
        engines' ``_startup``): a restart keeps the resident set and its
        slots exactly."""
        with self._lock:
            for slot, name in enumerate(self._names):
                if name is not None:
                    padded, scale = self._host[name]
                    self._write_slot(slot, padded, scale)

    # -------------------------------------------------------------- internals

    def _free_slot(self) -> int:
        """A free slot (never 0, never one a load has reserved), evicting
        the LRU idle resident when none is free. The caller holds the
        lock."""
        reserved = {slot for slot, _ in self._loading.values()}
        for i in range(1, self.max_adapters):
            if self._names[i] is None and i not in reserved:
                return i
        while self._lru:
            victim, _ = self._lru.popitem(last=False)
            if self._refs.get(victim, 0) == 0 and victim in self._idx:
                slot = self._idx.pop(victim)
                self._names[slot] = None
                self._refs.pop(victim, None)
                self._host.pop(victim, None)
                if self.stats is not None:
                    self.stats.incr("adapter_evictions")
                return slot
        raise AdapterPoolFullError(
            f"all {self.max_adapters - 1} adapter slots are pinned by live "
            "requests; retry when a tenant drains"
        )

    def apply_remote_write(self, slot: int, padded: dict, scale: float) -> None:
        """A follower rank's half of a slot write rank 0 announced
        (``multihost.follow_slots``): the factors came over the bridge, so
        the write is the one rank 0 makes, without the disk or the names."""
        with self._lock:
            self._write_slot(slot, padded, scale, announce=False)

    def _whole_shape(self, module: str, pool_a: torch.Tensor, pool_b: torch.Tensor):
        """(in, out) of ``module``'s whole kernel."""
        if self._whole is None:
            return pool_a.shape[1], pool_b.shape[2]
        return tuple(self._whole[module + ".kernel"].shape)

    def _pad(self, name: str, entries: dict) -> dict:
        """Zero-pad (A, B) to the pool rank and zero-fill the sites the
        adapter does not target, at the whole kernels' shapes. The padding
        columns of A and rows of B are zero, so the padded delta is exactly
        the adapter's own."""
        for module in entries:
            if module not in self._sites:
                raise ValueError(
                    f"adapter {name!r} targets module "
                    f"{module} which has no pool (pooled targets: "
                    f"{POOL_TARGET_MODULES})"
                )
        out = {}
        for module, (pool_a, pool_b, _) in self._sites.items():
            d_in, d_out = self._whole_shape(module, pool_a, pool_b)
            a = torch.zeros((d_in, self.rank), dtype=torch.float32)
            b = torch.zeros((self.rank, d_out), dtype=torch.float32)
            if module in entries:
                ea, eb = entries[module]
                r = ea.shape[1]
                if r > self.rank:
                    raise ValueError(
                        f"adapter {name!r} has rank {r} > pool rank "
                        f"{self.rank} (fixed at startup from the adapters "
                        "then on disk); restart the server so the pool "
                        "rescans, or retrain the adapter at a smaller rank"
                    )
                a[:, :r] = ea
                b[:r, :] = eb
            out[module] = (a, b)
        return out

    def _write_slot(self, slot: int, padded: dict, scale: float, announce: bool = True) -> None:
        """Write one slot's rows in place (see the module docstring for why
        no forward can be reading them), the rank's slice of each factor;
        on rank 0 of a tensor-parallel mesh the write is announced first,
        so the follower ranks receive the factors before any pool moves."""
        if announce and self.on_write is not None:
            self.on_write(slot, padded, scale)
        for module, (pool_a, pool_b, pool_s) in self._sites.items():
            a, b = shard_lora_factors(module, *padded[module], self._config, self._tp,
                                      self._tp_index)
            pool_a[slot].copy_(a)
            pool_b[slot].copy_(b)
            pool_s[slot] = scale
