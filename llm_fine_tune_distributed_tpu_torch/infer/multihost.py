"""Tensor-parallel serving across processes: one HTTP front door, N ranks
decoding (counterpart of the JAX ``infer/multihost.py``).

In PyTorch one process drives one device, so every ``--tp N > 1`` mesh spans
processes, and every rank must enter the same forward, with the same inputs,
in the same order: the forward's all-reduces and its all-gather pair up
across the ranks. HTTP requests arrive only at rank 0. This module carries
rank 0's decisions to the others:

- the window engine: rank 0 wraps its Generator in ``MultihostCoordinator``,
  which broadcasts each batch's (prompts, GenerationConfig, seed) before
  decoding it; every other rank runs ``follow()``, which enters the same
  ``generate_batch`` until the coordinator stops it;
- the slot engines (continuous, paged): the engine calls a ``SlotBridge``
  method just before each dispatch (startup, prefill, chunk, step, draft,
  spec step); every other rank runs ``follow_slots()``, which mirrors each
  dispatch on its own shards of the cache or pool and its own copy of the
  slot state, so that it samples the same token as rank 0 (the logits are
  gathered whole on every rank, and each slot's generator is seeded alike).

The wire format is the JAX package's, byte for byte: a fixed-shape int64
header (``_HEADER_LEN`` for the window protocol, ``_SLOT_HEADER_LEN`` for the
slot protocol), then fixed-shape payloads whose shapes the header and the
engine's geometry give; a GenerationConfig rides as JSON in a ``_CFG_BUF``
buffer, a slot's sampling knobs as ``f64[6]``, and trees (a hot-swap's
leaves, an adapter's factors) as a JSON manifest followed by the raw
leaves. The transport is ``runtime/distributed.broadcast_host`` over the
mesh's gloo control group, beside the forward's group: a follower needs
each header on its host before it can enter the step, which NCCL would
deliver only through the device and a sync. Each broadcast completes before
rank 0 enters the forward's collectives, so no rank waits on a header while
another waits in the forward.

Failure policy (the JAX one): a follower whose mirrored dispatch fails
re-raises and exits non-zero, so the job fails visibly instead of leaving
rank 0's next collective without a peer; the coordinator marks itself
``wedged`` on any failure, and the server's ``/healthz`` answers 503 so the
orchestrator restarts every rank; a ``SlotBridge`` whose broadcast fails
is ``wedged`` too, and raises ``FatalEngineError``, which ends the engine.

Beyond the dispatches: an adapter registry's pool writes (``adapter_write``,
from the request thread that loads the adapter: each op is atomic under a
lock), a hot-swap's raw leaves (``swap``: every rank re-quantizes and slices
them itself) and, the port's own op, ``gather``: rank 0 asks every rank for
its slices of some resident leaves (the deploy manager's fingerprint and
rollback capture read them whole; the JAX package reads its global arrays).
The JAX follower reads an adapter write's leaves before its scale, which
rank 0 sends between the manifest and the leaves; the port's follower reads
them in the order they are sent.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from llm_fine_tune_distributed_tpu_torch.infer.errors import FatalEngineError
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.runtime.distributed import broadcast_host

_HEADER_LEN = 5  # [stop, batch, bucket, seed, cfg_len]
_CFG_BUF = 4096  # fixed JSON buffer so the broadcast shape is static


def _endpoints(generator):
    """(is rank 0, control group) of ``generator``'s mesh."""
    mesh = generator.mesh
    if mesh is None or mesh.control_group is None:
        raise ValueError("the multihost bridge needs a Generator on a tensor-parallel mesh "
                         "over more than one process (make_tp_mesh(tp > 1))")
    return mesh.tensor_index == 0, mesh.control_group


def _encode_cfg(gen: GenerationConfig):
    raw = json.dumps(dataclasses.asdict(gen)).encode()
    if len(raw) > _CFG_BUF:
        raise ValueError(f"GenerationConfig JSON exceeds {_CFG_BUF} bytes")
    buf = np.zeros((_CFG_BUF,), np.uint8)
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    return buf, len(raw)


def _decode_cfg(buf: np.ndarray, length: int) -> GenerationConfig:
    raw = bytes(buf[:length].astype(np.uint8).tobytes())
    return GenerationConfig(**json.loads(raw.decode()))


class MultihostCoordinator:
    """Rank 0's Generator for the window engine: ``generate_batch`` fans out
    to the follower ranks first. Every other attribute is the Generator's,
    so the engine does not know the difference."""

    def __init__(self, generator):
        self.generator = generator
        self._is_source, self._group = _endpoints(generator)
        # set on the first failure and never cleared: a follower that
        # mirrored the failure has exited (follow() re-raises), so every
        # later batch would wait at a broadcast with no peer; /healthz
        # answers 503 off this flag
        self.wedged = False

    def __getattr__(self, name):
        return getattr(self.generator, name)

    def _broadcast(self, arr: np.ndarray) -> np.ndarray:
        return broadcast_host(arr, self._is_source, self._group)

    def generate_batch(self, prompts: Sequence[Sequence[int]],
                       gen: Optional[GenerationConfig] = None, seed: int = 0,
                       live_rows: Optional[int] = None) -> List[List[int]]:
        gen = gen or GenerationConfig()
        prompts = [list(p) for p in prompts]
        try:
            bucket = max(len(p) for p in prompts)
            cfg_buf, cfg_len = _encode_cfg(gen)
            self._broadcast(np.asarray([0, len(prompts), bucket, seed, cfg_len], np.int64))
            padded = np.zeros((len(prompts), bucket), np.int64)
            lens = np.zeros((len(prompts),), np.int64)
            for i, p in enumerate(prompts):
                padded[i, : len(p)] = p
                lens[i] = len(p)
            self._broadcast(padded)
            self._broadcast(lens)
            self._broadcast(cfg_buf)
            # live_rows shapes only rank 0's telemetry: it does not ride
            return self.generator.generate_batch(prompts, gen, seed=seed, live_rows=live_rows)
        except Exception:
            self.wedged = True
            raise

    def stop(self) -> None:
        """Release the follower ranks (server shutdown); nothing to release
        once they are gone."""
        if self.wedged:
            return
        stop = np.zeros((_HEADER_LEN,), np.int64)
        stop[0] = 1
        self._broadcast(stop)


def follow(generator) -> None:
    """Follower loop of the window engine (ranks > 0): mirror every batch of
    rank 0 until it stops. A failure re-raises: rank 0 decodes with its own
    config object, so nothing guarantees that it failed too, and a follower
    that looped on would leave its next collective without a peer."""
    is_source, group = _endpoints(generator)
    if is_source:
        raise ValueError("rank 0 coordinates; only ranks > 0 follow")
    while True:
        header = broadcast_host(np.zeros((_HEADER_LEN,), np.int64), False, group)
        stop, batch, bucket, seed, cfg_len = (int(x) for x in header)
        if stop:
            return
        padded = broadcast_host(np.zeros((batch, bucket), np.int64), False, group)
        lens = broadcast_host(np.zeros((batch,), np.int64), False, group)
        cfg_buf = broadcast_host(np.zeros((_CFG_BUF,), np.uint8), False, group)
        try:
            gen = _decode_cfg(cfg_buf, cfg_len)
            prompts = [[int(t) for t in padded[i, : int(lens[i])]] for i in range(batch)]
            generator.generate_batch(prompts, gen, seed=seed)
        except Exception:
            print("[serve] follower batch failed; crashing so the wedge is visible (restart "
                  "the serving job)", flush=True)
            raise


# --------------------------------------------------------------------------
# The slot engines' tick protocol. Header: int64 [op, a, b, c, d, e, f, g,
# h, i], the meaning of a..i by op (each SlotBridge method). Variable-size
# payloads ride as a JSON manifest whose byte length is in the header, then
# one raw broadcast per leaf, shaped by the manifest.

_SLOT_HEADER_LEN = 10

SLOT_STOP = 0
SLOT_STARTUP = 1
SLOT_PREFILL = 2
SLOT_STEP = 3
SLOT_SPEC_STEP = 4
SLOT_PAGED_CHUNK = 5
SLOT_PAGED_FINAL = 6
SLOT_PAGED_STEP = 7
SLOT_SPEC_PAGED_STEP = 8
SLOT_SWAP = 9
SLOT_ADAPTER = 10
SLOT_DRAFT_STEP = 11
# the port's own op (the JAX package reads its global arrays whole): rank 0
# asks every rank for its slices of some resident leaves
SLOT_GATHER = 12

# a request's sampling knobs in one f64 vector (do_sample and adapter_idx
# round-trip exactly through f64)
_KNOB_FIELDS = (
    "temperature", "top_p", "top_k", "repetition_penalty", "do_sample", "adapter_idx",
)
_KNOB_DTYPES = {
    "temperature": np.float32, "top_p": np.float32, "top_k": np.int32,
    "repetition_penalty": np.float32, "do_sample": np.bool_, "adapter_idx": np.int32,
}


def _encode_knobs(knobs: dict) -> np.ndarray:
    return np.asarray([float(knobs[f]) for f in _KNOB_FIELDS], np.float64)


def _decode_knobs(vec: np.ndarray) -> dict:
    return {f: _KNOB_DTYPES[f](vec[i]) for i, f in enumerate(_KNOB_FIELDS)}


def request_knobs(gen: GenerationConfig, adapter_idx: int = 0) -> dict:
    """The knobs of a request as they ride: its own Python values, so the
    f64 wire carries them exactly (a ``top_k`` of None rides as 0, which
    samples as None does)."""
    return {"temperature": gen.temperature, "top_p": gen.top_p, "top_k": gen.top_k or 0,
            "repetition_penalty": gen.repetition_penalty, "do_sample": gen.do_sample,
            "adapter_idx": adapter_idx}


def _knobs_config(vec: np.ndarray):
    """(GenerationConfig, adapter slot) a follower samples a slot with: the
    f64 values as rank 0's Python floats (not ``_decode_knobs``' f32, whose
    rounding would sample differently)."""
    v = dict(zip(_KNOB_FIELDS, vec.tolist()))
    gen = GenerationConfig(temperature=v["temperature"], top_p=v["top_p"],
                           top_k=int(v["top_k"]), repetition_penalty=v["repetition_penalty"],
                           do_sample=bool(v["do_sample"]))
    return gen, int(v["adapter_idx"])


def _ack(group) -> None:
    """Every rank of the control group reached this point: an all-reduce,
    which needs each rank's part (a broadcast from rank 0 does not)."""
    torch.distributed.all_reduce(torch.zeros(1, dtype=torch.int64), group=group)


def _host_array(x) -> np.ndarray:
    """A host tensor or array as numpy (bf16, which numpy lacks, as f32:
    exact, and cast back exactly where a bf16 leaf takes it)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _gather_leaves(params: dict, names, generator, group) -> dict:
    """Every rank's slice of each leaf in ``names``, all-gathered over the
    control group, put back whole on every rank (host tensors)."""
    from llm_fine_tune_distributed_tpu_torch.parallel.sharding import unshard_leaf

    tp = generator.mesh.tensor_size
    out = {}
    for name in names:
        local = params[name].detach().cpu().contiguous()
        parts = [torch.empty_like(local) for _ in range(tp)]
        torch.distributed.all_gather(parts, local, group=group)
        out[name] = unshard_leaf(name, parts, generator.config, tp)
    return out


def _tree_manifest(updates: dict):
    """(manifest uint8 buffer, ordered [(path, np.ndarray)] entries) for a
    flat {path: array} dict: the sender half of the sized-payload codec."""
    entries = [(p, np.asarray(updates[p])) for p in sorted(updates)]
    manifest = json.dumps([[p, list(a.shape), a.dtype.str] for p, a in entries]).encode()
    return np.frombuffer(manifest, np.uint8).copy(), entries


def _manifest_entries(buf: np.ndarray):
    """Receiver half: [(path, shape tuple, dtype)] from a manifest buffer."""
    return [(p, tuple(shape), np.dtype(dt))
            for p, shape, dt in json.loads(bytes(buf.tobytes()).decode())]


def _atomic(op):
    """One op's header and payloads go out together: the engine's worker
    announces dispatches while a request's thread may announce an adapter
    load."""
    @functools.wraps(op)
    def run(self, *args, **kwargs):
        with self._op_lock:
            return op(self, *args, **kwargs)
    return run


class SlotBridge:
    """Rank 0's half of the slot engines' tick protocol. The engine calls
    the matching method immediately before each dispatch; each broadcast
    completes before rank 0 enters the forward. Engines take it as
    ``bridge=``; without one, a Generator whose mesh spans processes is
    refused at engine construction. Each op is atomic (a lock): adapter
    writes are announced from the request threads that load them."""

    def __init__(self, generator):
        self._is_source, self._group = _endpoints(generator)
        if not self._is_source:
            raise ValueError("only rank 0 announces; ranks > 0 run follow_slots")
        self._generator = generator
        # set when a broadcast fails (a follower is gone) and never cleared:
        # the engine goes terminal and /healthz answers 503, so that the
        # orchestrator restarts every rank (no restart in-process can bring
        # a follower back)
        self.wedged = False
        self._op_lock = threading.RLock()

    def _send(self, arr: np.ndarray) -> None:
        if self.wedged:
            raise FatalEngineError("the follower ranks are gone; restart every rank")
        try:
            broadcast_host(np.ascontiguousarray(arr), True, self._group)
        except Exception as e:
            self.wedged = True
            raise FatalEngineError(f"a follower rank is gone ({type(e).__name__}: {e}); "
                                   "restart every rank") from e

    def _header(self, op: int, *vals) -> None:
        h = np.zeros((_SLOT_HEADER_LEN,), np.int64)
        h[0] = op
        for i, v in enumerate(vals):
            h[1 + i] = int(v)
        self._send(h)

    @_atomic
    def startup(self, kind: int, slots: int, buf_len: int, spec_k: int, num_blocks: int = 0,
                block_len: int = 0, table_blocks: int = 0, kv_quant_int8: bool = False,
                use_draft: bool = False) -> None:
        """kind 0 = continuous (dense), 1 = paged. Announced from the
        engines' supervised ``_startup``: a restart announces again, and the
        followers rebuild their cache and state with it. Every follower then
        answers (``_ack``): a broadcast can land in a dead peer's socket
        buffer without an error, so a restart after a follower died would
        otherwise pass for a healthy one."""
        self._header(SLOT_STARTUP, kind, slots, buf_len, spec_k, num_blocks, block_len,
                     table_blocks, int(kv_quant_int8), int(use_draft))
        try:
            _ack(self._group)
        except Exception as e:
            self.wedged = True
            raise FatalEngineError(f"a follower rank is gone ({type(e).__name__}: {e}); "
                                   "restart every rank") from e

    @_atomic
    def prefill(self, bucket: int, plen: int, slot: int, seed: int, knobs: dict,
                padded: np.ndarray, draft_padded=None) -> None:
        dbucket = 0 if draft_padded is None else draft_padded.shape[1]
        self._header(SLOT_PREFILL, bucket, plen, slot, seed, 0 if draft_padded is None else 1,
                     dbucket)
        self._send(_encode_knobs(knobs))
        self._send(padded.astype(np.int32))
        if draft_padded is not None:
            self._send(draft_padded.astype(np.int32))

    @_atomic
    def step(self, live: np.ndarray) -> None:
        self._header(SLOT_STEP)
        self._send(live.astype(np.bool_))

    @_atomic
    def draft_step(self, window: np.ndarray, start: np.ndarray) -> None:
        """Before the draft model's dispatch; the verify's operands follow
        in ``spec_step`` / ``spec_paged_step``."""
        self._header(SLOT_DRAFT_STEP)
        self._send(window.astype(np.int32))
        self._send(start.astype(np.int32))

    def _drafts(self, drafts, n_draft: np.ndarray) -> None:
        """The verify's drafts: host drafts (prompt lookup) ride; drafts a
        ``draft_step`` made on the device are the followers' own (header
        ``a`` = 0), as every rank drafted the same tokens."""
        if isinstance(drafts, np.ndarray):
            self._send(drafts.astype(np.int32))

    @_atomic
    def spec_step(self, live: np.ndarray, drafts, n_draft: np.ndarray) -> None:
        self._header(SLOT_SPEC_STEP, int(isinstance(drafts, np.ndarray)))
        self._send(live.astype(np.bool_))
        self._drafts(drafts, n_draft)
        self._send(n_draft.astype(np.int32))

    @_atomic
    def paged_chunk(self, table: np.ndarray, chunk: np.ndarray, chunk_start: int,
                    adapter_idx: int) -> None:
        self._header(SLOT_PAGED_CHUNK, chunk.shape[1], chunk_start, adapter_idx)
        self._send(table.astype(np.int32))
        self._send(chunk.astype(np.int32))

    @_atomic
    def paged_final(self, bucket: int, chunk_start: int, plen: int, slot: int, seed: int,
                    knobs: dict, table: np.ndarray, padded: np.ndarray, seen_row: np.ndarray,
                    draft_padded=None) -> None:
        dbucket = 0 if draft_padded is None else draft_padded.shape[1]
        self._header(SLOT_PAGED_FINAL, bucket, chunk_start, plen, slot, seed,
                     0 if draft_padded is None else 1, dbucket)
        self._send(_encode_knobs(knobs))
        self._send(table.astype(np.int32))
        self._send(padded.astype(np.int32))
        self._send(seen_row.astype(np.bool_))
        if draft_padded is not None:
            self._send(draft_padded.astype(np.int32))

    @_atomic
    def paged_step(self, live: np.ndarray, tables: np.ndarray) -> None:
        self._header(SLOT_PAGED_STEP, tables.shape[1])
        self._send(live.astype(np.bool_))
        self._send(tables.astype(np.int32))

    @_atomic
    def spec_paged_step(self, live: np.ndarray, tables: np.ndarray, drafts,
                        n_draft: np.ndarray) -> None:
        self._header(SLOT_SPEC_PAGED_STEP, tables.shape[1], int(isinstance(drafts, np.ndarray)))
        self._send(live.astype(np.bool_))
        self._send(tables.astype(np.int32))
        self._drafts(drafts, n_draft)
        self._send(n_draft.astype(np.int32))

    @_atomic
    def swap(self, updates, cache_invalidated: bool = False) -> None:
        """A hot-swap's raw leaves (``[(name, host tensor or array)]``), each
        rank to re-quantize and slice onto its own shards, as the JAX package
        encodes them (bf16 rides as f32, exactly); header ``b`` says whether
        the paged pools drop their int8 block scales (a new fingerprint)."""
        manifest, entries = _tree_manifest({name: _host_array(arr) for name, arr in updates})
        self._header(SLOT_SWAP, len(manifest), int(cache_invalidated))
        self._send(manifest)
        for _, arr in entries:
            self._send(arr)

    @_atomic
    def gather(self, params: dict, names) -> dict:
        """The whole leaves ``names`` of ``params`` (rank 0's slices), each
        rank's slice gathered over the control group and put back in place
        (``parallel/sharding.unshard_leaf``), on the host."""
        manifest = np.frombuffer(json.dumps(list(names)).encode(), np.uint8).copy()
        self._header(SLOT_GATHER, len(manifest))
        self._send(manifest)
        try:
            return _gather_leaves(params, names, self._generator, self._group)
        except Exception as e:
            self.wedged = True
            raise FatalEngineError(f"a follower rank is gone ({type(e).__name__}: {e}); "
                                   "restart every rank") from e

    @_atomic
    def adapter_write(self, slot: int, padded: dict, scale: float) -> None:
        """One adapter pool slot's write (the registry's ``on_write``): its
        whole factors ``{module: (A, B)}`` as ``<module>/a`` and
        ``<module>/b`` manifest entries and its scale as an f64 payload,
        the JAX encoding; each follower slices them as rank 0 does."""
        flat = {}
        for site, (a, b) in padded.items():
            flat[f"{site}/a"] = np.asarray(a)
            flat[f"{site}/b"] = np.asarray(b)
        manifest, entries = _tree_manifest(flat)
        self._header(SLOT_ADAPTER, slot, len(manifest))
        self._send(manifest)
        self._send(np.asarray([scale], np.float64))
        for _, arr in entries:
            self._send(arr)

    @_atomic
    def stop(self) -> None:
        """Release the follower ranks (server shutdown); nothing to release
        once they are gone."""
        if not self.wedged:
            self._header(SLOT_STOP)


def follow_slots(generator, adapters=None) -> None:
    """Follower loop of the slot engines (ranks > 0): mirror every dispatch
    of rank 0 against this rank's shards of the cache or pool and its own
    copy of the slot state, until rank 0 stops. Any failure re-raises (the
    job must fail, not wedge).

    ``adapters``: an ``AdapterRegistry`` of this rank with rank 0's pool
    geometry (``max_adapters`` and the adapter directory's rank); the pool
    writes arrive over the bridge and the slots forward through its pooled
    view."""
    is_source, group = _endpoints(generator)
    if is_source:
        raise ValueError("rank 0 announces; only ranks > 0 follow")
    gen = generator
    mirror: dict = {}  # the engine's device state on this rank, rebuilt at every startup

    def recv(shape, dtype) -> np.ndarray:
        return broadcast_host(np.zeros(shape, dtype), False, group)

    def recv_manifest(mlen):
        return _manifest_entries(recv((mlen,), np.uint8))

    def recv_leaves(entries):
        return {p: recv(shape, dt) for p, shape, dt in entries}

    def knobs():
        return _knobs_config(recv((len(_KNOB_FIELDS),), np.float64))

    def drafts(h_flag):
        if h_flag:
            return recv((mirror["slots"], mirror["spec_k"]), np.int32).astype(np.int64)
        return mirror.pop("drafts")

    def draft_prefill(draft, dbucket, slot):
        if draft:
            gen.draft_slot_prefill(mirror["dcache"], recv((1, dbucket), np.int32), slot)

    while True:
        h = recv((_SLOT_HEADER_LEN,), np.int64)
        op = int(h[0])
        if op == SLOT_STOP:
            return
        try:
            if op == SLOT_STARTUP:
                kind, slots, buf_len, spec_k, num_blocks, block_len, table_blocks, kvq, \
                    use_draft = (int(x) for x in h[1:])
                mirror.clear()  # the old cache goes before the new one is made
                mirror.update(kind=kind, slots=slots, buf_len=buf_len, spec_k=spec_k,
                              block_len=block_len, table_blocks=table_blocks)
                if kind == 0:
                    mirror["cache"], mirror["state"] = gen.init_slot_state(slots, buf_len)
                else:
                    mirror["cache"], mirror["state"] = gen.init_paged_state(
                        slots, num_blocks, block_len, kv_quant="int8" if kvq else "none")
                    from llm_fine_tune_distributed_tpu_torch.ops.flash_attention import (
                        reset_paged_decode_tickets,
                    )

                    reset_paged_decode_tickets(gen.device)
                if use_draft:
                    mirror["dcache"] = gen.init_draft_slot_cache(slots, buf_len)
                # the slots forward through the registry's pooled view, as
                # rank 0's engine sets it
                mirror["state"]["params"] = adapters.params if adapters is not None else gen.params
                _ack(group)  # rank 0 waits for every follower's rebuild
                continue
            S, tb = mirror.get("slots"), mirror.get("table_blocks")
            cache, state = mirror.get("cache"), mirror.get("state", {})
            if op == SLOT_PREFILL:
                bucket, plen, slot, seed, draft, dbucket = (int(x) for x in h[1:7])
                cfg, adapter_idx = knobs()
                padded = recv((1, bucket), np.int32).astype(np.int64)
                gen.slot_prefill(cache, state, padded, plen, slot, cfg, seed,
                                 adapter_idx=adapter_idx)
                draft_prefill(draft, dbucket, slot)
            elif op == SLOT_STEP:
                gen.slot_step(cache, state, recv((S,), np.bool_))
            elif op == SLOT_DRAFT_STEP:
                K = mirror["spec_k"]
                window = recv((S, K + 1), np.int32).astype(np.int64)
                start = recv((S,), np.int32).astype(np.int64)
                mirror["drafts"] = gen.draft_slot_step(mirror["dcache"], state, window, start)
            elif op == SLOT_SPEC_STEP:
                live = recv((S,), np.bool_)
                d = drafts(int(h[1]))
                n_draft = recv((S,), np.int32).astype(np.int64)
                gen.spec_slot_step(cache, state, live, d, n_draft)
            elif op == SLOT_PAGED_CHUNK:
                chunk_w, chunk_start, adapter_idx = (int(x) for x in h[1:4])
                table = recv((1, tb), np.int32)
                chunk = recv((1, chunk_w), np.int32).astype(np.int64)
                gen.paged_prefill_chunk(cache, state, table, chunk, chunk_start,
                                        adapter_idx=adapter_idx)
            elif op == SLOT_PAGED_FINAL:
                bucket, chunk_start, plen, slot, seed, draft, dbucket = (int(x) for x in h[1:8])
                cfg, adapter_idx = knobs()
                table = recv((1, tb), np.int32)
                padded = recv((1, bucket), np.int32).astype(np.int64)
                seen_row = recv((1, gen.config.vocab_size), np.bool_)
                gen.paged_prefill_final(cache, state, table, padded, chunk_start, plen, seen_row,
                                        slot, cfg, seed, adapter_idx=adapter_idx)
                draft_prefill(draft, dbucket, slot)
            elif op == SLOT_PAGED_STEP:
                nb = int(h[1])
                live = recv((S,), np.bool_)
                gen.paged_step(cache, state, live, recv((S, nb), np.int32))
            elif op == SLOT_SPEC_PAGED_STEP:
                nb, flag = int(h[1]), int(h[2])
                live = recv((S,), np.bool_)
                tables = recv((S, nb), np.int32)
                d = drafts(flag)
                n_draft = recv((S,), np.int32).astype(np.int64)
                gen.spec_paged_step(cache, state, live, tables, d, n_draft)
            elif op == SLOT_ADAPTER:
                slot, mlen = int(h[1]), int(h[2])
                # the order rank 0 sends: the manifest, the scale, the leaves
                entries = recv_manifest(mlen)
                scale = float(recv((1,), np.float64)[0])
                flat = recv_leaves(entries)
                if adapters is None:
                    raise ValueError(
                        "rank 0 announced an adapter pool write but this follower has no "
                        "AdapterRegistry: start every rank with the same --adapter-dir")
                padded = {path[:-2]: (torch.from_numpy(flat[path].copy()),
                                      torch.from_numpy(flat[path[:-2] + "/b"].copy()))
                          for path in flat if path.endswith("/a")}
                adapters.apply_remote_write(slot, padded, scale)
            elif op == SLOT_SWAP:
                from llm_fine_tune_distributed_tpu_torch.infer.engine import (
                    _cow_swap_tree,
                    _requantize_updates,
                )

                flat = recv_leaves(recv_manifest(int(h[1])))
                raw = [(name, torch.from_numpy(arr.copy())) for name, arr in flat.items()]
                params = gen.params
                new, _ = _cow_swap_tree(params, _requantize_updates(params, raw,
                                                                    shard=gen.shard_leaf))
                gen.adopt_params(params, new)
                if adapters is not None:
                    adapters.rebind(new)
                state["params"] = adapters.params if adapters is not None else new
                if int(h[2]):
                    # rank 0's paged engine dropped its prefix cache: its
                    # pool's int8 block scales start again from zero
                    for entry in cache["layers"].values():
                        for name in ("k_scale", "v_scale"):
                            if name in entry:
                                entry[name].zero_()
            elif op == SLOT_GATHER:
                names = json.loads(bytes(recv((int(h[1]),), np.uint8).tobytes()).decode())
                _gather_leaves(gen.params, names, gen, group)
            else:
                raise ValueError(f"unknown slot-bridge op {op}")
        except Exception:
            print("[serve] slot follower dispatch failed; crashing so the wedge is visible "
                  "(restart the serving job)", flush=True)
            raise
