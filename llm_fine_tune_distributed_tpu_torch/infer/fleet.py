"""Serving fleet: N supervised engine replicas behind one front-door router
(counterpart of the JAX ``infer/fleet.py``).

``EngineFleet`` presents the surface of a single engine (``submit`` /
``submit_full`` / ``stream`` / ``begin_drain`` / ``wait_drained`` /
``healthy`` / ``stats_snapshot`` ...), so ``infer/server.py`` serves a fleet
wherever it served an engine.

**Shared weights, private state.** Every replica wraps the same Generator,
so the weights are on the card once; each replica owns its KV pool, prefix
cache, supervisor, worker and stats, and a crash is a replica's own event.
Replicas run on the card's default stream, one worker thread each.

**Placement** (``infer/routing.py`` scores): per request the router takes a
view of each replica (health, queue depth, live slots, resident prompt
prefix, whether the request's LoRA adapter is resident) and picks by
policy: adapter residency, then prefix-cache affinity, then least-loaded,
load ties by rotation. Affinity reads the replica's own prefix cache
(``prefix_match_len``) and the router's intent map of recently routed keys,
which covers a prefix that is queued and not yet prefilled; a tenant's keys
are salted with its adapter's name as its replica's prefix cache salts
them. Each replica owns its adapter registry (pool residency is a replica's
own, and one replica's eviction must not pull a slot another decodes with).

**Degraded replicas** (terminal, draining, mid-recovery) leave the candidate
set. A request a replica fails retryably (a restart, a dead circuit, a
drain) or refuses for a full queue is placed again on a sibling; a stream
fails over only at admission. Only when every serving replica is saturated
does the fleet answer 429, with Retry-After the smallest predicted drain.

**Lifecycle**: ``add_replica`` / ``retire_replica`` (growing through the
``replica_factory``), ``migrate_slot`` and ``evacuate_replica`` move live
requests between replicas through the shared host KV tier (``export_requests``
/ ``adopt_request``), and a prefill-role replica hands each request to a
decode replica after its first token (``_handoff``). A retired replica's
counters and histograms fold into the fleet's, so totals never go back.

**Stats**: counters sum, occupancy gauges sum, epochs and severities take
the max, rates are recomputed from the summed counters, and histograms
merge exactly, the per-tenant records and histograms too (retired replicas
included); plus the router's counters and a ``per_replica`` map.

Not ported: the compile ledger (the port compiles no programs, so the
snapshot has no ``compile``).
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import OrderedDict, deque
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from llm_fine_tune_distributed_tpu_torch.infer.errors import (
    BrownoutShedError,
    CircuitOpenError,
    DrainingError,
    FatalEngineError,
    NoHealthyReplicaError,
    QueueOverflowError,
    RetryableEngineError,
    ServingError,
)
from llm_fine_tune_distributed_tpu_torch.infer.routing import (
    ROUTING_POLICIES,
    Placement,
    ReplicaView,
    choose_replica,
    prefix_block_keys,
)
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.observe.capacity import (
    SaturationModel,
    report_from_capacity_snapshots,
)
from llm_fine_tune_distributed_tpu_torch.observe.metrics import FLEET_COUNTERS, ServingStats
from llm_fine_tune_distributed_tpu_torch.observe.slo import GenerationSlices, SloPolicy
from llm_fine_tune_distributed_tpu_torch.observe.tracing import (
    FlightRecorder,
    Histogram,
    RequestTrace,
)

# replica failures that do not implicate the request: it is placed again on
# a sibling (a full queue is handled apart, for the all-saturated 429; a
# timeout or a client deadline is the request's own and never retries)
_FAILOVER_ERRORS = (RetryableEngineError, CircuitOpenError, FatalEngineError, DrainingError)

# slack past a client deadline before the fleet's own wait gives up: the
# replica enforces the deadline (a 504 with the tokens so far) and must win
# that race; the fleet's wait only backstops a hung replica
DEADLINE_TIMEOUT_GRACE_S = 1.0

# gauges that are epochs, severities or shared resources, not occupancy:
# the fleet reports the furthest replica, not the sum (one weight tree and
# one host tier back every replica)
_MAX_GAUGES = ("engine_generation", "weight_generation", "brownout_stage", "weight_bytes",
               "host_tier_bytes")


def _add_tenants(into: Dict[str, Dict[str, int]], per_tenant: Dict[str, Dict[str, int]]) -> None:
    """Add a snapshot's ``per_tenant`` records into ``into``, key by key."""
    for tenant, rec in per_tenant.items():
        mine = into.setdefault(tenant, {k: 0 for k in ServingStats.TENANT_KEYS})
        for k in ServingStats.TENANT_KEYS:
            mine[k] += int(rec.get(k, 0))


def _merge_tenant_histograms(into: Dict[str, Dict[str, Histogram]],
                             tenant_hists: Dict[str, Dict[str, Histogram]]) -> None:
    """Merge per-tenant latency histograms into ``into`` (exact: fixed buckets)."""
    for tenant, hists in tenant_hists.items():
        mine = into.setdefault(tenant, {})
        for name, h in hists.items():
            mine.setdefault(name, Histogram(h.bounds)).merge(h)


class EngineFleet:
    """N engine replicas and the prefix-aware, load-balancing front door."""

    ROUTER_COUNTERS = FLEET_COUNTERS

    def __init__(self, replicas: Sequence, routing: str = "prefix",
                 prefix_home_capacity: int = 8192, replica_factory=None,
                 migrate_on_retire: bool = False):
        """``replica_factory(rid, role=None)`` builds one more replica
        (``add_replica``; None disables growth). ``migrate_on_retire``:
        ``retire_replica`` and ``evacuate_replica`` empty a replica by
        migrating its requests to siblings through the host tier instead of
        waiting for them to finish."""
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        if routing not in ROUTING_POLICIES:
            raise ValueError(f"unknown routing policy {routing!r}; choose from {ROUTING_POLICIES}")
        self.migrate_on_retire = bool(migrate_on_retire)
        # stable replica ids: the set grows and shrinks, so every reference
        # across threads (placements, the intent map, /metrics labels) holds
        # an id, never a list position; ids are never reused
        self._by_id: "OrderedDict[int, object]" = OrderedDict(enumerate(replicas))
        self._next_id = len(self._by_id)
        self._replica_factory = replica_factory
        self.routing = routing
        # affinity keys at the replicas' block length (dense replicas have
        # none: no keys, so affinity never fires)
        self._block_len = int(getattr(replicas[0], "block_len", 0) or 0)
        # one lock over the rotation counter, the intent map, the counters,
        # the placement log and the replica map; never held across a replica
        # call that blocks, a build or a drain
        self._lock = threading.Lock()
        self._rr_seq = 0
        # block key -> replica id it was last routed to (LRU-bounded)
        self._prefix_home: "OrderedDict[bytes, int]" = OrderedDict()
        self._prefix_cap = max(0, int(prefix_home_capacity))
        self._counters: Dict[str, int] = {k: 0 for k in self.ROUTER_COUNTERS}
        self._placements: "deque[Tuple[int, str]]" = deque(maxlen=4096)
        # what retired replicas served, folded in before they leave the map
        self._retired_counters: Dict[str, int] = {}
        self._retired_hist: Dict[str, Histogram] = {}
        self._retired_tiers: Dict[str, int] = {}
        self._retired_waste: Dict[str, int] = {}
        self._retired_slices: List[GenerationSlices] = []
        self._retired_tenants: Dict[str, Dict[str, int]] = {}
        self._retired_tenant_hist: Dict[str, Dict[str, Histogram]] = {}
        self._retired_count = 0
        # the fleet's own timeline: scale_up, scale_down, migrate, handoff,
        # scale_decision (the autoscaler's) and role_degraded
        self.recorder = FlightRecorder(1024)
        self._saturation = SaturationModel()
        for rid, rep in self._by_id.items():
            self._wire_roles(rid, rep)
        roles = [getattr(r, "role", "mixed") for r in self._by_id.values()]
        if any(r != "mixed" for r in roles):
            # no prefill-capable (or decode-capable) replica: placement and
            # handoff degrade to mixed behaviour, but say so once
            for stage in ("prefill", "decode"):
                if not any(r in (stage, "mixed") for r in roles):
                    warnings.warn(
                        f"fleet has no {stage}-capable replica (roles: {roles}); degrading to "
                        "mixed placement — every replica will both prefill and decode",
                        RuntimeWarning, stacklevel=2)
                    self.recorder.record("role_degraded", missing=stage, roles=list(roles))

    def _wire_roles(self, rid: int, rep) -> None:
        """Install the handoff hook on a prefill-role replica."""
        if getattr(rep, "role", "mixed") == "prefill" and hasattr(rep, "handoff"):
            rep.handoff = lambda req, _rid=rid: self._handoff(_rid, req)

    # ---------------------------------------------------------- replica set

    @property
    def replicas(self) -> List:
        """The live replicas in id order (a fresh list each read)."""
        return list(self._by_id.values())

    def replica_items(self) -> List[Tuple[int, object]]:
        """(stable id, replica) pairs in id order: what per-replica output
        is labelled by."""
        return list(self._by_id.items())

    def add_replica(self, role: Optional[str] = None):
        """Grow the fleet by one replica: a pool, a supervisor and a worker
        over the shared weights. Returns ``(new_id, replica)``; RuntimeError
        without a ``replica_factory``. ``role`` asks the factory for that
        pool's replica (the ratio autoscaler's dimension)."""
        if self._replica_factory is None:
            raise RuntimeError("fleet has no replica_factory; add_replica is disabled")
        with self._lock:
            rid = self._next_id
            self._next_id += 1
        # built outside the lock: the router keeps placing meanwhile
        rep = self._replica_factory(rid) if role is None else self._replica_factory(rid, role=role)
        self._wire_roles(rid, rep)
        with self._lock:
            self._by_id[rid] = rep
            n = len(self._by_id)
        self.recorder.record("scale_up", replica=rid, replicas=n,
                             role=getattr(rep, "role", "mixed"))
        return rid, rep

    def retire_replica(self, rid: Optional[int] = None, timeout_s: float = 60.0,
                       migrate: Optional[bool] = None, role: Optional[str] = None):
        """Shrink the fleet by one replica (default: the newest; with
        ``role``, the newest of that role, KeyError if none): close its
        admission, migrate its requests to siblings when ``migrate`` (None:
        the fleet's ``migrate_on_retire``) or let them finish, fold its
        stats into the fleet's, then drop it and its intent-map entries and
        close its worker, so its pool, prefix cache and flight recorder are
        freed. Returns the retired id; refuses to retire the last replica.
        A migration failure falls back to the drain, never a drop."""
        with self._lock:
            if len(self._by_id) <= 1:
                raise ValueError("cannot retire the last replica")
            if rid is None and role is not None:
                rid = next((c for c in reversed(self._by_id)
                            if getattr(self._by_id[c], "role", "mixed") == role), None)
                if rid is None:
                    raise KeyError(f"no replica with role {role!r}")
            if rid is None:
                rid = next(reversed(self._by_id))
            if rid not in self._by_id:
                raise KeyError(f"no replica with id {rid}")
            rep = self._by_id[rid]
        rep.begin_drain()  # the router stops choosing it now
        migrate = self.migrate_on_retire if migrate is None else bool(migrate)
        migrated = 0
        if migrate and hasattr(rep, "export_requests"):
            try:
                migrated = self._evacuate(rid, rep, timeout_s)
            except Exception:
                migrated = 0  # it re-adopted them: the drain below settles them
        drained = rep.wait_drained(timeout_s)
        self._fold_retired(rep)
        with self._lock:
            self._by_id.pop(rid, None)
            self._retired_count += 1
            for key in [k for k, home in self._prefix_home.items() if home == rid]:
                del self._prefix_home[key]
            n = len(self._by_id)
        self.recorder.record("scale_down", replica=rid, replicas=n, drained=bool(drained),
                             migrated=migrated, role=getattr(rep, "role", "mixed"))
        close = getattr(rep, "close", None)
        if close is not None:
            close()
        return rid

    # ------------------------------------------------------- live migration

    def migrate_slot(self, source_rid: int, target_rid: Optional[int] = None,
                     timeout_s: float = 30.0) -> int:
        """Move every request in flight and queued off replica
        ``source_rid`` onto ``target_rid`` (None: the least-loaded sibling
        per request). The source banks each request's tokens and spills its
        blocks to the shared host tier, the target adopts it (restore, then
        decode: greedy tokens equal the run left alone), and the intent map
        follows it. Waiters and streams ride along: the Request object is
        what moves. Returns the number moved; KeyError on an unknown id,
        RuntimeError after the source re-adopted on an export failure."""
        with self._lock:
            if source_rid not in self._by_id:
                raise KeyError(f"no replica with id {source_rid}")
            if target_rid is not None and target_rid not in self._by_id:
                raise KeyError(f"no replica with id {target_rid}")
            if target_rid == source_rid:
                raise ValueError("cannot migrate a replica onto itself")
            source = self._by_id[source_rid]
        return self._evacuate(source_rid, source, timeout_s, target_rid=target_rid)

    def evacuate_replica(self, engine) -> int:
        """Best-effort evacuation before a replica's hot-swap (the rolling
        swap's hook): with ``migrate_on_retire``, ``engine``'s requests move
        to siblings. 0 when migration is off, the engine is not a replica,
        cannot export or has no sibling, or the export failed."""
        if not self.migrate_on_retire:
            return 0
        for rid, rep in self.replica_items():
            if rep is engine:
                if len(self._by_id) <= 1 or not hasattr(rep, "export_requests"):
                    return 0
                try:
                    return self._evacuate(rid, rep, timeout_s=30.0)
                except Exception:  # the swap falls back to the drain
                    return 0
        return 0

    def _candidates(self, source_rid: int, source, target_rid: Optional[int] = None,
                    stage: Optional[str] = None) -> List[Tuple[int, object]]:
        """Siblings that can adopt: available, with ``adopt_request``, not
        the source; for a handoff (``stage="decode"``) not prefill-only."""
        out = []
        for tid, rep in self.replica_items():
            if tid == source_rid or rep is source:
                continue
            if target_rid is not None and tid != target_rid:
                continue
            if stage == "decode" and getattr(rep, "role", "mixed") == "prefill":
                continue
            if not rep.healthy or rep.draining or rep.recovering:
                continue
            if hasattr(rep, "adopt_request"):
                out.append((tid, rep))
        return out

    def _adopted(self, req, tid: int, rep) -> None:
        """Book a successful adoption on the target and the intent map."""
        stats = getattr(rep, "stats", None)
        if stats is not None:
            stats.incr("slots_migrated")
        self._repin_prefix(req, tid)

    def _evacuate(self, rid: int, source, timeout_s: float,
                  target_rid: Optional[int] = None) -> int:
        """Export the source's requests and adopt each on a sibling. An
        export failure re-raises (the source re-adopted everything); an
        adoption failure tries the next sibling, and when every sibling
        refuses, the source adopts the request back and finishes it. Each
        request lands on exactly one engine."""
        moved = 0
        for req in source.export_requests(timeout=timeout_s):
            ranked = sorted(self._candidates(rid, source, target_rid),
                            key=lambda c: (c[1].queue_depth + c[1].live_slots, c[0]))
            for tid, rep in ranked:
                try:
                    rep.adopt_request(req)
                except Exception:  # the next sibling
                    continue
                self._adopted(req, tid, rep)
                self.recorder.record("migrate", request=req.id, source=rid, target=tid)
                moved += 1
                break
            else:
                source.adopt_request(req)  # bypasses the draining gate by design
                self.recorder.record("migrate_fallback", request=req.id, source=rid)
        return moved

    def _handoff(self, source_rid: int, req) -> bool:
        """Place one freshly prefilled request on a decode-capable sibling
        (the prefill replica's ``handoff`` hook, on its worker thread, so it
        never waits on another worker). Siblings sharing the source's host
        tier come first (they restore the spilled blocks; any other must
        prefill again), then the least busy. True once one adopted."""
        source = self._by_id.get(source_rid)
        tier = getattr(source, "_host_tier", None)
        ranked = sorted(
            self._candidates(source_rid, source, stage="decode"),
            key=lambda c: (0 if tier is not None and getattr(c[1], "_host_tier", None) is tier
                           else 1, c[1].queue_depth + c[1].live_slots, c[0]))
        for tid, rep in ranked:
            try:
                rep.adopt_request(req)
            except Exception:  # the next sibling
                continue
            self._adopted(req, tid, rep)
            self.recorder.record("handoff", request=req.id, source=source_rid, target=tid)
            return True
        return False

    def _repin_prefix(self, req, target_rid: int) -> None:
        """Point the intent map at the adopter: the conversation's next requests
        should land where its blocks now are."""
        keys = self._keys(list(req.prompt) + list(req.preempted_tokens), req.adapter)
        with self._lock:
            self._remember(keys, target_rid)

    def _remember(self, keys: List[bytes], rid: int) -> None:
        """Route ``keys`` to ``rid`` in the intent map (caller holds the
        lock)."""
        for key in keys:
            self._prefix_home[key] = rid
            self._prefix_home.move_to_end(key)
        while len(self._prefix_home) > self._prefix_cap:
            self._prefix_home.popitem(last=False)

    def _fold_retired(self, rep) -> None:
        """Add a retiring replica's final counters, shed and waste maps,
        histograms and SLO slices to the fleet's accumulators."""
        stats = getattr(rep, "stats", None)
        slices = getattr(rep, "slo_slices", None)
        snap = stats.snapshot() if stats is not None else None
        with self._lock:
            if snap is not None:
                for key in ServingStats.COUNTERS:
                    self._retired_counters[key] = (self._retired_counters.get(key, 0)
                                                   + int(snap.get(key, 0)))
                for into, field in ((self._retired_tiers, "requests_shed_by_tier"),
                                    (self._retired_waste, "wasted_tokens_by_reason")):
                    for k, n in (snap.get(field) or {}).items():
                        into[k] = into.get(k, 0) + int(n)
                for name in ServingStats.HISTOGRAM_SPECS:
                    h = stats.hist[name]
                    self._retired_hist.setdefault(name, Histogram(h.bounds)).merge(h)
                _add_tenants(self._retired_tenants, snap.get("per_tenant") or {})
                _merge_tenant_histograms(self._retired_tenant_hist, stats.tenant_histograms())
            if slices is not None:
                self._retired_slices.append(slices)

    # -------------------------------------------------------------- routing

    def _keys(self, prompt_ids: Sequence[int], adapter: Optional[str] = None) -> List[bytes]:
        if self._block_len <= 0:
            return []
        return prefix_block_keys(prompt_ids, self._block_len, adapter)

    def _home_run(self, keys: List[bytes], rid: int) -> int:
        """Leading keys last routed to ``rid`` (caller holds the lock)."""
        n = 0
        for key in keys:
            if self._prefix_home.get(key) != rid:
                break
            n += 1
        return n

    def _route(self, keys: List[bytes], excluded: frozenset, adapter: Optional[str] = None,
               best_effort: bool = False) -> Optional[Placement]:
        """One placement: views, score, and the router's state committed at
        decision time (a same-prefix burst must see the first request's
        intent while it is still queued)."""
        views = []
        for i, rep in self.replica_items():
            if i in excluded:
                continue
            with self._lock:
                home = self._home_run(keys, i)
            views.append(ReplicaView(
                index=i, healthy=rep.healthy, draining=rep.draining,
                recovering=rep.recovering or bool(getattr(rep, "swap_pending", False)),
                queue_depth=rep.queue_depth, live_slots=rep.live_slots, slots=rep.slot_count,
                prefix_hits=max(rep.prefix_match_len(keys) if keys else 0, home),
                # a replica holding the tenant's adapter skips the load and
                # cannot evict a neighbour tenant's slot
                adapter_hits=int(adapter is not None
                                 and getattr(rep, "adapter_resident", None) is not None
                                 and rep.adapter_resident(adapter)),
                brownout_stage=int(getattr(rep, "brownout_stage", 0) or 0),
                role=str(getattr(rep, "role", "mixed") or "mixed"),
            ))
        with self._lock:
            placement = choose_replica(self.routing, views, self._rr_seq,
                                       best_effort=best_effort, stage="prefill")
            if placement is None:
                return None
            self._rr_seq += 1
            self._counters[f"requests_routed_{placement.reason}"] += 1
            self._placements.append((placement.index, placement.reason))
            self._remember(keys, placement.index)
        return placement

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    def recent_placements(self) -> List[Tuple[int, str]]:
        """The last placements as (replica id, reason)."""
        with self._lock:
            return list(self._placements)

    # ------------------------------------------------------------- dispatch

    def _exhausted_error(self, overflowed: Dict[int, QueueOverflowError],
                         last_err: Optional[BaseException]) -> BaseException:
        """No candidate left: the fleet's answer."""
        items = self.replica_items()
        if not any(rep.healthy for _, rep in items):
            err: ServingError = NoHealthyReplicaError(
                f"all {len(items)} replicas are terminally dead (circuit open or fatal); the pod "
                "needs a recycle")
            err.__cause__ = last_err
            return err
        admitting = {i: rep for i, rep in items if rep.healthy and not rep.draining}
        # the soonest any still-serving replica can take the retry
        retry_after = min((rep.predicted_drain_s() for rep in admitting.values()), default=None)
        if admitting and set(admitting) <= set(overflowed):
            self._count("requests_shed_fleet_saturated")
            return QueueOverflowError(
                f"all {len(admitting)} serving replicas are saturated (every admission queue "
                "full)", retry_after_s=retry_after)
        if not admitting:
            return DrainingError(
                "fleet draining; admission closed on every replica",
                retry_after_s=last_err.retry_after_s if isinstance(last_err, ServingError)
                else None)
        if last_err is not None:
            return last_err
        return RetryableEngineError("no replica available (all mid-recovery); safe to retry",
                                    retry_after_s=retry_after)

    def _brownout_shed(self, excluded: set) -> Optional[BrownoutShedError]:
        """The fleet-wide best_effort 429 when every available replica left
        the candidate set for brownout stage 3; None otherwise."""
        browned = [rep for i, rep in self.replica_items()
                   if i not in excluded and rep.healthy and not rep.draining
                   and not rep.recovering and int(getattr(rep, "brownout_stage", 0) or 0) >= 3]
        if not browned:
            return None
        self._count("requests_shed_fleet_brownout")
        drains = [rep.predicted_drain_s() for rep in browned
                  if getattr(rep, "predicted_drain_s", None) is not None]
        return BrownoutShedError(
            f"all {len(browned)} available replica(s) in brownout stage 3: best_effort shed "
            "fleet-wide", retry_after_s=min(drains) if drains else None, tier="best_effort")

    def _dispatch(self, method: str, prompt_ids: Sequence[int], gen: GenerationConfig, seed: int,
                  timeout: Optional[float], priority: Optional[str] = None,
                  deadline_s: Optional[float] = None, adapter: Optional[str] = None):
        """Route, call the replica, and fail over until one serves or none
        is left; each replica is tried at most once, ``timeout`` spans all
        attempts, and a client deadline caps it. One RequestTrace, minted
        here, is marked by the router and adopted by every hop."""
        if deadline_s is not None:
            budget = deadline_s + DEADLINE_TIMEOUT_GRACE_S
            timeout = budget if timeout is None else min(timeout, budget)
        deadline = time.monotonic() + timeout if timeout is not None else None
        client_deadline = time.monotonic() + deadline_s if deadline_s is not None else None
        best_effort = priority == "best_effort"
        keys = self._keys(prompt_ids, adapter)
        trace = RequestTrace()
        excluded: set = set()
        overflowed: Dict[int, QueueOverflowError] = {}
        last_err: Optional[BaseException] = None
        while True:
            placement = self._route(keys, frozenset(excluded), adapter, best_effort=best_effort)
            if placement is None:
                shed = self._brownout_shed(excluded) if best_effort else None
                raise shed if shed is not None else self._exhausted_error(overflowed, last_err)
            trace.mark(f"router_decision replica={placement.index} policy={self.routing} "
                       f"reason={placement.reason} score={placement.score:g}")
            replica = self._by_id.get(placement.index)
            if replica is None:  # retired between the decision and here
                excluded.add(placement.index)
                trace.mark(f"failover replica={placement.index} error=retired")
                self._count("requests_failed_over")
                continue
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"fleet request not served within {timeout}s "
                                       f"({len(excluded)} replica(s) tried)")
            # scripted replicas keep bare signatures: pass what they declare
            kwargs = dict(seed=seed, timeout=remaining)
            if priority is not None:
                kwargs["priority"] = priority
            if client_deadline is not None:
                kwargs["deadline_s"] = max(client_deadline - time.monotonic(), 0.001)
            if adapter is not None:  # only when named: bare replicas keep their signature
                kwargs["adapter"] = adapter
            if getattr(replica, "SUPPORTS_TRACE", False):
                kwargs["trace"] = trace
            try:
                return getattr(replica, method)(prompt_ids, gen, **kwargs)
            except QueueOverflowError as e:
                overflowed[placement.index] = e
                excluded.add(placement.index)
                last_err = e
                trace.mark(f"reroute_overflow replica={placement.index}")
                self._count("requests_rerouted_overflow")
            except _FAILOVER_ERRORS as e:
                excluded.add(placement.index)
                last_err = e
                trace.mark(f"failover replica={placement.index} error={type(e).__name__}")
                self._count("requests_failed_over")

    # ------------------------------------------------------- engine surface

    def submit(self, prompt_ids: Sequence[int], gen: GenerationConfig, seed: int = 0,
               timeout: Optional[float] = None, priority: Optional[str] = None,
               deadline_s: Optional[float] = None, adapter: Optional[str] = None) -> List[int]:
        return self.submit_full(prompt_ids, gen, seed, timeout, priority=priority,
                                deadline_s=deadline_s, adapter=adapter).result

    def submit_full(self, prompt_ids: Sequence[int], gen: GenerationConfig, seed: int = 0,
                    timeout: Optional[float] = None, priority: Optional[str] = None,
                    deadline_s: Optional[float] = None, adapter: Optional[str] = None):
        """A blocking request with placement and failover. ``deadline_s``
        bounds the whole attempt; a DeadlineExceededError is final.
        ``adapter`` names the tenant's LoRA adapter (routed to a replica
        holding it when one does)."""
        return self._dispatch("submit_full", prompt_ids, gen, seed, timeout, priority=priority,
                              deadline_s=deadline_s, adapter=adapter)

    def stream(self, prompt_ids: Sequence[int], gen: GenerationConfig, seed: int = 0,
               timeout: Optional[float] = None, priority: Optional[str] = None,
               deadline_s: Optional[float] = None,
               adapter: Optional[str] = None) -> Iterator[int]:
        """A streaming request: admission refusals fail over as in
        ``submit``; once the iterator is out, a failure reaches the caller
        (replaying would send tokens twice)."""
        return self._dispatch("stream", prompt_ids, gen, seed, timeout, priority=priority,
                              deadline_s=deadline_s, adapter=adapter)

    def begin_drain(self) -> None:
        for rep in self.replicas:
            rep.begin_drain()

    def wait_drained(self, timeout_s: float, poll_s: float = 0.05) -> bool:
        """True when every replica drained within the shared timeout; the
        replicas drain concurrently, so N timeouts do not stack."""
        results: List[bool] = []
        threads = [threading.Thread(target=lambda r=rep: results.append(
            r.wait_drained(timeout_s, poll_s)), daemon=True) for rep in self.replicas]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return len(results) == len(threads) and all(results)

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop every replica's worker once its queued work is served."""
        for rep in self.replicas:
            close = getattr(rep, "close", None)
            if close is not None:
                close(timeout)

    @property
    def healthy(self) -> bool:
        """Serving while any replica serves."""
        return any(rep.healthy for rep in self.replicas)

    @property
    def draining(self) -> bool:
        return all(rep.draining for rep in self.replicas)

    @property
    def circuit_state(self) -> str:
        """"closed" while any replica serves, else the worst terminal kind."""
        states = [rep.circuit_state for rep in self.replicas]
        if "closed" in states:
            return "closed"
        return "open" if "open" in states else "fatal"

    @property
    def terminal_error(self) -> Optional[ServingError]:
        if self.healthy:
            return None
        return next((rep.terminal_error for rep in self.replicas
                     if rep.terminal_error is not None), None)

    # ----------------------------------------------------------------- stats

    def merged_histograms(self) -> Dict[str, Histogram]:
        """The fleet's latency histograms: exact merges of the replicas'
        and of what retired replicas observed."""
        out: Dict[str, Histogram] = {}
        for name in ServingStats.HISTOGRAM_SPECS:
            hists = [rep.stats.hist[name] for rep in self.replicas]
            if name in self._retired_hist:
                hists.append(self._retired_hist[name])
            merged = Histogram(hists[0].bounds)
            for h in hists:
                merged.merge(h)
            out[name] = merged
        return out

    def merged_tenant_histograms(self) -> Dict[str, Dict[str, Histogram]]:
        """Each tenant's latency histograms merged exactly over the replicas
        its traffic landed on, retired ones included."""
        out: Dict[str, Dict[str, Histogram]] = {}
        sources = [rep.stats.tenant_histograms() for rep in self.replicas]
        with self._lock:
            sources.append({t: dict(h) for t, h in self._retired_tenant_hist.items()})
        for tenant_hists in sources:
            _merge_tenant_histograms(out, tenant_hists)
        return out

    def slo_report(self) -> dict:
        """The merged burn-rate report and each replica's (``GET /v1/slo``)."""
        per = {str(i): rep.slo_report() for i, rep in self.replica_items()}
        merged = SloPolicy.merge_reports(list(per.values()))
        merged["per_replica"] = per
        return merged

    def history(self, metric: str, window_s=None) -> dict:
        """Each replica's trailing series of one metric (``GET
        /v1/history``): the rings sample on their own clocks."""
        per = {str(i): rep.history(metric, window_s) for i, rep in self.replica_items()}
        first = next(iter(per.values()))
        return {"metric": metric, "kind": first["kind"], "window_s": first["window_s"],
                "replicas": per}

    def memory_breakdown(self) -> dict:
        """Weight fields once (the replicas share the weights), KV pool
        fields summed (each replica owns its pool)."""
        per = [rep.memory_breakdown() for rep in self.replicas]

        def kv_saved(m: dict) -> int:
            # an int8 pool saves its codes' bytes against bf16, less scales
            return m["kv_pool_bytes"] - m["kv_scale_bytes"] if m["kv_scale_bytes"] > 0 else 0

        first = per[0]
        return {
            "weight_bytes": first["weight_bytes"],
            "kv_pool_bytes": sum(m["kv_pool_bytes"] for m in per),
            "kv_scale_bytes": sum(m["kv_scale_bytes"] for m in per),
            "bytes_saved_vs_bf16": (first["bytes_saved_vs_bf16"] - kv_saved(first)
                                    + sum(kv_saved(m) for m in per)),
        }

    def stats_snapshot(self) -> dict:
        """The fleet's view and a ``per_replica`` map (``/v1/stats``): the
        JAX fleet's keys but ``compile``."""
        per = {str(i): {"replica": i, **rep.stats_snapshot()} for i, rep in self.replica_items()}
        snaps = list(per.values())
        with self._lock:
            retired_counters = dict(self._retired_counters)
            retired_tiers = dict(self._retired_tiers)
            retired_waste = dict(self._retired_waste)
            retired_count = self._retired_count
            retired_slices = list(self._retired_slices)
            retired_tenants = {t: dict(rec) for t, rec in self._retired_tenants.items()}
            counters = dict(self._counters)
        agg: dict = {}
        for key in ServingStats.COUNTERS:  # every replica that ever served
            agg[key] = sum(s[key] for s in snaps) + retired_counters.get(key, 0)
        for key in ServingStats.GAUGES:
            vals = [s[key] for s in snaps]
            agg[key] = max(vals) if key in _MAX_GAUGES else sum(vals)
        agg["tokens_per_s_1m"] = sum(s["tokens_per_s_1m"] for s in snaps)
        agg["uptime_s"] = max(s["uptime_s"] for s in snaps)
        agg["slots"] = sum(s["slots"] for s in snaps)
        agg["slot_occupancy"] = agg["live_slots"] / agg["slots"] if agg["slots"] else 0.0
        if all("total_blocks" in s for s in snaps):
            total = agg["total_blocks"] = sum(s["total_blocks"] for s in snaps)
            agg["block_pool_occupancy"] = agg["blocks_in_use"] / total if total else 0.0
            agg["peak_block_pool_occupancy"] = agg["peak_blocks_in_use"] / total if total else 0.0
        agg["prefix_hit_rate"] = (agg["prefix_tokens_reused"] / agg["prompt_tokens"]
                                  if agg["prompt_tokens"] else 0.0)
        agg["draft_acceptance_rate"] = (agg["draft_tokens_accepted"] / agg["draft_tokens_proposed"]
                                        if agg["draft_tokens_proposed"] else 0.0)
        agg["mean_tokens_per_step"] = (agg["tokens_served"] / agg["decode_steps"]
                                       if agg["decode_steps"] else 0.0)
        # a tenant's records sum over the replicas its traffic landed on
        for s in snaps:
            _add_tenants(retired_tenants, s.get("per_tenant") or {})
        agg["per_tenant"] = retired_tenants
        by_tier = {t: 0 for t in ServingStats.SHED_TIERS}
        waste = {r: 0 for r in ServingStats.WASTE_REASONS}
        for into, field, retired in ((by_tier, "requests_shed_by_tier", retired_tiers),
                                     (waste, "wasted_tokens_by_reason", retired_waste)):
            for src in [retired] + [s.get(field) or {} for s in snaps]:
                for k, n in src.items():
                    into[k] = into.get(k, 0) + int(n)
        agg["requests_shed_by_tier"] = by_tier
        agg["wasted_tokens_by_reason"] = waste
        emitted = agg["goodput_tokens"] + sum(waste.values())
        agg["goodput_fraction"] = agg["goodput_tokens"] / emitted if emitted else 1.0
        agg["histograms"] = {name: h.summary() for name, h in self.merged_histograms().items()}
        # utilization is per device, not additive: the busiest replica's
        for key in ("model_flops_utilization", "hbm_bandwidth_utilization"):
            agg[key] = max((s.get(key, 0.0) for s in snaps), default=0.0)
        agg["slo"] = SloPolicy.merge_reports([s.get("slo") for s in snaps if s.get("slo")])
        agg["per_generation"] = GenerationSlices.merged_summaries(
            [rep.slo_slices for rep in self.replicas if getattr(rep, "slo_slices", None)]
            + retired_slices)
        agg["circuit_state"] = self.circuit_state
        agg["draining"] = self.draining
        agg["replicas"] = len(snaps)
        agg["replicas_retired"] = retired_count
        agg["routing"] = self.routing
        reps = self.replicas
        agg["healthy_replicas"] = sum(1 for rep in reps if rep.healthy)
        agg["available_replicas"] = sum(
            1 for rep in reps if rep.healthy and not rep.draining and not rep.recovering)
        # the stage split of tokens by replica role (live replicas)
        by_role: Dict[str, Dict[str, int]] = {}
        for s in snaps:
            rec = by_role.setdefault(str(s.get("role", "mixed")),
                                     {"replicas": 0, "prefill_tokens": 0, "decode_tokens": 0})
            rec["replicas"] += 1
            rec["prefill_tokens"] += int(s.get("prefill_tokens", 0))
            rec["decode_tokens"] += int(s.get("decode_tokens", 0))
        agg["tokens_by_role"] = by_role
        roles = set(by_role)
        agg["role"] = roles.pop() if len(roles) == 1 else ("disaggregated" if roles else "mixed")
        agg.update(counters)
        agg["per_replica"] = per
        return agg

    def capacity_report(self, horizon_s: float = 60.0, min_replicas: int = 1,
                        max_replicas: Optional[int] = None) -> dict:
        """The capacity view of the fleet (``GET /v1/capacity``, the
        autoscaler's input): the replicas' forecasts summed, their
        sustainable throughput, headroom and the replica recommendation
        (``observe/capacity.report_from_capacity_snapshots``)."""
        snaps = [rep.capacity_snapshot() for _, rep in self.replica_items()
                 if getattr(rep, "capacity_snapshot", None) is not None]
        return report_from_capacity_snapshots(snaps, len(self._by_id), model=self._saturation,
                                              horizon_s=horizon_s, min_replicas=min_replicas,
                                              max_replicas=max_replicas)
