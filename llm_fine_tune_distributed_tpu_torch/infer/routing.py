"""Fleet routing policy (counterpart of the JAX ``infer/routing.py``): pure
placement scoring over replica snapshots, with no device state and no side
effects, so placement is unit-testable and, given the same request stream,
deterministic.

- ``prefix_block_keys`` is the one implementation of the cumulative-token
  block keys the paged engine's prefix cache indexes by
  (``infer/paged.PrefixCache`` delegates to it), so the router scores
  affinity with the exact keys admission looks up.
- ``choose_replica`` scores a candidate set of ``ReplicaView`` snapshots
  under one of three policies:

  * ``prefix``: adapter residency first, then the longest resident
    prompt-prefix run; zero hits and ties fall through to least-loaded;
  * ``least-loaded``: smallest (queued + decoding) / slots;
  * ``round-robin``: strict rotation over the available replicas.

  Load ties break by rotation, not by lowest index, so equally idle
  replicas share first-touch traffic.

Degraded replicas (terminal, draining, mid-recovery) are excluded before
scoring; the fleet (``infer/fleet.py``) decides what that means end to end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

ROUTING_POLICIES = ("prefix", "least-loaded", "round-robin")

# Replica roles for disaggregated prefill/decode serving. A ``mixed``
# replica interleaves chunked prefill with decode ticks (the historical
# behavior); a ``prefill`` replica runs prompts to first-token and hands
# the live request off to a decode-capable replica; a ``decode`` replica
# only adopts handed-off requests and runs plain decode. New requests
# route to prefill-capable replicas (prefill or mixed); handoffs land on
# decode-capable ones (decode or mixed).
REPLICA_ROLES = ("mixed", "prefill", "decode")


def prefix_block_keys(prompt: Sequence[int], block_len: int,
                      adapter: Optional[str] = None) -> List[bytes]:
    """One key per FULL leading prompt block: the raw bytes of the prompt's
    first ``(i+1) * block_len`` tokens as int32 (cumulative, so key i
    matches iff every token through the end of block i matches — exact
    match, never a hash). Shared by PrefixCache (cache index), the host
    tier and the fleet router (affinity scoring); a partial trailing block
    gets no key.

    ``adapter``: a tenant's LoRA adapter changes ``k_proj`` and ``v_proj``,
    so its blocks hold other K/V than the base model's for the same tokens.
    Its keys are salted with its name (``name + b"\\0"`` before the token
    bytes), so a tenant never reuses blocks cached under the base model or
    another tenant. A base request (None) keeps the JAX package's keys. The
    JAX function has no salt, and its paged engine does reuse them.
    """
    L = int(block_len)
    if L <= 0:
        raise ValueError(f"block_len must be positive, got {block_len}")
    n = len(prompt) // L
    arr = np.asarray(list(prompt[: n * L]), np.int32)
    salt = adapter.encode() + b"\0" if adapter is not None else b""
    return [salt + arr[: (i + 1) * L].tobytes() for i in range(n)]


@dataclass
class ReplicaView:
    """Point-in-time routing snapshot of one replica (plain ints/bools read
    off the engine under the GIL — no locks, no device state)."""

    index: int
    healthy: bool = True
    draining: bool = False
    recovering: bool = False
    queue_depth: int = 0
    live_slots: int = 0
    slots: int = 1
    prefix_hits: int = 0  # leading full prompt blocks resident on this replica
    adapter_hits: int = 0  # 1 if the request's adapter is resident here
    # overload control: the replica's brownout stage (0 healthy .. 3
    # shedding best_effort). Stage-3 replicas leave the candidate set for
    # best_effort requests — the router sheds that tier fleet-wide before
    # each engine's own admission gate has to
    brownout_stage: int = 0
    # disaggregation: one of REPLICA_ROLES. Decode-only replicas leave the
    # candidate set for new requests (stage="prefill"); if that empties
    # the set the filter is dropped and the fleet degrades to mixed
    # placement rather than going dead.
    role: str = "mixed"

    @property
    def available(self) -> bool:
        """In the candidate set: serving, admitting, not mid-restart."""
        return self.healthy and not self.draining and not self.recovering

    @property
    def load(self) -> float:
        """Backlog pressure normalized by capacity: (queued + decoding) per
        slot — the quantity the admission Retry-After estimate scales by."""
        return (self.queue_depth + self.live_slots) / max(1, self.slots)


@dataclass(frozen=True)
class Placement:
    """A routing decision: which replica, which rule decided, and the
    winning rule's score — what the fleet stamps into the request trace's
    router span."""

    index: int
    # "adapter_affinity" | "prefix_affinity" | "least_loaded" | "round_robin"
    reason: str
    # affinity strength under the deciding rule: resident prefix blocks
    # (prefix_affinity), adapter residency 0/1 (adapter_affinity),
    # negative load (least_loaded — higher is still better), 0 for
    # round-robin. Deterministic in (policy, views, rr_seq) like the rest
    # of the decision.
    score: float = 0.0


def choose_replica(
    policy: str,
    views: Sequence[ReplicaView],
    rr_seq: int = 0,
    best_effort: bool = False,
    stage: str = "prefill",
) -> Optional[Placement]:
    """Deterministic placement over the available views; None if none are.

    ``rr_seq`` is the router's monotonically increasing placement counter;
    it drives the round-robin rotation AND breaks exact load ties under
    the other policies, so the decision is a pure function of
    (policy, views, rr_seq, best_effort, stage). ``best_effort`` requests
    also exclude stage-3 brownout replicas (fleet-wide tier shedding);
    higher tiers route through brownout normally. ``stage`` is which phase
    the placed work enters: ``"prefill"`` (a new request — decode-only
    replicas are excluded) or ``"decode"`` (a post-prefill handoff —
    prefill-only replicas are excluded). The role filter is best-effort:
    if it would empty the candidate set (e.g. an all-decode fleet), it is
    dropped and placement degrades to mixed behavior instead of None.
    """
    if policy not in ROUTING_POLICIES:
        raise ValueError(
            f"unknown routing policy {policy!r}; choose from {ROUTING_POLICIES}"
        )
    if stage not in ("prefill", "decode"):
        raise ValueError(f"unknown stage {stage!r}; choose 'prefill' or 'decode'")
    cands = [v for v in views if v.available]
    if best_effort:
        cands = [v for v in cands if v.brownout_stage < 3]
    excluded_role = "decode" if stage == "prefill" else "prefill"
    staged = [v for v in cands if v.role != excluded_role]
    if staged:
        cands = staged
    if not cands:
        return None
    if policy == "round-robin":
        return Placement(cands[rr_seq % len(cands)].index, "round_robin")
    reason = "least_loaded"
    if policy == "prefix":
        if any(v.adapter_hits > 0 for v in cands):
            # adapter residency outranks prefix residency: an adapter miss
            # pays a disk hot-load and may evict a neighbor tenant's slot
            cands = [v for v in cands if v.adapter_hits > 0]
            reason = "adapter_affinity"
        best_hits = max(v.prefix_hits for v in cands)
        if best_hits > 0:
            cands = [v for v in cands if v.prefix_hits == best_hits]
            if reason == "least_loaded":
                reason = "prefix_affinity"
    min_load = min(v.load for v in cands)
    tied = [v for v in cands if v.load == min_load]
    chosen = tied[rr_seq % len(tied)]
    if reason == "prefix_affinity":
        score = float(chosen.prefix_hits)
    elif reason == "adapter_affinity":
        score = float(chosen.adapter_hits)
    else:
        score = -min_load
    return Placement(chosen.index, reason, score)
