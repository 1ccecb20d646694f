"""The port's fleet router and replica set (``infer/routing.py``,
``infer/fleet.py``) against the JAX package's, case by case as
``tests/test_fleet.py`` pins them (the ``tiny`` preset in f32, the same
weights in both):

- ``prefix_block_keys`` is the prefix cache's key function, and
  ``choose_replica`` gives the JAX function's placement for the same views,
  sequence and policy;
- on scripted replicas, overflow reroutes, the fleet-wide 429 quotes the
  smallest predicted drain, failover resettles, a timeout never fails over,
  and losing every replica maps to the JAX fleet's error, with its counters;
- on the tiny model, two fleets fed the same stream place it the same (and
  as the JAX fleet places it), prefix affinity follows the replica's cache,
  a replica that dies sheds its queue to the survivor with solo tokens,
  drain fans out, and the snapshot's sums and maxima hold;
- adapter residency outranks prefix depth in placement, and a tenant's
  requests follow its adapter to the one replica that loaded it, with the
  fleet's per-tenant merge and router counter the JAX fleet's; a tenant's
  affinity keys are salted with its adapter's name (base keys unchanged).
"""

import threading
import time

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer import errors as port_errors
from llm_fine_tune_distributed_tpu_torch.infer.engine import PagedContinuousBatchingEngine
from llm_fine_tune_distributed_tpu_torch.infer.fleet import EngineFleet
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator
from llm_fine_tune_distributed_tpu_torch.infer.paged import BlockAllocator, PrefixCache
from llm_fine_tune_distributed_tpu_torch.infer.routing import (
    ROUTING_POLICIES,
    ReplicaView,
    choose_replica,
    prefix_block_keys,
)
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.observe.metrics import ServingStats

TIMEOUT = 240


def _jax():
    from llm_fine_tune_distributed_tpu.infer import errors, routing
    from llm_fine_tune_distributed_tpu.infer.fleet import EngineFleet as JaxFleet
    from llm_fine_tune_distributed_tpu.infer.sampling import GenerationConfig as JaxConfig
    from llm_fine_tune_distributed_tpu.observe.metrics import ServingStats as JaxStats

    return dict(fleet=JaxFleet, errors=errors, routing=routing, stats=JaxStats, config=JaxConfig)


PORT = dict(fleet=EngineFleet, errors=port_errors, stats=ServingStats, config=GenerationConfig)


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port's Generator on the same weights (JAX PRNGKey(0))
    with each package's paged engine and fleet."""
    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTok
    from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
    from llm_fine_tune_distributed_tpu.infer.engine import (
        PagedContinuousBatchingEngine as JaxPaged,
    )
    from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_get_preset
    from llm_fine_tune_distributed_tpu.models.transformer import init_params as jax_init_params
    from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax

    jmc = jax_get_preset("tiny")
    jparams = jax_init_params(jax.random.PRNGKey(0), jmc, dtype=jnp.float32)
    jgen = JaxGenerator(jparams, jmc, JaxTok(), compute_dtype=jnp.float32, eos_token_ids=[])
    mc = get_preset("tiny")
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jparams)).items()}
    gen = Generator(params_from_jax(flat, mc), mc, ByteChatMLTokenizer(),
                    compute_dtype=torch.float32, eos_token_ids=[], device="cpu")
    return {"jax": dict(_jax(), gen=jgen, paged=JaxPaged),
            "port": dict(PORT, gen=gen, paged=PagedContinuousBatchingEngine)}


def _greedy(side, n=6):
    return side["config"](max_new_tokens=n, do_sample=False)


def _prompts():
    tok = ByteChatMLTokenizer()
    return [tok.encode(t) for t in ("alpha", "beta bravo", "the quick brown fox")]


def _fleet(side, n=2, routing="prefix", **kw):
    """Paged replicas with test-speed supervision over the one generator."""
    kw.setdefault("restart_backoff_s", 0.01)
    kw.setdefault("restart_backoff_max_s", 0.02)
    return side["fleet"]([side["paged"](side["gen"], slots=4, buf_len=96, prompt_bucket=16,
                                        block_len=16, prefill_chunk=32, **kw)
                          for _ in range(n)], routing=routing)


def _close(fleet):
    if hasattr(fleet, "close"):  # the JAX fleet has no close(); its workers are daemons
        fleet.close()


def _both(pair, scenario, *args):
    return {name: scenario(pair[name], *args) for name in ("jax", "port")}


# ------------------------------------------------- shared prefix-key helper


def test_prefix_block_keys_shared_with_prefix_cache():
    """The cache's keys are the router's: cumulative, exact, no key for a
    partial block, and the JAX function's bytes."""
    routing = _jax()["routing"]
    cache = PrefixCache(BlockAllocator(8), block_len=4)
    prompt = list(range(11))
    keys = prefix_block_keys(prompt, 4)
    assert keys == routing.prefix_block_keys(prompt, 4)
    assert cache.block_keys(prompt) == keys
    assert len(keys) == 2 and keys[1].startswith(keys[0])
    other = prefix_block_keys([99] + prompt[1:], 4)
    assert other[0] != keys[0] and other[1] != keys[1]
    assert prefix_block_keys(prompt[:3], 4) == []


@pytest.mark.parametrize("block_len", [0, -4])
def test_prefix_block_keys_rejects_nonpositive_block_len(block_len):
    routing = _jax()["routing"]
    with pytest.raises(ValueError):
        routing.prefix_block_keys([1, 2, 3], block_len)
    with pytest.raises(ValueError):
        prefix_block_keys([1, 2, 3], block_len)


def test_prefix_cache_resident_run_is_read_only():
    """``resident_run`` counts leading cached keys, takes no references and
    leaves the LRU order alone, as the JAX cache's does."""
    from llm_fine_tune_distributed_tpu.infer import paged as jax_paged

    out = {}
    for name, (Alloc, Cache) in {"jax": (jax_paged.BlockAllocator, jax_paged.PrefixCache),
                                 "port": (BlockAllocator, PrefixCache)}.items():
        alloc = Alloc(8)
        cache = Cache(alloc, block_len=2)
        keys = prefix_block_keys([1, 2, 3, 4, 5, 6], 2)
        blocks = alloc.alloc(2)
        cache.insert(keys[:2], blocks)
        before = {bid: alloc.refcount(bid) for bid in blocks}
        runs = (cache.resident_run(keys), cache.resident_run(keys[:1]),
                cache.resident_run([b"missing"] + keys))
        same_refs = {bid: alloc.refcount(bid) for bid in blocks} == before
        evicted = []
        cache.evict(8, collect=evicted)  # the LRU order is still the insertion order
        out[name] = (runs, same_refs, [bid for _, bid in evicted])
    assert out["port"] == out["jax"] == ((2, 1, 0), True, [1, 2])


# ---------------------------------------------------- pure placement policy


def _views(cls, **overrides):
    base = [cls(index=i, slots=4) for i in range(3)]
    for i, kw in overrides.items():
        for k, v in kw.items():
            setattr(base[int(i)], k, v)
    return base


def _choose(policy, rr_seq=0, **overrides):
    """The port's placement, after checking the JAX function places the same
    views alike."""
    routing = _jax()["routing"]
    p = choose_replica(policy, _views(ReplicaView, **overrides), rr_seq)
    j = routing.choose_replica(policy, _views(routing.ReplicaView, **overrides), rr_seq)
    as_tuple = lambda x: None if x is None else (x.index, x.reason, x.score)  # noqa: E731
    assert as_tuple(p) == as_tuple(j)
    return p


def test_choose_replica_prefix_affinity_wins():
    p = _choose("prefix", **{"1": {"prefix_hits": 3}, "2": {"prefix_hits": 1}})
    assert (p.index, p.reason) == (1, "prefix_affinity")
    p = _choose("prefix", **{"0": {"queue_depth": 5}})
    assert p.reason == "least_loaded" and p.index in (1, 2)


def test_choose_replica_least_loaded_uses_queue_and_slots():
    loads = {"0": {"queue_depth": 2, "live_slots": 2}, "1": {"queue_depth": 0, "live_slots": 3},
             "2": {"queue_depth": 4, "live_slots": 4}}
    assert _choose("least-loaded", **loads).index == 1
    assert _choose("prefix", **loads).index == 1


def test_choose_replica_round_robin_rotates():
    assert [_choose("round-robin", s).index for s in range(6)] == [0, 1, 2, 0, 1, 2]
    assert _choose("round-robin", 1).reason == "round_robin"


def test_choose_replica_load_ties_rotate():
    assert {_choose("least-loaded", s).index for s in range(3)} == {0, 1, 2}


def test_choose_replica_excludes_degraded():
    degraded = {"0": {"healthy": False}, "1": {"recovering": True}, "2": {"draining": True}}
    assert _choose("prefix", **degraded) is None
    degraded["2"] = {}
    assert _choose("prefix", **degraded).index == 2
    assert _choose("prefix", 5, **degraded) == _choose("prefix", 5, **degraded)


def test_choose_replica_unknown_policy_raises():
    routing = _jax()["routing"]
    for choose, cls in ((choose_replica, ReplicaView),
                        (routing.choose_replica, routing.ReplicaView)):
        with pytest.raises(ValueError):
            choose("random", _views(cls))
    assert set(ROUTING_POLICIES) == set(routing.ROUTING_POLICIES) == {
        "prefix", "least-loaded", "round-robin"}


# ------------------------------------------- scripted-replica fleet dispatch


class _FakeResult:
    def __init__(self, result):
        self.result = result


class _FakeReplica:
    """The surface a fleet reads off a replica, with scripted failures."""

    block_len = 0

    def __init__(self, stats_cls, index, slots=2, drain_s=1.0, raises=None):
        self.index = index
        self.slot_count = slots
        self.drain_s = drain_s
        self.raises = raises  # raised on every submit
        self.healthy = True
        self.draining = False
        self.recovering = False
        self.queue_depth = 0
        self.live_slots = 0
        self.calls = 0
        self.circuit_state = "closed"
        self.stats = stats_cls(slots=slots)

    def predicted_drain_s(self):
        return self.drain_s

    def prefix_match_len(self, keys):
        return 0

    def stats_snapshot(self):
        return {**self.stats.snapshot(), "circuit_state": self.circuit_state,
                "draining": self.draining}

    def submit_full(self, prompt_ids, gen, seed=0, timeout=None):
        self.calls += 1
        if self.raises is not None:
            raise self.raises
        return _FakeResult(list(prompt_ids) + [self.index])


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - both packages' taxonomies
        return (type(e).__name__, getattr(e, "retry_after_s", None))


def _scripted(side, script):
    """Run ``script(fleet_cls, make, errors, greedy)`` for one package."""
    make = lambda *a, **kw: _FakeReplica(side["stats"], *a, **kw)  # noqa: E731
    return script(side["fleet"], make, side["errors"], _greedy(side))


def _scripted_both(script):
    out = {"jax": _scripted(_jax(), script), "port": _scripted(PORT, script)}
    assert out["port"] == out["jax"]
    return out["port"]


def test_idle_sibling_absorbs_overflow_never_429():
    def script(Fleet, make, errors, g):
        full = make(0, raises=errors.QueueOverflowError("full", retry_after_s=9.0))
        idle = make(1)
        fleet = Fleet([full, idle], routing="round-robin")
        out = fleet.submit([1, 2, 3], g, timeout=5)
        snap = fleet.stats_snapshot()
        return (out, full.calls, idle.calls, snap["requests_rerouted_overflow"],
                snap["requests_shed_fleet_saturated"])

    assert _scripted_both(script) == ([1, 2, 3, 1], 1, 1, 1, 0)


def test_all_saturated_429_quotes_minimum_drain():
    def script(Fleet, make, errors, g):
        slow = make(0, drain_s=7.0, raises=errors.QueueOverflowError("full", retry_after_s=7.0))
        fast = make(1, drain_s=2.0, raises=errors.QueueOverflowError("full", retry_after_s=2.0))
        fleet = Fleet([slow, fast], routing="round-robin")
        out = _outcome(lambda: fleet.submit([1, 2, 3], g, timeout=5))
        return out, slow.calls, fast.calls, fleet.stats_snapshot()["requests_shed_fleet_saturated"]

    assert _scripted_both(script) == (("QueueOverflowError", 2.0), 1, 1, 1)


def test_failover_resettles_on_sibling():
    def script(Fleet, make, errors, g):
        fleet = Fleet([make(0, raises=errors.RetryableEngineError("restart casualty")), make(1)],
                      routing="round-robin")
        return fleet.submit([5], g), fleet.stats_snapshot()["requests_failed_over"]

    assert _scripted_both(script) == ([5, 1], 1)


def test_timeout_never_fails_over():
    def script(Fleet, make, errors, g):
        sibling = make(1)
        fleet = Fleet([make(0, raises=TimeoutError("deadline")), sibling], routing="round-robin")
        return _outcome(lambda: fleet.submit([5], g, timeout=5)), sibling.calls

    assert _scripted_both(script) == (("TimeoutError", None), 0)


def test_all_replicas_terminal_maps_to_no_healthy_replica():
    def script(Fleet, make, errors, g):
        fleet = Fleet([make(0), make(1)])
        for rep in fleet.replicas:
            rep.healthy = False
        return _outcome(lambda: fleet.submit([5], g)), fleet.healthy

    assert _scripted_both(script) == (("NoHealthyReplicaError", None), False)


def test_all_replicas_draining_maps_to_draining_error():
    def script(Fleet, make, errors, g):
        fleet = Fleet([make(0), make(1)])
        for rep in fleet.replicas:
            rep.draining = True
        return _outcome(lambda: fleet.submit([5], g)), fleet.draining

    assert _scripted_both(script) == (("DrainingError", None), True)


def test_all_replicas_recovering_is_retryable():
    def script(Fleet, make, errors, g):
        fleet = Fleet([make(0), make(1)])
        for rep in fleet.replicas:
            rep.recovering = True
        return _outcome(lambda: fleet.submit([5], g))

    assert _scripted_both(script) == ("RetryableEngineError", 1.0)  # the least predicted drain


def test_router_intent_map_groups_same_prefix_bursts():
    """The intent map commits at decision time: with every replica's cache
    cold for good, repeats of a routed prefix follow the first placement."""
    def script(Fleet, make, errors, g):
        reps = [make(0), make(1)]
        for rep in reps:
            rep.block_len = 4  # keys exist; caches never warm
        fleet = Fleet(reps, routing="prefix")
        a, b = [1, 2, 3, 4, 9], [7, 7, 7, 7, 9]
        for p in [a, b] * 4:
            fleet.submit(p, g)
        snap = fleet.stats_snapshot()
        return (fleet.recent_placements(), snap["requests_routed_prefix_affinity"],
                snap["requests_routed_least_loaded"])

    placements, affinity, least = _scripted_both(script)
    assert [i for i, _ in placements] == [0, 1] * 4
    assert [r for _, r in placements[2:]] == ["prefix_affinity"] * 6
    assert (affinity, least) == (6, 2)


def test_fleet_rejects_bad_config():
    for side in (_jax(), PORT):
        with pytest.raises(ValueError):
            side["fleet"]([], routing="prefix")
        with pytest.raises(ValueError):
            side["fleet"]([_FakeReplica(side["stats"], 0)], routing="hash-ring")


# ------------------------------------------------- real-model fleet behavior


def _settled(fleet, timeout_s=10.0):
    """Wait until no replica has queued or decoding work."""
    deadline = time.monotonic() + timeout_s
    while any(r.queue_depth or r.live_slots for r in fleet.replicas):
        assert time.monotonic() < deadline, "fleet never went idle"
        time.sleep(0.005)


STREAM = ("the quick brown fox jumps over the lazy dog",
          "pack my box with five dozen liquor jugs",
          "the quick brown fox jumps over the sleeping cat",
          "pack my box with five dozen jars",
          "the quick brown fox jumps over the lazy dog again")


def _determinism(side):
    tok = ByteChatMLTokenizer()
    stream = [tok.encode(t) for t in STREAM]
    fleets = [_fleet(side), _fleet(side)]
    outs = []
    for fleet in fleets:
        run = []
        for p in stream:
            _settled(fleet)  # a sequential, settled stream: reproducible views
            run.append(fleet.submit(p, _greedy(side), timeout=TIMEOUT))
        outs.append(run)
    placements = [f.recent_placements() for f in fleets]
    solo = [side["gen"].generate_ids(p, _greedy(side)) for p in stream]
    for f in fleets:
        _close(f)
    return {"outs": outs, "placements": placements, "solo": solo}


def test_routing_determinism_same_stream_same_placements(pair):
    """Two fleets built alike and fed the same sequential stream place it
    alike, as the JAX fleets place it, and greedy tokens equal solo runs."""
    out = _both(pair, _determinism)
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port["outs"][0] == port["outs"][1] == port["solo"]
    assert port["placements"][0] == port["placements"][1]
    assert {i for i, _ in port["placements"][0]} == {0, 1}
    assert "prefix_affinity" in {r for _, r in port["placements"][0]}


def _affinity(side):
    prompt = ByteChatMLTokenizer().encode(STREAM[0])
    fleet = _fleet(side)
    fleet._prefix_cap = 0  # no intent map: only the replicas' caches score
    first = fleet.submit(prompt, _greedy(side), timeout=TIMEOUT)
    home = fleet.recent_placements()[0][0]
    repeats = [fleet.submit(prompt, _greedy(side), timeout=TIMEOUT) for _ in range(2)]
    snap = fleet.stats_snapshot()
    _close(fleet)
    return {"first": first, "repeats": repeats, "home": home,
            "placements": fleet.recent_placements(),
            "reused": snap["prefix_tokens_reused"],
            "per": {k: snap["per_replica"][k]["prefix_tokens_reused"] for k in ("0", "1")}}


def test_prefix_affinity_follows_replica_cache(pair):
    """With the intent map off, a repeat routes back to the replica that
    prefilled its blocks and reads them as a cache hit."""
    out = _both(pair, _affinity)
    assert out["port"] == out["jax"]
    port, home = out["port"], out["port"]["home"]
    assert port["repeats"] == [port["first"]] * 2
    assert [i for i, _ in port["placements"]] == [home] * 3
    assert [r for _, r in port["placements"][1:]] == ["prefix_affinity"] * 2
    assert port["reused"] > 0 and port["per"][str(home)] > 0 and port["per"][str(1 - home)] == 0


def _crash(side):
    prompts = _prompts()
    solo = [side["gen"].generate_ids(p, _greedy(side)) for p in prompts]
    fleet = _fleet(side, routing="round-robin", circuit_threshold=1, circuit_window_s=60.0)
    victim, survivor = fleet.replicas
    victim.faults.fail_decode_next(10)  # its first tick dies, and again after a restart
    outcomes = [None] * len(prompts)

    def ask(i):
        outcomes[i] = _outcome(lambda: fleet.submit(prompts[i], _greedy(side), timeout=TIMEOUT))

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    hung = any(t.is_alive() for t in threads)
    snap = fleet.stats_snapshot()
    out = {"hung": hung, "outcomes": outcomes, "solo": solo,
           "pending": (victim._pending, survivor._pending),
           "health": (victim.healthy, survivor.healthy, fleet.healthy),
           "circuit": fleet.circuit_state, "failed_over": snap["requests_failed_over"] >= 1,
           "healthy_replicas": snap["healthy_replicas"]}
    fleet.submit(prompts[0], _greedy(side), timeout=TIMEOUT)
    out["last_on_survivor"] = fleet.recent_placements()[-1][0] == fleet.replicas.index(survivor)
    _close(fleet)
    return out


def test_replica_crash_sheds_queue_to_survivor(pair):
    """A replica that dies under load (circuit threshold 1): its requests
    resettle on the sibling, no waiter hangs, every answer is its solo run,
    and new work avoids the dead replica."""
    out = _both(pair, _crash)
    assert out["port"] == out["jax"]
    port = out["port"]
    assert not port["hung"]
    assert port["outcomes"] == [("ok", s) for s in port["solo"]]
    assert port["pending"] == (0, 0) and port["health"] == (False, True, True)
    assert port["circuit"] == "closed" and port["failed_over"]
    assert port["healthy_replicas"] == 1 and port["last_on_survivor"]


def _drain(side):
    fleet = _fleet(side)
    prompts = _prompts()
    warm = fleet.submit(prompts[0], _greedy(side), timeout=TIMEOUT) is not None
    fleet.begin_drain()
    refused = _outcome(lambda: fleet.submit(prompts[1], _greedy(side), timeout=5))[0]
    out = (warm, fleet.draining, refused, fleet.wait_drained(timeout_s=30.0))
    _close(fleet)
    return out


def test_fleet_drain_fans_out(pair):
    out = _both(pair, _drain)
    assert out["port"] == out["jax"] == (True, True, "DrainingError", True)


def _aggregate(side):
    fleet = _fleet(side)
    prompts = _prompts()
    for p in prompts:
        fleet.submit(p, _greedy(side), timeout=TIMEOUT)
    snap = fleet.stats_snapshot()
    _close(fleet)
    per = snap["per_replica"]
    return {
        "keys": sorted(per),
        "sums": {k: (snap[k], per["0"][k] + per["1"][k])
                 for k in ("tokens_served", "requests_completed", "prompt_tokens", "slots")},
        "generation": (snap["engine_generation"],
                       max(per["0"]["engine_generation"], per["1"]["engine_generation"])),
        "ttft": (snap["histograms"]["ttft_s"]["count"],
                 per["0"]["histograms"]["ttft_s"]["count"]
                 + per["1"]["histograms"]["ttft_s"]["count"]),
        "fleet": (snap["replicas"], snap["routing"], snap["healthy_replicas"],
                  snap["available_replicas"]),
        "routed": sum(snap[k] for k in ("requests_routed_prefix_affinity",
                                        "requests_routed_least_loaded",
                                        "requests_routed_round_robin")),
    }


def test_fleet_stats_aggregate_math(pair):
    """Counters sum, the generation is the max, merged histogram counts are
    the replicas' totals, as in the JAX fleet's snapshot."""
    out = _both(pair, _aggregate)
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port["keys"] == ["0", "1"]
    assert all(a == b for a, b in port["sums"].values())
    assert port["sums"]["tokens_served"][0] == len(_prompts()) * 6
    assert port["generation"][0] == port["generation"][1] and port["ttft"][0] == port["ttft"][1]
    assert port["fleet"] == (2, "prefix", 2, 2) and port["routed"] == len(_prompts())


# ------------------------------------------------- adapter-affinity routing


def test_choose_replica_adapter_affinity_outranks_prefix():
    """A replica holding the request's adapter wins against a deeper prefix
    run elsewhere; prefix depth orders the adapter-resident set; other
    policies ignore adapter residency (the JAX function's placements)."""
    p = _choose("prefix", **{"1": {"prefix_hits": 3}, "2": {"adapter_hits": 1}})
    assert (p.index, p.reason) == (2, "adapter_affinity")
    p = _choose("prefix", **{"0": {"adapter_hits": 1}, "1": {"adapter_hits": 1, "prefix_hits": 2},
                             "2": {"prefix_hits": 5}})
    assert (p.index, p.reason) == (1, "adapter_affinity")
    assert _choose("least-loaded", **{"2": {"adapter_hits": 1}}).reason == "least_loaded"


def test_tenant_prefix_keys_are_salted():
    """A tenant's keys are its adapter's name, a zero byte, then the JAX
    key bytes: they never equal the base model's or another tenant's, and
    the prefix cache and the router make the same ones."""
    prompt = list(range(11))
    base = prefix_block_keys(prompt, 4)
    acme = prefix_block_keys(prompt, 4, "acme")
    assert acme == [b"acme\0" + k for k in base]
    assert not set(acme) & set(base) and not set(acme) & set(prefix_block_keys(prompt, 4, "x"))
    assert PrefixCache(BlockAllocator(8), block_len=4).block_keys(prompt, "acme") == acme


def _tenant_affinity(side, adapter_dir):
    fleet = side["fleet"]([side["paged"](side["gen"], slots=4, buf_len=96, prompt_bucket=16,
                                         block_len=16, prefill_chunk=32,
                                         restart_backoff_s=0.01, restart_backoff_max_s=0.02,
                                         adapters=side["registry"](side["base"], adapter_dir,
                                                                   max_adapters=4))
                           for _ in range(2)], routing="prefix")
    try:
        prompts = _prompts()
        out = [list(fleet.submit(prompts[0], _greedy(side), timeout=TIMEOUT, adapter="acme"))]
        home = [i for i, rep in enumerate(fleet.replicas) if rep.adapter_resident("acme")]
        for p in prompts[1:]:
            out.append(list(fleet.submit(p, _greedy(side), timeout=TIMEOUT, adapter="acme")))
        after = [i for i, rep in enumerate(fleet.replicas) if rep.adapter_resident("acme")]
        placements = fleet.recent_placements()
        snap = fleet.stats_snapshot()
        fleet.submit(prompts[0], _greedy(side), timeout=TIMEOUT)  # a base request
        return {"tokens": out, "home": home, "after": after,
                "first": placements[0][1] in ("least_loaded", "prefix_affinity"),
                "later": [r for _, r in placements[1:]],
                "routed_adapter": snap["requests_routed_adapter_affinity"],
                "per_tenant": snap["per_tenant"], "adapters_resident": snap["adapters_resident"],
                "base_reason": fleet.recent_placements()[-1][1]}
    finally:
        _close(fleet)


def test_fleet_routes_tenant_back_to_adapter_resident_replica(pair, tmp_path):
    """The tenant's first request loads its adapter on one replica; every
    later one routes back there ("adapter_affinity"), so one load serves
    its whole stream; the fleet's per-tenant map sums the tokens; a base
    request never takes adapter affinity. The JAX fleet's record."""
    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.config import TrainConfig
    from llm_fine_tune_distributed_tpu.infer.adapters import AdapterRegistry as JaxRegistry
    from llm_fine_tune_distributed_tpu.parallel.lora import add_lora_params, save_lora_adapter
    from llm_fine_tune_distributed_tpu_torch.infer.adapters import AdapterRegistry

    jbase = pair["jax"]["gen"].params
    params = add_lora_params(jbase, jax.random.PRNGKey(7), rank=4, alpha=8.0)

    def bump(node):
        if isinstance(node, dict):
            if "lora_b" in node:
                return {**node, "lora_b": jnp.ones_like(node["lora_b"]) * 0.01}
            return {k: bump(v) for k, v in node.items()}
        return node

    save_lora_adapter(bump(params), str(tmp_path / "acme"),
                      TrainConfig(freeze_strategy="lora", lora_rank=4, lora_alpha=8.0))
    sides = {"jax": dict(pair["jax"], registry=JaxRegistry, base=jbase),
             "port": dict(pair["port"], registry=AdapterRegistry,
                          base=pair["port"]["gen"].params)}
    out = {name: _tenant_affinity(side, str(tmp_path)) for name, side in sides.items()}
    port = out["port"]
    assert len(port["home"]) == 1 and port["after"] == port["home"] and port["first"]
    assert port["later"] == ["adapter_affinity"] * (len(_prompts()) - 1)
    assert port["routed_adapter"] == len(_prompts()) - 1
    assert port["per_tenant"]["acme"] == {"requests": 3, "tokens": 18, "queue_depth": 0}
    assert port["adapters_resident"] == 1 and port["base_reason"] != "adapter_affinity"
    assert out["port"] == out["jax"]
