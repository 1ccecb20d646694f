"""The port's host KV tier, spill and restore, export and adopt, and live
migration across a fleet (``infer/paged.HostBlockTier``, the tier paths of
``infer/engine.py``, ``infer/fleet.EngineFleet.migrate_slot``) against the
JAX package's, case by case as ``tests/test_tiered_kv.py`` pins them, on the
``tiny`` preset in f32 with the same weights (JAX ``PRNGKey(0)``):

- the tier's LRU byte bound, refresh, refusals and fingerprints give the JAX
  tier's answers to the same script;
- a spill -> host -> restore round trip is bit-exact for f32 and int8 pools,
  and the port's entry holds the JAX engine's arrays, leaf by leaf in the
  JAX flatten order (same dtypes and shapes; values within the two forwards'
  f32 difference, codes within one step);
- a spill fault is a counted discard, an evicted prefix restores, and a
  restore fault or a tier miss prefills again, with the same tokens and
  counters as the JAX engine;
- export then adopt resumes a stream with its solo tokens, and fleet
  migration (``migrate_slot``, ``retire_replica`` with and without a
  migrate fault, several requests at once) settles each request on exactly
  one replica, with the JAX fleet's tokens and counters.

The tier cases run the same script on both packages' classes; the engine
and fleet cases run one scenario function on each package and compare what
it returns.
"""

import threading
import time

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from llm_fine_tune_distributed_tpu_torch.infer.fleet import EngineFleet
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator
from llm_fine_tune_distributed_tpu_torch.infer.paged import HostBlockTier
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset

TIMEOUT = 240
# a prompt spanning >= 2 full 16-token blocks, so spills have blocks to move
VICTIM_TEXT = "a forty-ish token victim prompt for host tier spills"


def _enc(text):
    return ByteChatMLTokenizer().encode(text)


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port's Generator on the same weights, each with its
    package's engine, fleet, tier and config classes."""
    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTok
    from llm_fine_tune_distributed_tpu.infer import EngineFleet as JaxFleet
    from llm_fine_tune_distributed_tpu.infer import GenerationConfig as JaxConfig
    from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
    from llm_fine_tune_distributed_tpu.infer.engine import (
        PagedContinuousBatchingEngine as JaxPaged,
    )
    from llm_fine_tune_distributed_tpu.infer.paged import HostBlockTier as JaxTier
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
    from llm_fine_tune_distributed_tpu.infer.engine import (
        ContinuousBatchingEngine as JaxContinuous,
    )

    return {
        "jax": dict(gen=jgen, paged=JaxPaged, continuous=JaxContinuous, fleet=JaxFleet,
                    tier=JaxTier, config=JaxConfig),
        "port": dict(gen=gen, paged=PagedContinuousBatchingEngine,
                     continuous=ContinuousBatchingEngine, fleet=EngineFleet, tier=HostBlockTier,
                     config=GenerationConfig),
    }


def _greedy(side, n):
    return side["config"](max_new_tokens=n, do_sample=False)


def _tiered(side, tier=None, **kw):
    kw = {"slots": 2, "buf_len": 256, "prompt_bucket": 64, "block_len": 16,
          "prefill_chunk": 256, **kw}
    return side["paged"](side["gen"],
                         host_tier=tier if tier is not None else side["tier"](64 << 20), **kw)


def _tiered_fleet(side, n=2, **fleet_kw):
    """A fleet of paged replicas sharing ONE tier: the sharing is the
    migration's transport."""
    tier = side["tier"](64 << 20)
    reps = [_tiered(side, tier=tier, slots=4, restart_backoff_s=0.01, restart_backoff_max_s=0.02)
            for _ in range(n)]
    return side["fleet"](reps, routing="prefix", **fleet_kw)


def _close(obj):
    if hasattr(obj, "close"):  # the JAX engines have no close(); their workers are daemons
        obj.close()


def _both(pair, scenario, *args):
    """``scenario(side, *args)`` on the JAX package, then on the port."""
    return {name: scenario(pair[name], *args) for name in ("jax", "port")}


def _counters(snap, keys=("prefix_blocks_spilled", "prefix_blocks_discarded",
                          "host_tier_restore_hits", "host_tier_restore_misses",
                          "slots_migrated", "requests_completed", "requests_failed")):
    return {k: snap[k] for k in keys}


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.005)


# ------------------------------------------------------------- tier unit


def _tier_lru_script(side):
    row = lambda fill: [np.full(128, fill, np.uint8), np.full(128, fill, np.uint8)]  # noqa: E731
    tier = side["tier"](1024)  # exactly 4 entries of 256 bytes
    keys = [bytes([i]) for i in range(5)]
    out = [tier.put(k, row(i)) for i, k in enumerate(keys[:4])]
    out.append((len(tier), tier.bytes_used))
    tier.get(keys[0])  # refresh: k0 is now the most recent
    out.append(tier.put(keys[4], row(4)))  # evicts k1, not k0
    out.append(tier.bytes_used)
    out.append([tier.get(k) is None for k in keys])
    out.append(tier.put(keys[0], row(9)))  # re-put refreshes in place
    out.append((tier.bytes_used, int(tier.get(keys[0])[0][0])))
    before = tier.bytes_used
    out.append((tier.put(b"huge", [np.zeros(4096, np.uint8)]), tier.bytes_used == before))
    out.append(side["tier"](0).put(b"k", row(0)))  # a disabled tier refuses everything
    tier.discard(keys[0])
    out.append(tier.get(keys[0]) is None)
    tier.clear()
    out.append((len(tier), tier.bytes_used))
    return out


def test_host_tier_lru_byte_bound_and_refresh(pair):
    out = _both(pair, _tier_lru_script)
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port[:4] == [True] * 4 and port[4] == (4, 1024)
    assert port[5] is True and port[6] <= 1024
    assert port[7] == [False, True, False, False, False]
    assert port[9] == (1024, 9) and port[10] == (False, True) and port[11] is False
    assert port[12] is True and port[13] == (0, 0)


def _tier_fingerprint_script(side):
    tier = side["tier"](1 << 20)
    rows = [np.arange(8, dtype=np.float32)]
    out = [tier.put(b"k1", rows, fingerprint=b"gen1"), tier.put(b"k2", rows, fingerprint=b"gen1")]
    # the right fingerprint restores; any other (None included) misses
    out += [tier.get(b"k1", fingerprint=b"gen1") is not None,
            tier.get(b"k1", fingerprint=b"gen2") is None, tier.get(b"k1") is None]
    out += [tier.resident_run([b"k1", b"k2"], fingerprint=b"gen1"),
            tier.resident_run([b"k1", b"k2"], fingerprint=b"gen2")]
    out.append(tier.put(b"k3", rows, fingerprint=b"gen2"))
    out.append(tier.resident_run([b"k1", b"k3"], fingerprint=b"gen1"))  # the leading run only
    return out


def test_host_tier_fingerprint_stale_reads_as_miss(pair):
    out = _both(pair, _tier_fingerprint_script)
    assert out["port"] == out["jax"] == [True, True, True, True, True, 2, 0, True, 1]


# ---------------------------------------------------- device round trip


def _round_trip(side, kv_quant):
    """gather -> tier -> scatter into fresh rows -> gather again."""
    eng = _tiered(side, kv_quant=kv_quant)
    prompt = _enc(VICTIM_TEXT)
    eng.submit(prompt, _greedy(side, 6), timeout=TIMEOUT)  # fills the pool and prefix cache
    keys = eng._prefix.block_keys(prompt)
    bids = eng._prefix.match(keys, limit=len(keys))
    assert len(bids) == len(keys) >= 2
    orig = [[np.array(a) for a in rows] for rows in eng._gather_blocks(bids)]
    eng._spill_to_tier(list(zip(keys, bids)))
    snap = eng.stats_snapshot()
    entries = [eng._host_tier.get(k, fingerprint=eng._weight_fingerprint) for k in keys]
    assert all(e is not None for e in entries)
    fresh = eng._allocator.alloc(len(keys))
    eng._scatter_blocks(fresh, entries)
    back = [[np.array(a) for a in rows] for rows in eng._gather_blocks(fresh)]
    for bid in list(fresh) + list(bids):
        eng._allocator.free(bid)
    _close(eng)
    return {"orig": orig, "back": back, "spilled": snap["prefix_blocks_spilled"],
            "discarded": snap["prefix_blocks_discarded"], "nkeys": len(keys),
            "entry_bytes": [sum(np.asarray(a).nbytes for a in e) for e in entries]}


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_spill_restore_round_trip_bit_exact(pair, kv_quant):
    """The restored rows equal the spilled ones bit for bit; for int8 the
    entry carries the codes AND their scales. The port's entry is the JAX
    engine's, leaf by leaf: same count, order, dtypes and shapes; f32 values
    within 1e-5 of the largest |value| (the two forwards' f32 difference),
    int8 codes within one step and scales within 1e-5 relative."""
    out = _both(pair, _round_trip, kv_quant)
    port, ref = out["port"], out["jax"]
    for side in (port, ref):
        assert side["spilled"] == side["nkeys"] and side["discarded"] == 0
        for back_rows, orig_rows in zip(side["back"], side["orig"]):
            assert len(back_rows) == len(orig_rows)
            for b, o in zip(back_rows, orig_rows):
                assert b.dtype == o.dtype
                np.testing.assert_array_equal(b, o)
    assert port["nkeys"] == ref["nkeys"] and port["entry_bytes"] == ref["entry_bytes"]
    if kv_quant == "int8":
        dtypes = {r.dtype for r in port["orig"][0]}
        assert np.dtype(np.int8) in dtypes and len(dtypes) >= 2
    for prow, jrow in zip(port["orig"], ref["orig"]):
        assert len(prow) == len(jrow)
        for p, j in zip(prow, jrow):
            assert p.dtype == j.dtype and p.shape == j.shape
            if p.dtype == np.int8:
                assert np.abs(p.astype(np.int32) - j.astype(np.int32)).max() <= 1
            elif kv_quant == "int8":  # a scale
                np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-7)
            else:
                np.testing.assert_allclose(p, j, rtol=0, atol=1e-5 * max(1.0, np.abs(j).max()))


def _spill_fault(side):
    eng = _tiered(side)
    prompt = _enc(VICTIM_TEXT)
    eng.submit(prompt, _greedy(side, 6), timeout=TIMEOUT)
    keys = eng._prefix.block_keys(prompt)
    bids = eng._prefix.match(keys, limit=len(keys))
    eng.faults.fail_spill_next(1)
    eng._spill_to_tier(list(zip(keys, bids)))  # must NOT raise
    after_fault = (_counters(eng.stats_snapshot()), len(eng._host_tier))
    eng._spill_to_tier(list(zip(keys, bids)))  # the fault disarmed itself
    healed = eng.stats_snapshot()["prefix_blocks_spilled"]
    for bid in bids:
        eng._allocator.free(bid)
    _close(eng)
    return after_fault, healed, len(keys)


def test_spill_fault_degrades_to_counted_discard(pair):
    out = _both(pair, _spill_fault)
    assert out["port"] == out["jax"]
    (snap, resident), healed, nkeys = out["port"]
    assert snap["prefix_blocks_spilled"] == 0 and snap["prefix_blocks_discarded"] == nkeys
    assert resident == 0 and healed == nkeys


# --------------------------------------------- evict -> restore -> decode


def _evict_and_spill(eng):
    """``_plan``'s sequence under block pressure: evict collecting the
    dropped (key, block) pairs, then spill them before any reallocation."""
    dropped = []
    eng._prefix.evict(eng._num_blocks, collect=dropped)
    eng._spill_to_tier(dropped)
    return len(dropped)


def _evict_restore(side):
    eng = _tiered(side)
    prompt = _enc(VICTIM_TEXT)
    g = _greedy(side, 6)
    solo = side["gen"].generate_ids(prompt, g)
    first = eng.submit(prompt, g, timeout=TIMEOUT)
    dropped = _evict_and_spill(eng)
    emptied = (len(eng._prefix), len(eng._host_tier))
    again = eng.submit(prompt, g, timeout=TIMEOUT)
    snap = eng.stats_snapshot()
    _close(eng)
    return {"solo": solo, "first": first, "again": again, "dropped": dropped,
            "emptied": emptied, "counters": _counters(snap),
            "tier_bytes": snap["host_tier_bytes"]}


def test_evicted_prefix_restores_from_tier_bit_identical(pair):
    out = _both(pair, _evict_restore)
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port["first"] == port["again"] == port["solo"]
    assert port["dropped"] >= 2 and port["emptied"][0] == 0 and port["emptied"][1] >= 2
    assert port["counters"]["host_tier_restore_hits"] >= 2
    assert port["counters"]["host_tier_restore_misses"] == 0 and port["tier_bytes"] > 0


def _restore_fault(side):
    eng = _tiered(side)
    prompt = _enc(VICTIM_TEXT)
    g = _greedy(side, 6)
    solo = side["gen"].generate_ids(prompt, g)
    runs = [eng.submit(prompt, g, timeout=TIMEOUT)]
    # an injected scatter fault: the restore aborts, its blocks go back to
    # the pool and the plan prefills again
    _evict_and_spill(eng)
    eng.faults.fail_restore_next(1)
    runs.append(eng.submit(prompt, g, timeout=TIMEOUT))
    snap = _counters(eng.stats_snapshot())
    failed = any(ev["kind"] == "restore_failed" for ev in eng.recorder.events())
    # a total miss (the tier emptied under the cache): a plain prefill
    _evict_and_spill(eng)
    eng._host_tier.clear()
    runs.append(eng.submit(prompt, g, timeout=TIMEOUT))
    _close(eng)
    return {"solo": solo, "runs": runs, "counters": snap, "failed": failed}


def test_restore_fault_and_tier_miss_fall_back_to_reprefill(pair):
    out = _both(pair, _restore_fault)
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port["runs"] == [port["solo"]] * 3
    assert port["counters"]["host_tier_restore_misses"] >= 2
    assert port["counters"]["host_tier_restore_hits"] == 0 and port["failed"]


# ------------------------------------------------------- export / adopt


def _export_adopt(side):
    eng = _tiered(side)
    prompt = _enc(VICTIM_TEXT)
    g = _greedy(side, 48)
    solo = side["gen"].generate_ids(prompt, g)
    stream = eng.stream(prompt, g, timeout=TIMEOUT)
    tokens = [next(stream), next(stream)]
    exported = eng.export_requests(timeout=30)
    after = {"n": len(exported), "live": eng.live_slots, "queued": eng.queue_depth,
             "banked_ge_2": len(exported[0].preempted_tokens) >= 2,
             "tier_ge_2": len(eng._host_tier) >= 2,
             "spilled_ge_2": eng.stats_snapshot()["prefix_blocks_spilled"] >= 2,
             "export_event": any(ev["kind"] == "export" for ev in eng.recorder.events())}
    eng.adopt_request(exported[0])
    tokens.extend(stream)
    snap = eng.stats_snapshot()
    _close(eng)
    return {"solo": solo, "tokens": tokens, "after": after,
            "counters": _counters(snap, ("requests_completed", "requests_failed"))}


def test_export_banks_and_adopt_resumes_bit_identical(pair):
    """Export banks a mid-decode stream (tokens + spilled blocks) without
    settling it; adopting it back resumes the ORIGINAL iterator to its solo
    tokens."""
    out = _both(pair, _export_adopt)
    assert out["port"]["tokens"] == out["jax"]["tokens"]
    assert out["port"]["after"] == out["jax"]["after"]
    assert out["port"]["counters"] == out["jax"]["counters"]
    port = out["port"]
    assert port["tokens"] == port["solo"]
    assert port["after"] == {"n": 1, "live": 0, "queued": 0, "banked_ge_2": True,
                             "tier_ge_2": True, "spilled_ge_2": True, "export_event": True}
    assert port["counters"] == {"requests_completed": 1, "requests_failed": 0}


def test_export_with_nothing_live_returns_empty(pair):
    def scenario(side):
        eng = _tiered(side)
        out = eng.export_requests(timeout=30)
        _close(eng)
        return out

    out = _both(pair, scenario)
    assert out["port"] == out["jax"] == []


# --------------------------------------------------------- live migration


def _started_stream(side, fleet, n=48):
    prompt = _enc(VICTIM_TEXT)
    g = _greedy(side, n)
    solo = side["gen"].generate_ids(prompt, g)
    stream = fleet.stream(prompt, g, timeout=TIMEOUT)
    tokens = [next(stream), next(stream)]
    src = next(rid for rid, rep in fleet.replica_items() if rep.live_slots > 0)
    return solo, stream, tokens, src


def _migrate(side):
    fleet = _tiered_fleet(side, migrate_on_retire=True)
    solo, stream, tokens, src = _started_stream(side, fleet)
    moved = fleet.migrate_slot(src)
    tokens.extend(stream)  # the SAME iterator finishes on the sibling
    reps = dict(fleet.replica_items())
    tgt = next(rid for rid in reps if rid != src)
    keys = ("slots_migrated", "requests_completed")
    out = {"solo": solo, "tokens": tokens, "moved": moved,
           "target": _counters(reps[tgt].stats_snapshot(), keys),
           "source": _counters(reps[src].stats_snapshot(), keys),
           "source_idle": (reps[src].live_slots, reps[src].queue_depth),
           "repinned": tgt in set(fleet._prefix_home.values())}
    for call, exc in (((src,), {"target_rid": src}), ((9999,), {})):
        try:
            fleet.migrate_slot(*call, **exc)
            out.setdefault("raised", []).append(None)
        except (ValueError, KeyError) as e:
            out.setdefault("raised", []).append(type(e).__name__)
    _close(fleet)
    return out


def test_migrate_slot_moves_stream_settles_on_exactly_one_replica(pair):
    out = _both(pair, _migrate)
    for key in ("tokens", "moved", "target", "source", "source_idle", "repinned", "raised"):
        assert out["port"][key] == out["jax"][key], key
    port = out["port"]
    assert port["tokens"] == port["solo"] and port["moved"] == 1
    assert port["target"] == {"slots_migrated": 1, "requests_completed": 1}
    assert port["source"] == {"slots_migrated": 0, "requests_completed": 0}
    assert port["source_idle"] == (0, 0) and port["repinned"]
    assert port["raised"] == ["ValueError", "KeyError"]


def _migrate_fault(side):
    fleet = _tiered_fleet(side, migrate_on_retire=True)
    solo, stream, tokens, src = _started_stream(side, fleet)
    reps = dict(fleet.replica_items())
    reps[src].faults.fail_migrate_next(1)
    try:
        fleet.migrate_slot(src)
        raised = None
    except RuntimeError as e:
        raised = type(e).__name__
    tokens.extend(stream)  # completes on the source after the re-adopt
    snaps = [rep.stats_snapshot() for rep in reps.values()]
    after = fleet.submit(_enc("after the storm"), _greedy(side, 6), timeout=TIMEOUT)
    _close(fleet)
    return {"solo": solo, "tokens": tokens, "raised": raised,
            "completed": sorted(s["requests_completed"] for s in snaps),
            "failed": [s["requests_failed"] for s in snaps],
            "migrated": [s["slots_migrated"] for s in snaps], "after": after}


def test_migrate_fault_readopts_no_drop_no_double_settle(pair):
    """An injected failure mid-migration: the source re-adopts, the stream
    completes with its solo tokens and exactly one replica settles it."""
    out = _both(pair, _migrate_fault)
    assert out["port"] == {**out["jax"], "after": out["port"]["after"]}
    assert out["port"]["after"] == out["jax"]["after"]
    port = out["port"]
    assert port["tokens"] == port["solo"] and port["raised"] == "RuntimeError"
    assert port["completed"] == [0, 1] and port["failed"] == [0, 0]
    assert port["migrated"] == [0, 0] and port["after"]


def _retire_fault(side):
    fleet = _tiered_fleet(side, migrate_on_retire=True)
    solo, stream, tokens, src = _started_stream(side, fleet)
    dict(fleet.replica_items())[src].faults.fail_migrate_next(1)
    fleet.retire_replica(rid=src, timeout_s=120)  # must NOT raise
    n = len(fleet.replicas)
    tokens.extend(stream)
    _close(fleet)
    return {"solo": solo, "tokens": tokens, "replicas": n}


def test_retire_with_migrate_fault_falls_back_to_drain_wait(pair):
    out = _both(pair, _retire_fault)
    assert out["port"] == out["jax"]
    assert out["port"]["tokens"] == out["port"]["solo"] and out["port"]["replicas"] == 1


def _retire_migrates(side):
    fleet = _tiered_fleet(side, migrate_on_retire=True)
    solo, stream, tokens, src = _started_stream(side, fleet)
    survivor = next(rep for rid, rep in fleet.replica_items() if rid != src)
    fleet.retire_replica(rid=src, timeout_s=120)
    n = len(fleet.replicas)
    tokens.extend(stream)
    snap, fsnap = survivor.stats_snapshot(), fleet.stats_snapshot()
    _close(fleet)
    return {"solo": solo, "tokens": tokens, "replicas": n,
            "survivor": _counters(snap, ("slots_migrated", "requests_completed")),
            "fleet_migrated": fsnap["slots_migrated"], "tier_key": "host_tier_bytes" in fsnap}


def test_retire_replica_migrates_active_stream_off(pair):
    """Retirement with migration does not wait for the live request: it
    moves to the survivor (``slots_migrated`` 1 proves the path) and
    completes with its solo tokens."""
    out = _both(pair, _retire_migrates)
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port["tokens"] == port["solo"] and port["replicas"] == 1
    assert port["survivor"] == {"slots_migrated": 1, "requests_completed": 1}
    assert port["fleet_migrated"] == 1 and port["tier_key"]


def _neighbors(side):
    fleet = _tiered_fleet(side, migrate_on_retire=True)
    prompts = [_enc(VICTIM_TEXT),
               _enc("a second long-context request riding the same replica here")]
    g = _greedy(side, 24)
    solos = [side["gen"].generate_ids(p, g) for p in prompts]
    results = [None] * len(prompts)

    def ask(i):
        results[i] = fleet.submit(prompts[i], g, timeout=TIMEOUT)

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    _wait(lambda: sum(rep.live_slots for rep in fleet.replicas) >= 1)
    src = max(fleet.replica_items(), key=lambda kv: kv[1].live_slots)[0]
    moved = fleet.migrate_slot(src)
    for t in threads:
        t.join(timeout=TIMEOUT)
    _close(fleet)
    return {"solos": solos, "results": results, "moved_ok": moved >= 0}


def test_migration_with_concurrent_neighbors_all_complete(pair):
    """Evacuating a replica with several requests places every one; each
    finishes with its solo tokens, in both packages."""
    out = _both(pair, _neighbors)
    assert out["port"]["results"] == out["jax"]["results"] == out["port"]["solos"]
    assert out["port"]["moved_ok"]


def _dense_migrate(side):
    """A fleet of two dense (continuous) replicas: no tier and no prefix
    keys; the migrated request banks its tokens and the sibling prefills
    prompt + banked tokens again."""
    reps = [side["continuous"](side["gen"], slots=2, buf_len=256, prompt_bucket=64)
            for _ in range(2)]
    fleet = side["fleet"](reps, routing="round-robin", migrate_on_retire=True)
    solo, stream, tokens, src = _started_stream(side, fleet)
    moved = fleet.migrate_slot(src)
    tokens.extend(stream)
    snaps = {rid: rep.stats_snapshot() for rid, rep in fleet.replica_items()}
    _close(fleet)
    return {"solo": solo, "tokens": tokens, "moved": moved,
            "migrated": sorted(s["slots_migrated"] for s in snaps.values()),
            "completed": sorted(s["requests_completed"] for s in snaps.values())}


def test_dense_replicas_migrate_a_stream(pair):
    """The continuous engine is a replica too: a stream migrated off one
    dense replica finishes on the other with its solo tokens, as in the JAX
    fleet."""
    out = _both(pair, _dense_migrate)
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port["tokens"] == port["solo"] and port["moved"] == 1
    assert port["migrated"] == [0, 1] and port["completed"] == [0, 1]

class _FailSecondMigrate:
    """The engine's fault hooks with the migrate hook failing on its second
    call only: the export's first request (the live one) detaches, and the
    fault fires on the queued one."""

    def __init__(self, faults):
        self._faults, self._calls = faults, 0

    def __getattr__(self, name):
        return getattr(self._faults, name)

    def maybe_fail_migrate(self):
        self._calls += 1
        if self._calls == 2:
            raise RuntimeError("injected migration failure on the queued request")


def test_export_fault_on_a_queued_request_keeps_it(pair):
    """A migrate fault on a QUEUED request leaves it in the engine's buffer
    (the fault fires before the request leaves it), and the live request
    already detached is re-adopted: both finish with their solo tokens and
    the pending ledger returns to zero. The JAX engine pops the queued
    request before its fault fires, which would strand its waiter; the JAX
    side is therefore not run here."""
    side = pair["port"]
    eng = _tiered(side, slots=1)
    prompts = [_enc(VICTIM_TEXT), _enc("a queued request behind the live one")]
    g = _greedy(side, 24)
    solos = [side["gen"].generate_ids(p, g) for p in prompts]
    try:
        stream = eng.stream(prompts[0], g, timeout=TIMEOUT)
        tokens = [next(stream)]
        queued = []
        t = threading.Thread(target=lambda: queued.append(eng.submit(prompts[1], g,
                                                                     timeout=TIMEOUT)))
        t.start()
        _wait(lambda: eng.queue_depth == 1)
        eng.faults = _FailSecondMigrate(eng.faults)
        with pytest.raises(RuntimeError, match="re-adopted"):
            eng.export_requests(timeout=30)
        tokens.extend(stream)
        t.join(TIMEOUT)
        assert tokens == solos[0] and queued == [solos[1]]
        assert eng.wait_drained(30) and eng._pending == 0
        assert any(ev["kind"] == "export_failed" and ev["readopted"] == 1
                   for ev in eng.recorder.events())
    finally:
        eng.close()

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the spill and restore copies on the card need an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_cuda_spill_restore_round_trip_bitwise(cuda, kv_quant):
    """On the card: gather a served prompt's blocks into pinned host
    memory, publish them in the tier, scatter them into fresh rows and
    gather again; every leaf is bitwise the original, codes and scales, and
    the null block is untouched (no pad rows are written)."""
    from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
    from llm_fine_tune_distributed_tpu_torch.infer.generate import pool_leaves

    mc = get_preset("tiny")
    params = tf.init_params(mc, seed=0, device=cuda, dtype=torch.float32)
    gen = Generator(params, mc, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                    eos_token_ids=[], device=cuda)
    eng = PagedContinuousBatchingEngine(gen, slots=2, buf_len=256, prompt_bucket=64,
                                        block_len=16, prefill_chunk=256, kv_quant=kv_quant,
                                        host_tier=HostBlockTier(64 << 20))
    try:
        prompt = _enc(VICTIM_TEXT)
        eng.submit(prompt, GenerationConfig(max_new_tokens=6, do_sample=False), timeout=TIMEOUT)
        keys = eng._prefix.block_keys(prompt)
        bids = eng._prefix.match(keys, limit=len(keys))
        orig = [[a.clone() for a in rows] for rows in eng._gather_blocks(bids)]
        assert all(a.is_pinned() for a in eng._gather_blocks(bids)[0])
        eng._spill_to_tier(list(zip(keys, bids)))
        entries = [eng._host_tier.get(k) for k in keys]
        null = [leaf[0].clone() for leaf in pool_leaves(eng.pool)]
        fresh = eng._allocator.alloc(len(keys))
        eng._scatter_blocks(fresh, entries)
        back = eng._gather_blocks(fresh)
        for b_rows, o_rows in zip(back, orig):
            for b, o in zip(b_rows, o_rows):
                assert b.dtype == o.dtype and torch.equal(b, o)
        assert all(torch.equal(leaf[0], n) for leaf, n in zip(pool_leaves(eng.pool), null))
        for bid in list(fresh) + list(bids):
            eng._allocator.free(bid)
    finally:
        eng.close()
