"""Disaggregated prefill/decode pools in the port (replica roles in
``infer/routing.py``, the handoff of ``infer/engine.py``, the fleet's
placement in ``infer/fleet.py`` and ratio autoscaling in
``observe/capacity.py``) against the JAX package's, case by case as
``tests/test_disagg.py`` pins them (the ``tiny`` preset in f32, the same
weights in both):

- ``choose_replica`` filters by stage (new requests never land on a decode
  replica, handoffs never on a prefill one) and drops a filter that would
  empty the candidate set, with the JAX function's placements;
- a prefill replica runs the prompt to its first token and hands the request
  to a decode replica through the shared host tier; the stream finishes
  there with its solo tokens, and both packages count the same;
- a handoff fault, or no decode replica to take it, decodes in place with
  the same tokens; the handoff prefers the sibling that shares the tier;
- ``prefill_tokens`` / ``decode_tokens`` split the work as the JAX engines
  split it; the forecaster's decay, the per-role capacity report and the
  ratio autoscaler answer as the JAX ones; the fleet adds and retires by
  role.
"""

import math

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
from llm_fine_tune_distributed_tpu_torch.infer.routing import (
    REPLICA_ROLES,
    ReplicaView,
    choose_replica,
)
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.observe import capacity as port_capacity
from llm_fine_tune_distributed_tpu_torch.observe.tracing import FlightRecorder

TIMEOUT = 240
# a prompt spanning >= 2 full 16-token blocks, so handoffs move blocks
VICTIM_TEXT = "a forty-ish token victim prompt for prefill handoffs"


def _enc(text):
    return ByteChatMLTokenizer().encode(text)


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port's Generator on the same weights (JAX PRNGKey(0))
    with each package's engines, fleet and tier."""
    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTok
    from llm_fine_tune_distributed_tpu.infer import EngineFleet as JaxFleet
    from llm_fine_tune_distributed_tpu.infer import GenerationConfig as JaxConfig
    from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
    from llm_fine_tune_distributed_tpu.infer import engine as jax_engine
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
    return {
        "jax": dict(gen=jgen, paged=jax_engine.PagedContinuousBatchingEngine,
                    continuous=jax_engine.ContinuousBatchingEngine, fleet=JaxFleet, tier=JaxTier,
                    config=JaxConfig),
        "port": dict(gen=gen, paged=PagedContinuousBatchingEngine,
                     continuous=ContinuousBatchingEngine, fleet=EngineFleet, tier=HostBlockTier,
                     config=GenerationConfig),
    }


def _greedy(side, n):
    return side["config"](max_new_tokens=n, do_sample=False)


def _paged(side, tier, role="mixed", **kw):
    kw = {"slots": 4, "buf_len": 256, "prompt_bucket": 64, "block_len": 16,
          "prefill_chunk": 256, "restart_backoff_s": 0.01, "restart_backoff_max_s": 0.02, **kw}
    return side["paged"](side["gen"], host_tier=tier, role=role, **kw)


def _role_fleet(side, roles):
    """Replicas with roles sharing ONE tier: the handoff's transport."""
    tier = side["tier"](64 << 20)
    return side["fleet"]([_paged(side, tier, role=r) for r in roles], routing="prefix")


def _close(obj):
    if hasattr(obj, "close"):  # the JAX engines and fleet have no close()
        obj.close()


def _both(pair, scenario, *args):
    return {name: scenario(pair[name], *args) for name in ("jax", "port")}


def _jax_routing():
    from llm_fine_tune_distributed_tpu.infer import routing

    return routing


# ------------------------------------------------------------ role routing


def _placements(mod, views, **kw):
    out = []
    for policy in ("prefix", "least-loaded", "round-robin"):
        for seq in range(8):
            p = mod.choose_replica(policy, views, rr_seq=seq, **kw)
            out.append(None if p is None else (p.index, p.reason))
    return out


def _role_views(cls):
    return [cls(0, role="decode"), cls(1, role="prefill"), cls(2, role="mixed")]


def test_choose_replica_stage_filters_roles():
    import llm_fine_tune_distributed_tpu_torch.infer.routing as port_routing

    jax_routing = _jax_routing()
    for stage, allowed in (("prefill", {1, 2}), ("decode", {0, 2})):
        port = _placements(port_routing, _role_views(ReplicaView), stage=stage)
        assert port == _placements(jax_routing, _role_views(jax_routing.ReplicaView), stage=stage)
        assert all(p is not None and p[0] in allowed for p in port)


def test_choose_replica_role_filter_degrades_not_dead():
    jax_routing = _jax_routing()
    for choose, cls in ((choose_replica, ReplicaView),
                        (jax_routing.choose_replica, jax_routing.ReplicaView)):
        views = [cls(0, role="decode"), cls(1, role="decode")]
        assert choose("prefix", views).index in (0, 1)  # the filter is dropped
        assert choose("prefix", [cls(0, role="prefill")], stage="decode").index == 0
        with pytest.raises(ValueError):
            choose("prefix", views, stage="verify")


def test_engine_rejects_unknown_role(pair):
    assert REPLICA_ROLES == _jax_routing().REPLICA_ROLES == ("mixed", "prefill", "decode")
    for side in (pair["jax"], pair["port"]):
        with pytest.raises(ValueError, match="unknown replica role 'verifier'"):
            side["continuous"](side["gen"], slots=1, buf_len=64, role="verifier")


def _all_decode(side):
    tier = side["tier"](64 << 20)
    with pytest.warns(RuntimeWarning, match="no prefill-capable"):
        fleet = side["fleet"]([_paged(side, tier, role="decode") for _ in range(2)],
                              routing="prefix")
    degraded = any(ev["kind"] == "role_degraded" and ev["missing"] == "prefill"
                   for ev in fleet.recorder.events())
    prompt = _enc(VICTIM_TEXT)
    g = _greedy(side, 6)
    out = (degraded, fleet.submit(prompt, g, timeout=TIMEOUT), side["gen"].generate_ids(prompt, g))
    _close(fleet)
    return out


def test_all_decode_fleet_warns_and_serves(pair):
    """No prefill-capable replica: the fleet says so once, then serves with
    mixed placement."""
    out = _both(pair, _all_decode)
    assert out["port"] == out["jax"]
    degraded, tokens, solo = out["port"]
    assert degraded and tokens == solo


# ------------------------------------------------------- handoff (tentpole)


_SPLIT = ("requests_handed_off", "requests_handoff_failed", "requests_completed",
          "slots_migrated", "prefill_tokens", "decode_tokens")


def _split(snap):
    return {k: snap[k] for k in _SPLIT}


def _handoff(side):
    fleet = _role_fleet(side, ["prefill", "decode"])
    prompt = _enc(VICTIM_TEXT)
    g = _greedy(side, 48)
    solo = side["gen"].generate_ids(prompt, g)
    tokens = list(fleet.stream(prompt, g, timeout=TIMEOUT))
    pre, dec = fleet.replicas
    fsnap = fleet.stats_snapshot()
    report = fleet.capacity_report()
    out = {"solo": solo, "tokens": tokens, "pre": _split(pre.stats_snapshot()),
           "dec": _split(dec.stats_snapshot()),
           "fleet_handoff": "handoff" in [ev["kind"] for ev in fleet.recorder.events()],
           "replica_handoff": any(ev["kind"] == "handoff" for ev in pre.recorder.events()),
           "by_role": fsnap["tokens_by_role"], "role": fsnap["role"],
           "report_roles": {r: {k: sec[k] for k in ("replicas", "dedicated_replicas")}
                            for r, sec in report["roles"].items()},
           "report_keys": {r: sorted(sec) for r, sec in report["roles"].items()},
           "plen": len(prompt)}
    _close(fleet)
    return out


def test_prefill_to_decode_handoff_bit_identical(pair):
    """The new request lands on the prefill replica, its first token hands
    it off, the decode replica adopts it through the shared tier and the
    ORIGINAL stream finishes there with the solo tokens; the counters, the
    role split and the per-role capacity sections equal the JAX fleet's."""
    out = _both(pair, _handoff)
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port["tokens"] == port["solo"]
    pre, dec = port["pre"], port["dec"]
    assert pre["requests_handed_off"] == 1 and pre["requests_handoff_failed"] == 0
    assert pre["requests_completed"] == 0 and pre["decode_tokens"] == 0
    assert pre["prefill_tokens"] >= port["plen"] - 1
    assert dec["slots_migrated"] == 1 and dec["requests_completed"] == 1
    assert dec["decode_tokens"] > 0
    assert port["fleet_handoff"] and port["replica_handoff"]
    assert port["by_role"]["prefill"]["replicas"] == port["by_role"]["decode"]["replicas"] == 1
    assert port["by_role"]["prefill"]["decode_tokens"] == 0
    assert port["role"] == "disaggregated"
    assert port["report_roles"] == {r: {"replicas": 1, "dedicated_replicas": 1}
                                    for r in ("prefill", "decode")}
    for keys in port["report_keys"].values():
        assert {"demand_tokens_per_s", "forecast_demand_tokens_per_s", "capacity_tokens_per_s",
                "headroom_tokens_per_s", "utilization", "recommended_replicas"} <= set(keys)


def _handoff_fault(side):
    fleet = _role_fleet(side, ["prefill", "decode"])
    pre, dec = fleet.replicas
    prompt = _enc(VICTIM_TEXT)
    g = _greedy(side, 48)
    solo = side["gen"].generate_ids(prompt, g)
    pre.faults.fail_handoff_next(1)
    first = fleet.submit(prompt, g, timeout=TIMEOUT)
    after_fault = (_split(pre.stats_snapshot()), _split(dec.stats_snapshot()))
    failed = [ev for ev in pre.recorder.events() if ev["kind"] == "handoff_failed"]
    prompt2 = _enc("a different long prompt that should hand off cleanly")
    solo2 = side["gen"].generate_ids(prompt2, g)
    second = fleet.submit(prompt2, g, timeout=TIMEOUT)
    healed = (pre.stats_snapshot()["requests_handed_off"],
              dec.stats_snapshot()["requests_completed"])
    _close(fleet)
    return {"solo": [solo, solo2], "tokens": [first, second], "after_fault": after_fault,
            "where": failed[-1]["where"] if failed else None, "healed": healed}


def test_handoff_fault_degrades_to_decode_in_place(pair):
    """A handoff fault fires before anything leaves the prefill replica:
    it decodes in place with the same tokens; the next request hands off."""
    out = _both(pair, _handoff_fault)
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port["tokens"] == port["solo"]
    pre, dec = port["after_fault"]
    assert (pre["requests_handoff_failed"], pre["requests_handed_off"],
            pre["requests_completed"]) == (1, 0, 1)
    assert dec["requests_completed"] == 0 and dec["slots_migrated"] == 0
    assert port["where"] == "spill" and port["healed"] == (1, 1)


def _no_decode_sibling(side):
    fleet = _role_fleet(side, ["prefill", "decode"])
    pre, dec = fleet.replicas
    dec.begin_drain()
    prompt = _enc(VICTIM_TEXT)
    g = _greedy(side, 48)
    out = {"solo": side["gen"].generate_ids(prompt, g),
           "tokens": fleet.submit(prompt, g, timeout=TIMEOUT),
           "pre": _split(pre.stats_snapshot()), "dec": _split(dec.stats_snapshot())}
    failed = [ev for ev in pre.recorder.events() if ev["kind"] == "handoff_failed"]
    out["where"] = failed[-1]["where"] if failed else None
    _close(fleet)
    return out


def test_handoff_without_decode_sibling_decodes_in_place(pair):
    """The only decode replica drains: the spilled request re-enters the
    prefill replica's queue and resumes there, counted as a failed handoff
    at the adopt step."""
    out = _both(pair, _no_decode_sibling)
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port["tokens"] == port["solo"] and port["where"] == "adopt"
    assert port["pre"]["requests_handoff_failed"] == 1 and port["pre"]["requests_completed"] == 1
    assert port["dec"]["requests_completed"] == 0


def _prefers_sharer(side):
    tier, far = side["tier"](64 << 20), side["tier"](64 << 20)
    reps = [_paged(side, tier, role="prefill"), _paged(side, far, role="decode"),
            _paged(side, tier, role="decode")]
    fleet = side["fleet"](reps, routing="prefix")
    prompt = _enc(VICTIM_TEXT)
    g = _greedy(side, 48)
    out = {"solo": side["gen"].generate_ids(prompt, g),
           "tokens": fleet.submit(prompt, g, timeout=TIMEOUT),
           "migrated": [r.stats_snapshot()["slots_migrated"] for r in reps],
           "completed": [r.stats_snapshot()["requests_completed"] for r in reps]}
    _close(fleet)
    return out


def test_handoff_prefers_tier_sharing_sibling(pair):
    """Two decode candidates, the later one sharing the source's tier: it
    wins, since it restores the spilled blocks."""
    out = _both(pair, _prefers_sharer)
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port["tokens"] == port["solo"]
    assert port["migrated"] == [0, 0, 1] and port["completed"] == [0, 0, 1]


# ------------------------------------------------- token-split attribution


def _token_split(side, kind):
    if kind == "paged":
        eng = _paged(side, side["tier"](64 << 20))
    else:
        eng = side["continuous"](side["gen"], slots=4, buf_len=256, prompt_bucket=64)
    prompt = _enc(VICTIM_TEXT)
    g = _greedy(side, 6)
    out = eng.submit(prompt, g, timeout=TIMEOUT)
    keys = ("tokens_served", "decode_tokens", "prefill_tokens", "prompt_tokens",
            "prefix_tokens_reused")
    snaps = [{k: eng.stats_snapshot()[k] for k in keys}]
    if kind == "paged":
        eng.submit(prompt, g, timeout=TIMEOUT)
        snaps.append({k: eng.stats_snapshot()[k] for k in keys})
    _close(eng)
    return {"n": len(out), "plen": len(prompt), "snaps": snaps}


@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_token_split_attribution(pair, kind):
    """``prefill_tokens`` counts the prompt positions prefilled and
    ``decode_tokens`` the decode ticks' tokens; the first token is in
    neither. A repeat on the paged engine prefills only its tail."""
    out = _both(pair, _token_split, kind)
    assert out["port"] == out["jax"]
    port = out["port"]
    first = port["snaps"][0]
    assert first["tokens_served"] == port["n"] == 6 and first["decode_tokens"] == 5
    assert first["prefill_tokens"] in (port["plen"] - 1, port["plen"])
    if kind == "paged":
        second = port["snaps"][1]
        assert first["prompt_tokens"] == port["plen"]
        assert second["decode_tokens"] == 10 and second["prefix_tokens_reused"] > 0
        assert second["prefill_tokens"] < first["prefill_tokens"] + port["plen"]


# ------------------------------------------- forecaster staleness decay


def _decay(cap):
    fc = cap.LoadForecaster(short_tau_s=10.0, long_tau_s=100.0)
    for i in range(40):
        fc.update(float(i), arrivals=10 * i, admitted=10 * i, tokens=100 * i, queue_depth=4,
                  live_slots=4, prefill_tokens=40 * i, decode_tokens=60 * i)
    return {"rate0": fc.rate("token_rate"), "at39": fc.rate("token_rate", now=39.0),
            "at20": fc.rate("token_rate", now=20.0), "at49": fc.rate("token_rate", now=49.0),
            "pre49": fc.rate("prefill_token_rate", now=49.0),
            "pre": fc.rate("prefill_token_rate"), "at4000": fc.rate("token_rate", now=4000.0),
            "fc4000": fc.forecast(60.0, now=4000.0), "snap139": fc.snapshot(now=139.0),
            "long": fc.rate("token_rate", "long"), "qd": fc.queue_depth, "snap": fc.snapshot()}


def test_forecaster_staleness_decay_reads_idle_as_idle():
    """An idle replica's frozen rates decay at read by exp(-gap/tau), as
    the JAX forecaster's do, to the same values."""
    from llm_fine_tune_distributed_tpu.observe import capacity as jax_capacity

    port, ref = _decay(port_capacity), _decay(jax_capacity)
    assert port == ref
    assert port["rate0"] == pytest.approx(100.0, rel=0.05)
    assert port["at39"] == port["at20"] == port["rate0"]
    assert port["at49"] == pytest.approx(port["rate0"] * math.exp(-1.0))
    assert port["pre49"] == pytest.approx(port["pre"] * math.exp(-1.0))
    assert port["at4000"] < 1e-6 and port["fc4000"] < 1e-6
    assert port["snap139"]["rates_short"]["token_rate"] == pytest.approx(
        port["rate0"] * math.exp(-10.0))
    assert port["snap139"]["rates_long"]["token_rate"] == pytest.approx(
        port["long"] * math.exp(-1.0))
    assert port["snap139"]["queue_depth"] == pytest.approx(port["qd"] * math.exp(-10.0))
    assert port["snap"]["rates_short"]["token_rate"] == port["rate0"]


# ------------------------------------------------- per-role capacity model


def _role_snap(role, prefill_rate, decode_rate, tick_s=0.05):
    return {
        "slots": 4, "role": role, "mean_decode_tick_s": tick_s, "mean_tokens_per_step": 0.0,
        "live_slots_mean": 2.0, "model_flops_utilization": 0.0, "hbm_bandwidth_utilization": 0.0,
        "forecaster": {
            "rates_short": {"arrival_rate": 1.0, "admit_rate": 1.0,
                            "token_rate": prefill_rate + decode_rate,
                            "prefill_token_rate": prefill_rate,
                            "decode_token_rate": decode_rate},
            "trend_tokens_per_s2": 0.0, "queue_depth": 0.0, "queue_wait_s": 0.0,
            "live_slots_mean": 2.0,
        },
    }


def test_report_role_sections_split_demand_and_capacity():
    from llm_fine_tune_distributed_tpu.observe import capacity as jax_capacity

    snaps = [_role_snap("prefill", 70.0, 0.0), _role_snap("decode", 0.0, 30.0)]
    rep = port_capacity.report_from_capacity_snapshots(snaps, 2)
    assert rep == jax_capacity.report_from_capacity_snapshots(snaps, 2)
    pre, dec = rep["roles"]["prefill"], rep["roles"]["decode"]
    assert pre["replicas"] == 1 and pre["dedicated_replicas"] == 1
    assert pre["demand_tokens_per_s"] == pytest.approx(70.0)
    assert pre["capacity_tokens_per_s"] == pytest.approx(80.0)
    assert pre["utilization"] == pytest.approx(70.0 / 80.0)
    assert pre["recommended_replicas"] == 2
    assert dec["demand_tokens_per_s"] == pytest.approx(30.0)
    assert dec["headroom_tokens_per_s"] == pytest.approx(50.0)
    assert dec["recommended_replicas"] == 1
    snaps.append(_role_snap("mixed", 10.0, 10.0))  # a mixed replica serves both stages
    roles = port_capacity.report_from_capacity_snapshots(snaps, 3)["roles"]
    assert roles == jax_capacity.report_from_capacity_snapshots(snaps, 3)["roles"]
    assert roles["prefill"]["replicas"] == roles["decode"]["replicas"] == 2
    assert roles["prefill"]["dedicated_replicas"] == 1
    assert roles["prefill"]["demand_tokens_per_s"] == pytest.approx(80.0)
    assert roles["decode"]["demand_tokens_per_s"] == pytest.approx(40.0)


# ---------------------------------------------------- ratio autoscaling


class _RoleScriptedFleet:
    """The role-aware surface an Autoscaler reads, with scripted per-stage
    demand through a package's own pure report."""

    def __init__(self, cap, roles, prefill_demand=0.0, decode_demand=0.0):
        self.cap = cap
        self.roles = list(roles)
        self.prefill_demand = prefill_demand
        self.decode_demand = decode_demand
        self.recorder = FlightRecorder(64)
        self.added: list = []
        self.retired: list = []

    def capacity_report(self, horizon_s=60.0, min_replicas=1, max_replicas=None):
        n_pre = max(1, sum(1 for r in self.roles if r != "decode"))
        n_dec = max(1, sum(1 for r in self.roles if r != "prefill"))
        snaps = [_role_snap(r, self.prefill_demand / n_pre if r != "decode" else 0.0,
                            self.decode_demand / n_dec if r != "prefill" else 0.0)
                 for r in self.roles]
        return self.cap.report_from_capacity_snapshots(
            snaps, len(self.roles), horizon_s=horizon_s, min_replicas=min_replicas,
            max_replicas=max_replicas)

    def add_replica(self, role=None):
        self.roles.append(role or "mixed")
        self.added.append(role)
        return len(self.roles) - 1, object()

    def retire_replica(self, rid=None, timeout_s=60.0, migrate=None, role=None):
        if len(self.roles) <= 1:
            raise ValueError("cannot retire the last replica")
        self.retired.append(role)
        if role is not None:
            self.roles.remove(role)
        else:
            self.roles.pop()
        return rid


def _autoscale(roles, prefill, decode, **kw):
    """One tick of each package's Autoscaler on the same scripted fleet:
    (port decision, port fleet), after checking both agree."""
    from llm_fine_tune_distributed_tpu.observe import capacity as jax_capacity

    out = []
    for cap in (jax_capacity, port_capacity):
        fleet = _RoleScriptedFleet(cap, roles, prefill_demand=prefill, decode_demand=decode)
        d = cap.Autoscaler(fleet, **kw).tick(0.0)
        events = [ev for ev in fleet.recorder.events() if ev["kind"] == "scale_decision"]
        out.append((d, fleet.added, fleet.retired, fleet.roles,
                    [{k: v for k, v in ev.items() if k != "t_s"} for ev in events]))
    assert out[0][1:] == out[1][1:]
    assert out[0][0] == out[1][0]
    return out[1]


def test_ratio_autoscaler_grows_starved_role_in_band():
    """Fleet totals in band, the prefill pool starved: ratio mode grows a
    prefill replica; without it the same report decides nothing."""
    plain, *_ = _autoscale(["prefill", "decode"], 95.0, 25.0, mode="on", max_replicas=4,
                           cooldown_s=0.0)
    assert plain is None
    d, added, _, roles, events = _autoscale(["prefill", "decode"], 95.0, 25.0, mode="on",
                                            max_replicas=4, cooldown_s=0.0, ratio=True)
    assert d is not None and d["applied"] is True
    assert d["direction"] == "up" and d["role"] == "prefill"
    assert d["role_demand_tokens_per_s"]["prefill"] == pytest.approx(95.0)
    assert added == ["prefill"] and roles == ["prefill", "decode", "prefill"]
    assert events and events[-1]["role"] == "prefill" and events[-1]["applied"] is True


def test_ratio_autoscaler_trades_surplus_role_at_max():
    d, _, retired, roles, _ = _autoscale(["prefill", "decode", "decode"], 95.0, 60.0, mode="on",
                                         max_replicas=3, cooldown_s=0.0, ratio=True)
    assert d is not None and d["applied"] is True
    assert d["direction"] == "down" and d["role"] == "decode"
    assert retired == ["decode"] and roles == ["prefill", "decode"]


def test_ratio_autoscaler_count_step_picks_pressured_role():
    d, added, *_ = _autoscale(["prefill", "decode"], 190.0, 30.0, mode="on", max_replicas=4,
                              cooldown_s=0.0, ratio=True)
    assert d["direction"] == "up" and d["applied"] is True and d["role"] == "prefill"
    assert added == ["prefill"]


def test_ratio_mode_off_keeps_decisions_role_free():
    d, added, retired, *_ = _autoscale(["prefill", "decode"], 190.0, 30.0, mode="dry-run",
                                       max_replicas=4, cooldown_s=0.0)
    assert d is not None and "role" not in d
    assert added == [] and retired == []


def _by_role(side):
    tier = side["tier"](64 << 20)

    def factory(rid, role=None):
        return _paged(side, tier, role=role or "mixed")

    fleet = side["fleet"]([_paged(side, tier, role="prefill"), _paged(side, tier, role="decode")],
                          routing="prefix", replica_factory=factory)
    rid, rep = fleet.add_replica(role="decode")
    out = {"added": (rid, rep.role, len(fleet.replicas))}
    ups = [ev for ev in fleet.recorder.events() if ev["kind"] == "scale_up"]
    out["up_role"] = ups[-1]["role"] if ups else None
    out["retired"] = fleet.retire_replica(role="decode", timeout_s=30)
    downs = [ev for ev in fleet.recorder.events() if ev["kind"] == "scale_down"]
    out["down_role"] = downs[-1]["role"] if downs else None
    try:
        fleet.retire_replica(role="mixed")
        out["no_mixed"] = None
    except KeyError as e:
        out["no_mixed"] = type(e).__name__
    rid2, rep2 = fleet.add_replica(role="prefill")
    out["prefill_wired"] = (rep2.role, rep2.handoff is not None)
    _close(fleet)
    return out


def test_fleet_add_and_retire_replica_by_role(pair):
    """``add_replica(role=)`` builds and wires that role, and
    ``retire_replica(role=)`` takes the newest replica of it; both stamp the
    role into their events."""
    out = _both(pair, _by_role)
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port["added"] == (2, "decode", 3) and port["up_role"] == "decode"
    assert port["retired"] == 2 and port["down_role"] == "decode"
    assert port["no_mixed"] == "KeyError" and port["prefill_wired"] == ("prefill", True)
