"""The port's capacity observatory (``observe/capacity.py``) against the JAX
package's on the same scripts: the forecaster under a synthetic clock, the
saturation model, the hysteresis recommendation, the reports, and the
autoscaler over a scripted fleet (the cases of ``tests/test_capacity.py``).
Each script runs once per package with that package's classes, and the two
results must be equal. Then ``capacity_snapshot`` of the port's tiny slot
engines: the JAX engine's keys, and live signal after traffic.
"""

import math
import time
from types import SimpleNamespace

import pytest
import torch

from llm_fine_tune_distributed_tpu.observe import capacity as jax_capacity
from llm_fine_tune_distributed_tpu.observe import tracing as jax_tracing
from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.observe import capacity, tracing

SIDES = {"port": SimpleNamespace(cap=capacity, tracing=tracing),
         "jax": SimpleNamespace(cap=jax_capacity, tracing=jax_tracing)}
GEOMETRY = {"continuous": dict(slots=4, buf_len=96, prompt_bucket=16),
            "paged": dict(slots=4, buf_len=96, prompt_bucket=16, block_len=16, prefill_chunk=32)}
ENGINES = {"continuous": ContinuousBatchingEngine, "paged": PagedContinuousBatchingEngine}


def _both(script, *args):
    """``script(side, *args)`` on both packages; their results must be
    equal. Returns the port's."""
    mine = script(SIDES["port"], *args)
    assert mine == script(SIDES["jax"], *args)
    return mine


# ------------------------------------------------------------ LoadForecaster


def test_forecaster_seeds_then_converges_to_constant_rate():
    def script(m):
        fc = m.cap.LoadForecaster(short_tau_s=10.0, long_tau_s=100.0)
        fc.update(0.0, arrivals=0, admitted=0, tokens=0)
        seeded = (fc.samples, fc.rate("token_rate"))
        for i in range(1, 101):  # 50 tokens/s, sampled every second
            fc.update(float(i), arrivals=2 * i, admitted=2 * i, tokens=50 * i,
                      queue_depth=3, queue_wait_s=0.5, live_slots=4)
        return seeded, fc.snapshot(), fc.snapshot(now=130.0), fc.forecast(60.0), \
            fc.forecast(60.0, now=130.0), fc.rate("token_rate", "long")

    seeded, snap, stale, forecast, stale_forecast, long_rate = _both(script)
    assert seeded == (0, 0.0) and snap["samples"] == 100 and snap["short_tau_s"] == 10.0
    assert math.isclose(snap["rates_short"]["token_rate"], 50.0, rel_tol=1e-3)
    assert math.isclose(snap["rates_short"]["arrival_rate"], 2.0, rel_tol=1e-3)
    assert math.isclose(long_rate, 50.0, rel_tol=0.3)
    assert abs(snap["trend_tokens_per_s2"]) < 0.5
    assert math.isclose(forecast, 50.0, rel_tol=0.05)
    assert math.isclose(snap["queue_depth"], 3.0, rel_tol=1e-3)
    assert math.isclose(snap["live_slots_mean"], 4.0, rel_tol=1e-3)
    assert set(snap["rates_short"]) == set(capacity.LoadForecaster.RATES)
    # 30 s without a sample: the rates decay at the reader's clock
    assert stale["rates_short"]["token_rate"] < 0.1 * snap["rates_short"]["token_rate"]
    assert stale_forecast < forecast


def test_forecaster_ramp_trend_extrapolates_decay_floors_at_zero():
    def script(m):
        fc = m.cap.LoadForecaster(short_tau_s=10.0, long_tau_s=60.0)
        fc.update(0.0, arrivals=0, admitted=0, tokens=0)
        total = 0
        for i in range(1, 61):  # token rate grows 1 tok/s every second
            total += 10 + i
            fc.update(float(i), arrivals=i, admitted=i, tokens=total)
        ramp = (fc.trend_tokens_per_s2, fc.forecast(60.0), fc.rate("token_rate", "short"))
        for i in range(61, 181):
            fc.update(float(i), arrivals=60, admitted=60, tokens=total)
        return ramp, (fc.trend_tokens_per_s2, fc.rate("token_rate", "short"), fc.forecast(600.0))

    (trend, forecast, rate), (trend_after, rate_after, far) = _both(script)
    assert trend > 0.3 and forecast > rate
    assert trend_after < 0.0 and rate_after < 1.0 and far == 0.0


def test_forecaster_zero_dt_and_counter_reset_are_harmless():
    def script(m):
        fc = m.cap.LoadForecaster()
        fc.update(0.0, arrivals=0, admitted=0, tokens=0)
        fc.update(1.0, arrivals=5, admitted=5, tokens=100)
        before = fc.snapshot()
        fc.update(1.0, arrivals=9, admitted=9, tokens=999)  # same stamp: skipped
        same = fc.snapshot() == before
        fc.update(2.0, arrivals=0, admitted=0, tokens=0)  # a restarted replica's counters
        return same, fc.rate("token_rate", "short"), fc.samples

    same, rate, samples = _both(script)
    assert same and rate >= 0.0 and samples == 2


# ----------------------------------------------------------- SaturationModel


def test_saturation_model_measured_ticks_and_derate():
    def script(m):
        sat = m.cap.SaturationModel()
        calls = [dict(slots=4, mean_decode_tick_s=0.0), dict(slots=0, mean_decode_tick_s=0.1),
                 dict(slots=4, mean_decode_tick_s=0.05),
                 dict(slots=4, mean_decode_tick_s=0.05, mean_tokens_per_step=6.0,
                      live_slots_mean=3.0),
                 dict(slots=4, mean_decode_tick_s=0.05, mean_tokens_per_step=1.0,
                      live_slots_mean=4.0),
                 dict(slots=4, mean_decode_tick_s=0.05, hbm_bw_util=0.9),
                 dict(slots=4, mean_decode_tick_s=0.05, mfu=0.5, hbm_bw_util=0.5)]
        return [sat.sustainable_tokens_per_s(**kw) for kw in calls]

    cold, no_slots, plain, spec, floor, derated, below = _both(script)
    assert cold == 0.0 == no_slots
    assert plain == pytest.approx(80.0) and spec == pytest.approx(160.0)
    assert floor == pytest.approx(80.0) and derated == pytest.approx(72.0)
    assert below == pytest.approx(80.0)


# -------------------------------------------------------- recommend_replicas


def test_recommend_replicas_hysteresis_band():
    cases = [(60.0, 100.0, 1), (130.0, 100.0, 2), (90.0, 100.0, 1), (400.0, 100.0, 1),
             (30.0, 100.0, 3), (110.0, 100.0, 4), (0.0, 100.0, 2), (0.0, 100.0, 1),
             (500.0, 0.0, 2), (5.0, 100.0, 0), (88.0, 100.0, 2), (40.0, 100.0, 2)]
    got = _both(lambda m: [m.cap.recommend_replicas(*c) for c in cases])
    assert got == [1, 2, 2, 7, 1, 2, 1, 1, 2, 1, 2, 1]


def test_recommendation_crosses_each_band_exactly_once_per_direction():
    ramp = [10.0 * i for i in range(1, 61)]
    decay = [600.0 - 10.0 * i for i in range(1, 60)]
    phases = (("ramp", ramp), ("hold_hi", [600.0] * 30), ("decay", decay),
              ("hold_lo", [10.0] * 30))

    def script(m):
        current, changes = 1, []
        for name, series in phases:
            for demand in series:
                rec = m.cap.recommend_replicas(demand, 100.0, current)
                if rec != current:
                    changes.append((name, "up" if rec > current else "down"))
                    current = rec
        return changes, current

    changes, current = _both(script)
    assert all(d == "up" for p, d in changes if p == "ramp")
    assert all(d == "down" for p, d in changes if p == "decay")
    assert not [c for c in changes if c[0] in ("hold_hi", "hold_lo")] and current == 1


# ------------------------------------------------------------ capacity_report


def _forecast_dict(token_rate, queue_depth=0.0, live_slots=0.0, trend=0.0):
    return {
        "rates_short": {"arrival_rate": token_rate / 10.0, "admit_rate": token_rate / 10.0,
                        "token_rate": token_rate,
                        "prefill_token_rate": token_rate / 4.0,
                        "decode_token_rate": 3.0 * token_rate / 4.0},
        "trend_tokens_per_s2": trend,
        "queue_depth": queue_depth,
        "queue_wait_s": 0.0,
        "live_slots_mean": live_slots,
    }


def test_capacity_report_backlog_and_bounds():
    def script(m):
        report = m.cap.capacity_report
        return [
            report([_forecast_dict(100.0, queue_depth=2.0, live_slots=4.0)], [200.0], 1),
            report([_forecast_dict(180.0, queue_depth=20.0, live_slots=4.0, trend=0.5)],
                   [200.0], 1, horizon_s=30.0),
            report([_forecast_dict(500.0)], [0.0], 2),
            report([_forecast_dict(900.0)], [100.0], 2, max_replicas=3),
            report([_forecast_dict(0.0)], [100.0], 2, min_replicas=2),
        ]

    calm, jammed, unknown, capped, floored = _both(script)
    assert calm["current_load"]["backlog_factor"] == 1.0 and calm["recommended_replicas"] == 1
    assert jammed["current_load"]["backlog_factor"] == pytest.approx(5.0)
    assert jammed["forecast"]["demand_tokens_per_s"] == pytest.approx(915.0)
    assert jammed["recommended_replicas"] > 1 and jammed["headroom"]["tokens_per_s"] < 0.0
    assert unknown["capacity"]["replicas_measured"] == 0 and unknown["recommended_replicas"] == 2
    assert capped["recommended_replicas"] == 3
    assert floored["recommended_replicas"] == 2
    assert floored["bounds"] == {"min_replicas": 2, "max_replicas": None}
    assert set(floored) == {"replicas", "current_load", "forecast", "capacity", "headroom",
                            "recommended_replicas", "bands", "bounds"}


def test_report_from_capacity_snapshots_and_role_sections():
    snap = {"slots": 4, "mean_decode_tick_s": 0.05, "mean_tokens_per_step": 0.0,
            "live_slots_mean": 2.0, "model_flops_utilization": 0.0,
            "hbm_bandwidth_utilization": 0.0,
            "forecaster": _forecast_dict(40.0, live_slots=2.0, trend=0.1)}
    roles = [dict(snap, role=r) for r in ("prefill", "decode", "mixed")]

    def script(m):
        return (m.cap.report_from_capacity_snapshots([snap, snap], 2),
                m.cap.report_from_capacity_snapshots(roles, 3, max_replicas=4),
                m.cap.role_sections(["mixed"], [_forecast_dict(80.0)], [100.0], growth=1.5))

    pair, split, sections = _both(script)
    assert pair["capacity"]["per_replica_tokens_per_s"] == pytest.approx(80.0)
    assert pair["capacity"]["total_tokens_per_s"] == pytest.approx(160.0)
    assert pair["current_load"]["token_rate"] == pytest.approx(80.0)
    assert pair["recommended_replicas"] == 2 and set(pair["roles"]) == {"prefill", "decode"}
    assert split["roles"]["prefill"]["replicas"] == 2
    assert split["roles"]["decode"]["dedicated_replicas"] == 1
    assert sections["decode"]["forecast_demand_tokens_per_s"] == pytest.approx(90.0)


# ------------------------------------------------------ Autoscaler (scripted)


class _ScriptedFleet:
    """The surface Autoscaler reads off a fleet, with a scripted demand
    routed through its package's real report."""

    def __init__(self, m, replicas=1, demand=0.0, per_replica=100.0):
        self.m = m
        self.n = replicas
        self.demand = demand
        self.per_replica = per_replica
        self.recorder = m.tracing.FlightRecorder(64)
        self.adds = self.retires = 0
        self.fail_add = False

    def capacity_report(self, horizon_s=60.0, min_replicas=1, max_replicas=None):
        return self.m.cap.capacity_report(
            [_forecast_dict(self.demand, live_slots=4.0)], [self.per_replica] * self.n, self.n,
            horizon_s=horizon_s, min_replicas=min_replicas, max_replicas=max_replicas)

    def add_replica(self):
        if self.fail_add:
            raise RuntimeError("replica factory failure")
        self.n += 1
        self.adds += 1
        return self.n - 1, object()

    def retire_replica(self, rid=None, timeout_s=60.0):
        if self.n <= 1:
            raise ValueError("cannot retire the last replica")
        self.n -= 1
        self.retires += 1
        return rid


def _events(fleet):
    return [{k: v for k, v in e.items() if k != "t_s"} for e in fleet.recorder.events()]


def test_autoscaler_dry_run_records_without_acting():
    def script(m):
        fleet = _ScriptedFleet(m, replicas=1, demand=300.0)
        scaler = m.cap.Autoscaler(fleet, mode="dry-run", max_replicas=8, cooldown_s=0.0)
        d = scaler.tick(0.0)
        return d, fleet.n, fleet.adds, _events(fleet), scaler.decisions()

    d, n, adds, events, decisions = _both(script)
    assert d["direction"] == "up" and d["applied"] is False and n == 1 and adds == 0
    assert [e["kind"] for e in events] == ["scale_decision"]
    assert events[0]["mode"] == "dry-run" and events[0]["applied"] is False
    assert decisions == [d]


def test_autoscaler_on_applies_one_step_under_cooldown():
    def script(m):
        fleet = _ScriptedFleet(m, replicas=1, demand=500.0)
        scaler = m.cap.Autoscaler(fleet, mode="on", max_replicas=8, cooldown_s=30.0)
        out = []
        for now in (0.0, 10.0, 31.0):
            out.append((scaler.tick(now), fleet.n))
        fleet.demand = 10.0
        out.append((scaler.tick(62.0), fleet.n))
        return out, fleet.retires

    steps, retires = _both(script)
    (d1, n1), (d2, n2), (d3, n3), (d4, n4) = steps
    assert d1["applied"] is True and n1 == 2  # one step, not to the target
    assert d2["cooldown"] is True and d2["applied"] is False and n2 == 2
    assert d3["applied"] is True and n3 == 3
    assert d4["direction"] == "down" and n4 == 2 and retires == 1


def test_autoscaler_bounds_off_failure_and_history():
    def script(m):
        fleet = _ScriptedFleet(m, replicas=2, demand=10_000.0)
        at_max = m.cap.Autoscaler(fleet, mode="on", max_replicas=2, cooldown_s=0.0).tick(0.0)
        fleet.demand = 0.0
        at_min = m.cap.Autoscaler(fleet, mode="on", min_replicas=2, max_replicas=4,
                                  cooldown_s=0.0).tick(0.0)
        off = m.cap.Autoscaler(_ScriptedFleet(m, demand=10_000.0), mode="off", max_replicas=8)
        off_out = (off.tick(0.0), off.decisions())
        failing = _ScriptedFleet(m, replicas=1, demand=500.0)
        failing.fail_add = True
        scaler = m.cap.Autoscaler(failing, mode="on", max_replicas=4, cooldown_s=30.0)
        failed = scaler.tick(0.0)
        failing.fail_add = False
        retried = scaler.tick(1.0)
        with pytest.raises(ValueError) as err:
            m.cap.Autoscaler(_ScriptedFleet(m), mode="auto")
        hist = m.cap.Autoscaler(_ScriptedFleet(m, replicas=1, demand=500.0), mode="dry-run",
                                max_replicas=8, cooldown_s=0.0, history=4)
        for i in range(10):
            hist.tick(float(i))
        return (at_max, at_min, off_out, failed, retried, failing.n, str(err.value),
                len(hist.decisions(limit=64)), len(hist.decisions(limit=2)))

    at_max, at_min, off_out, failed, retried, n, message, kept, last2 = _both(script)
    assert at_max is None and at_min is None and off_out == (None, [])
    assert failed["applied"] is False and "RuntimeError" in failed["error"]
    assert retried["applied"] is True and n == 2  # a failure starts no cooldown
    assert "unknown autoscale mode 'auto'" in message and (kept, last2) == (4, 2)


# --------------------------------------------------------- engine snapshots


@pytest.fixture(scope="module")
def gen():
    mc = get_preset("tiny")
    params = tf.init_params(mc, seed=0, device="cpu", dtype=torch.float32)
    return Generator(params, mc, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                     eos_token_ids=[], device="cpu")


def _jax_capacity_keys():
    """The key set of a (cold) JAX paged engine's ``capacity_snapshot``:
    top level and the forecaster's view."""
    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTok
    from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
    from llm_fine_tune_distributed_tpu.infer.engine import (
        PagedContinuousBatchingEngine as JaxPaged,
    )
    from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_preset
    from llm_fine_tune_distributed_tpu.models.transformer import init_params

    mc = jax_preset("tiny")
    jgen = JaxGenerator(init_params(jax.random.PRNGKey(0), mc, dtype=jnp.float32), mc, JaxTok(),
                        compute_dtype=jnp.float32, eos_token_ids=[])
    snap = JaxPaged(jgen, **GEOMETRY["paged"]).capacity_snapshot()
    return set(snap), set(snap["forecaster"])


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_engine_capacity_snapshot_has_the_jax_keys_and_live_signal(gen, kind):
    """Traffic feeds the forecaster on the tick clock (the ring samples
    every 10 ms here) and the snapshot carries the measured tick, which the
    saturation model turns into a positive capacity."""
    eng = ENGINES[kind](gen, slo_sample_interval_s=0.01, **GEOMETRY[kind])
    try:
        cold = eng.capacity_snapshot()
        assert cold["decode_ticks"] == 0 and cold["mean_decode_tick_s"] == 0.0
        for text in ("alpha", "beta bravo", "the quick brown fox"):
            eng.submit(list(text.encode()), GenerationConfig(max_new_tokens=6, do_sample=False),
                       timeout=240)
        snap = eng.capacity_snapshot()
    finally:
        eng.close()
    top, fc = _jax_capacity_keys()
    assert set(snap) == top and set(snap["forecaster"]) == fc
    assert snap["slots"] == 4 and snap["role"] == "mixed"
    assert snap["decode_ticks"] > 0 and snap["mean_decode_tick_s"] > 0.0
    assert snap["mean_tokens_per_step"] > 0.0
    assert snap["forecaster"]["samples"] >= 1
    assert set(snap["forecaster"]["rates_short"]) == set(capacity.LoadForecaster.RATES)
    rep = capacity.report_from_capacity_snapshots([snap], 1, max_replicas=4)
    assert rep["capacity"]["per_replica_tokens_per_s"] > 0.0
    assert 1 <= rep["recommended_replicas"] <= 4


# ------------------------------------------------------------ elastic fleets
#
# ``tests/test_capacity.py``'s fleet cases on both packages' paged fleets
# over the same tiny weights (JAX PRNGKey(0), f32).


@pytest.fixture(scope="module")
def fleet_pair():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTok
    from llm_fine_tune_distributed_tpu.infer import EngineFleet as JaxFleet
    from llm_fine_tune_distributed_tpu.infer import GenerationConfig as JaxConfig
    from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
    from llm_fine_tune_distributed_tpu.infer.engine import (
        PagedContinuousBatchingEngine as JaxPaged,
    )
    from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_preset
    from llm_fine_tune_distributed_tpu.models.transformer import init_params
    from llm_fine_tune_distributed_tpu.observe.metrics import prometheus_exposition as jax_expo
    from llm_fine_tune_distributed_tpu_torch.infer.fleet import EngineFleet
    from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax
    from llm_fine_tune_distributed_tpu_torch.observe.metrics import prometheus_exposition

    jmc = jax_preset("tiny")
    jparams = init_params(jax.random.PRNGKey(0), jmc, dtype=jnp.float32)
    jgen = JaxGenerator(jparams, jmc, JaxTok(), compute_dtype=jnp.float32, eos_token_ids=[])
    mc = get_preset("tiny")
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jparams)).items()}
    pgen = Generator(params_from_jax(flat, mc), mc, ByteChatMLTokenizer(),
                     compute_dtype=torch.float32, eos_token_ids=[], device="cpu")
    return {"jax": SimpleNamespace(gen=jgen, paged=JaxPaged, fleet=JaxFleet, config=JaxConfig,
                                   cap=jax_capacity, expo=jax_expo),
            "port": SimpleNamespace(gen=pgen, paged=PagedContinuousBatchingEngine,
                                    fleet=EngineFleet, config=GenerationConfig, cap=capacity,
                                    expo=prometheus_exposition)}


def _fleet_both(fleet_pair, script):
    out = {name: script(side) for name, side in fleet_pair.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def _elastic_fleet(side, n=1, routing="prefix", **kw):
    """A growable fleet of paged replicas and the factory it grows from."""
    kw = {"restart_backoff_s": 0.01, "restart_backoff_max_s": 0.02, **kw}

    def factory(rid):
        return side.paged(side.gen, **GEOMETRY["paged"], **kw)

    return side.fleet([factory(i) for i in range(n)], routing=routing, replica_factory=factory)


def _fleet_prompts():
    tok = ByteChatMLTokenizer()
    return [tok.encode(t) for t in ("alpha", "beta bravo", "the quick brown fox")]


def _settled(fleet, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while any(r.queue_depth or r.live_slots for r in fleet.replicas):
        assert time.monotonic() < deadline, "fleet never went idle"
        time.sleep(0.005)


def _close_fleet(fleet):
    if hasattr(fleet, "close"):  # the JAX fleet has no close()
        fleet.close()


def test_scale_up_then_retire_bit_identical_and_recorded(fleet_pair):
    """Growing the fleet and retiring back down changes where requests run,
    never what they return; both steps are on the fleet's flight recorder."""
    def script(side):
        g = side.config(max_new_tokens=6, do_sample=False)
        prompts = _fleet_prompts()
        solo = [side.gen.generate_ids(p, g) for p in prompts]
        fleet = _elastic_fleet(side, n=1)
        outs = [fleet.submit(prompts[0], g, timeout=240)]
        rid, rep = fleet.add_replica()
        grown = (rid, len(fleet.replicas), rep is fleet.replicas[1])
        for p in prompts[1:]:
            _settled(fleet)
            outs.append(fleet.submit(p, g, timeout=240))
        retired = fleet.retire_replica(timeout_s=60.0)
        n = len(fleet.replicas)
        outs.append(fleet.submit(prompts[0], g, timeout=240))
        kinds = [e["kind"] for e in fleet.recorder.events()]
        snap = fleet.stats_snapshot()
        try:
            fleet.retire_replica()
            last = None
        except ValueError as e:
            last = type(e).__name__
        _close_fleet(fleet)
        return {"ok": outs == solo + [solo[0]], "grown": grown, "retired": (retired, n),
                "events": (kinds.count("scale_up"), kinds.count("scale_down")),
                "snap": (snap["replicas"], snap["replicas_retired"], snap["tokens_served"]),
                "last": last}

    assert _fleet_both(fleet_pair, script) == {
        "ok": True, "grown": (1, 2, True), "retired": (1, 1), "events": (1, 1),
        "snap": (1, 1, 24), "last": "ValueError"}


def _metric_total(text, name):
    import re

    m = re.search(rf"^{name}(?:{{}})? (\S+)$", text, re.MULTILINE)
    assert m, f"{name} missing from exposition"
    return float(m.group(1))


def test_scale_down_3_to_1_mid_traffic_totals_monotone(fleet_pair):
    """Scaling 3 -> 1 with requests in flight folds each retired replica's
    counters and histograms into the fleet's first, so no total goes down
    and every answer stays its solo run."""
    def script(side):
        import threading

        g = side.config(max_new_tokens=6, do_sample=False)
        fleet = _elastic_fleet(side, n=3, routing="round-robin")
        prompts = _fleet_prompts()
        solo = [side.gen.generate_ids(p, g) for p in prompts]
        for p in prompts:
            fleet.submit(p, g, timeout=240)
        before = fleet.stats_snapshot()

        def expo(snap):
            s = dict(snap)
            s.pop("per_replica", None)
            return side.expo(s, fleet.merged_histograms())

        before_total = _metric_total(expo(before), "serving_tokens_served_total")
        outcomes = [None] * len(prompts)

        def ask(i):
            try:
                outcomes[i] = ("ok", fleet.submit(prompts[i], g, timeout=240))
            except BaseException as e:  # noqa: BLE001 - recording the outcome
                outcomes[i] = ("err", type(e).__name__)

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        fleet.retire_replica(timeout_s=60.0)
        fleet.retire_replica(timeout_s=60.0)
        for t in threads:
            t.join(timeout=240)
        after = fleet.stats_snapshot()
        out = {"hung": any(t.is_alive() for t in threads),
               "answers": outcomes == [("ok", s) for s in solo],
               "per_before": sorted(before["per_replica"]), "per_after": sorted(after["per_replica"]),
               "replicas": (after["replicas"], after["replicas_retired"]),
               "monotone": all(after[k] >= before[k] for k in (
                   "tokens_served", "requests_completed", "prompt_tokens", "goodput_tokens",
                   "requests_admitted")),
               "tokens": after["tokens_served"],
               "ttft": after["histograms"]["ttft_s"]["count"]
               - before["histograms"]["ttft_s"]["count"],
               "total_up": _metric_total(expo(after), "serving_tokens_served_total")
               >= before_total}
        _close_fleet(fleet)
        return out

    assert _fleet_both(fleet_pair, script) == {
        "hung": False, "answers": True, "per_before": ["0", "1", "2"], "per_after": ["0"],
        "replicas": (1, 2), "monotone": True, "tokens": 36, "ttft": 3, "total_up": True}


def test_retire_purges_intent_map_and_reroutes(fleet_pair):
    """Retiring a replica drops the intent-map entries that point at it;
    repeats of its prefix route to a live replica with the same answer."""
    def script(side):
        g = side.config(max_new_tokens=6, do_sample=False)
        fleet = _elastic_fleet(side, n=2)
        prompt = ByteChatMLTokenizer().encode("the quick brown fox jumps over the lazy dog")
        first = fleet.submit(prompt, g, timeout=240)
        _settled(fleet)
        fleet.submit(prompt, g, timeout=240)
        home = fleet.recent_placements()[-1][0]
        homed = home in dict(fleet.replica_items()) and home in set(fleet._prefix_home.values())
        fleet.retire_replica(rid=home, timeout_s=60.0)
        purged = home not in set(fleet._prefix_home.values())
        _settled(fleet)
        again = fleet.submit(prompt, g, timeout=240) == first
        survivor = fleet.recent_placements()[-1][0]
        out = (homed, purged, again, survivor != home and survivor in dict(fleet.replica_items()))
        _close_fleet(fleet)
        return out

    assert _fleet_both(fleet_pair, script) == (True, True, True, True)


def test_fleet_capacity_report_end_to_end(fleet_pair):
    def script(side):
        g = side.config(max_new_tokens=6, do_sample=False)
        fleet = _elastic_fleet(side, n=2, slo_sample_interval_s=0.01)
        for p in _fleet_prompts():
            fleet.submit(p, g, timeout=240)
        rep = fleet.capacity_report(min_replicas=1, max_replicas=4)
        scaler = side.cap.Autoscaler(fleet, mode="dry-run", max_replicas=4, cooldown_s=0.0)
        scaler.tick(time.monotonic())
        out = (rep["replicas"], rep["capacity"]["replicas_measured"] >= 1,
               rep["capacity"]["per_replica_tokens_per_s"] > 0.0,
               1 <= rep["recommended_replicas"] <= 4, rep["bounds"], len(fleet.replicas))
        _close_fleet(fleet)
        return out

    assert _fleet_both(fleet_pair, script) == (
        2, True, True, True, {"min_replicas": 1, "max_replicas": 4}, 2)
