"""The port's SLO engine (``observe/slo.py``) and trace writer
(``observe/tracing.TraceJsonlWriter``) against the JAX package's on the
same scripts: the cases of ``tests/test_slo.py`` for the metric ring, the
generation slices, the burn-rate policy, the canary judge over fake engines
and the trace log's rotation.

Each script runs once per package with that package's classes, and the two
results must be equal (dicts, lists and numbers alike), then hold the JAX
test's assertions. Everything here is host arithmetic: no model, no device.
"""

import json
import os
import threading
import time
from types import SimpleNamespace

import pytest

from llm_fine_tune_distributed_tpu.observe import metrics as jax_metrics
from llm_fine_tune_distributed_tpu.observe import slo as jax_slo
from llm_fine_tune_distributed_tpu.observe import tracing as jax_tracing
from llm_fine_tune_distributed_tpu_torch.observe import metrics, slo, tracing

SIDES = {
    "port": SimpleNamespace(slo=slo, stats=metrics.ServingStats, tracing=tracing),
    "jax": SimpleNamespace(slo=jax_slo, stats=jax_metrics.ServingStats, tracing=jax_tracing),
}


def _both(script, *args):
    """``script(side, *args)`` on both packages; their results must be
    equal. Returns the port's."""
    mine = script(SIDES["port"], *args)
    theirs = script(SIDES["jax"], *args)
    assert mine == theirs
    return mine


# ------------------------------------------------------------- MetricRing


def test_ring_due_and_sample_cadence():
    def script(m):
        ring = m.slo.MetricRing(capacity=8, interval_s=1.0)
        stats = m.stats(slots=4)
        out = [ring.due(10.0)]
        ring.sample(10.0, stats)
        out += [ring.due(10.5), ring.due(11.0)]
        ring.sample(11.0, stats)
        return out + [len(ring)]

    assert _both(script) == [True, False, True, 2]


def test_ring_window_counters_baselines():
    def script(m, capacity):
        ring = m.slo.MetricRing(capacity=capacity, interval_s=1.0)
        stats = m.stats(slots=4)
        for t in (10.0, 11.0, 12.0):
            stats.incr("tokens_served", 5)
            ring.sample(t, stats)
        return ring.window_counters(1.5, now=12.0), ring.window_counters(100.0, now=12.0)

    narrow, wide = _both(script, 8)
    assert narrow["tokens_served"] == 10 and wide["tokens_served"] == 15
    # wrapped: the oldest retained sample is the baseline, not zero
    _, wide = _both(script, 2)
    assert wide["tokens_served"] == 5


def test_ring_histogram_deltas_are_exact():
    def script(m):
        ring = m.slo.MetricRing(capacity=8, interval_s=1.0)
        stats = m.stats(slots=4)
        stats.observe("ttft_s", 0.1)
        ring.sample(10.0, stats)
        stats.observe("ttft_s", 0.2)
        stats.observe("ttft_s", 0.2)
        ring.sample(11.0, stats)
        stats.observe("ttft_s", 0.4)
        ring.sample(12.0, stats)
        return ring.window_histogram("ttft_s", 1.5, now=12.0), \
            ring.window_histogram("ttft_s", 100.0, now=12.0)

    (counts, total, s), (_, total_all, s_all) = _both(script)
    assert total == 3 == sum(counts) and s == pytest.approx(0.8)
    assert total_all == 4 and s_all == pytest.approx(0.9)


def test_ring_series_counter_and_gauge():
    def script(m):
        ring = m.slo.MetricRing(capacity=8, interval_s=1.0)
        stats = m.stats(slots=4)
        for t, depth in ((10.0, 2), (11.0, 7)):
            stats.incr("requests_admitted", 3)
            ring.sample(t, stats, gauges={"queue_depth": depth})
        with pytest.raises(ValueError) as err:
            ring.series("not_a_metric")
        return (ring.series("requests_admitted", now=11.0), ring.series("queue_depth", now=11.0),
                str(err.value), sorted(ring.metrics()))

    counter, gauge, message, names = _both(script)
    assert counter["kind"] == "counter"
    assert [p["value"] for p in counter["samples"]] == [3, 6]
    assert [p["delta"] for p in counter["samples"]] == [0, 3]
    assert [p["age_s"] for p in counter["samples"]] == [1.0, 0.0]
    assert gauge["kind"] == "gauge" and [p["value"] for p in gauge["samples"]] == [2, 7]
    assert "unknown history metric 'not_a_metric'" in message
    assert set(names) == set(slo.RING_COUNTERS) | set(slo.RING_GAUGES)
    assert (slo.RING_COUNTERS, slo.RING_GAUGES, slo.RING_HISTOGRAMS) == \
        (jax_slo.RING_COUNTERS, jax_slo.RING_GAUGES, jax_slo.RING_HISTOGRAMS)


def test_frac_above_interpolates():
    def script(m):
        h = m.tracing.Histogram.exponential()
        for v in (0.01, 0.02, 0.04, 10.0):
            h.observe(v)
        counts, total, _ = h._state()
        return [m.slo._frac_above(h.bounds, counts, total, t) for t in (1e-6, 1e6, 1.0, 0.03)]

    lo, hi, one, mid = _both(script)
    assert lo == pytest.approx(1.0) and hi == pytest.approx(0.0)
    assert one == pytest.approx(0.25, abs=0.05) and 0.25 < mid < 0.75


# ------------------------------------------------------ GenerationSlices


def test_generation_slices_settle_summaries_and_prune():
    def script(m):
        slices = m.slo.GenerationSlices(keep=4)
        s0 = slices.slice_for(0)
        s0.ttft.observe(0.1)
        s0.inter_token.observe(0.02)
        slices.note_settled(0, failed=False)
        slices.note_settled(0, failed=True)
        small = m.slo.GenerationSlices(keep=2)
        for gen in range(5):
            small.slice_for(gen)
        pruned = small.generations()
        small.note_settled(0, failed=False)  # a straggler of a pruned generation
        return slices.summaries(), pruned, small.generations()

    out, pruned, after = _both(script)
    assert set(out) == {"0"} and out["0"]["completed"] == 1 and out["0"]["failed"] == 1
    assert out["0"]["error_rate"] == pytest.approx(0.5) and out["0"]["ttft"]["count"] == 1
    assert pruned == after == [3, 4]


def test_generation_slices_delta_and_merge():
    def script(m):
        GS = m.slo.GenerationSlices
        slices = GS()
        s = slices.slice_for(1)
        s.ttft.observe(0.1)
        slices.note_settled(1, failed=False)
        then = slices.state(1)
        s.ttft.observe(0.4)
        s.ttft.observe(0.4)
        slices.note_settled(1, failed=False)
        slices.note_settled(1, failed=True)
        d = GS.delta(slices.state(1), then)
        other = GS()
        other.slice_for(1).ttft.observe(0.2)
        other.note_settled(1, failed=False)
        merged = GS.merge_states([slices.state(1), other.state(1)])
        return d, merged, GS.merged_summaries([slices, other]), GS.merge_states([])

    d, merged, fleet, empty = _both(script)
    assert d["completed"] == 1 and d["failed"] == 1 and d["error_rate"] == pytest.approx(0.5)
    assert d["ttft"]["count"] == 2 and d["ttft"]["mean"] == pytest.approx(0.4, rel=0.01)
    assert merged["completed"] == 3 and merged["failed"] == 1 and merged["ttft"][1] == 4
    assert fleet["1"]["completed"] == 3 and fleet["1"]["ttft"]["count"] == 4
    assert empty["completed"] == 0


# ------------------------------------------------------------- SloPolicy


def _ring_with_errors(m, n_ok, n_bad):
    """Completions and failures inside both windows as of t=700: the
    baseline at t=10 predates both cutoffs."""
    ring = m.slo.MetricRing(capacity=16, interval_s=1.0)
    stats = m.stats(slots=4)
    ring.sample(10.0, stats)
    stats.incr("requests_completed", n_ok)
    stats.incr("requests_failed", n_bad)
    for t in (660.0, 700.0):
        ring.sample(t, stats)
    return ring


def test_slo_error_rate_burn_math_and_min_events():
    def script(m):
        policy = m.slo.SloPolicy(error_rate=0.01, fast_window_s=60.0, slow_window_s=600.0,
                                 min_events=8)
        return [policy.evaluate(_ring_with_errors(m, ok, bad), now=700.0)
                for ok, bad in ((90, 10), (100, 0), (1, 1))]

    hot, clean, thin = _both(script)
    obj = hot["objectives"]["error_rate"]
    assert not obj["compliant"] and not hot["compliant"]
    for w in obj["windows"].values():
        assert w["burn_rate"] == pytest.approx(10.0) and w["events"] == 100
    assert clean["compliant"]
    assert clean["objectives"]["error_rate"]["windows"]["fast"]["burn_rate"] == 0.0
    assert thin["compliant"]  # 50% errors but 2 events < min_events


def test_slo_breach_needs_every_window_hot():
    def script(m):
        ring = m.slo.MetricRing(capacity=16, interval_s=1.0)
        stats = m.stats(slots=4)
        ring.sample(10.0, stats)
        stats.incr("requests_completed", 50)
        stats.incr("requests_failed", 50)
        ring.sample(200.0, stats)  # the bad minute: in the slow window only
        stats.incr("requests_completed", 20)
        ring.sample(690.0, stats)
        policy = m.slo.SloPolicy(error_rate=0.01, fast_window_s=60.0, slow_window_s=600.0,
                                 min_events=8)
        return policy.evaluate(ring, now=695.0)

    obj = _both(script)["objectives"]["error_rate"]
    assert obj["windows"]["slow"]["burn_rate"] > 1.0
    assert obj["windows"]["fast"]["burn_rate"] == 0.0 and obj["compliant"]


def test_slo_latency_and_availability_objectives():
    def script(m):
        ring = m.slo.MetricRing(capacity=16, interval_s=1.0)
        stats = m.stats(slots=4)
        ring.sample(10.0, stats)
        for _ in range(20):
            stats.observe("ttft_s", 10.0)  # every first token far over target
        stats.incr("requests_admitted", 80)
        stats.incr("requests_shed_overflow", 15)
        stats.incr("requests_shed_deadline", 5)
        ring.sample(660.0, stats)
        ring.sample(700.0, stats)
        policy = m.slo.SloPolicy(ttft_p99_s=2.0, availability=0.999, min_events=8)
        return policy.evaluate(ring, now=700.0), policy.evaluate(ring)

    report, at_last_sample = _both(script)
    ttft = report["objectives"]["ttft_p99"]
    assert not ttft["compliant"]
    assert ttft["windows"]["fast"]["bad_fraction"] == pytest.approx(1.0)
    assert ttft["windows"]["slow"]["bad_fraction"] == pytest.approx(1.0)
    avail = report["objectives"]["availability"]
    assert avail["windows"]["fast"]["bad_fraction"] == pytest.approx(0.2)
    assert not avail["compliant"] and at_last_sample == report


def test_slo_observe_transitions_and_merge_reports():
    def script(m):
        policy = m.slo.SloPolicy(error_rate=0.01, min_events=8)
        bad = policy.evaluate(_ring_with_errors(m, 90, 10), now=700.0)
        good = policy.evaluate(_ring_with_errors(m, 100, 0), now=700.0)
        edges = [policy.observe_transitions(r) for r in (bad, bad, good, good)]
        merged = m.slo.SloPolicy.merge_reports([bad, good])
        return edges, merged, m.slo.SloPolicy.merge_reports([])

    edges, merged, empty = _both(script)
    assert [[k for k, _ in e] for e in edges] == [["slo_breach"], [], ["slo_recovered"], []]
    assert edges[0][0][1]["objective"] == "error_rate"
    w = merged["objectives"]["error_rate"]["windows"]["fast"]
    assert not merged["compliant"] and w["burn_rate"] == pytest.approx(10.0)
    assert w["events"] == 200 and empty["compliant"]


# ------------------------------------------------------------ CanaryJudge


class _FakeEngine:
    """What CanaryJudge reads off an engine: slo_slices, weight_generation
    and recorder, each of its package's classes."""

    def __init__(self, m):
        self.slo_slices = m.slo.GenerationSlices()
        self.weight_generation = 0
        self.recorder = m.tracing.FlightRecorder(capacity=64)


def _feed(engine, gen, ttfts, inter=0.01, failed=0, delay=0.03):
    """Settled traffic into one engine's generation slice after a short
    delay: it lands inside the judge's confirmation window."""

    def run():
        time.sleep(delay)
        s = engine.slo_slices.slice_for(gen)
        for t in ttfts:
            s.ttft.observe(t)
            s.inter_token.observe(inter)
            engine.slo_slices.note_settled(gen, failed=False)
        for _ in range(failed):
            engine.slo_slices.note_settled(gen, failed=True)

    th = threading.Thread(target=run)
    th.start()
    return th


def _judge(m, canary_feed, sibling_feed, judge_kw):
    """One confirmation window over a canary (generation 1) and a sibling;
    the verdict without its window, and the canary's flight event kinds."""
    judge = m.slo.CanaryJudge(**{"window_s": 0.25, "min_requests": 4, "poll_s": 0.02,
                                 **judge_kw})
    canary, sib = _FakeEngine(m), _FakeEngine(m)
    canary.weight_generation = 1
    threads = [_feed(canary, 1, *canary_feed), _feed(sib, 0, *sibling_feed)]
    verdict = judge.judge(canary, [sib], generation=1)
    for t in threads:
        t.join()
    return verdict, [e["kind"] for e in canary.recorder.events()]


@pytest.mark.parametrize("case", ["pass", "latency_regression", "error_regression"])
def test_canary_verdicts_on_fake_engines(case):
    canary_feed, sibling_feed, kw, want = {
        "pass": (([0.05] * 6,), ([0.05] * 6,), dict(ttft_ratio=2.0, min_baseline_s=0.001), "pass"),
        "latency_regression": (([0.5] * 6,), ([0.05] * 6,),
                               dict(ttft_ratio=2.0, min_baseline_s=0.001), "regression"),
        "error_regression": (([0.05] * 4, 0.01, 4), ([0.05] * 6,), dict(max_error_rate=0.25),
                             "regression"),
    }[case]
    verdict, kinds = _both(_judge, canary_feed, sibling_feed, kw)
    assert verdict["verdict"] == want
    assert "canary_begin" in kinds and "canary_verdict" in kinds
    if case == "pass":
        assert verdict["canary_requests"] == 6 and verdict["baseline_requests"] == 6
    elif case == "latency_regression":
        assert "ttft" in verdict["reason"]
    else:
        assert "error rate" in verdict["reason"]


def test_canary_insufficient_traffic_and_no_siblings():
    def script(m):
        judge = m.slo.CanaryJudge(window_s=0.05, min_requests=4, poll_s=0.01)
        canary, sib = _FakeEngine(m), _FakeEngine(m)
        return judge.judge(canary, [], generation=1), judge.judge(canary, [sib], generation=1)

    alone, quiet = _both(script)
    assert alone["verdict"] == "no_siblings" and quiet["verdict"] == "insufficient_traffic"


# --------------------------------------------------- trace log rotation


def _write_traces(m, root, writer_kw, records):
    os.makedirs(root, exist_ok=True)
    writer = m.tracing.TraceJsonlWriter(os.path.join(root, "trace.jsonl"), **writer_kw)
    for rec in records:
        writer.write(rec)
    writer.close()
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name)) as f:
            out[name] = [json.loads(line) for line in f]
    return out


def test_trace_writer_rotates_and_keeps_last_k(tmp_path):
    records = [{"event": "request_done", "request_id": f"req-{i:04d}", "tokens": i}
               for i in range(50)]
    mine = _write_traces(SIDES["port"], str(tmp_path / "port"), dict(max_bytes=300, keep=2),
                         records)
    theirs = _write_traces(SIDES["jax"], str(tmp_path / "jax"), dict(max_bytes=300, keep=2),
                           records)
    assert mine == theirs
    assert {"trace.jsonl", "trace.jsonl.1"} <= set(mine) <= {
        "trace.jsonl", "trace.jsonl.1", "trace.jsonl.2"}
    assert all(r["event"] == "request_done" for recs in mine.values() for r in recs)
    assert mine["trace.jsonl"][-1]["request_id"] == "req-0049"
    assert os.path.getsize(tmp_path / "port" / "trace.jsonl.1") <= 400


def test_trace_writer_unbounded_by_default(tmp_path):
    records = [{"event": "e", "i": i} for i in range(100)]
    mine = _write_traces(SIDES["port"], str(tmp_path / "port"), {}, records)
    assert mine == _write_traces(SIDES["jax"], str(tmp_path / "jax"), {}, records)
    assert list(mine) == ["trace.jsonl"] and len(mine["trace.jsonl"]) == 100
