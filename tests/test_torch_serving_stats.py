"""The port's serving metrics against the JAX package's on the same inputs:
``Histogram`` (bounds, counts, percentiles, summary, Prometheus lines),
``ServingStats.snapshot()``'s key set, and the ``prometheus_exposition``
text of the same snapshot and histograms. The snapshot's time-dependent
values (``uptime_s``, ``tokens_per_s_1m``) are taken from one side and
handed to both."""

import numpy as np
import pytest

from llm_fine_tune_distributed_tpu.observe import metrics as jax_metrics
from llm_fine_tune_distributed_tpu.observe.tracing import Histogram as JaxHistogram
from llm_fine_tune_distributed_tpu_torch.observe import metrics
from llm_fine_tune_distributed_tpu_torch.observe.tracing import Histogram

FACTORIES = {
    "exponential": lambda cls: cls.exponential(),
    "linear": lambda cls: cls.linear(0.0, 16.0, 1.0),
}


def _observations(kind, seed, n=500):
    rng = np.random.default_rng(seed)
    if kind == "exponential":  # latencies from 0.05 ms to well past the top bound
        return np.exp(rng.uniform(np.log(5e-5), np.log(1e3), size=n)).tolist()
    return rng.integers(0, 20, size=n).astype(float).tolist()


def _pair(kind, seed):
    mine, theirs = FACTORIES[kind](Histogram), FACTORIES[kind](JaxHistogram)
    for v in _observations(kind, seed):
        mine.observe(v)
        theirs.observe(v)
    return mine, theirs


@pytest.mark.parametrize("kind", sorted(FACTORIES))
def test_histogram_matches_jax(kind):
    mine, theirs = _pair(kind, 0)
    more, more_jax = _pair(kind, 1)
    mine.merge(more)
    theirs.merge(more_jax)
    assert mine.bounds == theirs.bounds
    assert mine.counts == theirs.counts and mine.total == theirs.total == 1000
    assert mine.sum == theirs.sum
    for q in (0.5, 0.9, 0.99, 50, 90, 99, 100):
        assert mine.percentile(q) == theirs.percentile(q)
    assert mine.summary() == theirs.summary()
    for labels in ("", 'replica="0"'):
        assert mine.prometheus_lines("serving_x_seconds", labels) == \
            theirs.prometheus_lines("serving_x_seconds", labels)
    empty, empty_jax = FACTORIES[kind](Histogram), FACTORIES[kind](JaxHistogram)
    assert empty.summary() == empty_jax.summary() and empty.percentile(50) == 0.0
    with pytest.raises(ValueError):
        mine.merge(Histogram([1.0, 2.0]))


@pytest.mark.parametrize("total_blocks", [0, 63])
def test_serving_stats_snapshot_keys_match_jax(total_blocks):
    mine = metrics.ServingStats(4, total_blocks).snapshot()
    theirs = jax_metrics.ServingStats(4, total_blocks).snapshot()
    assert set(mine) == set(theirs)
    assert set(mine["histograms"]) == set(theirs["histograms"])
    assert mine["requests_shed_by_tier"] == theirs["requests_shed_by_tier"]
    assert mine["wasted_tokens_by_reason"] == theirs["wasted_tokens_by_reason"]
    pinned = ("uptime_s", "tokens_per_s_1m")
    assert {k: v for k, v in mine.items() if k not in pinned} == \
        {k: v for k, v in theirs.items() if k not in pinned}


def _traffic(stats):
    """The same counters, gauges and observations on either package's
    ServingStats."""
    for name, n in (("tokens_served", 37), ("requests_admitted", 5), ("requests_completed", 4),
                    ("requests_abandoned", 1), ("decode_steps", 30), ("prefill_tokens", 211),
                    ("decode_tokens", 33), ("goodput_tokens", 31), ("prompt_tokens", 211),
                    ("prefix_tokens_reused", 64), ("prefill_chunks", 7)):
        stats.incr(name, n)
    stats.waste_incr("abandoned", 6)
    stats.gauge("live_slots", 2)
    stats.gauge("queue_depth", 1)
    stats.gauge("blocks_in_use", 9)
    stats.gauge_max("peak_blocks_in_use", 12)
    rng = np.random.default_rng(3)
    for name in stats.hist:
        for v in rng.uniform(1e-4, 2.0, size=20):
            stats.observe(name, float(v))


@pytest.mark.parametrize("engine", ["continuous", "paged", "window"])
def test_prometheus_exposition_text_matches_jax(engine):
    if engine == "window":
        snap, hists, jax_hists = {"engine": "window", "queue_depth": 3, "max_batch": 8}, None, None
    else:
        blocks = 63 if engine == "paged" else 0
        mine, theirs = metrics.ServingStats(4, blocks), jax_metrics.ServingStats(4, blocks)
        _traffic(mine)
        _traffic(theirs)
        snap = {"engine": engine, **mine.snapshot()}
        jax_snap = {"engine": engine, **theirs.snapshot()}
        for key in ("uptime_s", "tokens_per_s_1m"):
            jax_snap[key] = snap[key]
        assert jax_snap == snap
        hists, jax_hists = mine.hist, theirs.hist
        # a slot engine's snapshot also carries its SLO report and its
        # per-generation slices (the port's own classes made them)
        snap["slo"], snap["per_generation"] = _slo_and_generations(mine)
    text = metrics.prometheus_exposition(snap, hists)
    assert text == jax_metrics.prometheus_exposition(snap, jax_hists)
    # with the cards' memory report (a card may lack a field)
    memory = {"1": {"bytes_in_use": 7, "peak_bytes_in_use": 9, "bytes_limit": None},
              "0": {"bytes_in_use": 3 << 30, "peak_bytes_in_use": 5 << 30,
                    "bytes_limit": 85899345920}}
    with_memory = metrics.prometheus_exposition(snap, hists, memory=memory)
    assert with_memory == jax_metrics.prometheus_exposition(snap, jax_hists, memory=memory)
    assert with_memory.startswith(text[:-1]) and with_memory.endswith(
        '# TYPE device_hbm_bytes_limit gauge\ndevice_hbm_bytes_limit{device="0"} 85899345920\n')
    assert metrics.prometheus_exposition(snap, hists, memory={}) == text
    if engine != "window":
        assert "serving_tokens_served_total 37\n" in text
        assert 'serving_wasted_tokens_total{reason="abandoned"} 6\n' in text
        assert 'serving_ttft_seconds_bucket{le="+Inf"} 20\n' in text
        assert "serving_slo_compliant 0\n" in text
        assert 'serving_slo_burn_rate{objective="error_rate",window="fast"} 20\n' in text
        assert 'serving_generation_requests_failed_total{generation="1"} 1\n' in text
    assert metrics.PROMETHEUS_CONTENT_TYPE == jax_metrics.PROMETHEUS_CONTENT_TYPE


def _slo_and_generations(stats):
    """An SLO report with a breach (20% failures) and the summaries of two
    weight generations."""
    from llm_fine_tune_distributed_tpu_torch.observe import slo

    ring = slo.MetricRing(capacity=8, interval_s=1.0)
    ring.sample(10.0, stats)
    stats.incr("requests_completed", 40)
    stats.incr("requests_failed", 10)
    ring.sample(700.0, stats)
    slices = slo.GenerationSlices()
    for gen, ttft, failed in ((0, 0.25, False), (1, 3.5, True), (1, 0.5, False)):
        slices.slice_for(gen).ttft.observe(ttft)
        slices.slice_for(gen).inter_token.observe(ttft / 10)
        slices.note_settled(gen, failed=failed)
    return slo.SloPolicy().evaluate(ring, now=700.0), slices.summaries()
