"""Serving observability of the port against the JAX package's, on the
``tiny`` preset in f32:

- ``RequestTrace`` gives the JAX dict for the same marks;
- a greedy request's trace spans on both slot engines: names and order
  equal to the JAX engine's for the same request on the same weights (the
  paged prompt is long enough for a prefill chunk), and the trace log's
  record: the JAX keys, and its values apart from times and the random
  trace id;
- ``stats_snapshot``'s key set is the JAX engine's minus ``compile`` (the
  port compiles no programs; the paged engine keeps its ``prefix_hits``);
- ``memory_breakdown`` equals the JAX engine's for the same weights (plain
  and int8) and the same pools (dense, paged bf16, paged int8);
- the server's ``/v1/slo``, ``/v1/history`` (its 400s included),
  ``/v1/capacity``, ``/v1/lineage`` (the JAX 404), ``/v1/profile`` (404
  without ``--profile-dir``, 400 on a bad body, 409 while a capture runs:
  a stub capture, no GPU), the ``"trace"`` field, the memory keys of
  ``/v1/stats`` and the SLO series of ``/metrics``, on port 0; the window
  engine's JAX 404s; the observability flags reach ``serve`` as the JAX
  server's ``main`` hands them to its ``serve``;
- the tenant series (``tests/test_metrics_schema.py``'s cases): the
  per-tenant key set, tenant-labelled samples and histograms, their TYPE
  lines at zero tenants, and the fleet's per-tenant sums, line for line the
  JAX exposition's.
"""

import ast
import http.client
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer import server
from llm_fine_tune_distributed_tpu_torch.infer.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.observe import capacity, profiler, tracing

TIMEOUT = 240
GEOMETRY = {"continuous": dict(slots=4, buf_len=96, prompt_bucket=16),
            "paged": dict(slots=4, buf_len=96, prompt_bucket=16, block_len=16, prefill_chunk=32)}
SHORT = list(b"alpha")
LONG = list(b"the quick brown fox jumps over the lazy dog, twice over")  # 55 > one chunk
QUESTION = {"question": "How many cups in a gallon?", "system_prompt": "Be brief.",
            "greedy": True, "max_new_tokens": 6}
SERVER_GEOMETRY = dict(slots=2, kv_buf_len=256, kv_block_len=16, prefill_chunk=64, max_batch=2)


def test_request_trace_matches_jax():
    from llm_fine_tune_distributed_tpu.observe.tracing import RequestTrace as JaxTrace

    traces = [cls(request_id=7, t0=100.0, trace_id="abc") for cls in (tracing.RequestTrace, JaxTrace)]
    for tr in traces:
        for span, t in (("received", 100.0), ("queued", 100.0), ("admitted", 100.5),
                        ("completed", 101.25)):
            tr.mark(span, t=t)
    mine, theirs = (tr.to_dict() for tr in traces)
    assert mine == theirs
    assert [e["span"] for e in mine["events"]] == ["received", "queued", "admitted", "completed"]
    assert mine["events"][2]["t_s"] == pytest.approx(0.5) and mine["total_s"] == pytest.approx(1.25)
    fresh = tracing.RequestTrace(3).to_dict()
    assert set(fresh) == {"request_id", "trace_id", "events"} and fresh["events"] == []
    assert len(fresh["trace_id"]) == 16
    assert len({tracing.RequestTrace().trace_id for _ in range(8)}) == 8  # fresh ids


# ----------------------------------------------------------- the engines


def _pair(quantize=False, compute="f32"):
    """The JAX and the port's Generator on the same tiny weights (the JAX
    package's, from PRNGKey(0)), optionally quantized to int8 by each
    package's own quantizer."""
    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTok
    from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
    from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_preset
    from llm_fine_tune_distributed_tpu.models.transformer import init_params
    from llm_fine_tune_distributed_tpu.ops import int8 as jax_int8
    from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax
    from llm_fine_tune_distributed_tpu_torch.ops import int8

    jmc, mc = jax_preset("tiny"), get_preset("tiny")
    jparams = init_params(jax.random.PRNGKey(0), jmc, dtype=jnp.float32)
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jparams)).items()}
    params = params_from_jax(flat, mc)
    if quantize:
        jparams, params = jax_int8.quantize_params_int8(jparams), int8.quantize_params_int8(params)
    jdtype, dtype = {"f32": (jnp.float32, torch.float32),
                     "bf16": (jnp.bfloat16, torch.bfloat16)}[compute]
    jgen = JaxGenerator(jparams, jmc, JaxTok(), compute_dtype=jdtype, eos_token_ids=[])
    gen = Generator(params, mc, ByteChatMLTokenizer(), compute_dtype=dtype, eos_token_ids=[],
                    device="cpu")
    return jgen, gen


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _jax_engine(jgen, kind, **kw):
    from llm_fine_tune_distributed_tpu.infer import engine as jax_engine

    cls = {"continuous": jax_engine.ContinuousBatchingEngine,
           "paged": jax_engine.PagedContinuousBatchingEngine}[kind]
    eng = cls(jgen, **{**GEOMETRY[kind], **kw})
    deadline = time.monotonic() + TIMEOUT
    while eng._cache is None:  # its worker builds the cache
        assert time.monotonic() < deadline, "the JAX engine never built its cache"
        time.sleep(0.01)
    return eng


def _port_engine(gen, kind, **kw):
    cls = {"continuous": ContinuousBatchingEngine, "paged": PagedContinuousBatchingEngine}[kind]
    return cls(gen, **{**GEOMETRY[kind], **kw})


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_engine_trace_spans_and_trace_log_match_jax(pair, kind, tmp_path):
    from llm_fine_tune_distributed_tpu.infer import GenerationConfig as JaxConfig

    jgen, gen = pair
    prompt = LONG if kind == "paged" else SHORT
    logs = {side: str(tmp_path / side / "traces.jsonl") for side in ("port", "jax")}
    eng = _port_engine(gen, kind, trace_log=logs["port"])
    try:
        req = eng.submit_full(prompt, GenerationConfig(max_new_tokens=6, do_sample=False),
                              timeout=TIMEOUT)
        snap = eng.stats_snapshot()
    finally:
        eng.close()
    jeng = _jax_engine(jgen, kind, trace_log=logs["jax"])
    jreq = jeng.submit_full(prompt, JaxConfig(max_new_tokens=6, do_sample=False), timeout=TIMEOUT)
    spans = [s for s, _ in req.trace.events]
    assert spans == [s for s, _ in jreq.trace.events]
    want = ["received", "queued", "admitted"] + (["prefill_chunk"] if kind == "paged" else []) + \
        ["prefill", "first_token", "completed"]
    assert spans == want
    times = [t for _, t in req.trace.events]
    assert times == sorted(times)
    hists = snap["histograms"]
    assert hists["ttft_s"]["count"] == 1 and hists["inter_token_s"]["count"] == 5
    assert snap["per_generation"]["0"]["completed"] == 1
    assert snap["per_generation"]["0"]["ttft"]["count"] == 1
    (mine,), (theirs,) = _records(logs["port"]), _records(logs["jax"])
    assert set(mine) == set(theirs)
    timeless = ("trace_id", "events", "total_s")
    assert {k: v for k, v in mine.items() if k not in timeless} == \
        {k: v for k, v in theirs.items() if k not in timeless}
    assert mine["request_id"] == req.id and mine["generated_tokens"] == 6
    assert mine["error"] is None and mine["prompt_tokens"] == len(prompt)
    assert [e["span"] for e in mine["events"]] == [e["span"] for e in theirs["events"]] == want


@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_stats_snapshot_keys_are_the_jax_keys_but_compile(pair, kind):
    jgen, gen = pair
    eng = _port_engine(gen, kind)
    try:
        snap = eng.stats_snapshot()
    finally:
        eng.close()
    jsnap = _jax_engine(jgen, kind).stats_snapshot()
    extra = {"prefix_hits"} if kind == "paged" else set()
    assert set(snap) == set(jsnap) - {"compile"} | extra
    assert set(snap["slo"]) == set(jsnap["slo"]) and snap["slo"]["compliant"] is True
    assert snap["role"] == jsnap["role"] == "mixed"
    assert snap["per_generation"] == jsnap["per_generation"]  # generation 0, empty
    assert snap["per_generation"]["0"]["completed"] == 0
    assert snap["model_flops_utilization"] == 0.0 == snap["hbm_bandwidth_utilization"]
    assert snap["weight_bytes"] == jsnap["weight_bytes"] > 0
    assert snap["kv_pool_bytes"] == jsnap["kv_pool_bytes"] > 0


@pytest.mark.parametrize("weights,compute,kind,kv_quant", [
    ("f32", "f32", "continuous", "none"),
    ("f32", "bf16", "paged", "none"),
    ("f32", "f32", "paged", "int8"),
    ("int8", "f32", "paged", "int8"),
    ("int8", "bf16", "continuous", "none"),
])
def test_memory_breakdown_matches_jax(weights, compute, kind, kv_quant):
    jgen, gen = _pair(quantize=weights == "int8", compute=compute)
    kw = {"kv_quant": kv_quant} if kind == "paged" else {}
    eng = _port_engine(gen, kind, **kw)
    try:
        mine = eng.memory_breakdown()
    finally:
        eng.close()
    theirs = _jax_engine(jgen, kind, **kw).memory_breakdown()
    assert mine == theirs
    assert mine["kv_scale_bytes"] > 0 if kv_quant == "int8" else mine["kv_scale_bytes"] == 0
    quantized = weights == "int8" or kv_quant == "int8"
    assert (mine["bytes_saved_vs_bf16"] > 0) == quantized


# ------------------------------------------------------------ the server


@pytest.fixture(scope="module")
def gen(pair):
    return pair[1]


class _Server:
    """``build_server`` on a thread, for one test."""

    def __init__(self, gen, **kw):
        self.httpd, self.engine = server.build_server(gen, host="127.0.0.1", port=0,
                                                      **{**SERVER_GEOMETRY, **kw})
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.engine.close()
        self.thread.join(10)

    def request(self, method, path, body=None, raw=None):
        """-> (status, parsed JSON or text)."""
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=TIMEOUT)
        try:
            data = raw if raw is not None else (None if body is None else json.dumps(body))
            conn.request(method, path, body=data, headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            text = resp.read().decode()
            try:
                return resp.status, json.loads(text)
            except ValueError:
                return resp.status, text
        finally:
            conn.close()


@pytest.mark.parametrize("engine", ["continuous", "paged"])
def test_trace_field_slo_history_capacity_and_stats(gen, engine):
    # objectives no CPU run can miss, so the report is compliant however
    # loaded the machine is
    with _Server(gen, engine=engine, slo_sample_interval_s=0.001, slo_ttft_p99_s=60.0,
                 slo_inter_token_p99_s=60.0, slo_fast_window_s=30.0) as srv:
        status, plain = srv.request("POST", "/v1/generate", QUESTION)
        assert status == 200 and "trace" not in plain
        status, traced = srv.request("POST", "/v1/generate", {**QUESTION, "trace": True})
        assert status == 200 and traced["answer"] == plain["answer"]
        spans = [e["span"] for e in traced["trace"]["events"]]
        assert spans[:3] == ["received", "queued", "admitted"]
        assert spans[-2:] == ["first_token", "completed"] and "prefill" in spans
        assert [e["t_s"] for e in traced["trace"]["events"]] == \
            sorted(e["t_s"] for e in traced["trace"]["events"])
        assert traced["trace"]["request_id"] == 2

        status, slo = srv.request("GET", "/v1/slo")
        assert status == 200 and slo["engine"] == engine and slo["compliant"] is True
        assert set(slo["objectives"]) == {"ttft_p99", "inter_token_p99", "error_rate",
                                          "availability"}
        assert slo["objectives"]["ttft_p99"]["target"] == 60.0
        assert slo["objectives"]["ttft_p99"]["windows"]["fast"]["window_s"] == 30.0

        # the worker samples once more when it goes idle: the newest sample
        # then holds every token served
        deadline = time.monotonic() + TIMEOUT
        while True:
            status, hist = srv.request("GET", "/v1/history?metric=tokens_served&window=600")
            values = [p["value"] for p in hist["samples"]]
            if values[-1] == 12 or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        assert status == 200 and hist["metric"] == "tokens_served" and hist["kind"] == "counter"
        assert values == sorted(values) and values[-1] == 12
        status, gauge = srv.request("GET", "/v1/history?metric=live_slots")
        assert status == 200 and gauge["kind"] == "gauge" and gauge["window_s"] is None
        for query, message in (
                ("", "missing ?metric=<name> (GET /v1/history?metric=queue_depth&window=60)"),
                ("?metric=tokens_served&window=0",
                 "'window' must be a positive number of seconds, got '0'"),
                ("?metric=tokens_served&window=abc",
                 "'window' must be a positive number of seconds, got 'abc'"),
                ("?metric=nope", "unknown history metric 'nope'")):
            status, body = srv.request("GET", "/v1/history" + query)
            assert status == 400 and body["error"].startswith(message), body

        status, cap = srv.request("GET", "/v1/capacity")
        want = capacity.report_from_capacity_snapshots([srv.engine.capacity_snapshot()], 1)
        assert status == 200 and set(cap) == set(want) | {"engine", "autoscale", "decisions"}
        assert cap["engine"] == engine and cap["autoscale"] == "off" and cap["decisions"] == []
        assert cap["replicas"] == 1 and cap["capacity"]["per_replica_tokens_per_s"] > 0.0

        status, stats = srv.request("GET", "/v1/stats")
        assert status == 200 and stats["device_memory"] == {}
        assert stats["device_memory_report"] == srv.engine.memory_breakdown()
        assert stats["weight_bytes"] == stats["device_memory_report"]["weight_bytes"] > 0
        assert stats["per_generation"]["0"]["completed"] == 2
        status, text = srv.request("GET", "/metrics")
        assert status == 200 and "serving_slo_compliant 1\n" in text
        assert 'serving_slo_burn_rate{objective="ttft_p99",window="fast"} 0\n' in text
        assert 'serving_generation_requests_completed_total{generation="0"} 2\n' in text
        assert "device_hbm_bytes_in_use" not in text  # no GPU, no memory series


@pytest.mark.parametrize("engine", ["continuous", "paged", "window"])
def test_lineage_and_profile_404_without_their_features(gen, engine):
    from llm_fine_tune_distributed_tpu.infer import server as jax_server

    with _Server(gen, engine=engine) as srv:
        status, body = srv.request("GET", "/v1/lineage")
        assert status == 404 and body == {"error": server._LINEAGE_404}
        status, body = srv.request("POST", "/v1/profile", {"duration_s": 1})
        assert status == 404
        assert body == {"error": "profiling disabled; start the server with --profile-dir"}
        if engine == "window":
            for path in ("/v1/slo", "/v1/history?metric=tokens_served", "/v1/capacity"):
                status, body = srv.request("GET", path)
                assert status == 404 and body == {
                    "error": server._NEEDS_SLOT_ENGINE[path.partition("?")[0]]}
            status, answer = srv.request("POST", "/v1/generate", {**QUESTION, "trace": True})
            assert status == 200 and "trace" not in answer
    # the bodies are string literals of the JAX server, word for word
    with open(jax_server.__file__) as f:
        literals = {n.value for n in ast.walk(ast.parse(f.read()))
                    if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    for text in [server._LINEAGE_404] + list(server._NEEDS_SLOT_ENGINE.values()):
        assert text in literals


class _StubCapture(profiler.ProfilerCapture):
    """The capture's bookkeeping with no profiler underneath: it writes an
    empty Chrome trace at the stop."""

    def _begin(self):
        self._prof = "stub"

    def _end(self):
        pass

    def _export(self, trace_dir):
        self._prof = None
        with open(os.path.join(trace_dir, self.TRACE_FILE), "w") as f:
            json.dump({"traceEvents": []}, f)


@pytest.mark.parametrize("engine", ["continuous", "paged"])
def test_profile_capture_200_409_400_and_its_flight_events(gen, engine, tmp_path, monkeypatch):
    monkeypatch.setattr(server, "ProfilerCapture", _StubCapture)
    with _Server(gen, engine=engine, profile_dir=str(tmp_path)) as srv:
        for raw in (b"[1, 2]", b'{"duration_s": "x"}', b'{"duration_s": 0}', b"nope"):
            status, body = srv.request("POST", "/v1/profile", raw=raw)
            assert status == 400 and body["error"].startswith("bad request: "), raw
        status, body = srv.request("POST", "/v1/profile", {"duration_s": 60})
        want_dir = str(tmp_path / "capture_0001")
        assert status == 200 and body == {"profiling": True, "trace_dir": want_dir,
                                          "duration_s": 60.0}
        status, body = srv.request("POST", "/v1/profile", {"duration_s": 1})
        assert status == 409 and body == {"error": f"capture already running in {want_dir}"}
        assert srv.request("POST", "/v1/generate", QUESTION)[0] == 200  # serving goes on
        assert srv.httpd.profiler_capture.stop() == want_dir
        assert srv.httpd.profiler_capture.stop() is None  # idempotent
        status, body = srv.request("POST", "/v1/profile", {})  # the default 3 s
        assert status == 200 and body["trace_dir"] == str(tmp_path / "capture_0002")
        kinds = [e["kind"] for e in srv.request("GET", "/v1/flight")[1]["events"]]
    # closing the server stopped the second capture
    assert [k for k in kinds if k.startswith("profile_")] == [
        "profile_start", "profile_stop", "profile_start"]
    for n in (1, 2):
        with open(tmp_path / f"capture_{n:04d}" / "trace.json") as f:
            assert json.load(f) == {"traceEvents": []}


def test_profile_capture_on_the_cpu_writes_a_chrome_trace(tmp_path):
    """The real capture, CPU activity only, started on one thread and
    stopped early from another: its thread starts and stops the profiler
    (which must be one thread) and writes a Chrome trace."""
    events = []
    capture = profiler.ProfilerCapture(str(tmp_path),
                                       on_event=lambda kind, **f: events.append((kind, f)))
    trace_dir = capture.start(60.0)
    assert capture.active == trace_dir
    stopped = []
    t = threading.Thread(target=lambda: stopped.append(capture.stop()))
    t.start()
    t.join(TIMEOUT)
    assert stopped == [trace_dir] and capture.active is None and capture.stop() is None
    with open(os.path.join(trace_dir, "trace.json")) as f:
        assert isinstance(json.load(f)["traceEvents"], list)
    assert [k for k, _ in events] == ["profile_start", "profile_stop"]
    begin = events[0][1]  # the start's hold of the boundary, timed
    assert sorted(begin) == ["dir", "duration_s", "lock_held_ms"] and begin["lock_held_ms"] >= 0.0
    stop = events[1][1]  # no error; the stop's hold of the boundary and the export, timed
    assert sorted(stop) == ["dir", "export_ms", "lock_held_ms"] and stop["dir"] == trace_dir
    assert stop["lock_held_ms"] >= 0.0 and stop["export_ms"] >= 0.0
    # a timed capture stops itself
    trace_dir = capture.start(0.05)
    deadline = time.monotonic() + TIMEOUT
    while capture.active is not None:
        assert time.monotonic() < deadline, "the capture never stopped itself"
        time.sleep(0.01)
    assert [k for k, _ in events][2:] == ["profile_start", "profile_stop"]
    assert os.path.exists(os.path.join(trace_dir, "trace.json"))


def test_observability_flags_reach_serve_with_the_jax_defaults_and_values(tmp_path, monkeypatch):
    from llm_fine_tune_distributed_tpu.infer import server as jax_server

    names = ("trace_log", "trace_log_max_mb", "profile_dir", "slo_ttft_p99_s",
             "slo_inter_token_p99_s", "slo_error_rate", "slo_availability", "slo_fast_window_s",
             "slo_slow_window_s", "slo_sample_interval_s")
    got, want = [], []
    monkeypatch.setattr(server, "serve", lambda *a, **kw: got.append(kw))
    monkeypatch.setattr(jax_server, "serve", lambda *a, **kw: want.append(kw))
    flags = ["--trace-log", "t.jsonl", "--trace-log-max-mb", "2.5", "--profile-dir", "prof",
             "--slo-ttft-p99-s", "1.5", "--slo-inter-token-p99-s", "0.01",
             "--slo-error-rate", "0.05", "--slo-availability", "0.99",
             "--slo-fast-window-s", "30", "--slo-slow-window-s", "300",
             "--slo-sample-interval-s", "0.2"]
    for argv in ([], flags):
        assert server.main(["--model-dir", str(tmp_path), "--device", "cpu"] + argv) == 0
        assert jax_server.main(["--model-dir", str(tmp_path)] + argv) == 0
    assert [{n: kw[n] for n in names} for kw in got] == [{n: kw[n] for n in names} for kw in want]
    assert got[0]["trace_log"] is None and got[0]["slo_sample_interval_s"] == 1.0
    assert got[1]["slo_inter_token_p99_s"] == 0.01 and got[1]["profile_dir"] == "prof"


# -------------------------------------------------------------- fleet schema
#
# ``tests/test_metrics_schema.py``'s fleet cases: the router's counter lists,
# the fleet snapshot's keys and the exposition's per-replica labels, held to
# the JAX fleet's on two paged replicas each.


def _fleets(pair):
    from llm_fine_tune_distributed_tpu.infer.fleet import EngineFleet as JaxFleet
    from llm_fine_tune_distributed_tpu_torch.infer.fleet import EngineFleet

    jgen, gen = pair
    return (EngineFleet([_port_engine(gen, "paged"), _port_engine(gen, "paged")]),
            JaxFleet([_jax_engine(jgen, "paged"), _jax_engine(jgen, "paged")]))


def test_fleet_counter_lists_agree():
    from llm_fine_tune_distributed_tpu.infer.fleet import EngineFleet as JaxFleet
    from llm_fine_tune_distributed_tpu.observe.metrics import FLEET_COUNTERS as JAX_COUNTERS
    from llm_fine_tune_distributed_tpu_torch.infer.fleet import EngineFleet
    from llm_fine_tune_distributed_tpu_torch.observe.metrics import FLEET_COUNTERS

    assert set(FLEET_COUNTERS) == set(EngineFleet.ROUTER_COUNTERS)
    assert tuple(FLEET_COUNTERS) == tuple(JAX_COUNTERS) == tuple(JaxFleet.ROUTER_COUNTERS)


def test_fleet_stats_snapshot_key_schema(pair):
    """The fleet snapshot has the JAX fleet's keys but ``compile``, each
    ``per_replica`` entry is the replica's own snapshot plus its label, and
    the histograms are the engine's."""
    fleet, jfleet = _fleets(pair)
    try:
        snap = fleet.stats_snapshot()
        single = set(fleet.replicas[0].stats_snapshot())
    finally:
        fleet.close()
    jsnap = jfleet.stats_snapshot()
    assert set(snap) == set(jsnap) - {"compile"}
    assert set(snap["per_replica"]) == set(jsnap["per_replica"]) == {"0", "1"}
    for label, rsnap in snap["per_replica"].items():
        assert set(rsnap) == single | {"replica"} and rsnap["replica"] == int(label)
        assert set(rsnap) == set(jsnap["per_replica"][label]) - {"compile"} | {"prefix_hits"}
    assert set(snap["histograms"]) == set(jsnap["histograms"])
    assert snap["role"] == jsnap["role"] == "mixed"
    assert snap["per_tenant"] == jsnap["per_tenant"] == {}  # no tenant admitted yet


def _fleet_exposition(fleet, expo, **kw):
    fleet.replicas[0].stats.incr("tokens_served", 3)
    fleet.replicas[1].stats.incr("tokens_served", 4)
    fleet.replicas[0].stats.observe("ttft_s", 0.12)
    snap = {"engine": "paged", **fleet.stats_snapshot()}
    per = snap.pop("per_replica")  # as the server's handler does
    series = [(label, per[label], fleet.replicas[int(label)].stats.hist)
              for label in sorted(per, key=int)]
    memory = {"cuda:0": {"bytes_in_use": 1, "peak_bytes_in_use": 2, "bytes_limit": 3}}
    return expo(snap, fleet.merged_histograms(), memory=memory, replicas=series, **kw)


def test_fleet_metrics_exposition_replica_labels(pair):
    """Fleet /metrics: one TYPE line per metric, the aggregate sample, then
    the metric with replica="i" per replica (counters, gauges, histogram
    buckets), and a replica_info line each; the TYPE lines are the JAX
    fleet's, the tenant histograms' included."""
    import re

    from llm_fine_tune_distributed_tpu.observe.metrics import (
        prometheus_exposition as jax_exposition,
    )
    from llm_fine_tune_distributed_tpu_torch.observe.metrics import prometheus_exposition

    fleet, jfleet = _fleets(pair)
    try:
        text = _fleet_exposition(fleet, prometheus_exposition,
                                 tenant_histograms=fleet.merged_tenant_histograms())
    finally:
        fleet.close()
    jtext = _fleet_exposition(jfleet, jax_exposition,
                              tenant_histograms=jfleet.merged_tenant_histograms())
    typed = lambda t: {(m.group(1), m.group(2))  # noqa: E731
                       for m in re.finditer(r"^# TYPE (\S+) (\S+)$", t, re.M)}
    tenant_hists = {(n, k) for n, k in typed(jtext) if n.startswith("serving_tenant_")
                    and k == "histogram"}
    assert tenant_hists and tenant_hists <= typed(text) and typed(text) == typed(jtext)
    for line in ("serving_tokens_served_total 7", 'serving_tokens_served_total{replica="0"} 3',
                 'serving_tokens_served_total{replica="1"} 4', 'serving_slots{replica="0"} 4',
                 'serving_ttft_seconds_count{replica="1"} 0', "serving_ttft_seconds_count 1"):
        assert line in text and line in jtext, line
    assert re.search(r'serving_ttft_seconds_bucket\{replica="0",le="0\.2048"\} 1', text)
    assert 'serving_replica_info{replica="0",circuit_state="closed"' in text
    names = re.findall(r"^# TYPE (\S+) ", text, re.M)
    assert len(names) == len(set(names))


# the tenant series of /metrics and /v1/stats, held to the JAX package's


def _tenant_lines(text):
    return sorted(line for line in text.splitlines() if "tenant" in line)


def test_tenant_series_schema_and_labels(pair):
    """The per-tenant record's keys, its TYPE lines at zero tenants (no
    samples), tenant="name" samples, and the queue depth floored at 0: the
    JAX exposition's tenant lines for the same counts."""
    from llm_fine_tune_distributed_tpu.observe.metrics import ServingStats as JaxStats
    from llm_fine_tune_distributed_tpu.observe.metrics import (
        prometheus_exposition as jax_exposition,
    )
    from llm_fine_tune_distributed_tpu_torch.observe.metrics import (
        ServingStats,
        prometheus_exposition,
    )

    assert ServingStats.TENANT_KEYS == JaxStats.TENANT_KEYS == ("requests", "tokens",
                                                                "queue_depth")
    jgen, gen = pair
    eng, jeng = _port_engine(gen, "paged"), _jax_engine(jgen, "paged")
    try:
        texts = []
        for stats, snapshot, expo in ((eng.stats, eng.stats_snapshot, prometheus_exposition),
                                      (jeng.stats, jeng.stats_snapshot, jax_exposition)):
            snap = {"engine": "paged", **snapshot()}
            assert snap["per_tenant"] == {}
            text = expo(snap, stats.hist, memory={})
            assert "# TYPE serving_tenant_requests_total counter" in text
            assert "serving_tenant_requests_total{" not in text
            stats.tenant_incr("acme", "requests")
            stats.tenant_incr("acme", "tokens", 42)
            stats.tenant_incr("beta", "requests")
            stats.tenant_merge({"beta": {"tokens": 5}, "gamma": {"requests": 2, "tokens": 7}})
            snap = {"engine": "paged", **snapshot()}
            assert set(snap["per_tenant"]) == {"acme", "beta", "gamma"}
            later = expo(snap, stats.hist, memory={})
            stats.tenant_incr("acme", "queue_depth", -5)
            assert snapshot()["per_tenant"]["acme"]["queue_depth"] == 0
            texts.append((_tenant_lines(text), _tenant_lines(later), snapshot()["per_tenant"]))
    finally:
        eng.close()
    assert texts[0] == texts[1]
    assert 'serving_tenant_tokens_total{tenant="acme"} 42' in texts[0][1]


def test_tenant_histogram_series_labels(pair):
    """Per-tenant TTFT and inter-token histograms: TYPE lines whenever a map
    is passed (even empty), tenant-labelled buckets for observed tenants,
    nothing from the engine-level histogram; the JAX exposition's lines."""
    from llm_fine_tune_distributed_tpu.observe.metrics import (
        prometheus_exposition as jax_exposition,
    )
    from llm_fine_tune_distributed_tpu_torch.observe.metrics import prometheus_exposition

    jgen, gen = pair
    eng, jeng = _port_engine(gen, "paged"), _jax_engine(jgen, "paged")
    try:
        texts = []
        for stats, snapshot, expo in ((eng.stats, eng.stats_snapshot, prometheus_exposition),
                                      (jeng.stats, jeng.stats_snapshot, jax_exposition)):
            empty = expo({"engine": "paged", **snapshot()}, stats.hist, memory={},
                         tenant_histograms={})
            assert "# TYPE serving_tenant_ttft_seconds histogram" in empty
            assert "serving_tenant_ttft_seconds_bucket{" not in empty
            stats.observe("ttft_s", 0.12)
            stats.tenant_observe("acme", "ttft_s", 0.12)
            stats.tenant_observe("acme", "inter_token_s", 0.01)
            stats.tenant_observe("beta", "ttft_s", 3.0)
            text = expo({"engine": "paged", **snapshot()}, stats.hist, memory={},
                        tenant_histograms=stats.tenant_histograms())
            texts.append((_tenant_lines(empty), _tenant_lines(text)))
    finally:
        eng.close()
    assert texts[0] == texts[1]
    assert 'serving_tenant_ttft_seconds_count{tenant="acme"} 1' in texts[0][1]
    assert 'serving_tenant_inter_token_seconds_count{tenant="beta"} 0' in texts[0][1]


def test_fleet_merges_per_tenant_across_replicas(pair):
    """A tenant's counters sum over the replicas its traffic landed on, a
    retired replica's included, and the tenant histograms merge exactly."""
    from llm_fine_tune_distributed_tpu_torch.infer.fleet import EngineFleet

    _, gen = pair
    fleet = EngineFleet([_port_engine(gen, "paged") for _ in range(3)], routing="prefix")
    try:
        fleet.replicas[0].stats.tenant_incr("acme", "tokens", 3)
        fleet.replicas[1].stats.tenant_incr("acme", "tokens", 4)
        fleet.replicas[1].stats.tenant_incr("beta", "requests")
        fleet.replicas[2].stats.tenant_incr("acme", "tokens", 5)
        fleet.replicas[2].stats.tenant_observe("acme", "ttft_s", 0.5)
        fleet.replicas[0].stats.tenant_observe("acme", "ttft_s", 0.25)
        fleet.retire_replica(2)
        snap = fleet.stats_snapshot()
        assert snap["per_tenant"]["acme"]["tokens"] == 12
        assert snap["per_tenant"]["beta"]["requests"] == 1
        merged = fleet.merged_tenant_histograms()
        assert merged["acme"]["ttft_s"].summary()["count"] == 2
    finally:
        fleet.close()
