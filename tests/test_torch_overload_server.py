"""Overload control and the error taxonomy at the port's HTTP edge
(``infer/server.py``), on the ``tiny`` preset in f32 on the CPU:

- a failed tick, on both slot engines: a retryable one restarts the engine
  (the request in flight gets 503 ``engine_restarting``, ``/healthz`` stays
  200), while an open circuit or a fatal failure makes ``/healthz`` answer
  503 with ``circuit_state`` and ``terminal_error``; the request in flight
  gets the taxonomy's status and body;
- ``priority`` and ``deadline_ms`` are accepted and validated with the JAX
  server's 400 messages, and the seven overload flags reach ``serve`` with
  the values the JAX server's ``main`` gives them;
- a shed is a 429 or 503 with a positive whole ``Retry-After`` and the
  ``{"error": {...}}`` body of ``error_payload``, on ``/v1/generate`` and
  (before any event) on ``/v1/stream``; a deadline that expires mid-stream
  ends the stream with an ``event: error`` carrying the same body;
- ``/v1/stats`` and ``/metrics`` count the sheds and keep one schema;
- supervision at the edge (the cases of ``tests/test_server.py``): the
  supervision flags reach ``serve`` as the JAX server's ``main`` gives
  them, ``GET /v1/flight`` reads the flight recorder (404 on the window
  engine), and a drain through ``control["begin_drain"]`` finishes the
  request in flight, refuses new ones with 503 ``draining`` and returns
  from ``run_server``.

Concurrent arrivals are scripted with a gate on the engine's decode step,
never with sleeps that order events.
"""

import http.client
import json
import math
import threading
import time

import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer import server
from llm_fine_tune_distributed_tpu_torch.infer.errors import InjectedFault
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset

TIMEOUT = 240
QUESTION = {"question": "How many cups in a gallon?", "system_prompt": "Be brief.",
            "greedy": True, "max_new_tokens": 8}
SLOT_ENGINES = ("continuous", "paged")
GEOMETRY = dict(slots=2, kv_buf_len=256, kv_block_len=16, prefill_chunk=64, max_batch=2)


@pytest.fixture(scope="module")
def gen():
    mc = get_preset("tiny")
    params = tf.init_params(mc, seed=0, device="cpu", dtype=torch.float32)
    params = {k: v * 10.0 if k.endswith(".kernel") else v for k, v in params.items()}
    return Generator(params, mc, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                     eos_token_ids=[], device="cpu")


class _Gate:
    """Holds the engine's decode step until the test lets it through."""

    def __init__(self):
        self._permits = threading.Semaphore(0)
        self._open = threading.Event()
        self._parked = threading.Event()

    def wait(self):
        if self._open.is_set():
            return
        self._parked.set()
        self._permits.acquire()

    def park(self):
        assert self._parked.wait(TIMEOUT), "the worker never reached the gate"
        self._parked.clear()

    def step(self):
        self._permits.release()
        self.park()

    def open(self):
        self._open.set()
        for _ in range(64):
            self._permits.release()


class _Wrapped:
    """The Generator with its decode steps replaced by ``step(name, *a)``."""

    def __init__(self, gen, step):
        self._gen, self._step = gen, step

    def __getattr__(self, name):
        return getattr(self._gen, name)

    def slot_step(self, *a):
        return self._step("slot_step", *a)

    def paged_step(self, *a):
        return self._step("paged_step", *a)


def _gated(gen, gate):
    def step(name, *a):
        gate.wait()
        return getattr(gen, name)(*a)
    return _Wrapped(gen, step)


class _Server:
    """``build_server`` on a thread, for one test."""

    def __init__(self, gen, gate=None, **kw):
        self.gate = gate
        self.httpd, self.engine = server.build_server(gen, host="127.0.0.1", port=0,
                                                      **{**GEOMETRY, **kw})
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.gate is not None:
            self.gate.open()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.engine.close()
        self.thread.join(10)

    def request(self, method, path, body=None):
        """-> (status, headers, body bytes); never raises on an HTTP error."""
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=TIMEOUT)
        try:
            conn.request(method, path, body=None if body is None else json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    def post_async(self, path, body):
        """POST on a thread; ``join()`` -> (status, headers, body)."""
        out = []
        t = threading.Thread(target=lambda: out.append(self.request("POST", path, body)))
        t.start()

        def join():
            t.join(TIMEOUT)
            assert not t.is_alive() and out, "the request hung"
            return out[0]
        return join


def _events(raw: bytes):
    events = []
    for block in raw.decode().split("\n\n"):
        if not block:
            continue
        lines = block.split("\n")
        name = lines[0][len("event: "):] if lines[0].startswith("event: ") else "message"
        events.append((name, json.loads(lines[-1][len("data: "):])))
    return events


def _wait(cond, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached in time"
        time.sleep(0.002)


def _retry_after_header(headers, body):
    """The header is the body's hint rounded up to a positive whole second."""
    hint = body["error"]["retry_after_s"]
    assert headers["Retry-After"] == str(max(1, math.ceil(hint)))
    assert int(headers["Retry-After"]) >= 1
    return hint


# ------------------------------------------------------------ the repair


FAULTS = {
    # a failure the supervisor restarts from
    "retryable": dict(raise_=InjectedFault("injected tick failure"), kw={},
                      status=503, kind="engine_restarting", retryable=True),
    # the same failure with circuit_threshold 1: the first opens the circuit
    "circuit_open": dict(raise_=InjectedFault("injected tick failure"),
                         kw={"circuit_threshold": 1}, status=503, kind="circuit_open",
                         retryable=False),
    # a failure no restart can help (the taxonomy's fatal classes)
    "fatal": dict(raise_=NotImplementedError("no kernel for this device"), kw={},
                  status=500, kind="engine_fatal", retryable=False),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("engine", SLOT_ENGINES)
def test_healthz_is_503_once_a_tick_failed(gen, engine, fault):
    """One failed decode step, as the JAX server answers it. Retryable: the
    request in flight gets 503 ``engine_restarting`` with Retry-After and
    the failed generation, ``/healthz`` stays 200, and the next request is
    served by generation 1. Circuit open or fatal: the request in flight
    gets the terminal error's status and body, ``/healthz`` answers 503 with
    ``circuit_state`` "open" or "fatal" and the error, and later requests
    (and streams) are refused with it before any event."""
    case = FAULTS[fault]
    calls = []

    def step(name, *a):
        calls.append(name)
        if len(calls) == 2:  # the second decode step fails
            raise case["raise_"]
        return getattr(gen, name)(*a)

    with _Server(_Wrapped(gen, step), engine=engine, restart_backoff_s=0.01,
                 **case["kw"]) as srv:
        assert srv.request("GET", "/healthz")[::2] == (200, b"ok")
        status, headers, body = srv.request("POST", "/v1/generate", QUESTION)
        error = json.loads(body)["error"]
        assert status == case["status"] and error["kind"] == case["kind"]
        assert error["retryable"] is case["retryable"]
        cause = f"{type(case['raise_']).__name__}: {case['raise_']}"
        assert cause in error["message"]
        eng = srv.engine
        if fault == "retryable":
            assert error["generation"] == 0
            _retry_after_header(headers, {"error": error})
            _wait(lambda: eng.stats_snapshot()["engine_generation"] == 1)
            assert srv.request("GET", "/healthz")[::2] == (200, b"ok")
            status, _, body = srv.request("POST", "/v1/generate", QUESTION)
            assert status == 200 and json.loads(body)["answer"]
            snap = eng.stats_snapshot()
            assert (snap["circuit_state"], snap["engine_restarts"], eng.healthy) == (
                "closed", 1, True)
        else:
            state = "fatal" if fault == "fatal" else "open"
            assert "Retry-After" not in headers
            status, _, body = srv.request("GET", "/healthz")
            assert status == 503
            assert json.loads(body) == {"status": "unhealthy", "circuit_state": state,
                                        "error": error}
            assert not eng.healthy and eng.terminal_error.to_dict() == error
            assert isinstance(eng.terminal_error.__cause__, type(case["raise_"]))
            for path in ("/v1/generate", "/v1/stream"):
                status, headers, body = srv.request("POST", path, QUESTION)
                assert status == case["status"] and json.loads(body) == {"error": error}
                assert headers["Content-Type"] == "application/json"
            snap = eng.stats_snapshot()
            assert snap["circuit_state"] == state
    step_name = "paged_step" if engine == "paged" else "slot_step"
    assert snap["requests_failed"] == 1 and set(calls) == {step_name}


# ------------------------------------------------------- request fields


@pytest.mark.parametrize("engine,body,message", [
    ("continuous", {"priority": "urgent"},
     "'priority' must be one of ('interactive', 'batch', 'best_effort'), got 'urgent'"),
    ("paged", {"deadline_ms": 0},
     "'deadline_ms' must be a positive number of milliseconds, got 0"),
    ("continuous", {"deadline_ms": -5},
     "'deadline_ms' must be a positive number of milliseconds, got -5"),
    ("window", {"priority": "batch"},
     "'priority' needs a continuous/paged engine; this server runs the window engine, "
     "which admits FIFO"),
    ("window", {"deadline_ms": 100},
     "'deadline_ms' needs a continuous/paged engine; this server runs the window engine, "
     "which cannot cancel mid-decode"),
    ("continuous", {"priority": "batch", "speculative": 2},
     "'priority'/'deadline_ms' with 'speculative' needs the server started with "
     "--speculative K"),
    ("paged", {"trace": True}, "['trace'] not supported by this server"),
], ids=["bad_tier", "zero_deadline", "negative_deadline", "window_priority",
        "window_deadline", "speculative_fallback", "trace_unported"])
def test_overload_fields_are_validated_with_the_jax_messages(gen, engine, body, message):
    with _Server(gen, engine=engine) as srv:
        for path in ("/v1/generate", "/v1/stream"):
            status, _, raw = srv.request("POST", path, {**QUESTION, **body})
            assert status == 400 and message in json.loads(raw)["error"], raw


@pytest.mark.parametrize("engine", SLOT_ENGINES)
def test_priority_and_deadline_ms_are_accepted(gen, engine):
    """A request that names a tier and a generous deadline is served with
    the same answer as one without; ``"priority": null`` means the default."""
    with _Server(gen, engine=engine) as srv:
        plain = srv.request("POST", "/v1/generate", QUESTION)
        for extra in ({"priority": "batch", "deadline_ms": 600000}, {"priority": None},
                      {"priority": "best_effort"}):
            got = srv.request("POST", "/v1/generate", {**QUESTION, **extra})
            assert got[0] == 200 and got[2] == plain[2]
        status, _, raw = srv.request("POST", "/v1/stream",
                                     {**QUESTION, "priority": "interactive", "deadline_ms": 600000})
        assert status == 200 and _events(raw)[-1] == ("message", {"done": True, "n_tokens": 8})


def test_overload_flags_reach_serve_with_the_jax_defaults_and_values(tmp_path, monkeypatch):
    """The seven overload flags: absent, and set, ``serve`` gets what the
    JAX server's ``main`` hands its ``serve``."""
    from llm_fine_tune_distributed_tpu.infer import server as jax_server

    names = ("max_queue_depth", "queue_deadline_s", "priority_default", "age_promote_s",
             "brownout_queue_wait_s", "brownout_drain_s", "brownout_cap_tokens")
    got, want = [], []
    monkeypatch.setattr(server, "serve", lambda *a, **kw: got.append(kw))
    monkeypatch.setattr(jax_server, "serve", lambda *a, **kw: want.append(kw))
    flags = ["--max-queue-depth", "3", "--queue-deadline-s", "1.5",
             "--priority-default", "batch", "--age-promote-s", "0.25",
             "--brownout-queue-wait-s", "4", "--brownout-drain-s", "7.5",
             "--brownout-cap-tokens", "9"]
    for argv in ([], flags):
        assert server.main(["--model-dir", str(tmp_path), "--device", "cpu"] + argv) == 0
        assert jax_server.main(["--model-dir", str(tmp_path)] + argv) == 0
    assert [{n: kw[n] for n in names} for kw in got] == [{n: kw[n] for n in names} for kw in want]
    assert got[0]["max_queue_depth"] == 256 and got[0]["queue_deadline_s"] is None
    assert got[1]["priority_default"] == "batch" and got[1]["brownout_cap_tokens"] == 9


# ------------------------------------------------------------------ sheds


@pytest.mark.parametrize("engine", SLOT_ENGINES)
def test_queue_overflow_is_429_with_retry_after_and_the_taxonomy_body(gen, engine):
    """One slot busy and a depth-1 queue full: ``/v1/generate`` and
    ``/v1/stream`` are shed with 429, a positive whole Retry-After and the
    ``queue_overflow`` body; ``/v1/stats`` and ``/metrics`` count the sheds
    by tier and keep the same series as before them."""
    gate = _Gate()
    with _Server(_gated(gen, gate), gate=gate, engine=engine, slots=1,
                 max_queue_depth=1) as srv:
        metrics_before = srv.request("GET", "/metrics")[2].decode()
        occupier = srv.post_async("/v1/generate", QUESTION)
        gate.park()
        waiter = srv.post_async("/v1/generate", QUESTION)
        _wait(lambda: srv.engine.queue_depth == 1)
        for path in ("/v1/generate", "/v1/stream"):
            status, headers, raw = srv.request("POST", path, {**QUESTION, "priority": "batch"})
            body = json.loads(raw)
            assert status == 429 and headers["Content-Type"] == "application/json"
            hint = _retry_after_header(headers, body)
            assert body == {"error": {"kind": "queue_overflow", "message": body["error"]["message"],
                                      "retryable": True, "retry_after_s": hint, "tier": "batch"}}
            assert "admission queue full" in body["error"]["message"]
        gate.open()
        assert occupier()[0] == waiter()[0] == 200
        stats = json.loads(srv.request("GET", "/v1/stats")[2])
        metrics = srv.request("GET", "/metrics")[2].decode()
    assert stats["requests_shed_overflow"] == 2
    assert stats["requests_shed_by_tier"] == {"interactive": 0, "batch": 2, "best_effort": 0}
    assert 'serving_requests_shed_tier_total{tier="batch"} 2' in metrics.splitlines()
    assert "serving_requests_shed_overflow_total 2" in metrics.splitlines()

    def series(text):
        return {line.split(" ")[2] for line in text.splitlines() if line.startswith("# TYPE")}
    assert series(metrics) == series(metrics_before)


def test_stream_shed_before_its_first_token_gets_the_status(gen):
    """A stream whose request waits past the queue deadline is shed with a
    503, Retry-After and the ``queue_deadline`` body instead of an empty
    event stream."""
    gate = _Gate()
    deadline_s = 0.2
    with _Server(_gated(gen, gate), gate=gate, slots=1, queue_deadline_s=deadline_s) as srv:
        occupier = srv.post_async("/v1/generate", QUESTION)
        gate.park()
        stream = srv.post_async("/v1/stream", QUESTION)
        _wait(lambda: srv.engine.queue_depth == 1)
        queued_by = time.monotonic()
        time.sleep(max(0.0, queued_by + deadline_s + 0.05 - time.monotonic()))
        gate.open()
        status, headers, raw = stream()
        assert occupier()[0] == 200
    body = json.loads(raw)
    assert status == 503 and headers["Content-Type"] == "application/json"
    hint = _retry_after_header(headers, body)
    assert body["error"] == {"kind": "queue_deadline", "message": body["error"]["message"],
                             "retryable": True, "retry_after_s": hint}


@pytest.mark.parametrize("path", ["/v1/generate", "/v1/stream"])
def test_deadline_ms_mid_decode_is_504_with_the_greedy_prefix(gen, path):
    """``deadline_ms`` that expires mid-decode: ``/v1/generate`` answers 504
    with the tokens so far (a prefix of the solo greedy run);
    ``/v1/stream`` has sent them as deltas and ends with an ``event: error``
    carrying the same body."""
    gate = _Gate()
    body = {**QUESTION, "max_new_tokens": 100, "deadline_ms": 1200}
    prompt = gen.encode_chat([{"role": "system", "content": QUESTION["system_prompt"]},
                              {"role": "user", "content": QUESTION["question"]}])
    solo = gen.generate_ids(prompt, GenerationConfig(max_new_tokens=100, do_sample=False))
    with _Server(_gated(gen, gate), gate=gate) as srv:
        t0 = time.monotonic()
        pending = srv.post_async(path, body)
        gate.park()
        for _ in range(3):
            gate.step()
        time.sleep(max(0.0, t0 + 1.25 - time.monotonic()))
        gate.open()
        status, headers, raw = pending()
        snap = srv.engine.stats_snapshot()
    want = {"kind": "deadline_exceeded", "retryable": False, "tokens_generated": 4,
            "partial_tokens": solo[:4]}
    if path == "/v1/generate":
        assert status == 504 and "Retry-After" not in headers
        error = json.loads(raw)["error"]
    else:
        assert status == 200
        *deltas, (name, error) = _events(raw)
        assert name == "error"
        # a stream holds back a trailing partial character until the next token
        text = gen.tokenizer.decode(solo[:4]).rstrip("\ufffd")
        assert "".join(d["delta"] for _, d in deltas) == text
    assert {k: error[k] for k in want} == want
    assert error["message"] == "deadline expired mid-decode after 4 token(s)"
    assert snap["requests_shed_deadline_decode"] == 1
    assert snap["wasted_tokens_by_reason"]["deadline"] == 4


def test_stage3_brownout_sheds_best_effort_over_http(gen):
    """At stage 3, a best_effort request is a tier-labelled 429 with the
    ``brownout_shed`` body while an interactive one is served."""
    gate = _Gate()
    with _Server(_gated(gen, gate), gate=gate, brownout_drain_s=1e-9) as srv:
        occupier = srv.post_async("/v1/generate", QUESTION)
        gate.park()
        assert srv.engine.brownout_stage == 3
        status, headers, raw = srv.request("POST", "/v1/generate",
                                           {**QUESTION, "priority": "best_effort"})
        body = json.loads(raw)
        _retry_after_header(headers, body)
        assert status == 429 and body["error"]["kind"] == "brownout_shed"
        assert body["error"]["tier"] == "best_effort"
        interactive = srv.post_async("/v1/generate", {**QUESTION, "priority": "interactive"})
        _wait(lambda: srv.engine.queue_depth == 1)
        gate.open()
        assert occupier()[0] == interactive()[0] == 200
        stats = json.loads(srv.request("GET", "/v1/stats")[2])
    assert stats["requests_shed_by_tier"]["best_effort"] == 1
    assert stats["requests_shed_by_tier"]["interactive"] == 0
    assert stats["requests_shed_overflow"] == 1


# ------------------------------------------------------------ supervision


def test_supervision_flags_reach_serve_with_the_jax_defaults_and_values(tmp_path, monkeypatch):
    """The drain, restart, circuit, watchdog, flight and request-timeout
    flags: absent, and set, ``serve`` gets what the JAX server's ``main``
    hands its ``serve``."""
    from llm_fine_tune_distributed_tpu.infer import server as jax_server

    names = ("drain_timeout_s", "restart_backoff_s", "restart_backoff_max_s",
             "circuit_threshold", "circuit_window_s", "watchdog_timeout_s", "flight_dir",
             "request_timeout_s")
    got, want = [], []
    monkeypatch.setattr(server, "serve", lambda *a, **kw: got.append(kw))
    monkeypatch.setattr(jax_server, "serve", lambda *a, **kw: want.append(kw))
    flags = ["--drain-timeout-s", "7", "--restart-backoff-s", "0.25",
             "--restart-backoff-max-s", "4", "--circuit-threshold", "3",
             "--circuit-window-s", "12", "--watchdog-timeout-s", "90", "--flight-dir", "",
             "--request-timeout-s", "0"]
    for argv in ([], flags):
        assert server.main(["--model-dir", str(tmp_path), "--device", "cpu"] + argv) == 0
        assert jax_server.main(["--model-dir", str(tmp_path)] + argv) == 0
    assert [{n: kw[n] for n in names} for kw in got] == [{n: kw[n] for n in names} for kw in want]
    assert got[0]["flight_dir"] == "outputs/flight_recorder" and got[0]["request_timeout_s"] == 600
    assert got[1]["flight_dir"] is None and got[1]["request_timeout_s"] is None


@pytest.mark.parametrize("engine", SLOT_ENGINES)
def test_flight_endpoint(gen, engine):
    """GET /v1/flight: the live ring. The admission and the ticks of a
    served request are in it, ``?limit=`` keeps the newest, and a limit
    that is not a positive integer is a 400."""
    with _Server(gen, engine=engine) as srv:
        assert srv.request("POST", "/v1/generate", QUESTION)[0] == 200
        status, _, raw = srv.request("GET", "/v1/flight")
        events = json.loads(raw)["events"]
        assert status == 200 and all("kind" in e and "t_s" in e for e in events)
        kinds = [e["kind"] for e in events]
        assert kinds[0] == "admit" and kinds.count("tick") == QUESTION["max_new_tokens"] - 1
        status, _, raw = srv.request("GET", "/v1/flight?limit=2")
        assert status == 200 and json.loads(raw)["events"] == events[-2:]
        for bad in ("0", "-3", "abc"):
            status, _, raw = srv.request("GET", f"/v1/flight?limit={bad}")
            assert status == 400
            assert json.loads(raw) == {
                "error": f"'limit' must be a positive integer, got {bad!r}"}


def test_flight_endpoint_is_404_on_the_window_engine(gen):
    with _Server(gen, engine="window") as srv:
        status, _, raw = srv.request("GET", "/v1/flight")
    assert status == 404
    assert json.loads(raw) == {"error": "flight events need a continuous/paged engine (the "
                                        "window engine has no flight recorder)"}


@pytest.mark.parametrize("engine", SLOT_ENGINES)
def test_drain_finishes_in_flight_and_exits(gen, engine):
    """The SIGTERM path, driven through ``control["begin_drain"]``:
    ``/healthz`` turns 503 draining, a new request is a 503 ``draining``
    with Retry-After, the request in flight finishes with 200 and its
    tokens, and ``run_server`` returns within the drain timeout."""
    gate = _Gate()
    control = {}
    httpd, engine_ = server.build_server(_gated(gen, gate), host="127.0.0.1", port=0,
                                         **{**GEOMETRY, "engine": engine}, drain_timeout_s=60.0,
                                         control=control)
    assert control["httpd"] is httpd
    serving = threading.Thread(target=server.run_server, args=(httpd, engine_), daemon=True)
    serving.start()
    srv = _Server.__new__(_Server)
    srv.port = httpd.server_address[1]
    body = {**QUESTION, "max_new_tokens": 24}
    try:
        inflight = srv.post_async("/v1/generate", body)
        gate.park()
        control["begin_drain"]()  # what SIGTERM calls
        status, headers, raw = srv.request("GET", "/healthz")
        assert status == 503 and json.loads(raw) == {"status": "draining"}
        assert headers["Retry-After"] == "60"
        status, headers, raw = srv.request("POST", "/v1/generate", QUESTION)
        error = json.loads(raw)["error"]
        assert status == 503 and error["kind"] == "draining" and error["retryable"]
        _retry_after_header(headers, {"error": error})
        assert engine_.draining and engine_.stats_snapshot()["draining"] is True
        gate.open()
        status, _, raw = inflight()
        serving.join(60)
        assert not serving.is_alive()  # serve returned: the process exits 0
    finally:
        gate.open()
        if serving.is_alive():
            httpd.shutdown()
    assert status == 200
    prompt = gen.encode_chat([{"role": "system", "content": QUESTION["system_prompt"]},
                              {"role": "user", "content": QUESTION["question"]}])
    want = gen.generate_ids(prompt, GenerationConfig(max_new_tokens=24, do_sample=False))
    assert json.loads(raw) == {"answer": gen.decode_reply(want)}
    assert not engine_._worker.is_alive()  # run_server closed the engine
