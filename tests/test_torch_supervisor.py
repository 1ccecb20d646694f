"""Supervision of the port's slot engines (``infer/supervisor.py`` and the
supervised worker of ``infer/engine.py``) against the JAX package's, on the
``tiny`` preset in f32: the cases of ``tests/test_supervisor.py`` and the
flight-recorder cases of ``tests/test_observability.py``.

- the policy (sliding window, backoff, circuit) and the fault injector give
  the JAX classes' answers for the same sequence, step by step;
- an injected decode, spec-tick or prefill failure answers the requests in
  flight with ``RetryableEngineError`` (``retry_after_s`` > 0), keeps the
  queued ones, and the restarted engine's greedy tokens equal solo
  ``generate_ids`` and the JAX engine's after the same script;
- ``circuit_threshold`` failures open the circuit, a rebuild that fails
  counts as a failure, and a fatal failure reads ``circuit_state`` "fatal";
- a drain finishes the work in flight and refuses new work with
  ``DrainingError`` (the window engine too);
- the watchdog is poked as often as the JAX engine pokes it, and paused
  while the engine waits for traffic;
- the paged engine's pool, allocator and prefix cache are new after a
  restart, and the flight artifact holds tick < crash < restart.

Requests in flight at a failure are scripted with a gate on the decode
step, never with sleeps. The weights' kernels are scaled x10, as in the
other engine tests, so that the tiny model does not echo its input.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer.batching import BatchingEngine
from llm_fine_tune_distributed_tpu_torch.infer.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from llm_fine_tune_distributed_tpu_torch.infer.errors import (
    CircuitOpenError,
    RetryableEngineError,
    ServingError,
)
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.infer.supervisor import EngineSupervisor, FaultInjector
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.observe.tracing import FlightRecorder

GEOMETRY = {"continuous": dict(slots=4, buf_len=96, prompt_bucket=16),
            "paged": dict(slots=4, buf_len=96, prompt_bucket=16, block_len=16,
                          prefill_chunk=32)}
KINDS = ("continuous", "paged")
# the flight events the port records (the JAX engines add ones of features
# the port has not: SLO transitions, hot-swaps, spills, migrations)
PORT_EVENTS = {"admit", "tick", "spec", "preempt", "brownout", "shed_overflow", "shed_displaced",
               "shed_displaced_resolved", "shed_brownout", "shed_deadline", "deadline_cancel",
               "prefix_evict", "drain_begin", "crash", "restart", "circuit_open", "fatal"}
FAST = dict(restart_backoff_s=0.01, restart_backoff_max_s=0.02)
TIMEOUT = 240


def _enc(text):
    return list(text.encode("utf-8"))


PROMPTS = [_enc(t) for t in ("alpha", "beta bravo", "the quick brown fox")]
REPETITIVE = _enc("water water water water water")


class _Gate:
    """Holds the engine's decode step: the worker parks in ``wait`` until
    the test lets one step through (``step``) or opens the gate."""

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


class _PortWrapped:
    """The port's Generator with its plain decode steps behind a gate,
    raising ``fail_with`` when it is set, and a state constructor that
    fails after ``fail_init_after`` calls."""

    def __init__(self, gen, gate=None, fail_init_after=None):
        self._gen, self._gate = gen, gate
        self._inits = 0
        self._fail_init_after = fail_init_after
        self.fail_with = None

    def _hold(self):
        if self.fail_with is not None:
            raise self.fail_with
        if self._gate is not None:
            self._gate.wait()

    def __getattr__(self, name):
        return getattr(self._gen, name)

    def _init(self, name, *a, **kw):
        self._inits += 1
        if self._fail_init_after is not None and self._inits > self._fail_init_after:
            raise RuntimeError("device lost: cannot allocate")
        return getattr(self._gen, name)(*a, **kw)

    def init_slot_state(self, *a, **kw):
        return self._init("init_slot_state", *a, **kw)

    def init_paged_state(self, *a, **kw):
        return self._init("init_paged_state", *a, **kw)

    def slot_step(self, *a):
        self._hold()
        return self._gen.slot_step(*a)

    def paged_step(self, *a):
        self._hold()
        return self._gen.paged_step(*a)


class _JaxWrapped(_PortWrapped):
    """The JAX Generator likewise: its decode steps are compiled programs
    that the engine asks for once, so the gate wraps what they return."""

    def _gated(self, step):
        def run(*a):
            self._hold()
            return step(*a)
        return run

    def slot_step(self, *a):
        return self._gated(self._gen.slot_step(*a))

    def paged_step(self, *a):
        return self._gated(self._gen.paged_step(*a))


def _make_pair(scale):
    """The JAX and the port's Generator on the same weights (made by the
    JAX package from PRNGKey(0), kernels x ``scale``), each with its
    package's classes."""
    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTok
    from llm_fine_tune_distributed_tpu.infer import GenerationConfig as JaxConfig
    from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
    from llm_fine_tune_distributed_tpu.infer import engine as jax_engine
    from llm_fine_tune_distributed_tpu.infer import errors as jax_errors
    from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_get_preset
    from llm_fine_tune_distributed_tpu.models.transformer import init_params as jax_init_params
    from llm_fine_tune_distributed_tpu_torch.infer import errors as port_errors
    from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax

    jmc = jax_get_preset("tiny")
    jparams = jax_init_params(jax.random.PRNGKey(0), jmc, dtype=jnp.float32)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: x * scale if path[-1].key == "kernel" else x, jparams)
    jgen = JaxGenerator(jparams, jmc, JaxTok(), compute_dtype=jnp.float32, eos_token_ids=[])
    mc = get_preset("tiny")
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jparams)).items()}
    gen = Generator(params_from_jax(flat, mc), mc, ByteChatMLTokenizer(),
                    compute_dtype=torch.float32, eos_token_ids=[], device="cpu")
    return {
        "jax": dict(gen=jgen, config=JaxConfig, wrapped=_JaxWrapped, errors=jax_errors,
                    continuous=jax_engine.ContinuousBatchingEngine,
                    paged=jax_engine.PagedContinuousBatchingEngine),
        "port": dict(gen=gen, config=GenerationConfig, wrapped=_PortWrapped,
                     errors=port_errors, continuous=ContinuousBatchingEngine,
                     paged=PagedContinuousBatchingEngine),
    }


@pytest.fixture(scope="module")
def pair():
    return _make_pair(10.0)


@pytest.fixture(scope="module")
def spec_pair():
    """Kernels x3, as in the speculative engine tests: at x10 no bigram of
    the context repeats, so prompt lookup would propose nothing."""
    return _make_pair(3.0)


def _engine(side, kind, gate=None, fail_init_after=None, **kw):
    gen = side["wrapped"](side["gen"], gate, fail_init_after)
    return side[kind](gen, **{**GEOMETRY[kind], **FAST, **kw})


def _greedy(side, n=6, **kw):
    return side["config"](max_new_tokens=n, do_sample=False, **kw)


def _close(eng, gate=None):
    if gate is not None:
        gate.open()
    if hasattr(eng, "close"):  # the JAX engines have no close(); their workers are daemons
        eng.close()


def _outcome(fn):
    """("ok", tokens) or (error class name, retry_after_s > 0 or None,
    generation) of a call, by duck type so both packages compare."""
    try:
        return ("ok", list(fn()))
    except ServingError as e:
        return _error(e)
    except Exception as e:  # noqa: BLE001 - the JAX package's taxonomy
        if hasattr(e, "kind"):
            return _error(e)
        raise


def _error(e):
    retry = e.retry_after_s
    return (type(e).__name__, None if retry is None else retry > 0,
            getattr(e, "generation", None))


def _async(fn):
    out = []
    t = threading.Thread(target=lambda: out.append(_outcome(fn)))
    t.start()

    def join():
        t.join(TIMEOUT)
        assert not t.is_alive(), "a waiter hung"
        return out[0]

    return join


def _wait(cond, what="condition"):
    deadline = time.monotonic() + TIMEOUT
    while not cond():
        assert time.monotonic() < deadline, f"{what} not reached in time"
        time.sleep(0.002)


def _solo(pair, prompts, cfg=None):
    gen = pair["port"]["gen"]
    return [gen.generate_ids(p, cfg or _greedy(pair["port"])) for p in prompts]


# ------------------------------------------------------------------ policy


def test_supervisor_policy_window_and_backoff():
    """The JAX test's sequence, and a longer one, give the JAX
    supervisor's answer at every step."""
    from llm_fine_tune_distributed_tpu.infer.supervisor import EngineSupervisor as JaxSupervisor

    def run(cls):
        sup = cls(restart_backoff_s=0.5, restart_backoff_max_s=2.0, circuit_threshold=3,
                  circuit_window_s=10.0)
        trace = []
        for t in (0.0, 1.0, None, 11.5, 12.0, 12.5, 30.0, 50.0, 50.1):
            if t is None:
                sup.restarted()
            else:
                trace.append(sup.record_failure(now=t))
            trace.append((sup.backoff_delay(), sup.failure_count, sup.generation,
                          sup.circuit_open))
        return trace

    got = run(EngineSupervisor)
    assert got == run(JaxSupervisor)
    assert got[:4] == ["restart", (0.5, 1, 0, False), "restart", (1.0, 2, 0, False)]
    assert got[5:7] == ["restart", (0.5, 1, 1, False)]  # the first two aged out
    assert got[9:11] == ["open", (2.0, 3, 1, True)]  # the third in the window


def test_fault_injector_self_disarms():
    """Every hook fires once per arming and heals, as the JAX injector's."""
    from llm_fine_tune_distributed_tpu.infer.supervisor import FaultInjector as JaxInjector

    def run(cls):
        fi, trace = cls(), []

        def fire(name, *a):
            try:
                getattr(fi, name)(*a)
                trace.append((name, a, "ok"))
            except Exception as e:  # noqa: BLE001 - each package's InjectedFault
                trace.append((name, a, type(e).__name__, str(e)))

        fi.fail_decode_next(2)
        fi.fail_decode_at(7)
        for step in (1, 2, 3, 7, 7):
            fire("maybe_fail_decode", step)
        for hook in ("prefill", "spill", "restore", "migrate", "handoff"):
            fire(f"maybe_fail_{hook}")  # inert unless armed
            getattr(fi, f"fail_{hook}_next")(1)
            fire(f"maybe_fail_{hook}")
            fire(f"maybe_fail_{hook}")
        fi.delay_decode_next(2, 0.01)
        fi.clear_delays()
        t0 = time.monotonic()
        fire("maybe_fail_decode", 8)
        trace.append(time.monotonic() - t0 < 0.01)
        return trace

    got = run(FaultInjector)
    assert got == run(JaxInjector)
    assert [t[2] for t in got[:5]] == ["InjectedFault"] * 2 + ["ok", "InjectedFault", "ok"]


def test_slowed_decode_sleeps_and_heals():
    fi = FaultInjector()
    fi.delay_decode_next(1, 0.05)
    t0 = time.monotonic()
    fi.maybe_fail_decode(1)
    assert time.monotonic() - t0 >= 0.05
    t0 = time.monotonic()
    fi.maybe_fail_decode(2)
    assert time.monotonic() - t0 < 0.05


# --------------------------------------------------------- flight recorder


def test_flight_recorder_bounded_ring():
    from llm_fine_tune_distributed_tpu.observe.tracing import FlightRecorder as JaxRecorder

    def run(cls):
        rec = cls(capacity=4)
        for i in range(10):
            rec.record("tick", step=i)
        return len(rec), [{k: v for k, v in e.items() if k != "t_s"} for e in rec.events()]

    got = run(FlightRecorder)
    assert got == run(JaxRecorder)
    assert got == (4, [{"kind": "tick", "step": i} for i in (6, 7, 8, 9)])
    assert all(e["t_s"] >= 0.0 for e in FlightRecorder(2).events())


def test_supervisor_dump_flight(tmp_path):
    sup = EngineSupervisor(flight_dir=str(tmp_path / "flight"))
    rec = FlightRecorder(capacity=8)
    rec.record("tick", step=1)
    rec.record("crash", step=2, error="boom")
    path = sup.dump_flight(rec, "crash_restart", error="boom")
    assert path == str(tmp_path / "flight" / "flight_crash_restart_gen0_1.json")
    with open(path) as f:
        payload = json.load(f)
    assert payload["reason"] == "crash_restart" and payload["error"] == "boom"
    assert [e["kind"] for e in payload["events"]] == ["tick", "crash"]
    assert (payload["generation"], payload["failures_in_window"], payload["circuit_open"]) == (
        0, 0, False)
    # no flight_dir: a no-op, never an error
    assert EngineSupervisor().dump_flight(rec, "crash_restart") is None
    # a flight_dir that cannot be written: swallowed, no artifact
    blocker = tmp_path / "a_file"
    blocker.write_text("x")
    assert EngineSupervisor(flight_dir=str(blocker)).dump_flight(rec, "fatal") is None


# ------------------------------------------------------- crash -> recover


def _decode_crash(side, kind):
    """Three requests in flight when a decode tick fails; then the same
    prompts again on the restarted engine."""
    gate = _Gate()
    eng = _engine(side, kind, gate)
    cfg = _greedy(side)
    try:
        first = _async(lambda: eng.submit(PROMPTS[0], cfg, timeout=TIMEOUT))
        gate.park()
        rest = [_async(lambda p=p: eng.submit(p, cfg, timeout=TIMEOUT)) for p in PROMPTS[1:]]
        _wait(lambda: eng.queue_depth == 2, "two queued")
        while int(eng.live_slots) < 3:
            gate.step()
        eng.faults.fail_decode_next(1)
        gate.open()
        crashed = [join() for join in [first] + rest]
        after = [_outcome(lambda p=p: eng.submit(p, cfg, timeout=TIMEOUT)) for p in PROMPTS]
        snap = eng.stats_snapshot()
        return {"crashed": crashed, "after": after, "healthy": eng.healthy,
                **{k: snap[k] for k in ("engine_restarts", "engine_generation", "circuit_state",
                                        "requests_failed", "requests_completed")}}
    finally:
        _close(eng, gate)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_crash_recovers_bit_identical(pair, kind):
    """Every waiter in flight gets RetryableEngineError with a positive
    hint and the failed generation; afterwards greedy tokens equal solo
    generate_ids and the JAX engine's."""
    got = _decode_crash(pair["port"], kind)
    assert got == _decode_crash(pair["jax"], kind)
    assert got["crashed"] == [("RetryableEngineError", True, 0)] * 3
    assert got["after"] == [("ok", ids) for ids in _solo(pair, PROMPTS)]
    assert (got["engine_restarts"], got["engine_generation"], got["circuit_state"],
            got["requests_failed"], got["healthy"]) == (1, 1, "closed", 3, True)


def _spec_crash(side, kind):
    spec = _greedy(side, 8, speculative_lookup=4)
    eng = _engine(side, kind, speculative_k=4)
    try:
        warm = eng.submit_full(REPETITIVE, spec, timeout=TIMEOUT)
        eng.faults.fail_decode_next(1)
        crashed = _outcome(lambda: eng.submit(REPETITIVE, spec, timeout=TIMEOUT))
        after = eng.submit_full(REPETITIVE, spec, timeout=TIMEOUT)
        return {"warm": (list(warm.result), warm.draft_tokens_proposed > 0), "crashed": crashed,
                "after": (list(after.result), after.draft_tokens_proposed > 0),
                "restarts": eng.stats_snapshot()["engine_restarts"], "healthy": eng.healthy}
    finally:
        _close(eng)


@pytest.mark.parametrize("kind", KINDS)
def test_crash_during_speculation_recovers_bit_identical(spec_pair, kind):
    """A failure on a speculative tick: the rebuilt engine (target and
    draft state) speculates again and gives the solo speculative tokens."""
    pair = spec_pair
    got = _spec_crash(pair["port"], kind)
    assert got == _spec_crash(pair["jax"], kind)
    solo = pair["port"]["gen"].generate_ids(REPETITIVE, _greedy(pair["port"], 8,
                                                                speculative_lookup=4))
    assert got["warm"] == got["after"] == (solo, True)
    assert got["crashed"] == ("RetryableEngineError", True, 0)
    assert got["restarts"] == 1 and got["healthy"]


def _prefill_crash(side, kind):
    eng = _engine(side, kind)
    cfg = _greedy(side)
    try:
        warm = _outcome(lambda: eng.submit(PROMPTS[0], cfg, timeout=TIMEOUT))
        eng.faults.fail_prefill_next(1)
        crashed = _outcome(lambda: eng.submit(PROMPTS[1], cfg, timeout=TIMEOUT))
        after = _outcome(lambda: eng.submit(PROMPTS[1], cfg, timeout=TIMEOUT))
        return {"warm": warm, "crashed": crashed, "after": after,
                "restarts": eng.stats_snapshot()["engine_restarts"], "healthy": eng.healthy}
    finally:
        _close(eng)


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_crash_recovers(pair, kind):
    """The dense prefill commits nothing before the device call, so its
    request retries in the new generation unseen; the paged prefill runs
    after the blocks are mapped, so its request fails retryable."""
    got = _prefill_crash(pair["port"], kind)
    assert got == _prefill_crash(pair["jax"], kind)
    solo = _solo(pair, PROMPTS[:2])
    if kind == "continuous":
        assert got["crashed"] == ("ok", solo[1])
    else:
        assert got["crashed"] == ("RetryableEngineError", True, 0)
    assert got["warm"] == ("ok", solo[0]) and got["after"] == ("ok", solo[1])
    assert got["restarts"] == 1 and got["healthy"]


def _circuit(side, kind, fault):
    eng = _engine(side, kind, circuit_threshold=2, circuit_window_s=60.0)
    cfg = _greedy(side)
    try:
        trace = [_outcome(lambda: eng.submit(PROMPTS[0], cfg, timeout=TIMEOUT))]
        if fault == "fatal":  # no restart can help: the error class is fatal
            eng._generator.fail_with = NotImplementedError("no kernel for this device")
        else:
            eng.faults.fail_decode_next(10)  # keeps failing across restarts
        for p in PROMPTS:
            trace.append(_outcome(lambda p=p: eng.submit(p, cfg, timeout=TIMEOUT)))
        snap = eng.stats_snapshot()
        return {"trace": trace, "healthy": eng.healthy, "circuit_state": eng.circuit_state,
                "terminal": type(eng.terminal_error).__name__,
                "snapshot": (snap["circuit_state"], snap["engine_restarts"],
                             snap["requests_failed"])}
    finally:
        _close(eng)


@pytest.mark.parametrize("fault", ["open", "fatal"])
@pytest.mark.parametrize("kind", KINDS)
def test_circuit_opens_after_repeated_failures(pair, kind, fault):
    """With circuit_threshold 2 the first failure restarts and the second
    opens the circuit: the request in flight gets CircuitOpenError, and so
    does every later submit, at admission. A fatal failure (no restart can
    help) ends the engine at once with FatalEngineError, "fatal"."""
    got = _circuit(pair["port"], kind, fault)
    assert got == _circuit(pair["jax"], kind, fault)
    solo = _solo(pair, PROMPTS[:1])[0]
    assert got["trace"][0] == ("ok", solo) and not got["healthy"]
    if fault == "open":
        assert got["trace"][1:] == [("RetryableEngineError", True, 0),
                                    ("CircuitOpenError", None, None),
                                    ("CircuitOpenError", None, None)]
        assert got["circuit_state"] == "open" and got["terminal"] == "CircuitOpenError"
        assert got["snapshot"] == ("open", 1, 2)
    else:
        assert got["trace"][1:] == [("FatalEngineError", None, None)] * 3
        assert got["circuit_state"] == "fatal" and got["terminal"] == "FatalEngineError"
        assert got["snapshot"] == ("fatal", 0, 1)


def _failing_rebuild(side, kind):
    """Generation 0 builds; every rebuild after it raises, as a sticky
    device fault would."""
    eng = _engine(side, kind, fail_init_after=1, circuit_threshold=3)
    cfg = _greedy(side)
    try:
        warm = _outcome(lambda: eng.submit(PROMPTS[0], cfg, timeout=TIMEOUT))
        eng.faults.fail_decode_next(1)
        crashed = _outcome(lambda: eng.submit(PROMPTS[1], cfg, timeout=TIMEOUT))
        later = _outcome(lambda: eng.submit(PROMPTS[2], cfg, timeout=TIMEOUT))
        _wait(lambda: not eng.healthy, "the circuit to open")
        snap = eng.stats_snapshot()
        return {"warm": warm[0], "crashed": crashed, "later": later[0],
                "state": (eng.circuit_state, snap["engine_restarts"])}
    finally:
        _close(eng)


@pytest.mark.parametrize("kind", KINDS)
def test_failing_rebuild_reaches_the_open_circuit(pair, kind):
    """A rebuild that raises is a failure like a tick's: two failed
    rebuilds after the crash reach circuit_threshold 3 and open the
    circuit, and no waiter hangs (the later request is refused)."""
    got = _failing_rebuild(pair["port"], kind)
    assert got == _failing_rebuild(pair["jax"], kind)
    assert got == {"warm": "ok", "crashed": ("RetryableEngineError", True, 0),
                   "later": "CircuitOpenError", "state": ("open", 2)}


def _queued_survive(side, kind):
    gate = _Gate()
    eng = _engine(side, kind, gate, slots=1)
    cfg = _greedy(side)
    try:
        live = _async(lambda: eng.submit(PROMPTS[0], cfg, timeout=TIMEOUT))
        gate.park()
        queued = _async(lambda: eng.submit(PROMPTS[1], cfg, timeout=TIMEOUT))
        _wait(lambda: eng.queue_depth == 1, "the second request to queue")
        eng.faults.fail_decode_next(1)
        gate.open()
        return [live(), queued()]
    finally:
        _close(eng, gate)


@pytest.mark.parametrize("kind", KINDS)
def test_queued_requests_survive_a_restart(pair, kind):
    got = _queued_survive(pair["port"], kind)
    assert got == _queued_survive(pair["jax"], kind)
    assert got == [("RetryableEngineError", True, 0), ("ok", _solo(pair, PROMPTS[1:2])[0])]


def _drain(side, kind):
    gate = _Gate()
    eng = _engine(side, kind, gate)
    long = _greedy(side, 24)
    try:
        inflight = _async(lambda: eng.submit(PROMPTS[0], long, timeout=TIMEOUT))
        gate.park()
        eng.begin_drain()
        refused = _outcome(lambda: eng.submit(PROMPTS[1], _greedy(side), timeout=30))
        pending = eng.wait_drained(timeout_s=0.05, poll_s=0.01)
        gate.open()
        drained = eng.wait_drained(timeout_s=120.0)
        return {"refused": refused, "pending_while_held": pending, "drained": drained,
                "inflight": inflight(), "draining": eng.draining,
                "snap": eng.stats_snapshot()["draining"]}
    finally:
        _close(eng, gate)


@pytest.mark.parametrize("kind", KINDS)
def test_drain_finishes_in_flight(pair, kind):
    got = _drain(pair["port"], kind)
    assert got == _drain(pair["jax"], kind)
    solo = _solo(pair, PROMPTS[:1], _greedy(pair["port"], 24))[0]
    assert got == {"refused": ("DrainingError", True, None), "pending_while_held": False,
                   "drained": True, "inflight": ("ok", solo), "draining": True, "snap": True}


def test_window_engine_raises_draining_error(pair):
    """The window engine refuses a submit during a drain with the JAX
    engine's DrainingError (a 503 with Retry-After at the server)."""
    from llm_fine_tune_distributed_tpu.infer.batching import BatchingEngine as JaxBatchingEngine

    got = []
    for side, cls in ((pair["port"], BatchingEngine), (pair["jax"], JaxBatchingEngine)):
        eng = cls(side["gen"], max_batch=2, window_ms=1.0)
        eng.begin_drain()
        with pytest.raises(side["errors"].DrainingError) as exc:
            eng.submit(PROMPTS[0], _greedy(side), timeout=30)
        got.append((exc.value.status, exc.value.kind, exc.value.retry_after_s,
                    eng.wait_drained(1.0)))
        _close(eng)
    assert got[0] == got[1] == (503, "draining", 5.0, True)


@pytest.mark.parametrize("kind", KINDS)
def test_no_hung_waiter_under_crash_storm(pair, kind):
    """Eight submits racing an injected failure all resolve, with a result
    or a ServingError, and the pending ledger balances."""
    side = pair["port"]
    eng = _engine(side, kind)
    cfg = _greedy(side)
    try:
        eng.submit(PROMPTS[0], cfg, timeout=TIMEOUT)
        eng.faults.fail_decode_next(1)
        joins = [_async(lambda i=i: eng.submit(PROMPTS[i % 3], cfg, timeout=90))
                 for i in range(8)]
        outcomes = [join() for join in joins]
        solo = _solo(pair, PROMPTS)
        for i, out in enumerate(outcomes):
            assert out == ("ok", solo[i % 3]) or out == ("RetryableEngineError", True, 0), out
        assert ("RetryableEngineError", True, 0) in outcomes
        with eng._plock:
            assert eng._pending == 0  # one settle per submit
    finally:
        _close(eng)


# -------------------------------------------------------------- watchdog


class _RecordingWatchdog:
    """StepWatchdog-shaped probe: counts pokes and pauses."""

    def __init__(self):
        self.pokes = 0
        self.pauses = 0
        self.stopped = False

    def poke(self, step):
        self.pokes += 1

    def pause(self):
        self.pauses += 1

    def stop(self):
        self.stopped = True


def _watchdog_run(side, kind):
    wd = _RecordingWatchdog()
    eng = _engine(side, kind, watchdog=wd)
    try:
        _wait(lambda: wd.pauses >= 1, "the idle pause")  # the worker waits for traffic
        paused = wd.pauses  # the worker blocks on its queue until the request
        eng.submit(PROMPTS[0], _greedy(side), timeout=TIMEOUT)
        pokes = wd.pokes
        _wait(lambda: wd.pauses > paused, "the pause after the request")
        return pokes
    finally:
        _close(eng)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_worker_pokes_watchdog(pair, kind):
    """One poke per prefill and one per decode tick, as many as the JAX
    engine gives, and a pause whenever the worker waits for traffic."""
    got = _watchdog_run(pair["port"], kind)
    assert got == _watchdog_run(pair["jax"], kind)
    assert got == _greedy(pair["port"]).max_new_tokens  # 1 prefill + 5 ticks


def test_watchdog_stops_with_the_engine(pair):
    wd = _RecordingWatchdog()
    eng = _engine(pair["port"], "continuous", watchdog=wd, circuit_threshold=1)
    eng.faults.fail_decode_next(1)
    with pytest.raises(CircuitOpenError):
        eng.submit(PROMPTS[0], _greedy(pair["port"]), timeout=TIMEOUT)
    assert wd.stopped
    eng.close()
    wd2 = _RecordingWatchdog()
    eng = _engine(pair["port"], "continuous", watchdog=wd2)
    eng.close()  # a closed engine's watchdog must not outlive it
    assert wd2.stopped and not eng._worker.is_alive()


# ----------------------------------------------------- the paged restart


def test_paged_restart_builds_a_fresh_pool(pair):
    """After a restart the paged engine has a new pool (an int8 one, all
    zero), a new allocator with every block free, an empty prefix cache
    and null tables: a prompt cached before the crash is prefilled in
    full afterwards, and still decodes to the solo tokens."""
    side = pair["port"]
    eng = _engine(side, "paged", kv_quant="int8")
    cfg = _greedy(side)
    long_prompt = _enc("the quick brown fox jumps over the lazy dog " * 2)
    try:
        warm = eng.submit(long_prompt, cfg, timeout=TIMEOUT)
        reused = eng.stats_snapshot()["prefix_tokens_reused"]
        eng.submit(long_prompt, cfg, timeout=TIMEOUT)
        assert eng.stats_snapshot()["prefix_tokens_reused"] > reused  # served from the cache
        old_pool, old_alloc = eng.pool, eng._allocator
        assert len(eng._prefix) > 0
        eng.faults.fail_decode_next(1)
        with pytest.raises(RetryableEngineError):
            eng.submit(PROMPTS[0], cfg, timeout=TIMEOUT)
        _wait(lambda: eng.pool is not None and eng.pool is not old_pool, "the new pool")
        _wait(lambda: eng._allocator is not old_alloc, "the new allocator")
        assert eng._allocator.used_count == 0 and len(eng._prefix) == 0
        assert (eng._table == 0).all() and eng._slot_blocks == [[]] * 4
        layer = eng.pool["layers"]["0"]
        assert layer["k"].dtype == torch.int8
        assert all(not t.any() for t in layer.values())
        reused = eng.stats_snapshot()["prefix_tokens_reused"]
        assert eng.submit(long_prompt, cfg, timeout=TIMEOUT) == warm
        assert eng.stats_snapshot()["prefix_tokens_reused"] == reused  # nothing cached
    finally:
        _close(eng)


# ------------------------------------------------- the crash artifact


def _crash_artifact(side, kind, flight_dir):
    eng = _engine(side, kind, flight_dir=flight_dir)
    cfg = _greedy(side)
    try:
        eng.submit(PROMPTS[0], cfg, timeout=TIMEOUT)
        eng.faults.fail_decode_next(1)
        crashed = _outcome(lambda: eng.submit(PROMPTS[1], cfg, timeout=TIMEOUT))
        healed = _outcome(lambda: eng.submit(PROMPTS[1], cfg, timeout=TIMEOUT))
        dumps = sorted(os.listdir(flight_dir))
        with open(os.path.join(flight_dir, dumps[0])) as f:
            payload = json.load(f)
        return {"crashed": crashed, "healed": healed[0], "dumps": dumps,
                "reason": payload["reason"], "generation": payload["generation"],
                "events": [{k: v for k, v in e.items() if k not in ("t_s", "dt_ms")}
                           for e in payload["events"] if e["kind"] in PORT_EVENTS]}
    finally:
        _close(eng)


@pytest.mark.parametrize("kind", KINDS)
def test_crash_dumps_flight_with_restart_transition(pair, kind, tmp_path):
    """An injected decode crash dumps one artifact holding the ticks before
    the crash, the crash and the restart, in that order, with the JAX
    engine's events and fields."""
    got = _crash_artifact(pair["port"], kind, str(tmp_path / "port"))
    want = _crash_artifact(pair["jax"], kind, str(tmp_path / "jax"))
    assert got == want
    assert got["crashed"] == ("RetryableEngineError", True, 0) and got["healed"] == "ok"
    assert got["dumps"] == ["flight_crash_restart_gen1_1.json"]
    assert got["reason"] == "crash_restart" and got["generation"] == 1
    kinds = [e["kind"] for e in got["events"]]
    assert kinds.index("tick") < kinds.index("crash") < kinds.index("restart")
    crash = got["events"][kinds.index("crash")]
    restart = got["events"][kinds.index("restart")]
    assert crash["error"].startswith("InjectedFault: injected decode failure")
    assert restart["generation"] == 1 and restart["failures_in_window"] == 1

