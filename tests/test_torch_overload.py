"""Overload control of the port's slot engines (``infer/engine.py``) against
the JAX engines, on the ``tiny`` preset in f32: the cases of
``tests/test_overload.py`` without its router and fleet cases, and the queue
cases of ``tests/test_supervisor.py``.

Every case that has concurrent arrivals is scripted with a gate on the
engine's decode step instead of sleeps: the worker parks at the gate, the
test submits, then lets one step (or all of them) through. The same script
runs on the port's engine and on the JAX engine, and the statuses,
``Retry-After`` hints, greedy tokens and the shed and preemption counters
must be equal. Greedy requests that were preempted and resumed must give the
tokens of an uninterrupted solo run, bit for bit.

The weights' kernels are scaled x10, as in the other engine tests, so that
the tiny model does not just echo its last input token.

JAX is imported inside the fixture that needs it, so the card-only test
runs on a machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_overload.py``.
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
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.ops.flash_attention import paged_decode_attention

DENSE = dict(slots=2, buf_len=128, prompt_bucket=16)
PAGED = dict(slots=2, buf_len=128, prompt_bucket=16, block_len=16, prefill_chunk=64)
TIMEOUT = 240
COUNTERS = ("requests_admitted", "requests_completed", "requests_failed",
            "requests_shed_overflow", "requests_shed_deadline",
            "requests_shed_deadline_decode", "preemptions", "prefix_tokens_reused",
            "tokens_served", "goodput_tokens", "decode_steps")


def _enc(text):
    return list(text.encode("utf-8"))


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
        """Return once the worker is parked at the gate."""
        assert self._parked.wait(TIMEOUT), "the worker never reached the gate"
        self._parked.clear()

    def step(self):
        """Let one decode step through and wait for the worker to park at
        the next one."""
        self._permits.release()
        self.park()

    def open(self):
        self._open.set()
        for _ in range(64):
            self._permits.release()

    def close(self):
        """Hold the steps again (only while the worker is idle)."""
        self._permits = threading.Semaphore(0)
        self._open.clear()


class _PortGated:
    """The port's Generator with its decode steps behind a gate."""

    def __init__(self, gen, gate):
        self._gen, self._gate = gen, gate

    def __getattr__(self, name):
        return getattr(self._gen, name)

    def slot_step(self, *a):
        self._gate.wait()
        return self._gen.slot_step(*a)

    def paged_step(self, *a):
        self._gate.wait()
        return self._gen.paged_step(*a)


class _JaxGated:
    """The JAX Generator with its compiled decode steps behind a gate."""

    def __init__(self, gen, gate):
        self._gen, self._gate = gen, gate

    def __getattr__(self, name):
        return getattr(self._gen, name)

    def _gated(self, step):
        def run(*a):
            self._gate.wait()
            return step(*a)
        return run

    def slot_step(self, *a):
        return self._gated(self._gen.slot_step(*a))

    def paged_step(self, *a):
        return self._gated(self._gen.paged_step(*a))


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port's Generator on the same x10 weights (made by
    the JAX package from PRNGKey(0)), with the JAX package's engine classes
    and config type."""
    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTok
    from llm_fine_tune_distributed_tpu.infer import GenerationConfig as JaxConfig
    from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
    from llm_fine_tune_distributed_tpu.infer import engine as jax_engine
    from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_get_preset
    from llm_fine_tune_distributed_tpu.models.transformer import init_params as jax_init_params
    from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax

    jmc = jax_get_preset("tiny")
    jparams = jax_init_params(jax.random.PRNGKey(0), jmc, dtype=jnp.float32)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 10.0 if path[-1].key == "kernel" else x, jparams)
    jgen = JaxGenerator(jparams, jmc, JaxTok(), compute_dtype=jnp.float32, eos_token_ids=[])
    mc = get_preset("tiny")
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jparams)).items()}
    gen = Generator(params_from_jax(flat, mc), mc, ByteChatMLTokenizer(),
                    compute_dtype=torch.float32, eos_token_ids=[], device="cpu")
    jax_side = dict(gen=jgen, config=JaxConfig, dense=jax_engine.ContinuousBatchingEngine,
                    paged=jax_engine.PagedContinuousBatchingEngine, gated=_JaxGated)
    port_side = dict(gen=gen, config=GenerationConfig, dense=ContinuousBatchingEngine,
                     paged=PagedContinuousBatchingEngine, gated=_PortGated)
    return {"jax": jax_side, "port": port_side}


def _engine(side, kind="dense", gate=None, **kw):
    gen = side["gen"] if gate is None else side["gated"](side["gen"], gate)
    geometry = DENSE if kind == "dense" else PAGED
    return side[kind](gen, **{**geometry, **kw})


def _close(eng, gate=None):
    if gate is not None:
        gate.open()
    if hasattr(eng, "close"):  # the JAX engines have no close(); their workers are daemons
        eng.close()


class _Calls:
    """Blocking submits on threads, in a fixed arrival order: each call is
    queued (``queue_depth`` grew) before the next one starts. Outcomes are
    ("ok", tokens) or ("err", status, kind, retryable, tier, tokens)."""

    def __init__(self, eng):
        self.eng = eng
        self.outcomes = {}
        self.finished = []  # names, in completion order
        self._lock = threading.Lock()
        self._threads = []

    def submit(self, name, prompt, cfg, queued=True, **kw):
        depth = self.eng.queue_depth

        def run():
            try:
                out = ("ok", list(self.eng.submit(prompt, cfg, timeout=TIMEOUT, **kw)))
            except Exception as e:  # noqa: BLE001 - either package's taxonomy, by duck type
                out = _failure(e)
            with self._lock:
                self.outcomes[name] = out
                self.finished.append(name)

        t = threading.Thread(target=run)
        t.start()
        self._threads.append(t)
        if queued:
            _wait(lambda: self.eng.queue_depth > depth or name in self.outcomes)

    def join(self):
        for t in self._threads:
            t.join(TIMEOUT)
            assert not t.is_alive(), "a waiter hung"
        return self.outcomes


def _failure(e):
    """A taxonomy failure as a tuple; anything else as its repr (a test
    failure, never equal to a taxonomy outcome)."""
    if not hasattr(e, "status"):
        return ("raised", repr(e))
    return ("err", e.status, e.kind, e.retryable, getattr(e, "tier", None),
            list(getattr(e, "tokens", []) or []))


def _wait(cond, timeout=TIMEOUT, poll=0.002):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached in time"
        time.sleep(poll)


def _counters(eng):
    snap = eng.stats_snapshot()
    out = {k: snap[k] for k in COUNTERS}
    out["requests_shed_by_tier"] = snap["requests_shed_by_tier"]
    out["wasted_tokens_by_reason"] = snap["wasted_tokens_by_reason"]
    return out


def _both(pair, script):
    """Run ``script(side)`` on the JAX and the port's engines; both records
    must be equal. Returns the port's record."""
    want = script(pair["jax"])
    got = script(pair["port"])
    assert got == want
    return got


def _solo(side, prompt, n):
    return list(side["gen"].generate_ids(prompt, side["config"](max_new_tokens=n,
                                                                  do_sample=False)))


def _not_an_echo(prompt, tokens):
    assert tokens != [prompt[-1]] * len(tokens), tokens


# ------------------------------------------------------------- retry jitter


def test_retry_after_jitter_deterministic_and_bounded(pair):
    """Retry-After carries a +-20% deterministic jitter over the EWMA
    estimate: the same engine state gives the same hints (and the JAX
    engine's), consecutive sheds get different ones."""
    seqs = []
    for side in (pair["port"], pair["port"], pair["jax"]):
        eng = _engine(side)
        seqs.append([eng._retry_after() for _ in range(8)])
        _close(eng)
    assert seqs[0] == seqs[1] == seqs[2]
    # idle: backlog 1 over 2 slots at the 1.0 s seed -> 0.5 s, jittered to
    # [0.4, 0.6] and floored at the 0.5 s clamp
    assert all(0.5 <= v <= 0.6 for v in seqs[0])
    assert len(set(seqs[0])) > 1


def test_priority_validation(pair):
    side = pair["port"]
    with pytest.raises(ValueError, match="priority_default"):
        _engine(side, priority_default="bogus")
    eng = _engine(side)
    try:
        with pytest.raises(ValueError, match="priority"):
            eng.submit(_enc("hi"), GenerationConfig(max_new_tokens=4, do_sample=False),
                       priority="urgent", timeout=TIMEOUT)
    finally:
        _close(eng)


# ------------------------------------------------------------ admission


def test_queue_overflow_sheds_429_with_finite_retry_after(pair):
    """One slot busy and a depth-1 queue full: the next arrival is shed
    with a 429 whose Retry-After is finite (and the JAX engine's), the two
    admitted requests finish with the JAX engine's tokens."""

    def script(side):
        gate = _Gate()
        eng = _engine(side, gate=gate, slots=1, max_queue_depth=1)
        cfg = side["config"](max_new_tokens=12, do_sample=False)
        calls = _Calls(eng)
        calls.submit("occupier", _enc("alpha"), cfg, queued=False)
        gate.park()
        calls.submit("waiter", _enc("beta bravo"), cfg)
        try:
            eng.submit(_enc("gamma"), cfg, timeout=TIMEOUT)
            raise AssertionError("the third request was not shed")
        except Exception as e:  # noqa: BLE001 - either package's QueueOverflowError
            shed = (e.status, e.kind, e.retryable, e.tier, e.retry_after_s)
        gate.open()
        out = calls.join()
        rec = {"shed": shed, "outcomes": out, "counters": _counters(eng)}
        _close(eng, gate)
        return rec

    rec = _both(pair, script)
    status, kind, retryable, tier, retry_after = rec["shed"]
    assert (status, kind, retryable, tier) == (429, "queue_overflow", True, "interactive")
    assert 0.0 < retry_after <= 600.0
    assert rec["counters"]["requests_shed_overflow"] == 1
    assert rec["counters"]["requests_shed_by_tier"]["interactive"] == 1
    assert rec["outcomes"]["waiter"][0] == "ok"
    _not_an_echo(_enc("beta bravo"), rec["outcomes"]["waiter"][1])


def test_full_queue_displaces_a_lower_tier_waiter(pair):
    """A full queue holding a best_effort waiter: an interactive arrival
    takes its place, and the displaced waiter gets a tier-labelled 429."""

    def script(side):
        gate = _Gate()
        eng = _engine(side, gate=gate, slots=1, max_queue_depth=1)
        cfg = side["config"](max_new_tokens=6, do_sample=False)
        calls = _Calls(eng)
        calls.submit("occupier", _enc("alpha"), cfg, queued=False)
        gate.park()
        calls.submit("low", _enc("beta bravo"), cfg, priority="best_effort")
        calls.submit("high", _enc("gamma"), cfg, priority="interactive")
        gate.open()
        rec = {"outcomes": calls.join(), "counters": _counters(eng)}
        _close(eng, gate)
        return rec

    rec = _both(pair, script)
    assert rec["outcomes"]["low"][:5] == ("err", 429, "queue_overflow", True, "best_effort")
    assert rec["outcomes"]["high"][0] == "ok"
    assert rec["counters"]["requests_shed_by_tier"] == {
        "interactive": 0, "batch": 0, "best_effort": 1}


def test_queue_deadline_sheds_before_prefill(pair):
    """A request still queued past the engine's queue deadline is shed
    with a 503 before it is prefilled; it is never admitted."""
    deadline_s = 0.25

    def script(side):
        gate = _Gate()
        eng = _engine(side, gate=gate, slots=1, queue_deadline_s=deadline_s)
        cfg = side["config"](max_new_tokens=8, do_sample=False)
        calls = _Calls(eng)
        calls.submit("occupier", _enc("alpha"), cfg, queued=False)
        gate.park()
        calls.submit("late", _enc("beta bravo"), cfg)
        queued_by = time.monotonic()  # the waiter's deadline is at most this + deadline_s
        time.sleep(max(0.0, queued_by + deadline_s + 0.05 - time.monotonic()))
        gate.open()
        rec = {"outcomes": calls.join(), "counters": _counters(eng)}
        _close(eng, gate)
        return rec

    rec = _both(pair, script)
    assert rec["outcomes"]["late"] == ("err", 503, "queue_deadline", True, None, [])
    assert rec["counters"]["requests_shed_deadline"] == 1
    assert rec["counters"]["requests_admitted"] == 1


# --------------------------------------------------------------- deadlines


def test_deadline_expired_while_queued_is_504_with_no_tokens(pair):
    """A zero budget is expired the moment the worker looks: 504 with no
    partial tokens, and the engine keeps serving, correctly."""

    def script(side):
        eng = _engine(side)
        cfg = side["config"](max_new_tokens=4, do_sample=False)
        prompt = _enc("alpha")
        try:
            eng.submit(prompt, cfg, deadline_s=0.0, timeout=TIMEOUT)
            raise AssertionError("the request was not cancelled")
        except Exception as e:  # noqa: BLE001 - either package's DeadlineExceededError
            cancelled = _failure(e)
            body = e.to_dict()
        after = list(eng.submit(prompt, cfg, timeout=TIMEOUT))
        rec = {"cancelled": cancelled, "tokens_generated": body["tokens_generated"],
               "partial": body["partial_tokens"], "after": after, "counters": _counters(eng)}
        _close(eng)
        return rec

    rec = _both(pair, script)
    assert rec["cancelled"] == ("err", 504, "deadline_exceeded", False, None, [])
    assert rec["tokens_generated"] == 0 and rec["partial"] == []
    assert rec["after"] == _solo(pair["port"], _enc("alpha"), 4)
    assert rec["counters"]["requests_shed_deadline"] == 1


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_deadline_mid_decode_returns_greedy_prefix(pair, kind):
    """A deadline that expires mid-decode cancels at a tick: the 504 carries
    the tokens decoded so far, a prefix of the uninterrupted greedy run, and
    they count as waste of reason "deadline"."""
    prompt = _enc("beta bravo")
    deadline_s = 1.5  # the 5 released steps of a warm engine take milliseconds
    steps = 5

    def script(side):
        gate = _Gate()
        eng = _engine(side, kind, gate=gate)
        warm = side["config"](max_new_tokens=4, do_sample=False)
        gate.open()
        eng.submit(prompt, warm, timeout=TIMEOUT)  # compile before the clock runs
        gate.close()
        calls = _Calls(eng)
        t0 = time.monotonic()
        calls.submit("long", prompt, side["config"](max_new_tokens=100, do_sample=False),
                     queued=False, deadline_s=deadline_s)
        gate.park()
        for _ in range(steps):
            gate.step()
        time.sleep(max(0.0, t0 + deadline_s + 0.05 - time.monotonic()))
        gate.open()
        rec = {"outcomes": calls.join(), "counters": _counters(eng)}
        _close(eng, gate)
        return rec

    rec = _both(pair, script)
    status, kind_, retryable, _, tokens = rec["outcomes"]["long"][1:]
    assert (status, kind_, retryable) == (504, "deadline_exceeded", False)
    assert len(tokens) == steps + 1  # the prefill's token and one per released step
    assert tokens == _solo(pair["port"], prompt, 100)[: len(tokens)]
    assert rec["counters"]["requests_shed_deadline_decode"] == 1
    assert rec["counters"]["wasted_tokens_by_reason"]["deadline"] == len(tokens)


def test_paged_deadline_during_chunked_prefill_frees_the_blocks(pair):
    """On the paged engine a long prompt prefills one chunk a tick; a client
    deadline that expires between its chunks stops the prefill: 504 with no
    tokens, counted as a shed after admission, and its blocks are free."""
    prompt = _enc("a long prompt " * 8)[:100]  # two chunks: 64 + 36 tokens
    deadline_s = 0.5

    def script(side):
        gate = _Gate()
        eng = _engine(side, "paged", gate=gate)
        cfg = side["config"](max_new_tokens=8, do_sample=False)
        occupier = side["config"](max_new_tokens=24, do_sample=False)
        gate.open()  # compile before the clock runs; another prompt, so nothing is shared
        eng.submit(_enc("another prompt " * 7)[:100], cfg, timeout=TIMEOUT)
        eng.submit(_enc("occupier"), occupier, timeout=TIMEOUT)
        gate.close()
        calls = _Calls(eng)
        calls.submit("occupier", _enc("occupier"), occupier, queued=False)
        gate.park()
        t0 = time.monotonic()
        calls.submit("late", prompt, cfg, deadline_s=deadline_s)
        gate.step()  # admitted; its first chunk prefills before this tick's decode step
        time.sleep(max(0.0, t0 + deadline_s + 0.05 - time.monotonic()))
        gate.open()
        rec = {"outcomes": calls.join(), "counters": _counters(eng),
               "blocks_in_use": eng.stats_snapshot()["blocks_in_use"]}
        _close(eng, gate)
        return rec

    rec = _both(pair, script)
    assert rec["outcomes"]["late"] == ("err", 504, "deadline_exceeded", False, None, [])
    assert rec["counters"]["requests_shed_deadline_decode"] == 1
    assert rec["counters"]["requests_admitted"] == 4
    assert rec["outcomes"]["occupier"][0] == "ok"


# ------------------------------------------------------- priority admission


def test_priority_orders_admission_not_fifo(pair):
    """With the one slot busy, three waiters are admitted in the reverse of
    their arrival order: admission sorts by tier, not arrival."""

    def script(side):
        gate = _Gate()
        eng = _engine(side, gate=gate, slots=1, age_promote_s=60.0)
        cfg = side["config"](max_new_tokens=6, do_sample=False)
        calls = _Calls(eng)
        calls.submit("occupier", _enc("occupier"), cfg, queued=False)
        gate.park()
        for name, tier in (("last", "best_effort"), ("middle", "batch"),
                           ("first", "interactive")):
            calls.submit(name, _enc(name), cfg, priority=tier)
        gate.open()
        out = calls.join()
        rec = {"order": list(calls.finished), "outcomes": out}
        _close(eng, gate)
        return rec

    rec = _both(pair, script)
    assert rec["order"] == ["occupier", "first", "middle", "last"]
    assert all(o[0] == "ok" for o in rec["outcomes"].values())


@pytest.mark.parametrize("age_s,batch_first", [(1e-6, True), (0.0, False)],
                         ids=["aging", "no_aging"])
def test_aging_bounds_lower_tier_wait(pair, age_s, batch_first):
    """A batch request queued before an interactive flood: promoted while it
    waits, it is served first; with aging off it is served last."""

    def script(side):
        gate = _Gate()
        eng = _engine(side, gate=gate, slots=1, age_promote_s=age_s)
        cfg = side["config"](max_new_tokens=4, do_sample=False)
        calls = _Calls(eng)
        calls.submit("occupier", _enc("occupier"), cfg, queued=False)
        gate.park()
        calls.submit("starved", _enc("starved"), cfg, priority="batch")
        for i in range(3):
            calls.submit(f"flood {i}", _enc(f"flood {i}"), cfg, priority="interactive")
        gate.open()
        calls.join()
        order = list(calls.finished)
        _close(eng, gate)
        return order

    order = _both(pair, script)
    assert order[0] == "occupier"
    assert order.index("starved") == (1 if batch_first else 4)


# -------------------------------------------------------------- preemption


def _preempt_script(kind, victim_prompt, victim_new=24, **engine_kw):
    """Both slots busy (an interactive occupier and a best_effort victim
    streaming), an interactive arrival preempts the victim after its third
    token; then everything runs to completion. Returns the victim's
    streamed tokens, every outcome and the counters (and, on paged, the
    prefix tokens reused by the resume)."""

    def script(side):
        gate = _Gate()
        eng = _engine(side, kind, gate=gate, **engine_kw)
        greedy = side["config"]
        calls = _Calls(eng)
        calls.submit("occupier", _enc("long greedy occupier"),
                     greedy(max_new_tokens=48, do_sample=False), queued=False)
        gate.park()
        stream = eng.stream(victim_prompt, greedy(max_new_tokens=victim_new, do_sample=False),
                            priority="best_effort", timeout=TIMEOUT)
        gate.step()  # the victim is admitted (paged: its prefill runs before this step)
        gate.step()
        calls.submit("arrival", _enc("interactive arrival"),
                     greedy(max_new_tokens=8, do_sample=False), priority="interactive")
        gate.step()  # the arrival preempts the victim
        before = eng.stats_snapshot()
        gate.open()
        victim = list(stream)
        rec = {"victim": victim, "outcomes": calls.join(), "counters": _counters(eng),
               "reused_by_resume": (eng.stats_snapshot()["prefix_tokens_reused"]
                                    - before["prefix_tokens_reused"]),
               "preempted_before_open": before["preemptions"]}
        _close(eng, gate)
        return rec

    return script


def test_preempt_resume_bit_identical_dense(pair):
    """A preempted-then-resumed greedy request on the dense engine emits the
    uninterrupted run's tokens, with a live neighbour the whole time; the
    JAX engine gives the same tokens and counters for the same arrivals."""
    prompt = _enc("preempt me please")
    rec = _both(pair, _preempt_script("dense", prompt))
    assert rec["preempted_before_open"] == 1 and rec["counters"]["preemptions"] == 1
    assert rec["victim"] == _solo(pair["port"], prompt, 24)
    _not_an_echo(prompt, rec["victim"])
    assert all(o[0] == "ok" for o in rec["outcomes"].values())
    assert rec["counters"]["goodput_tokens"] == rec["counters"]["tokens_served"]


def test_preempt_resume_bit_identical_paged_and_banks_blocks(pair):
    """The same on the paged engine, and the preemption banks the victim's
    full context blocks in the prefix cache, so the resume prefills only the
    unbanked tail (``prefix_tokens_reused`` grows by the banked blocks)."""
    prompt = _enc("a forty-ish token victim prompt for block banking")
    assert len(prompt) >= 32
    rec = _both(pair, _preempt_script("paged", prompt))
    assert rec["counters"]["preemptions"] == 1
    assert rec["victim"] == _solo(pair["port"], prompt, 24)
    _not_an_echo(prompt, rec["victim"])
    banked = (len(prompt) + 3 - 1) // PAGED["block_len"]  # 3 tokens before the preemption
    assert rec["reused_by_resume"] >= banked * PAGED["block_len"] >= 32


def test_paged_preemption_under_block_pressure(pair):
    """A pool too small for two requests: an interactive arrival finds no
    free blocks with a slot free and preempts the best_effort request that
    holds them; the victim resumes after it and ends with its solo tokens."""
    prompt = _enc("a forty-ish token victim prompt for block banking")

    def script(side):
        gate = _Gate()
        # 1 null block + 8 usable: each request below reserves 5 or 6 blocks
        eng = _engine(side, "paged", gate=gate, num_blocks=9)
        cfg = side["config"]
        stream = eng.stream(prompt, cfg(max_new_tokens=40, do_sample=False),
                            priority="best_effort", timeout=TIMEOUT)
        gate.park()
        gate.step()
        calls = _Calls(eng)
        calls.submit("arrival", _enc("an interactive arrival that needs blocks"),
                     cfg(max_new_tokens=40, do_sample=False), priority="interactive")
        gate.step()  # no blocks: the arrival preempts the victim
        preempted = eng.stats_snapshot()["preemptions"]
        gate.open()
        victim = list(stream)
        rec = {"victim": victim, "outcomes": calls.join(), "counters": _counters(eng),
               "preempted": preempted}
        _close(eng, gate)
        return rec

    rec = _both(pair, script)
    assert rec["preempted"] == 1 and rec["counters"]["preemptions"] == 1
    assert rec["victim"] == _solo(pair["port"], prompt, 40)
    assert rec["outcomes"]["arrival"][0] == "ok"


@pytest.mark.parametrize("kind,prompt,jax_preemptions", [
    ("dense", "preempt me please", 21),
    ("paged", "a forty-ish token victim prompt for block banking", 11),
])
def test_fast_aging_preempts_once(pair, kind, prompt, jax_preemptions):
    """With aging far faster than a tick (``age_promote_s`` 0.5 ms) the
    victim has aged to the arrival's tier by the time it requeues. The
    port's admission gives the freed slot to the arrival that preempted it,
    so there is one preemption and the victim still ends with its solo
    tokens. The JAX engines select again by aged tier, re-admit the victim
    into the slot it just lost and let the arrival preempt it again, tick
    after tick: the reference's fault, recorded here (the dense engine
    preempts 21 times, the paged one 11)."""
    prompt = _enc(prompt)
    port = _preempt_script(kind, prompt, age_promote_s=0.0005)(pair["port"])
    assert port["counters"]["preemptions"] == 1
    assert port["victim"] == _solo(pair["port"], prompt, 24)
    assert all(o[0] == "ok" for o in port["outcomes"].values())
    ref = _preempt_script(kind, prompt, age_promote_s=0.0005)(pair["jax"])
    assert ref["counters"]["preemptions"] == jax_preemptions


# ---------------------------------------------------------------- brownout


def test_brownout_stages_escalate_and_deescalate_with_hysteresis(pair):
    """Pressure drives the stage up through the thresholds; the hysteresis
    band holds it until the pressure falls clearly below the threshold that
    raised it. The gauge follows; the JAX controller takes the same path."""

    def script(side):
        eng = _engine(side, brownout_queue_wait_s=1.0)  # pressure == queue-wait EWMA
        stages = []
        # the idle worker is parked on its queue; the update first decays
        # the EWMA by 0.8 (empty queue), so each pressure p goes in as p / 0.8
        for p in (0.80, 0.96, 0.88, 0.80, 0.0):
            eng._queue_wait_ewma = p / 0.8
            eng._update_brownout()
            stages.append((eng.brownout_stage, eng.stats_snapshot()["brownout_stage"]))
        _close(eng)
        return stages

    stages = _both(pair, script)
    assert [s for s, _ in stages] == [1, 3, 3, 2, 0]
    assert all(s == g for s, g in stages)


def test_stage3_sheds_best_effort_only_and_idle_guard(pair):
    """Stage 3 rejects best_effort at admission with a tier-labelled 429
    while interactive traffic is served; an idle engine never sheds against
    a stale stage."""
    prompt = _enc("alpha")

    def script(side):
        gate = _Gate()
        # a microscopic drain budget puts any traffic at stage 3
        eng = _engine(side, gate=gate, brownout_drain_s=1e-9)
        cfg = side["config"](max_new_tokens=4, do_sample=False)
        calls = _Calls(eng)
        calls.submit("occupier", _enc("occupier"), side["config"](max_new_tokens=24,
                                                                  do_sample=False), queued=False)
        gate.park()
        stage = eng.brownout_stage
        try:
            eng.submit(prompt, cfg, priority="best_effort", timeout=TIMEOUT)
            raise AssertionError("best_effort was not shed")
        except Exception as e:  # noqa: BLE001 - either package's BrownoutShedError
            shed = (e.status, e.kind, e.retryable, e.tier, e.retry_after_s, e.to_dict()["tier"],
                    type(e).__mro__[1].__name__)
        calls.submit("interactive", prompt, cfg, priority="interactive")
        gate.open()
        rec = {"stage": stage, "shed": shed, "outcomes": calls.join(),
               "counters": _counters(eng)}
        _close(eng, gate)
        idle = _engine(side)
        idle._brownout_stage = 3  # a burst that drained while browned out
        rec["idle"] = list(idle.submit(prompt, cfg, priority="best_effort", timeout=TIMEOUT))
        _close(idle)
        return rec

    rec = _both(pair, script)
    assert rec["stage"] == 3
    status, kind, retryable, tier, retry_after, body_tier, parent = rec["shed"]
    assert (status, kind, retryable, tier, body_tier) == (
        429, "brownout_shed", True, "best_effort", "best_effort")
    assert parent == "QueueOverflowError" and 0.5 <= retry_after <= 600.0
    solo = _solo(pair["port"], prompt, 4)
    assert rec["outcomes"]["interactive"] == ("ok", solo) and rec["idle"] == solo
    assert rec["counters"]["requests_shed_by_tier"] == {
        "interactive": 0, "batch": 0, "best_effort": 1}


def test_stage1_stops_drafting_and_stage2_caps_best_effort(pair):
    """Stage 1+ proposes no drafts (the fused tick still runs); stage 2+
    caps a best_effort request's output at ``brownout_cap_tokens``."""
    side = pair["port"]
    prompt = _enc("water water water water water water")
    spec = GenerationConfig(max_new_tokens=12, do_sample=False, speculative_lookup=3)
    eng = _engine(side, speculative_k=3, brownout_cap_tokens=5)
    try:
        eng._brownout_stage = 1  # the test holds the stage: no pressure moves it down
        eng._update_brownout = lambda: None
        assert eng.submit(prompt, spec, timeout=TIMEOUT) == _solo(side, prompt, 12)
        assert eng.stats_snapshot()["draft_tokens_proposed"] == 0
        eng._brownout_stage = 2
        capped = eng.submit(prompt, spec, priority="best_effort", timeout=TIMEOUT)
        full = eng.submit(prompt, spec, priority="interactive", timeout=TIMEOUT)
        eng._brownout_stage = 0
        assert eng.submit(prompt, spec, timeout=TIMEOUT) == full
        assert eng.stats_snapshot()["draft_tokens_proposed"] > 0
    finally:
        _close(eng)
    assert capped == full[:5] and len(full) == 12


# ------------------------------------------------------------- fleet surface
#
# ``tests/test_overload.py``'s fleet cases: the router's stage-3 filter, the
# fleet-wide best_effort shed and the failover budget a client deadline
# caps, each run on both packages' classes with the same scripted replicas.


def _fleet_sides():
    from llm_fine_tune_distributed_tpu.infer import errors as jax_errors
    from llm_fine_tune_distributed_tpu.infer import fleet as jax_fleet
    from llm_fine_tune_distributed_tpu.infer import routing as jax_routing
    from llm_fine_tune_distributed_tpu.infer.sampling import GenerationConfig as JaxConfig
    from llm_fine_tune_distributed_tpu.observe.metrics import ServingStats as JaxStats
    from llm_fine_tune_distributed_tpu_torch.infer import errors as port_errors
    from llm_fine_tune_distributed_tpu_torch.infer import fleet as port_fleet
    from llm_fine_tune_distributed_tpu_torch.infer import routing as port_routing
    from llm_fine_tune_distributed_tpu_torch.observe.metrics import ServingStats

    return {"jax": dict(fleet=jax_fleet, routing=jax_routing, errors=jax_errors, stats=JaxStats,
                        config=JaxConfig),
            "port": dict(fleet=port_fleet, routing=port_routing, errors=port_errors,
                         stats=ServingStats, config=GenerationConfig)}


def test_router_filters_stage3_for_best_effort_only():
    out = {}
    for name, side in _fleet_sides().items():
        View, choose = side["routing"].ReplicaView, side["routing"].choose_replica
        views = [View(index=0, brownout_stage=3), View(index=1, brownout_stage=3)]
        rec = [choose("least-loaded", views, best_effort=True) is None,
               choose("least-loaded", views, best_effort=False) is not None]
        views[1].brownout_stage = 2
        placed = choose("least-loaded", views, best_effort=True)
        rec.append(placed.index if placed is not None else None)
        out[name] = rec
    assert out["port"] == out["jax"] == [True, True, 1]


class _FleetFake:
    """The surface a fleet reads, with a settable brownout stage and the
    keyword arguments of the last submit."""

    block_len = 0

    def __init__(self, stats_cls, index, stage=0, drain_s=3.0):
        self.index = index
        self.slot_count = 2
        self.healthy = True
        self.draining = False
        self.recovering = False
        self.queue_depth = 0
        self.live_slots = 0
        self.brownout_stage = stage
        self.drain_s = drain_s
        self.circuit_state = "closed"
        self.stats = stats_cls(slots=2)
        self.seen_kwargs = None

    def predicted_drain_s(self):
        return self.drain_s

    def prefix_match_len(self, keys):
        return 0

    def stats_snapshot(self):
        return self.stats.snapshot()

    def submit_full(self, prompt_ids, gen, seed=0, timeout=None, **kwargs):
        self.seen_kwargs = dict(kwargs, timeout=timeout)

        class _R:
            result = list(prompt_ids) + [self.index]

        return _R()


def _fleet_brownout_script(side):
    g = side["config"](max_new_tokens=4, do_sample=False)
    a = _FleetFake(side["stats"], 0, stage=3, drain_s=7.0)
    b = _FleetFake(side["stats"], 1, stage=3, drain_s=2.0)
    fleet = side["fleet"].EngineFleet([a, b], routing="round-robin")
    try:
        fleet.submit([1, 2], g, priority="best_effort", timeout=5)
        shed = None
    except side["errors"].BrownoutShedError as e:
        shed = (e.tier, e.retry_after_s)
    out = [shed, a.seen_kwargs is None and b.seen_kwargs is None,
           fleet.stats_snapshot()["requests_shed_fleet_brownout"],
           fleet.submit([1, 2], g, priority="interactive", timeout=5) in ([1, 2, 0], [1, 2, 1])]
    b.brownout_stage = 2  # one replica below stage 3 serves best_effort again
    out.append(fleet.submit([1, 2], g, priority="best_effort", timeout=5))
    return out


def test_fleet_sheds_best_effort_fleet_wide_when_all_browned_out():
    """Every healthy replica at stage 3: best_effort gets one fleet-wide
    tier-labelled 429 quoting the soonest drain, without a dispatch; other
    tiers still place."""
    out = {name: _fleet_brownout_script(side) for name, side in _fleet_sides().items()}
    assert out["port"] == out["jax"] == [("best_effort", 2.0), True, 1, True, [1, 2, 1]]


def test_fleet_deadline_caps_failover_budget():
    """``deadline_s`` bounds the whole fleet attempt: the replica gets a
    timeout of the deadline plus the fixed grace, and the rest of the
    deadline."""
    out = {}
    for name, side in _fleet_sides().items():
        rep = _FleetFake(side["stats"], 0)
        fleet = side["fleet"].EngineFleet([rep], routing="round-robin")
        fleet.submit([7], side["config"](max_new_tokens=4, do_sample=False), priority="batch",
                     deadline_s=5.0, timeout=600.0)
        grace = side["fleet"].DEADLINE_TIMEOUT_GRACE_S
        out[name] = (rep.seen_kwargs["priority"], grace,
                     5.0 < rep.seen_kwargs["timeout"] <= 5.0 + grace,
                     0 < rep.seen_kwargs["deadline_s"] <= 5.0)
    assert out["port"] == out["jax"] == ("batch", 1.0, True, True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_paged_int8_preempt_resume_counts_its_launches(cuda):
    """The paged preempt/resume script over an int8 pool on the card in
    f32: the victim's tokens equal the same script's on the CPU (the plain
    decode attention), the resume reuses the banked blocks, and the paged
    decode kernel is launched once per layer on every decode step, across
    the preemption and the resume."""
    mc = get_preset("tiny")
    params = tf.init_params(mc, seed=0, device="cpu", dtype=torch.float32)
    params = {k: v * 10.0 if k.endswith(".kernel") else v for k, v in params.items()}
    prompt = _enc("a forty-ish token victim prompt for block banking")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    recs, launches = {}, {}
    try:
        for device in ("cpu", cuda):
            gen = Generator(params, mc, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                            eos_token_ids=[], device=device)
            side = dict(gen=gen, config=GenerationConfig, paged=PagedContinuousBatchingEngine,
                        gated=_PortGated)
            before = paged_decode_attention.launches
            recs[str(device)] = _preempt_script("paged", prompt, kv_quant="int8")(side)
            launches[str(device)] = paged_decode_attention.launches - before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    got, want = recs["cuda"], recs["cpu"]
    assert got["victim"] == want["victim"] and len(got["victim"]) == 24
    assert got["counters"]["preemptions"] == 1 and got["reused_by_resume"] >= 32
    assert launches["cpu"] == 0
    assert launches["cuda"] == mc.num_layers * got["counters"]["decode_steps"] > 0
