"""The port's dense continuous batching engine against the JAX
``ContinuousBatchingEngine`` and against its own solo ``generate_ids``, on
the ``tiny`` preset in f32 at the JAX engine tests' geometry (slots 4,
buf_len 96, prompt_bucket 16).

The weights' kernels are scaled x10: at the 0.02 init the tied tiny model
echoes its last input token, and two echoing engines would agree whatever
their attention did. Each parity test checks that the tokens are no echo.

JAX is imported inside the fixture that needs it, so the card-only test
runs on a machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_continuous_engine.py``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer.engine import ContinuousBatchingEngine
from llm_fine_tune_distributed_tpu_torch.infer.errors import CircuitOpenError, RetryableEngineError
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.ops.flash_attention import paged_decode_attention

GEOMETRY = dict(slots=4, buf_len=96, prompt_bucket=16)
MAX_NEW = 8
GREEDY = GenerationConfig(max_new_tokens=MAX_NEW, do_sample=False)
SAMPLED = GenerationConfig(max_new_tokens=MAX_NEW, do_sample=True, temperature=1.0)
TIMEOUT = 240


def _enc(text):
    return list(text.encode("utf-8"))


PROMPTS = [_enc(t) for t in ("alpha", "beta bravo", "the quick brown fox")]


def _not_an_echo(prompts, outs):
    assert any(out != [p[-1]] * len(out) for p, out in zip(prompts, outs)), outs


def _concurrent(submit, args):
    out = [None] * len(args)

    def run(i):
        out[i] = submit(*args[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    return out


def _port_generator(params, mc, device="cpu", eos=()):
    return Generator(params, mc, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                     eos_token_ids=list(eos), device=device)


class _Wrapped:
    """The port's Generator with its decode step replaced."""

    def __init__(self, gen, step):
        self._gen = gen
        self._step = step
        self.eos_token_ids = gen.eos_token_ids

    def __getattr__(self, name):
        return getattr(self._gen, name)

    def slot_step(self, *a):
        return self._step(*a)


def _failing_step(*a):
    raise RuntimeError("device lost")


@pytest.fixture(scope="module")
def generators():
    """The JAX and the port's Generator on the same x10 weights, made by the
    JAX package from PRNGKey(0)."""
    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTok
    from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
    from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_get_preset
    from llm_fine_tune_distributed_tpu.models.transformer import init_params as jax_init_params
    from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax

    jmc = jax_get_preset("tiny")
    jparams = jax_init_params(jax.random.PRNGKey(0), jmc, dtype=jnp.float32)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 10.0 if path[-1].key == "kernel" else x, jparams
    )
    jgen = JaxGenerator(jparams, jmc, JaxTok(), compute_dtype=jnp.float32, eos_token_ids=[])
    mc = get_preset("tiny")
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jparams)).items()}
    return jgen, _port_generator(params_from_jax(flat, mc), mc)


@pytest.fixture(scope="module")
def gen(generators):
    return generators[1]


@pytest.fixture
def engine(gen):
    eng = ContinuousBatchingEngine(gen, **GEOMETRY)
    yield eng
    eng.close()
    assert not eng._worker.is_alive()


def test_greedy_tokens_equal_the_jax_engines_with_live_neighbours(generators, engine):
    """Concurrent greedy requests, beside a sampled neighbour in the port,
    emit the JAX engine's tokens."""
    from llm_fine_tune_distributed_tpu.infer import GenerationConfig as JaxGenerationConfig
    from llm_fine_tune_distributed_tpu.infer.engine import (
        ContinuousBatchingEngine as JaxContinuousEngine,
    )

    jgen, _ = generators
    jeng = JaxContinuousEngine(jgen, **GEOMETRY)
    jcfg = JaxGenerationConfig(max_new_tokens=MAX_NEW, do_sample=False)
    want = _concurrent(lambda p: jeng.submit(p, jcfg, timeout=TIMEOUT), [(p,) for p in PROMPTS])
    args = [(p, GREEDY, 0) for p in PROMPTS] + [(PROMPTS[0], SAMPLED, 5)]
    got = _concurrent(lambda p, g, s: engine.submit(p, g, s, timeout=TIMEOUT), args)
    assert got[:3] == want
    assert all(len(t) == MAX_NEW for t in got)
    _not_an_echo(PROMPTS, got[:3])


def test_greedy_tokens_equal_solo_generate_ids(gen, engine):
    want = [gen.generate_ids(p, GREEDY) for p in PROMPTS]
    got = _concurrent(lambda p: engine.submit(p, GREEDY, timeout=TIMEOUT), [(p,) for p in PROMPTS])
    assert got == want
    _not_an_echo(PROMPTS, got)


def test_fifo_admission_mixed_traffic(gen):
    """With the one slot occupied, a sampled waiter that arrived before a
    greedy one is admitted first: no compatibility class jumps the queue.
    Each decode step sleeps 10 ms, so both arrive while the occupant runs."""

    def slow_step(*a):
        time.sleep(0.01)
        return gen.slot_step(*a)

    eng = ContinuousBatchingEngine(_Wrapped(gen, slow_step), slots=1, buf_len=96,
                                   prompt_bucket=16)
    done_at = {}

    def ask(name, delay, prompt, cfg):
        def run():
            time.sleep(delay)
            eng.submit(prompt, cfg, timeout=TIMEOUT)
            done_at[name] = time.monotonic()

        t = threading.Thread(target=run)
        t.start()
        return t

    try:
        threads = [
            ask("occupant", 0.0, PROMPTS[0], GenerationConfig(max_new_tokens=80, do_sample=False)),
            ask("sampled", 0.10, PROMPTS[1], SAMPLED),
            ask("greedy", 0.20, PROMPTS[2], GREEDY),
        ]
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
    finally:
        eng.close()
    assert done_at["occupant"] < done_at["sampled"] < done_at["greedy"], done_at


def test_slot_reuse_after_eos_with_a_shorter_prompt(gen):
    """One slot serves a long prompt that ends at EOS, then a shorter prompt
    whose prefill leaves the first tenant's K/V beyond it: both equal their
    solo runs (slot == position keeps the stale K/V masked)."""
    long_prompt = _enc("a longer prompt that fills more of the row")
    solo_open = gen.generate_ids(long_prompt, GREEDY)
    eos = solo_open[3]
    gen_eos = _port_generator(gen.params, gen.config, eos=[eos])
    short = _enc("the quick brown")  # bucket 16: its decode reaches the stale K/V
    want = [gen_eos.generate_ids(p, GREEDY) for p in (long_prompt, short, long_prompt)]
    assert want[0] == solo_open[: solo_open.index(eos)]
    assert len(short) + len(want[1]) > 16 and len(long_prompt) > 16 + MAX_NEW
    eng = ContinuousBatchingEngine(gen_eos, slots=1, buf_len=96, prompt_bucket=16)
    try:
        got = [eng.submit(p, GREEDY, timeout=TIMEOUT) for p in (long_prompt, short, long_prompt)]
        snap = eng.stats_snapshot()
    finally:
        eng.close()
    assert got == want
    assert snap["requests_completed"] == 3 and snap["live_slots"] == 0


def test_prompt_of_buf_len_minus_one_tokens(gen, engine):
    """A prompt one position short of the buffer gets a budget of one token
    (the first, from the prefill), equal to the solo run's; one position
    more is refused."""
    buf_len = GEOMETRY["buf_len"]
    prompt = (_enc("the quick brown fox jumps over the lazy dog. ") * 3)[: buf_len - 1]
    assert len(prompt) == buf_len - 1
    got = engine.submit(prompt, GREEDY, timeout=TIMEOUT)
    assert got == gen.generate_ids(prompt, GREEDY)[:1]
    with pytest.raises(ValueError, match="does not fit"):
        engine.submit(prompt + [1], GREEDY, timeout=TIMEOUT)


def test_slot_prefill_first_token_does_not_depend_on_the_bucket(gen):
    """The same prompt prefilled at buckets 16 and 32: the same first token
    and the same K/V in its row at the real positions; the other rows of
    the cache stay as they were."""
    prompt = PROMPTS[2]
    plen = len(prompt)
    firsts, rows = [], []
    for bucket in (16 * -(-plen // 16), 32 * -(-plen // 32) + 32):
        cache, state = gen.init_slot_state(3, 96)
        for entry in cache["layers"].values():
            entry["k"].fill_(7.0)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :plen] = prompt
        firsts.append(gen.slot_prefill(cache, state, padded, plen, 1, GREEDY, 0))
        k = cache["layers"]["0"]["k"]
        assert torch.all(k[0] == 7.0) and torch.all(k[2] == 7.0)
        assert torch.all(k[1, bucket:] == 7.0)
        assert int(state["pos"][1]) == plen and int(state["last"][1]) == firsts[-1]
        rows.append(k[1, :plen].clone())
    assert firsts[0] == firsts[1] == gen.generate_ids(prompt, GREEDY)[0]
    torch.testing.assert_close(rows[0], rows[1], rtol=1e-6, atol=1e-6)


def test_abandoned_request_is_shed_without_decoding(gen):
    """A submit that times out while queued is never admitted (each decode
    step sleeps 10 ms, so the occupier holds the one slot for ~0.8 s)."""

    def slow_step(*a):
        time.sleep(0.01)
        return gen.slot_step(*a)

    eng = ContinuousBatchingEngine(_Wrapped(gen, slow_step), slots=1, buf_len=96,
                                   prompt_bucket=16)
    long_cfg = GenerationConfig(max_new_tokens=80, do_sample=False)
    try:
        occupier = threading.Thread(target=lambda: eng.submit(PROMPTS[0], long_cfg,
                                                              timeout=TIMEOUT))
        occupier.start()
        time.sleep(0.05)
        with pytest.raises(TimeoutError):
            eng.submit(PROMPTS[1], GREEDY, timeout=0.05)
        occupier.join(TIMEOUT)
        assert not occupier.is_alive()
        assert eng.submit(PROMPTS[2], GREEDY, timeout=TIMEOUT) is not None
        snap = eng.stats_snapshot()
    finally:
        eng.close()
    assert snap["requests_abandoned"] == 1
    assert snap["requests_admitted"] == 2
    budget = 96 - len(PROMPTS[0])
    assert snap["tokens_served"] == min(80, budget) + MAX_NEW


def test_stream_yields_submits_tokens(gen, engine):
    """``stream`` yields, one at a time, the tokens ``submit`` returns for
    the same request, while a sampled neighbour decodes beside it."""
    want = engine.submit(PROMPTS[1], GREEDY, timeout=TIMEOUT)
    neighbour = threading.Thread(target=lambda: engine.submit(
        PROMPTS[0], GenerationConfig(max_new_tokens=24, do_sample=True), timeout=TIMEOUT))
    neighbour.start()
    got = list(engine.stream(PROMPTS[1], GREEDY, timeout=120))
    neighbour.join(TIMEOUT)
    assert not neighbour.is_alive()
    assert got == want


def test_errors_reach_the_waiter(gen, engine):
    with pytest.raises(ValueError, match="non-empty"):
        engine.submit([], GREEDY, timeout=30)
    with pytest.raises(ValueError, match="does not fit"):
        engine.submit(list(range(200)), GREEDY, timeout=30)
    assert engine.submit(PROMPTS[0], GREEDY, timeout=TIMEOUT)  # still serving
    # a device that fails every step: each failure is retryable (the JAX
    # classification), so the engine restarts until the default
    # circuit_threshold of 5 failures in the window opens the circuit
    eng = ContinuousBatchingEngine(_Wrapped(gen, _failing_step), **GEOMETRY,
                                   restart_backoff_s=0.01, restart_backoff_max_s=0.02)
    try:
        for generation in range(4):
            with pytest.raises(RetryableEngineError, match="device lost") as failed:
                eng.submit(PROMPTS[0], GREEDY, timeout=30)
            assert failed.value.generation == generation and failed.value.retry_after_s > 0
        with pytest.raises(CircuitOpenError, match="device lost"):
            eng.submit(PROMPTS[0], GREEDY, timeout=30)
        # a dead engine refuses later submits with its terminal error
        with pytest.raises(CircuitOpenError, match="device lost") as refused:
            eng.submit(PROMPTS[0], GREEDY, timeout=30)
        assert refused.value is eng.terminal_error and not eng.healthy
        snap = eng.stats_snapshot()
        assert (snap["requests_failed"], snap["engine_restarts"], snap["circuit_state"]) == (
            5, 4, "open")
    finally:
        eng.close()
    assert not eng._worker.is_alive()


def test_sampled_tokens_are_deterministic_in_request_and_seed(gen, engine):
    """A sampled request draws the same tokens whatever decodes beside it,
    the tokens of a solo ``generate_ids`` with its seed; another seed draws
    others."""
    alone = engine.submit(PROMPTS[2], SAMPLED, 7, timeout=TIMEOUT)
    crowded = _concurrent(lambda p, g, s: engine.submit(p, g, s, timeout=TIMEOUT),
                          [(PROMPTS[2], SAMPLED, 7), (PROMPTS[0], GREEDY, 0),
                           (PROMPTS[1], SAMPLED, 3)])
    other = engine.submit(PROMPTS[2], SAMPLED, 8, timeout=TIMEOUT)
    assert alone == crowded[0] == gen.generate_ids(PROMPTS[2], SAMPLED, seed=7)
    assert len(alone) == MAX_NEW and other != alone


def test_stats_snapshot_adds_up(engine):
    """One request at a time: each takes its first token from the prefill
    and the rest from ``MAX_NEW - 1`` decode steps."""
    results = [engine.submit(p, GREEDY, timeout=TIMEOUT) for p in PROMPTS]
    snap = engine.stats_snapshot()
    n = len(PROMPTS)
    assert snap["tokens_served"] == sum(len(r) for r in results) == n * MAX_NEW
    assert snap["requests_completed"] == snap["requests_admitted"] == n
    assert snap["decode_steps"] == n * (MAX_NEW - 1)
    assert snap["decode_tokens"] == n * (MAX_NEW - 1)
    assert snap["prefill_tokens"] == sum(len(p) for p in PROMPTS)
    assert snap["goodput_tokens"] == snap["tokens_served"]
    assert snap["live_slots"] == 0 and snap["queue_depth"] == 0
    assert snap["mean_tokens_per_step"] == snap["tokens_served"] / snap["decode_steps"]
    hist = snap["histograms"]
    assert hist["ttft_s"]["count"] == hist["queue_wait_s"]["count"] == n
    assert hist["inter_token_s"]["count"] == n * (MAX_NEW - 1)
    assert hist["decode_tick_s"]["count"] == snap["decode_steps"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_continuous_engine_equals_its_cpu_tokens(cuda):
    """The continuous engine on the card in f32 gives its CPU tokens, and
    never launches the paged decode kernel."""
    mc = get_preset("tiny")
    params = tf.init_params(mc, seed=0, device="cpu", dtype=torch.float32)
    params = {k: v * 10.0 if k.endswith(".kernel") else v for k, v in params.items()}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    outs = {}
    try:
        for device in ("cpu", cuda):
            eng = ContinuousBatchingEngine(_port_generator(params, mc, device=device), **GEOMETRY)
            launches = paged_decode_attention.launches
            try:
                outs[str(device)] = _concurrent(lambda p: eng.submit(p, GREEDY, timeout=TIMEOUT),
                                                [(p,) for p in PROMPTS])
            finally:
                eng.close()
            assert paged_decode_attention.launches == launches
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert outs["cuda"] == outs["cpu"]
    _not_an_echo(PROMPTS, outs["cpu"])
