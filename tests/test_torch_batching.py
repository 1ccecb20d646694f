"""The port's window batcher (``infer/batching.py``) against the JAX
``BatchingEngine``, and the cases of the JAX package's own batching tests:
concurrent greedy requests group into one batch with their solo tokens,
mixed configs resolve, errors reach the waiters, sampled requests keep
their solo seeding, a timed-out request is shed, deferred requests keep
FIFO order. ``tiny`` preset in f32, kernels x10 (see
``tests/test_torch_continuous_engine.py``)."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTokenizer
from llm_fine_tune_distributed_tpu.infer import GenerationConfig as JaxGenerationConfig
from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
from llm_fine_tune_distributed_tpu.infer.batching import BatchingEngine as JaxBatchingEngine
from llm_fine_tune_distributed_tpu.infer.batching import _pad_batch_size as jax_pad_batch_size
from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_get_preset
from llm_fine_tune_distributed_tpu.models.transformer import init_params as jax_init_params
from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer.batching import BatchingEngine, _pad_batch_size
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset

TIMEOUT = 240
PROMPTS = [list(t.encode()) for t in ("alpha", "beta bravo", "the quick brown fox")]


@pytest.fixture(scope="module")
def generators():
    jmc = jax_get_preset("tiny")
    jparams = jax_init_params(jax.random.PRNGKey(0), jmc, dtype=jnp.float32)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 10.0 if path[-1].key == "kernel" else x, jparams
    )
    jgen = JaxGenerator(jparams, jmc, JaxTokenizer(), compute_dtype=jnp.float32, eos_token_ids=[])
    mc = get_preset("tiny")
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jparams)).items()}
    gen = Generator(params_from_jax(flat, mc), mc, ByteChatMLTokenizer(),
                    compute_dtype=torch.float32, eos_token_ids=[], device="cpu")
    return jgen, gen


def _concurrent(submit, args, stagger=0.0):
    out = [None] * len(args)

    def run(i):
        time.sleep(stagger * i)
        out[i] = submit(*args[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    return out


class _Recorder:
    """A generator stand-in that records the batches it is given."""

    def __init__(self, sleep=0.0):
        self.batches = []
        self.sleep = sleep

    def generate_batch(self, prompts, gen, seed=0, live_rows=None):
        time.sleep(self.sleep)
        self.batches.append(([tuple(p) for p in prompts], live_rows))
        return [[0] * gen.max_new_tokens for _ in prompts]


def test_pad_batch_size():
    ns = (1, 2, 3, 5, 8, 9)
    assert [_pad_batch_size(n, 8) for n in ns] == [jax_pad_batch_size(n, 8) for n in ns] \
        == [1, 2, 4, 8, 8, 8]


def test_greedy_tokens_equal_the_jax_batchers(generators):
    jgen, gen = generators
    jeng = JaxBatchingEngine(jgen, max_batch=4, window_ms=200.0)
    want = _concurrent(lambda p: jeng.submit(
        p, JaxGenerationConfig(max_new_tokens=5, do_sample=False), timeout=TIMEOUT),
        [(p,) for p in PROMPTS])
    eng = BatchingEngine(gen, max_batch=4, window_ms=200.0)
    try:
        got = _concurrent(lambda p: eng.submit(
            p, GenerationConfig(max_new_tokens=5, do_sample=False), timeout=TIMEOUT),
            [(p,) for p in PROMPTS])
    finally:
        eng.close()
    assert got == want
    assert any(out != [p[-1]] * len(out) for p, out in zip(PROMPTS, got)), got


def test_concurrent_requests_match_solo(generators):
    """Three greedy requests in one window: one batch padded to 4 rows, each
    row its solo tokens."""
    _, gen = generators
    cfg = GenerationConfig(max_new_tokens=5, do_sample=False, repetition_penalty=1.0)
    solo = [gen.generate_ids(p, cfg) for p in PROMPTS]
    eng = BatchingEngine(gen, max_batch=4, window_ms=200.0)
    try:
        got = _concurrent(lambda p: eng.submit(p, cfg, timeout=TIMEOUT), [(p,) for p in PROMPTS])
    finally:
        eng.close()
    assert got == solo
    rec = _Recorder()
    eng = BatchingEngine(rec, max_batch=4, window_ms=200.0)
    try:
        _concurrent(lambda p: eng.submit(p, cfg, timeout=TIMEOUT), [(p,) for p in PROMPTS])
    finally:
        eng.close()
    (rows, live), = rec.batches
    assert len(rows) == 4 and live == 3 and rows[3] == rows[0]


def test_mixed_configs_all_resolve(generators):
    _, gen = generators
    cfg_a = GenerationConfig(max_new_tokens=4, do_sample=False, repetition_penalty=1.0)
    cfg_b = GenerationConfig(max_new_tokens=6, do_sample=False, repetition_penalty=1.0)
    eng = BatchingEngine(gen, max_batch=4, window_ms=50.0)
    cfgs = [cfg_a, cfg_b, cfg_a]
    try:
        got = _concurrent(lambda p, c: eng.submit(p, c, timeout=TIMEOUT),
                          list(zip(PROMPTS, cfgs)))
    finally:
        eng.close()
    assert [len(r) for r in got] == [c.max_new_tokens for c in cfgs]
    assert got == [gen.generate_ids(p, c) for p, c in zip(PROMPTS, cfgs)]


def test_generation_error_propagates_to_waiters():
    class Boom:
        def generate_batch(self, *a, **kw):
            raise RuntimeError("boom")

    eng = BatchingEngine(Boom(), max_batch=2, window_ms=5.0)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            eng.submit([1, 2, 3], GenerationConfig(max_new_tokens=2), timeout=30)
        with pytest.raises(RuntimeError, match="boom"):  # the worker keeps serving
            eng.submit([1, 2, 3], GenerationConfig(max_new_tokens=2), timeout=30)
    finally:
        eng.close()
    assert not eng._worker.is_alive()


def test_sampled_requests_keep_solo_seeding(generators):
    """Sampled requests never co-batch: each concurrent request gets the
    tokens of a solo run with its (config, seed)."""
    _, gen = generators
    cfg = GenerationConfig(max_new_tokens=5, do_sample=True, temperature=1.0)
    seeds = [3, 7]
    solo = [gen.generate_ids(p, cfg, seed=s) for p, s in zip(PROMPTS, seeds)]
    eng = BatchingEngine(gen, max_batch=4, window_ms=100.0)
    try:
        got = _concurrent(lambda p, s: eng.submit(p, cfg, seed=s, timeout=TIMEOUT),
                          list(zip(PROMPTS, seeds)))
    finally:
        eng.close()
    assert got == solo


def test_submit_timeout_sheds_load():
    """A wedged generator does not hold a handler forever: submit raises
    TimeoutError, and the abandoned request never reaches the device."""
    rec = _Recorder(sleep=0.5)
    eng = BatchingEngine(rec, max_batch=1, window_ms=1.0)
    try:
        first = threading.Thread(target=lambda: eng.submit([1], GenerationConfig(
            max_new_tokens=2, do_sample=False), timeout=TIMEOUT))
        first.start()
        time.sleep(0.1)
        with pytest.raises(TimeoutError):
            eng.submit([2], GenerationConfig(max_new_tokens=2), timeout=0.1)
        first.join(TIMEOUT)
        assert not first.is_alive()
        assert eng.wait_drained(30)
    finally:
        eng.close()
    assert [rows for rows, _ in rec.batches] == [[(1,)]]


def test_deferred_requests_keep_fifo_order():
    """An incompatible request drained during another group's window is
    served on the next cycle, before requests that arrived after it."""
    rec = _Recorder()
    greedy_a = GenerationConfig(max_new_tokens=2, do_sample=False)
    sampled = GenerationConfig(max_new_tokens=2, do_sample=True)
    greedy_b = GenerationConfig(max_new_tokens=3, do_sample=False)
    eng = BatchingEngine(rec, max_batch=4, window_ms=150.0)
    try:
        _concurrent(lambda p, c: eng.submit(p, c, timeout=TIMEOUT),
                    [([1], greedy_a), ([2], sampled), ([3], greedy_b)], stagger=0.03)
    finally:
        eng.close()
    order = [row for rows, _ in rec.batches for row in rows]
    assert order.index((2,)) < order.index((3,)), order


def test_drain_closes_admission_and_waits_for_the_queue():
    rec = _Recorder(sleep=0.2)
    eng = BatchingEngine(rec, max_batch=1, window_ms=1.0)
    try:
        t = threading.Thread(target=lambda: eng.submit([1], GenerationConfig(max_new_tokens=2),
                                                       timeout=TIMEOUT))
        t.start()
        time.sleep(0.05)
        eng.begin_drain()
        with pytest.raises(RuntimeError, match="draining"):
            eng.submit([2], GenerationConfig(max_new_tokens=2), timeout=TIMEOUT)
        assert eng.wait_drained(30)
        t.join(TIMEOUT)
        assert not t.is_alive()
    finally:
        eng.close()
    assert [rows for rows, _ in rec.batches] == [[(1,)]]
