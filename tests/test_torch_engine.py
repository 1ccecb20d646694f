"""The port's paged int8 engine against the JAX ``PagedContinuousBatchingEngine``
on the ``tiny`` preset in f32: identical greedy tokens, and the same sampling
pipeline.

Geometry as the JAX package's quantized-serving tests: slots 4, buf_len 96,
prompt_bucket 16, block_len 16, prefill_chunk 32. The weights' kernels are
scaled x10: at the 0.02 init the tied tiny model echoes its last input
token, and two echoing engines would agree whatever their attention did.
Each parity test also checks that the tokens are not such an echo.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTokenizer
from llm_fine_tune_distributed_tpu.infer import GenerationConfig as JaxGenerationConfig
from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
from llm_fine_tune_distributed_tpu.infer import sampling as jax_sampling
from llm_fine_tune_distributed_tpu.infer.engine import (
    PagedContinuousBatchingEngine as JaxPagedEngine,
)
from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_get_preset
from llm_fine_tune_distributed_tpu.models.transformer import init_params as jax_init_params
from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer import sampling
from llm_fine_tune_distributed_tpu_torch.infer.engine import PagedContinuousBatchingEngine, Request
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.ops.flash_attention import paged_decode_attention

GEOMETRY = dict(slots=4, buf_len=96, prompt_bucket=16, block_len=16, prefill_chunk=32)
MAX_NEW = 8
TIMEOUT = 240


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
    gen = Generator(
        params_from_jax(flat, mc), mc, ByteChatMLTokenizer(),
        compute_dtype=torch.float32, eos_token_ids=[], device="cpu",
    )
    return jgen, gen


@pytest.fixture(scope="module")
def engines(generators):
    jgen, gen = generators
    jeng = JaxPagedEngine(jgen, kv_quant="int8", **GEOMETRY)
    eng = PagedContinuousBatchingEngine(gen, kv_quant="int8", **GEOMETRY)
    yield jeng, eng
    eng.close()
    assert not eng._worker.is_alive()


def _enc(text):
    return list(text.encode("utf-8"))


def _not_an_echo(prompts, outs):
    assert any(out != [p[-1]] * len(out) for p, out in zip(prompts, outs)), outs


def _concurrent(submit, prompts):
    out = [None] * len(prompts)

    def run(i):
        out[i] = submit(prompts[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    return out


def test_concurrent_greedy_tokens_identical(engines):
    """Concurrent submits (no shared full blocks, so the order they are
    admitted in cannot change any output) emit the JAX engine's tokens."""
    jeng, eng = engines
    prompts = [_enc(t) for t in ("alpha", "beta bravo", "the quick brown fox")]
    want = _concurrent(
        lambda p: jeng.submit(p, JaxGenerationConfig(max_new_tokens=MAX_NEW, do_sample=False),
                              timeout=TIMEOUT), prompts)
    got = _concurrent(
        lambda p: eng.submit(p, GenerationConfig(max_new_tokens=MAX_NEW, do_sample=False),
                             timeout=TIMEOUT), prompts)
    assert got == want
    assert all(len(t) == MAX_NEW for t in got)
    _not_an_echo(prompts, got)


def test_prompt_longer_than_one_chunk(engines):
    """A 70-token prompt prefills in three chunks (32 + 32 + 6 padded to 16)."""
    jeng, eng = engines
    prompt = _enc("a prompt long enough to need more than one prefill chunk, and then some")
    assert len(prompt) > 2 * GEOMETRY["prefill_chunk"]
    want = jeng.submit(prompt, JaxGenerationConfig(max_new_tokens=MAX_NEW, do_sample=False),
                       timeout=TIMEOUT)
    got = eng.submit(prompt, GenerationConfig(max_new_tokens=MAX_NEW, do_sample=False),
                     timeout=TIMEOUT)
    assert got == want
    _not_an_echo([prompt], [got])


def test_shared_prefix_hits_the_prefix_cache(engines):
    """Two prompts sharing two full blocks: the second maps them from the
    prefix cache in both engines, and the tokens still agree."""
    jeng, eng = engines
    common = "shared system preamble of two blocks!"
    assert len(common) >= 2 * GEOMETRY["block_len"]
    before = eng.stats_snapshot()["prefix_hits"]
    launches = paged_decode_attention.launches
    jbefore = jeng.stats_snapshot()["prefix_tokens_reused"]
    prompts, outs = [], []
    for suffix in (" first question?", " second, different question?"):
        prompt = _enc(common + suffix)
        want = jeng.submit(prompt, JaxGenerationConfig(max_new_tokens=MAX_NEW, do_sample=False),
                           timeout=TIMEOUT)
        got = eng.submit(prompt, GenerationConfig(max_new_tokens=MAX_NEW, do_sample=False),
                         timeout=TIMEOUT)
        assert got == want
        prompts.append(prompt)
        outs.append(got)
    _not_an_echo(prompts, outs)
    snap = eng.stats_snapshot()
    assert snap["prefix_hits"] >= before + 1
    assert jeng.stats_snapshot()["prefix_tokens_reused"] - jbefore >= 2 * GEOMETRY["block_len"]
    # the CPU path never launches the CUDA kernel
    assert paged_decode_attention.launches == launches
    assert snap["decode_steps"] > 0 and snap["live_slots"] == 0


def test_sampled_requests_are_deterministic_in_seed(generators):
    """The same request and seed on the same pool state (a fresh engine each
    time) draws the same tokens; another seed draws others. A freed int8
    block keeps its absmax scale, in the JAX engine too, so a repeat on a
    pool that served other requests may quantize its prompt differently."""
    _, gen = generators
    cfg = GenerationConfig(max_new_tokens=MAX_NEW, do_sample=True, temperature=1.0)
    prompt = _enc("sampled prompt")
    outs = []
    for seed in (7, 7, 8):
        eng = PagedContinuousBatchingEngine(gen, kv_quant="int8", **GEOMETRY)
        try:
            outs.append(eng.submit(prompt, cfg, seed=seed, timeout=TIMEOUT))
        finally:
            eng.close()
    assert outs[0] == outs[1] and len(outs[0]) == MAX_NEW
    assert outs[2] != outs[0]


def test_close_serves_the_requests_already_queued(generators):
    _, gen = generators
    eng = PagedContinuousBatchingEngine(gen, kv_quant="int8", **GEOMETRY)
    reqs = [Request(_enc(t), GenerationConfig(max_new_tokens=4, do_sample=False), 0)
            for t in ("one", "two")]
    for r in reqs:
        eng._q.put(r)
    eng.close(timeout=TIMEOUT)
    assert not eng._worker.is_alive()
    assert all(r.done.is_set() and r.error is None and len(r.result) == 4 for r in reqs)


@pytest.mark.parametrize("knobs", [
    dict(),
    dict(temperature=1.0, top_k=None, top_p=0.9),
    dict(temperature=0.3, top_k=5, top_p=1.0, repetition_penalty=1.0),
])
def test_warp_and_injected_noise_match_jax(knobs):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 512)).astype(np.float32) * 4
    seen = rng.random(size=(3, 512)) < 0.1
    jcfg = JaxGenerationConfig(**knobs)
    cfg = GenerationConfig(**knobs)
    jvals, jidx = jax_sampling._warp(jnp.asarray(logits), jnp.asarray(seen), jcfg)
    vals, idx = sampling._warp(torch.from_numpy(logits), torch.from_numpy(seen), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-6, atol=1e-6)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = jax_sampling.sample_token(key, jnp.asarray(logits), jnp.asarray(seen), jcfg)
        # jax.random.categorical draws argmax(logits + gumbel(key)): hand the
        # same noise to the port
        noise = np.array(jax.random.gumbel(key, jvals.shape, jvals.dtype))
        got = sampling.sample_token(torch.from_numpy(logits), torch.from_numpy(seen), cfg,
                                    gumbel=torch.from_numpy(noise))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_sampling_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4, 512)).astype(np.float32)
    seen = rng.random(size=(4, 512)) < 0.2
    jcfg = JaxGenerationConfig(do_sample=False)
    want = jax_sampling.sample_token(None, jnp.asarray(logits), jnp.asarray(seen), jcfg)
    got = sampling.sample_token(torch.from_numpy(logits), torch.from_numpy(seen),
                                GenerationConfig(do_sample=False))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
