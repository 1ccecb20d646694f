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


def _jax_fresh_pool(jgen, prompt):
    """The JAX engine's greedy tokens for ``prompt`` on a fresh pool: the
    port's rule for a block the request was given (its scales start from
    zero), which the JAX engine keeps only on a pool no request used
    before."""
    jeng = JaxPagedEngine(jgen, kv_quant="int8", **GEOMETRY)
    return jeng.submit(prompt, JaxGenerationConfig(max_new_tokens=MAX_NEW, do_sample=False),
                       timeout=TIMEOUT)


def test_shared_prefix_hits_the_prefix_cache(generators, engines):
    """Two prompts sharing two full blocks: the second maps them from the
    prefix cache in both engines, and the port's tokens on its used pool
    equal the JAX engine's on a fresh pool (the JAX engine's own pool hands
    out freed blocks with their last owner's int8 scales)."""
    jgen, _ = generators
    jeng, eng = engines
    common = "shared system preamble of two blocks!"
    assert len(common) >= 2 * GEOMETRY["block_len"]
    before = eng.stats_snapshot()["prefix_hits"]
    launches = paged_decode_attention.launches
    jbefore = jeng.stats_snapshot()["prefix_tokens_reused"]
    prompts, outs = [], []
    for suffix in (" first question?", " second, different question?"):
        prompt = _enc(common + suffix)
        jeng.submit(prompt, JaxGenerationConfig(max_new_tokens=MAX_NEW, do_sample=False),
                    timeout=TIMEOUT)
        want = _jax_fresh_pool(jgen, prompt)
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
    """The same request and seed draws the same tokens on a fresh engine and
    again on that engine's pool after another request used and freed its
    blocks (a fresh int8 block starts from scale zero, whoever held it
    before); another seed draws others."""
    _, gen = generators
    cfg = GenerationConfig(max_new_tokens=MAX_NEW, do_sample=True, temperature=1.0)
    prompt = _enc("sampled prompt")
    outs = []
    for seed in (7, 7, 8):
        eng = PagedContinuousBatchingEngine(gen, kv_quant="int8", **GEOMETRY)
        try:
            outs.append(eng.submit(prompt, cfg, seed=seed, timeout=TIMEOUT))
            if len(outs) == 1:
                eng.submit(_enc(LOUD_PROMPT), cfg, seed=3, timeout=TIMEOUT)
                outs.append(eng.submit(prompt, cfg, seed=seed, timeout=TIMEOUT))
        finally:
            eng.close()
    assert outs[0] == outs[1] == outs[2] and len(outs[0]) == MAX_NEW
    assert outs[3] != outs[0]


# a longer prompt whose K/V absmax exceeds the pinned prompt's in the blocks
# the pinned request gets after it (checked in the test)
LOUD_PROMPT = "~~~~ }}}} |||| {{{{ zzzz ~~~~ }}}} |||| {{{{ zzzz ~~~~ }}}}"


def _pinned_run(gen, eng, prompt, cfg):
    """The request's tokens, and per layer the K/V codes of the positions
    it wrote and its blocks' scales (in table order), plus each of its
    blocks' largest scale as its prefill found them."""
    seen = {}
    final = gen.paged_prefill_final

    def recording(pool, state, table, *a, **kw):
        ids = torch.as_tensor(np.asarray(table[0]), dtype=torch.long)
        seen["table"] = ids.clone()
        seen["before"] = max(float(pool["layers"][i]["k_scale"][ids].max())
                             for i in pool["layers"])
        return final(pool, state, table, *a, **kw)

    gen.paged_prefill_final = recording
    try:
        tokens = eng.submit(prompt, cfg, timeout=TIMEOUT)
    finally:
        del gen.paged_prefill_final
    ids, n = seen["table"], len(prompt) + MAX_NEW - 1
    L = GEOMETRY["block_len"]
    layers = {}
    for i, entry in eng.pool["layers"].items():
        layers[i] = {name: entry[name][ids].flatten(0, 1)[:n].clone() for name in ("k", "v")}
        layers[i].update({name: entry[name][ids[: -(-n // L)]].clone()
                          for name in ("k_scale", "v_scale")})
    return tokens, layers, seen["before"]


def test_fresh_int8_block_starts_from_scale_zero(generators):
    """A greedy request on a fresh int8 pool, and the same request on a pool
    whose blocks a request with larger activations used and freed: the codes
    and scales of its blocks and its tokens are equal (a freshly allocated
    block's K/V scales are zeroed before its first write)."""
    _, gen = generators
    cfg = GenerationConfig(max_new_tokens=MAX_NEW)
    prompt = _enc("pinned request")
    runs = []
    for loud in (False, True):
        eng = PagedContinuousBatchingEngine(gen, kv_quant="int8", **GEOMETRY)
        try:
            if loud:
                eng.submit(_enc(LOUD_PROMPT), cfg, timeout=TIMEOUT)
            runs.append(_pinned_run(gen, eng, prompt, cfg))
        finally:
            eng.close()
    (fresh, fresh_layers, fresh_before), (used, used_layers, used_before) = runs
    assert fresh_before == 0.0
    # the freed blocks held larger scales than the pinned request's own
    assert used_before > max(float(v["k_scale"].max()) for v in fresh_layers.values())
    assert used == fresh and len(fresh) == MAX_NEW
    for i, want in fresh_layers.items():
        for name, t in want.items():
            assert torch.equal(used_layers[i][name], t), (i, name)


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
