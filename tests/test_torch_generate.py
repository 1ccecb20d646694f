"""The port's dense-cache generation against the JAX package's, on the
``tiny`` preset in f32: the cached forward, the cache buffer's edges, greedy
``generate_ids`` / ``generate_batch`` / ``generate_stream`` / ``chat``, EOS
handling and sampling.

The JAX parameters (``PRNGKey(0)``) are carried across with
``carry.params_from_jax``, their kernels scaled x10: at the 0.02 init the
tied tiny model echoes its last input token, and two echoing generators
would agree whatever their caches did. Tolerances: logits 1e-4 absolute
(f32, sums in another order); tokens identical.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTokenizer
from llm_fine_tune_distributed_tpu.infer import GenerationConfig as JaxGenerationConfig
from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
from llm_fine_tune_distributed_tpu.infer import load_model_dir as jax_load_model_dir
from llm_fine_tune_distributed_tpu.infer import load_tokenizer_dir as jax_load_tokenizer_dir
from llm_fine_tune_distributed_tpu.models import transformer as jax_tf
from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_get_preset
from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer import (
    GenerationConfig,
    Generator,
    load_model_dir,
    load_tokenizer_dir,
)
from llm_fine_tune_distributed_tpu_torch.models import configs
from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax
from llm_fine_tune_distributed_tpu_torch.models.hf_io import save_hf_checkpoint

LOGIT_TOL = 1e-4
GREEDY = dict(max_new_tokens=8, do_sample=False)
PROMPTS = ("the quick brown fox", "hi", "water purification methods in the wild")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """(JAX params, JAX config, port params, port config), kernels x10."""
    jmc = jax_get_preset("tiny")
    jparams = jax_tf.init_params(jax.random.PRNGKey(0), jmc, dtype=jnp.float32)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 10.0 if path[-1].key == "kernel" else x, jparams
    )
    mc = configs.get_preset("tiny")
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jparams)).items()}
    return jparams, jmc, params_from_jax(flat, mc), mc


def _generators(models, eos=()):
    jparams, jmc, params, mc = models
    jgen = JaxGenerator(jparams, jmc, JaxTokenizer(), compute_dtype=jnp.float32,
                        eos_token_ids=list(eos))
    gen = Generator(params, mc, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                    eos_token_ids=list(eos), device="cpu")
    return jgen, gen


@pytest.fixture(scope="module")
def generators(models):
    return _generators(models)


def _enc(text):
    return list(text.encode("utf-8"))


def _np(t):
    return t.detach().cpu().numpy()


def _caches_equal(jcache, cache):
    for i, entry in cache["layers"].items():
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(entry[name]), np.asarray(jcache["layers"][i][name]),
                                       rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar_pos", "batch_pos"])
def test_cached_logits_match_jax_over_six_decode_steps(models, per_row):
    """Prefill a right-padded [2, 10] batch, then 6 one-token steps: with a
    scalar ``cache_pos`` (both rows at the same slot) or a [batch] one (row
    i at ``len_i + t``, ragged lengths 7 and 10)."""
    jparams, jmc, params, mc = models
    rng = np.random.RandomState(0)
    ids = rng.randint(0, mc.vocab_size, (2, 10))
    steps = rng.randint(0, mc.vocab_size, (6, 2, 1))
    lens = np.array([7, 10])
    jcache = jax_tf.init_cache(jmc, 2, 24, dtype=jnp.float32)
    cache = tf.init_cache(mc, 2, 24, dtype=torch.float32)
    jl, jcache = jax_tf.forward(jparams, jnp.asarray(ids), jmc, cache=jcache, cache_pos=0,
                                compute_dtype=jnp.float32)
    tl, _ = tf.forward(params, torch.from_numpy(ids), mc, cache=cache, cache_pos=0,
                       compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0, atol=LOGIT_TOL)
    for t, tok in enumerate(steps):
        pos = lens + t if per_row else 10 + t
        jl, jcache = jax_tf.forward(jparams, jnp.asarray(tok), jmc, cache=jcache,
                                    cache_pos=jnp.asarray(pos), compute_dtype=jnp.float32)
        tpos = torch.from_numpy(pos) if per_row else pos
        tl, _ = tf.forward(params, torch.from_numpy(tok), mc, cache=cache, cache_pos=tpos,
                           compute_dtype=torch.float32)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0, atol=LOGIT_TOL)
    _caches_equal(jcache, cache)


@pytest.mark.parametrize("chunk,cache_pos", [
    (3, 6),  # scalar start clamped to 5 so that the chunk fits
    (3, 8),  # scalar start past the buffer: clamped to 5 as well
    (2, [6, 7]),  # row 1's second slot (8) is dropped
    (2, [9, 3]),  # row 0 writes nothing: both slots dropped
    (3, [7, 0]),  # row 0 keeps slot 7 only
], ids=["clamp", "clamp_past_end", "drop_one", "drop_row", "keep_last"])
def test_writes_at_the_buffer_edge_match_jax(models, chunk, cache_pos):
    """A full 8-slot cache, then a chunk written at its edge: the clamped
    start of ``dynamic_update_slice`` and the dropped slots of the JAX
    scatter leave the same buffers and logits."""
    jparams, jmc, params, mc = models
    rng = np.random.RandomState(1)
    fill = rng.randint(0, mc.vocab_size, (2, 8))
    ids = rng.randint(0, mc.vocab_size, (2, chunk))
    jcache = jax_tf.init_cache(jmc, 2, 8, dtype=jnp.float32)
    cache = tf.init_cache(mc, 2, 8, dtype=torch.float32)
    _, jcache = jax_tf.forward(jparams, jnp.asarray(fill), jmc, cache=jcache, cache_pos=0,
                               compute_dtype=jnp.float32)
    tf.forward(params, torch.from_numpy(fill), mc, cache=cache, cache_pos=0,
               compute_dtype=torch.float32)
    per_row = isinstance(cache_pos, list)
    jpos = jnp.asarray(cache_pos) if per_row else cache_pos
    tpos = torch.tensor(cache_pos) if per_row else cache_pos
    jl, jcache = jax_tf.forward(jparams, jnp.asarray(ids), jmc, cache=jcache, cache_pos=jpos,
                                compute_dtype=jnp.float32)
    tl, _ = tf.forward(params, torch.from_numpy(ids), mc, cache=cache, cache_pos=tpos,
                       compute_dtype=torch.float32)
    _caches_equal(jcache, cache)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0, atol=LOGIT_TOL)


def test_cache_with_padding_mask_is_refused(models):
    _, _, params, mc = models
    cache = tf.init_cache(mc, 1, 8, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="padding_mask with a KV cache"):
        tf.forward(params, torch.zeros(1, 2, dtype=torch.long), mc, cache=cache,
                   padding_mask=torch.ones(1, 8), compute_dtype=torch.float32)


@pytest.mark.parametrize("text", PROMPTS)
def test_greedy_generate_ids_equals_jax(generators, text):
    jgen, gen = generators
    want = jgen.generate_ids(_enc(text), JaxGenerationConfig(**GREEDY))
    got = gen.generate_ids(_enc(text), GenerationConfig(**GREEDY))
    assert got == want and len(got) == GREEDY["max_new_tokens"]
    assert got != [_enc(text)[-1]] * len(got)  # not an echo


def test_ragged_batch_equals_jax_and_solo_runs(generators):
    """Three prompts, one longer than the 256-token bucket (so the batch
    prefills two buckets and the short rows decode far from their pads)."""
    jgen, gen = generators
    prompts = [_enc(PROMPTS[0]), _enc("hi"), _enc("a long question, " * 18)]
    assert len(prompts[2]) > 256
    want = jgen.generate_batch(prompts, JaxGenerationConfig(**GREEDY))
    got = gen.generate_batch(prompts, GenerationConfig(**GREEDY))
    assert got == want
    assert got == [gen.generate_ids(p, GenerationConfig(**GREEDY)) for p in prompts]


def test_eos_stops_and_trims_each_row_as_jax(models, generators):
    """The first token of one prompt is declared EOS: that row comes back
    empty, the other row stops at its own first EOS (if any), and a solo
    run whose first token is EOS is empty, as in the JAX package."""
    _, gen = generators
    cfg = GenerationConfig(max_new_tokens=6, do_sample=False, repetition_penalty=1.0)
    jcfg = JaxGenerationConfig(max_new_tokens=6, do_sample=False, repetition_penalty=1.0)
    p1, p2 = _enc("abc"), _enc(PROMPTS[0])
    eos = gen.generate_ids(p1, cfg)[0]
    jgen_eos, gen_eos = _generators(models, eos=[eos])
    want = jgen_eos.generate_batch([p1, p2], jcfg)
    got = gen_eos.generate_batch([p1, p2], cfg)
    assert got == want and got[0] == []
    assert eos not in got[1]
    assert gen_eos.generate_ids(p1, cfg) == jgen_eos.generate_ids(p1, jcfg) == []


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("case", ["greedy", "sampled", "eos"])
def test_stream_chunks_concatenate_to_generate_ids(models, generators, chunk, case):
    """11 new tokens (a multiple of none of the chunks): the chunks add up to
    ``generate_ids``'s tokens; with an EOS mid-way the stream stops there,
    as the JAX stream does."""
    jgen, gen = generators
    prompt = _enc(PROMPTS[0])
    cfg = GenerationConfig(max_new_tokens=11, do_sample=case == "sampled", temperature=0.8)
    if case == "eos":
        plain = gen.generate_ids(prompt, cfg)
        eos = plain[4]
        jgen, gen = _generators(models, eos=[eos])
    pieces = list(gen.generate_stream(prompt, cfg, seed=3, chunk=chunk))
    assert all(1 <= len(p) <= chunk for p in pieces)
    streamed = [t for p in pieces for t in p]
    assert streamed == gen.generate_ids(prompt, cfg, seed=3)
    if case != "sampled":
        jcfg = JaxGenerationConfig(max_new_tokens=11, do_sample=False)
        want = [t for p in jgen.generate_stream(prompt, jcfg, chunk=chunk) for t in p]
        assert streamed == want
    if case == "eos":
        assert streamed == plain[: plain.index(eos)]


def test_sampled_runs_are_reproducible_in_the_seed(generators):
    _, gen = generators
    cfg = GenerationConfig(max_new_tokens=12, temperature=1.0)
    prompts = [_enc(t) for t in PROMPTS]
    a = gen.generate_batch(prompts, cfg, seed=5)
    assert a == gen.generate_batch(prompts, cfg, seed=5)
    assert a != gen.generate_batch(prompts, cfg, seed=6)
    assert all(0 <= t < gen.config.vocab_size for row in a for t in row)
    assert all(len(row) == 12 for row in a)


def test_speculation_and_draft_models_are_refused(models, generators):
    """``generate_stream`` ignores ``speculative_lookup`` and streams the
    plain greedy tokens, as the JAX stream does; a draft model of another
    vocabulary is refused with the JAX message."""
    jgen, gen = generators
    _, _, params, mc = models
    prompt = _enc(PROMPTS[0])
    streamed = [t for p in gen.generate_stream(
        prompt, GenerationConfig(**GREEDY, speculative_lookup=2), chunk=3) for t in p]
    want = [t for p in jgen.generate_stream(
        prompt, JaxGenerationConfig(**GREEDY, speculative_lookup=2), chunk=3) for t in p]
    assert streamed == want == gen.generate_ids(prompt, GenerationConfig(**GREEDY))
    other = dataclasses.replace(mc, vocab_size=mc.vocab_size + 1)
    with pytest.raises(ValueError, match="speculation verifies token ids"):
        Generator(params, mc, ByteChatMLTokenizer(), device="cpu", draft_params=params,
                  draft_config=other)


def test_chat_through_a_saved_model_dir_equals_jax(models, tmp_path):
    """A model directory written by the port (``save_hf_checkpoint`` +
    ``save_pretrained``) answers the same chat as the JAX Generator
    loading the same directory."""
    _, _, params, mc = models
    save_hf_checkpoint(params, str(tmp_path))
    with open(tmp_path / "config.json", "w") as f:
        json.dump(configs.to_hf_dict(mc), f)
    ByteChatMLTokenizer().save_pretrained(str(tmp_path))
    messages = [{"role": "system", "content": "Be brief."},
                {"role": "user", "content": "How many cups in a gallon?"}]
    jparams, jmc = jax_load_model_dir(str(tmp_path), dtype=jnp.float32)
    jgen = JaxGenerator(jparams, jmc, jax_load_tokenizer_dir(str(tmp_path)),
                        compute_dtype=jnp.float32)
    tparams, tmc = load_model_dir(str(tmp_path), device="cpu", dtype=torch.float32)
    gen = Generator(tparams, tmc, load_tokenizer_dir(str(tmp_path)),
                    compute_dtype=torch.float32, device="cpu")
    want = jgen.chat(messages, JaxGenerationConfig(max_new_tokens=12, do_sample=False))
    got = gen.chat(messages, GenerationConfig(max_new_tokens=12, do_sample=False))
    assert got == want and got
