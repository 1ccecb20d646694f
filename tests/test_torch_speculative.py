"""Speculative decoding in the port against the JAX package, on the
``tiny`` preset in f32: prompt lookup, the rejection-sampling verify steps
and ``Generator.generate_batch`` with ``speculative_lookup`` (prompt lookup
and draft models).

The verify steps get the JAX package's own draws, computed in the test from
its keys: ``jax.random.categorical`` is ``argmax(logits + gumbel(key))``, so
the uniform and the Gumbel noise are handed to the port. Tokens and accept
bits must be identical.

The Generator tests carry the JAX parameters (``PRNGKey(0)``) across with
``carry.params_from_jax``, their kernels scaled x3: at the 0.02 init the
tied tiny model echoes its last input token, and at x10 (the other
generation tests' scale) its greedy text almost never repeats a bigram in 24
tokens, so prompt lookup would never be accepted. At x3 it runs in loops
that lookup catches; each test checks that the tokens are no echo. Greedy
tokens, ``last_spec_steps`` and the per-row draft counts must equal the JAX
Generator's exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTokenizer
from llm_fine_tune_distributed_tpu.infer import GenerationConfig as JaxGenerationConfig
from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator
from llm_fine_tune_distributed_tpu.infer import sampling as jax_sampling
from llm_fine_tune_distributed_tpu.models import transformer as jax_tf
from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_get_preset
from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer import GenerationConfig, Generator, sampling
from llm_fine_tune_distributed_tpu_torch.models import configs
from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax

SCALE = 3.0
VOCAB = 512
MAX_NEW = 16


def _enc(text):
    return list(text.encode("utf-8"))


# ragged, one of them far from the others' length; at x3 all loop
PROMPTS = [_enc("alpha"), _enc("beta bravo"), _enc("the"), _enc("noise maker, " * 3)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _models(seed):
    jmc = jax_get_preset("tiny")
    jparams = jax_tf.init_params(jax.random.PRNGKey(seed), jmc, dtype=jnp.float32)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: x * SCALE if path[-1].key == "kernel" else x, jparams
    )
    mc = configs.get_preset("tiny")
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jparams)).items()}
    return jparams, jmc, params_from_jax(flat, mc), mc


@pytest.fixture(scope="module")
def models():
    """The target (seed 0) and a second tiny model (seed 9, the same
    vocabulary) for a draft that disagrees with it."""
    return _models(0), _models(9)


def _generators(models, draft, eos=()):
    (jparams, jmc, params, mc), (jother, _, other, _) = models
    jkw, kw = {}, {}
    if draft == "self":
        jkw, kw = dict(draft_params=jparams, draft_config=jmc), dict(draft_params=params,
                                                                     draft_config=mc)
    elif draft == "other":
        jkw, kw = dict(draft_params=jother, draft_config=jmc), dict(draft_params=other,
                                                                    draft_config=mc)
    jgen = JaxGenerator(jparams, jmc, JaxTokenizer(), compute_dtype=jnp.float32,
                        eos_token_ids=list(eos), **jkw)
    gen = Generator(params, mc, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                    eos_token_ids=list(eos), device="cpu", **kw)
    return jgen, gen


@pytest.fixture(scope="module")
def plain(models):
    """The port's Generator without a draft, and its plain greedy tokens."""
    _, gen = _generators(models, "lookup")
    cfg = GenerationConfig(max_new_tokens=MAX_NEW, do_sample=False)
    return gen, [gen.generate_ids(p, cfg) for p in PROMPTS]


# ----------------------------------------------------------------- lookup


def _lookup_cases():
    rng = np.random.default_rng(0)
    return {
        "random": rng.integers(0, 6, 40),
        "periodic": np.array([5, 6, 7] * 7 + [5, 6]),
        "short_2": np.array([1, 2]),
        "short_1": np.array([4]),
        "no_match": np.arange(12),
        "flush_against_the_end": np.array([5, 6, 7, 8, 5, 6]),
    }


@pytest.mark.parametrize("case", list(_lookup_cases()))
def test_prompt_lookup_equals_jax(case):
    from llm_fine_tune_distributed_tpu.infer.engine import _prompt_lookup as jax_lookup
    from llm_fine_tune_distributed_tpu_torch.infer.engine import _prompt_lookup

    ctx = _lookup_cases()[case]
    for k in range(1, 7):
        want = jax_lookup(ctx.astype(np.int32), k)
        got = _prompt_lookup(ctx.astype(np.int64), k)
        assert got.tolist() == want.tolist(), (case, k)
    if case in ("short_2", "short_1", "no_match"):
        assert _prompt_lookup(ctx, 4).size == 0


# ------------------------------------------------------------ verify steps


@pytest.mark.parametrize("bonus", [False, True], ids=["draft", "bonus"])
@pytest.mark.parametrize("knobs", [
    dict(),
    dict(temperature=1.0, top_k=None, top_p=0.9),
    dict(temperature=0.3, top_k=5, top_p=1.0, repetition_penalty=1.0),
    dict(temperature=1e-4),  # q a point mass
], ids=["defaults", "top_p", "top_k", "point_mass"])
def test_rejection_sample_step_matches_jax_under_its_noise(knobs, bonus):
    """Drafts in the support (its first, second and last entries) and out
    of it (q = 0, always rejected), over 12 keys."""
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(6, VOCAB)) * 4).astype(np.float32)
    seen = rng.random(size=(6, VOCAB)) < 0.1
    jcfg, cfg = JaxGenerationConfig(**knobs), GenerationConfig(**knobs)
    jvals, jidx = jax_sampling._warp(jnp.asarray(logits), jnp.asarray(seen), jcfg)
    jidx = np.asarray(jidx)
    accepted = 0
    for seed in range(12):
        draft = jidx[np.arange(6), [0, 1, -1, 0, 1, 0]].astype(np.int32)
        if knobs.get("top_k", 40):
            draft[3] = np.setdiff1d(np.arange(VOCAB), jidx[3])[seed]  # outside the support
        key = jax.random.PRNGKey(seed)
        want_tok, want_acc = jax_sampling.rejection_sample_step(
            key, jnp.asarray(logits), jnp.asarray(seen), jnp.asarray(draft), jcfg, bonus=bonus)
        key_u, key_c = jax.random.split(key)
        u = np.array(jax.random.uniform(key_u, (6,)))
        gumbel = np.array(jax.random.gumbel(key_c, jvals.shape, jnp.float32))
        tok, acc = sampling.rejection_sample_step(
            torch.from_numpy(logits), torch.from_numpy(seen), torch.from_numpy(draft), cfg,
            bonus=bonus, u=torch.from_numpy(u), gumbel=torch.from_numpy(gumbel))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
        np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
        accepted += int(acc.sum())
        if knobs.get("top_k", 40):
            assert not acc[3]
    assert (accepted == 0) if bonus else (accepted > 0)


def test_rejection_sample_step_traced_matches_jax_under_its_noise():
    """Per-row knobs: greedy rows (one with the draft equal to its argmax),
    sampled rows with top-k, top-p, a point mass and no warp; drafts in and
    out of the support, some rows on their bonus position; 24 keys."""
    rng = np.random.default_rng(1)
    b = 8
    logits = (rng.normal(size=(b, VOCAB)) * 4).astype(np.float32)
    seen = rng.random(size=(b, VOCAB)) < 0.1
    knobs = {
        "temperature": np.array([0.6, 1.0, 0.3, 1e-4, 0.8, 1.0, 0.6, 1.0], np.float32),
        "top_p": np.array([0.95, 0.9, 1.0, 0.95, 0.5, 1.0, 0.95, 1.0], np.float32),
        "top_k": np.array([40, VOCAB, 5, 40, 1, VOCAB, 40, 3], np.int32),
        "repetition_penalty": np.array([1.1, 1.0, 1.0, 1.1, 1.2, 1.0, 1.1, 1.0], np.float32),
        "do_sample": np.array([True, True, True, True, True, False, False, True]),
    }
    pen = knobs["repetition_penalty"][:, None]
    penalized = np.where(seen, np.where(logits > 0, logits / pen, logits * pen), logits)
    top = np.argsort(-penalized, axis=-1, kind="stable")
    accepted = {"greedy": 0, "sampled": 0}
    for seed in range(24):
        r = np.random.default_rng(100 + seed)
        bonus = r.random(b) < 0.25
        draft = top[np.arange(b), r.integers(0, 3, b)].astype(np.int32)
        draft[6] = top[6, 0]  # a greedy row whose draft is its argmax
        draft[7] = top[7, 10]  # outside top_k = 3
        keys = jax.random.split(jax.random.PRNGKey(seed), b)
        jkw = {k: jnp.asarray(v) for k, v in knobs.items()}
        want_tok, want_acc = jax_sampling.rejection_sample_step_traced(
            keys, jnp.asarray(logits), jnp.asarray(seen), jnp.asarray(draft),
            bonus=jnp.asarray(bonus), **jkw)
        split = jax.vmap(jax.random.split)(keys)
        u = np.array(jax.vmap(lambda k: jax.random.uniform(k, ()))(split[:, 0]))
        gumbel = np.array(jax.vmap(lambda k: jax.random.gumbel(k, (VOCAB,)))(split[:, 1]))
        tkw = {k: torch.from_numpy(v) for k, v in knobs.items()}
        tok, acc = sampling.rejection_sample_step_traced(
            torch.from_numpy(logits), torch.from_numpy(seen), torch.from_numpy(draft),
            bonus=torch.from_numpy(bonus), u=torch.from_numpy(u),
            gumbel=torch.from_numpy(gumbel), **tkw)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
        np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
        assert not acc[7]
        accepted["greedy"] += int(acc[5:7].sum())
        accepted["sampled"] += int(acc[:5].sum())
        greedy, greedy_acc, _ = sampling.greedy_verify(
            torch.from_numpy(logits), torch.from_numpy(seen), torch.from_numpy(draft),
            torch.from_numpy(knobs["repetition_penalty"]), torch.from_numpy(bonus))
        # the greedy rows of the traced step are greedy_verify's, bitwise
        np.testing.assert_array_equal(greedy.numpy()[5:7], tok.numpy()[5:7])
        np.testing.assert_array_equal(greedy_acc.numpy()[5:7], acc.numpy()[5:7])
    assert accepted["greedy"] > 0 and accepted["sampled"] > 0


def test_traced_step_draws_from_each_sampled_rows_generator():
    """Without injected noise a sampled row draws one uniform then one
    noise row from its own generator; a greedy row (no generator) draws
    nothing and returns its argmax."""
    rng = np.random.default_rng(2)
    logits = torch.from_numpy((rng.normal(size=(2, VOCAB)) * 4).astype(np.float32))
    seen = torch.zeros(2, VOCAB, dtype=torch.bool)
    draft = torch.tensor([3, 4])
    kw = dict(temperature=torch.tensor([1.0, 1.0]), top_p=torch.tensor([1.0, 1.0]),
              top_k=torch.tensor([VOCAB, VOCAB]), repetition_penalty=torch.tensor([1.0, 1.0]),
              do_sample=torch.tensor([True, False]), bonus=torch.tensor([False, False]))
    g = torch.Generator().manual_seed(5)
    tok, _ = sampling.rejection_sample_step_traced(logits, seen, draft, generators=[g, None], **kw)
    g2 = torch.Generator().manual_seed(5)
    u = torch.zeros(2)
    gumbel = torch.zeros(2, VOCAB)
    u[0] = sampling.uniform_noise((), g2, "cpu")
    gumbel[0] = sampling.gumbel_noise((VOCAB,), g2, "cpu")
    want, _ = sampling.rejection_sample_step_traced(logits, seen, draft, u=u, gumbel=gumbel, **kw)
    assert tok.tolist() == want.tolist()
    assert tok[1] == int(torch.argmax(logits[1]))


# ------------------------------------------------------------- generate_batch


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("draft", ["lookup", "self", "other"])
def test_greedy_speculative_batch_equals_jax_and_plain(models, plain, draft, k):
    """A ragged batch, with one token of row 0's loop declared EOS so that
    it falls inside an accepted run: the tokens equal the JAX Generator's and
    the port's plain ones, and so do ``last_spec_steps`` and the per-row
    draft counts."""
    _, plain_out = plain
    eos = plain_out[0][MAX_NEW // 2]
    jgen, gen = _generators(models, draft, eos=[eos])
    cfg = dict(max_new_tokens=MAX_NEW, do_sample=False)
    want = jgen.generate_batch(PROMPTS, JaxGenerationConfig(**cfg, speculative_lookup=k))
    got = gen.generate_batch(PROMPTS, GenerationConfig(**cfg, speculative_lookup=k))
    assert got == want
    assert got == [p[: p.index(eos)] if eos in p else p for p in plain_out]
    assert len(got[0]) < MAX_NEW  # the EOS stopped row 0
    assert any(out[:3] != [p[-1]] * 3 for p, out in zip(PROMPTS, plain_out))  # no echo
    assert gen.last_spec_steps == jgen.last_spec_steps
    np.testing.assert_array_equal(gen.last_row_draft_proposed, jgen.last_row_draft_proposed)
    np.testing.assert_array_equal(gen.last_row_draft_accepted, jgen.last_row_draft_accepted)
    assert gen.last_acceptance_rate == pytest.approx(jgen.last_acceptance_rate, abs=0)
    if draft != "other":
        assert gen.last_acceptance_rate > 0  # the drafts really were accepted
    if draft == "self":
        assert gen.last_row_draft_accepted.sum() >= gen.last_row_draft_proposed.sum() // 2
    # the plain path leaves no speculation telemetry behind
    gen.generate_batch(PROMPTS[:1], GenerationConfig(**cfg))
    assert gen.last_spec_steps is None and gen.last_row_draft_proposed is None


def test_live_rows_bound_the_telemetry(plain):
    """The window batcher's pads (rows past ``live_rows``) are not counted."""
    gen, _ = plain
    cfg = GenerationConfig(max_new_tokens=MAX_NEW, do_sample=False, speculative_lookup=3)
    gen.generate_batch(PROMPTS[:2] + [PROMPTS[0]] * 2, cfg, live_rows=2)
    assert gen.last_row_draft_proposed.shape == (2,)
    rows = gen.last_row_draft_accepted
    gen.generate_batch(PROMPTS[:2], cfg)
    np.testing.assert_array_equal(rows, gen.last_row_draft_accepted)


def test_self_draft_accepts_everything(models, plain):
    """The target as its own draft: every proposal is the greedy choice.
    11 tokens = the prefill's + 2 steps of 1 + 4, so no draft is cut by the
    budget and the rate is exactly 1, in 3 sequential forwards."""
    _, plain_out = plain
    _, gen = _generators(models, "self")
    cfg = GenerationConfig(max_new_tokens=11, do_sample=False, speculative_lookup=4)
    assert gen.generate_ids(PROMPTS[2], cfg) == plain_out[2][:11]
    assert gen.last_acceptance_rate == 1.0 and gen.last_spec_steps == 3


def test_draft_models_are_validated_as_jax(models):
    (_, _, params, mc), _ = models
    with pytest.raises(ValueError, match="come together"):
        Generator(params, mc, ByteChatMLTokenizer(), device="cpu", draft_params=params)
    with pytest.raises(ValueError, match="come together"):
        Generator(params, mc, ByteChatMLTokenizer(), device="cpu", draft_config=mc)
    other = dataclasses.replace(mc, vocab_size=mc.vocab_size * 2)
    with pytest.raises(ValueError, match=f"draft vocab {2 * mc.vocab_size} != target vocab"):
        Generator(params, mc, ByteChatMLTokenizer(), device="cpu", draft_params=params,
                  draft_config=other)
    gen = Generator(params, mc, ByteChatMLTokenizer(), device="cpu", draft_params=params,
                    draft_config=mc)
    assert gen.has_draft and gen.draft_params is gen.params  # one copy of a self-draft


# --------------------------------------------------------------- sampled


@pytest.mark.parametrize("draft", ["lookup", "other"])
def test_sampled_speculation_is_deterministic_in_the_seed(models, draft):
    _, gen = _generators(models, draft)
    cfg = GenerationConfig(max_new_tokens=10, temperature=1.0, speculative_lookup=3)
    a = gen.generate_batch(PROMPTS, cfg, seed=5)
    assert a == gen.generate_batch(PROMPTS, cfg, seed=5)
    assert a != gen.generate_batch(PROMPTS, cfg, seed=6)
    assert all(0 <= t < VOCAB for row in a for t in row)


def test_sampled_speculation_near_greedy_temperature_is_greedy(plain):
    """At temperature 1e-4 the warped distribution is a point mass: the
    accept probability of the greedy token is 1, and sampled speculation
    gives the greedy tokens for any seed."""
    gen, plain_out = plain
    base = dict(max_new_tokens=MAX_NEW, do_sample=True, temperature=1e-4)
    for seed in range(3):
        got = gen.generate_batch(PROMPTS, GenerationConfig(**base, speculative_lookup=3),
                                 seed=seed)
        assert got == plain_out
        assert gen.last_acceptance_rate > 0
        assert got == gen.generate_batch(PROMPTS, GenerationConfig(**base), seed=seed)


def test_sampled_speculation_matches_the_plain_distribution(models):
    """200 samples of one prompt in one batch each: plain (seeds 0 and 1)
    and speculative (seed 0) with the target as its own draft, whose
    proposals, the greedy tokens, are accepted with probability q(d) (at
    temperature 1 the sampled text does not loop, so prompt lookup would
    propose nothing). Position 0 precedes speculation and draws the same
    noise, so it is identical; at positions 1-2 the total variation
    distance from plain sampling stays within twice the plain-vs-plain
    distance plus 0.05 (the JAX test's bound)."""
    _, gen = _generators(models, "self")
    n, n_pos = 200, 3
    prompt = _enc("ab ab ab ab")
    base = dict(max_new_tokens=n_pos, do_sample=True, temperature=1.0, top_k=20, top_p=0.95)
    plain_a = gen.generate_batch([prompt] * n, GenerationConfig(**base), seed=0)
    plain_b = gen.generate_batch([prompt] * n, GenerationConfig(**base), seed=1)
    spec = gen.generate_batch([prompt] * n, GenerationConfig(**base, speculative_lookup=2), seed=0)
    assert gen.last_acceptance_rate > 0, "no draft accepted: the test has no power"

    def tv(x, y, j):
        support = {r[j] for r in x} | {r[j] for r in y}
        return 0.5 * sum(abs(sum(r[j] == t for r in x) - sum(r[j] == t for r in y)) / n
                         for t in support)

    assert [r[0] for r in spec] == [r[0] for r in plain_a]
    for j in range(1, n_pos):
        null, got = tv(plain_a, plain_b, j), tv(plain_a, spec, j)
        assert got < 2.0 * null + 0.05, (j, got, null)
