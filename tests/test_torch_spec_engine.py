"""Speculation in the port's continuous engines (the fused draft-verify tick
of ``ContinuousBatchingEngine`` and ``PagedContinuousBatchingEngine`` with
``speculative_k``) against the JAX engines and the port's own solo decode,
on the ``tiny`` preset in f32 at the JAX speculative tests' geometry (slots
4, buf_len 96, prompt_bucket 16, K 4), with ``block_len`` 4 so that a
tick's K+1 positions cross block boundaries.

The kernels are scaled x3, as in ``test_torch_speculative.py``: at x10 the
tiny model's greedy text almost never repeats a bigram, so prompt lookup
would never be accepted; at x3 it loops and does not echo the prompt.

Greedy tokens, per-request draft counts and the int8 pool's codes must
equal the JAX engines'. ``stats_snapshot()``'s ``mean_tokens_per_step``
depends on how concurrent requests interleave, so it is compared over
requests served one after another.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
    _prompt_lookup,
)
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset

SCALE = 3.0
K = 4
GEOMETRY = dict(slots=4, buf_len=96, prompt_bucket=16, speculative_k=K)
PAGED = dict(block_len=4, prefill_chunk=32)
KINDS = ("continuous", "paged", "int8")
MAX_NEW = 20
SPEC = GenerationConfig(max_new_tokens=MAX_NEW, do_sample=False, speculative_lookup=K)
GREEDY = GenerationConfig(max_new_tokens=MAX_NEW, do_sample=False)
TIMEOUT = 240
# stats_snapshot() entries that must equal the JAX engine's
COUNTS = ("draft_tokens_proposed", "draft_tokens_accepted", "draft_acceptance_rate",
          "mean_tokens_per_step")


def _enc(text):
    return list(text.encode("utf-8"))


PROMPTS = [_enc("alpha"), _enc("beta bravo"), _enc("the"), _enc("noise maker")]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_get_preset
    from llm_fine_tune_distributed_tpu.models.transformer import init_params

    jmc = jax_get_preset("tiny")
    jparams = init_params(jax.random.PRNGKey(0), jmc, dtype=jnp.float32)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: x * SCALE if path[-1].key == "kernel" else x, jparams
    )
    mc = get_preset("tiny")
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jparams)).items()}
    return jparams, jmc, params_from_jax(flat, mc), mc


def _port(weights, draft=False, eos=()):
    _, _, params, mc = weights
    kw = dict(draft_params=params, draft_config=mc) if draft else {}
    return Generator(params, mc, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                     eos_token_ids=list(eos), device="cpu", **kw)


def _jax(weights, draft=False):
    from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer as JaxTok
    from llm_fine_tune_distributed_tpu.infer import Generator as JaxGenerator

    jparams, jmc, _, _ = weights
    kw = dict(draft_params=jparams, draft_config=jmc) if draft else {}
    return JaxGenerator(jparams, jmc, JaxTok(), compute_dtype=jnp.float32, eos_token_ids=[], **kw)


@pytest.fixture(scope="module")
def gen(weights):
    return _port(weights)


@pytest.fixture(scope="module")
def solo(gen):
    """Each prompt's solo plain greedy tokens."""
    return [gen.generate_ids(p, GREEDY) for p in PROMPTS]


def _engine(generator, kind, **kw):
    if kind == "continuous":
        return ContinuousBatchingEngine(generator, **{**GEOMETRY, **kw})
    return PagedContinuousBatchingEngine(generator, kv_quant="int8" if kind == "int8" else "none",
                                         **{**GEOMETRY, **PAGED, **kw})


def _jax_engine(generator, kind):
    from llm_fine_tune_distributed_tpu.infer.engine import (
        ContinuousBatchingEngine as JaxContinuous,
        PagedContinuousBatchingEngine as JaxPaged,
    )

    if kind == "continuous":
        return JaxContinuous(generator, **GEOMETRY)
    return JaxPaged(generator, kv_quant="int8" if kind == "int8" else "none",
                    **{**GEOMETRY, **PAGED})


def _concurrent(fns):
    out = [None] * len(fns)

    def run(i):
        out[i] = fns[i]()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    return out


def _cfgs(cls):
    """Requests 0-2 speculate, request 3 does not."""
    return [cls(max_new_tokens=MAX_NEW, do_sample=False, speculative_lookup=K if i < 3 else 0)
            for i in range(len(PROMPTS))]


def _served_one_by_one(engine, cls, between=None):
    out = []
    for p, c in zip(PROMPTS, _cfgs(cls)):
        if between is not None:
            between(engine)
        out.append(engine.submit_full(p, c, timeout=TIMEOUT))
    return out


def _fresh_free_blocks(jax_engine):
    """Zero the int8 K/V scales of the JAX engine's free blocks (between
    requests, when its worker is idle): the port's rule, under which a block
    a request is given starts from scale zero, where the JAX engine hands it
    out with its last owner's."""
    if jax_engine._cache is None:
        return  # no pool yet: the first request's is new
    free = np.asarray(jax_engine._allocator._free, np.int32)
    if free.size:
        jax_engine._cache = {"layers": {i: {**e, **{n: e[n].at[free].set(0.0)
                                                  for n in ("k_scale", "v_scale")}}
                                        for i, e in jax_engine._cache["layers"].items()}}


def _counts(reqs):
    return [(r.draft_tokens_proposed, r.draft_tokens_accepted, r.spec_acceptance) for r in reqs]


@pytest.fixture(scope="module", params=[("continuous", False), ("paged", False), ("int8", False),
                                         ("continuous", True)],
                ids=["continuous-lookup", "paged-lookup", "int8-lookup", "continuous-self_draft"])
def jax_run(request, weights):
    """The JAX engine's run of the four requests, one after another: the
    records, the stats and (int8) its pool, each request's fresh blocks
    starting from scale zero as in the port (``_fresh_free_blocks``)."""
    from llm_fine_tune_distributed_tpu.infer import GenerationConfig as JaxGenerationConfig

    kind, draft = request.param
    engine = _jax_engine(_jax(weights, draft), kind)
    reqs = _served_one_by_one(engine, JaxGenerationConfig,
                              _fresh_free_blocks if kind == "int8" else None)
    snap = engine.stats_snapshot()
    pool = jax.device_get(engine._cache) if kind == "int8" else None
    return kind, draft, reqs, snap, pool


def test_tokens_counts_and_stats_equal_the_jax_engines(jax_run, weights, solo):
    """Spec and non-spec requests: the tokens equal the JAX engine's and
    the solo plain ones; per-request draft counts, acceptance and the
    engine's draft counters and ``mean_tokens_per_step`` equal JAX's; over
    an int8 pool the codes equal JAX's (scales within 1e-6 relative: the
    projections are f32 sums in another order)."""
    kind, draft, jreqs, jsnap, jpool = jax_run
    engine = _engine(_port(weights, draft), kind)
    try:
        reqs = _served_one_by_one(engine, GenerationConfig)
        snap = engine.stats_snapshot()
    finally:
        engine.close()
    assert [r.result for r in reqs] == [r.result for r in jreqs] == solo
    assert any(out[:3] != [p[-1]] * 3 for p, out in zip(PROMPTS, solo))  # no echo
    assert _counts(reqs) == _counts(jreqs)
    assert {k: snap[k] for k in COUNTS} == {k: jsnap[k] for k in COUNTS}
    assert snap["draft_tokens_accepted"] > 0 and reqs[3].draft_tokens_proposed == 0
    if draft:
        assert snap["draft_acceptance_rate"] == 1.0
    if jpool is not None:
        for i, entry in engine.pool["layers"].items():
            for name in ("k", "v"):
                np.testing.assert_array_equal(entry[name].numpy(),
                                              np.asarray(jpool["layers"][i][name]))
                np.testing.assert_allclose(entry[name + "_scale"].numpy(),
                                           np.asarray(jpool["layers"][i][name + "_scale"]),
                                           rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_greedy_spec_bit_identical_with_mixed_neighbours(gen, solo, kind):
    """Greedy speculative requests beside a live sampled request and a
    live non-speculative greedy one give the solo tokens (JAX
    ``test_greedy_spec_bit_identical_with_mixed_neighbors``)."""
    engine = _engine(gen, kind)
    try:
        sampled = GenerationConfig(max_new_tokens=48, temperature=1.0)
        occupier = threading.Thread(
            target=lambda: engine.submit(PROMPTS[0], sampled, seed=11, timeout=TIMEOUT))
        occupier.start()
        time.sleep(0.05)  # the sampled request takes its slot first
        fns = [lambda p=p: engine.submit(p, SPEC, timeout=TIMEOUT) for p in PROMPTS[:3]]
        fns.append(lambda: engine.submit(PROMPTS[3], GREEDY, timeout=TIMEOUT))
        got = _concurrent(fns)
        occupier.join(TIMEOUT)
    finally:
        engine.close()
    assert got == solo


@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_sampled_spec_deterministic_in_request_seed(gen, kind):
    """A sampled speculative stream depends on (request, seed) only: each
    live sampled slot draws a fixed amount per tick, whoever shares it."""
    cfg = GenerationConfig(max_new_tokens=10, temperature=1.0, speculative_lookup=K)
    engine = _engine(gen, kind)
    try:
        alone = engine.submit(PROMPTS[0], cfg, seed=7, timeout=TIMEOUT)
        same, other, _ = _concurrent([
            lambda: engine.submit(PROMPTS[0], cfg, seed=7, timeout=TIMEOUT),
            lambda: engine.submit(PROMPTS[0], cfg, seed=8, timeout=TIMEOUT),
            lambda: engine.submit(PROMPTS[1], cfg, seed=9, timeout=TIMEOUT),
        ])
    finally:
        engine.close()
    assert same == alone and other != alone


@pytest.mark.parametrize("kind", KINDS)
def test_eos_inside_accepted_run_stops_exactly(weights, kind):
    """An EOS verified inside a tick's accepted run ends the request at the
    EOS: no token after it leaks out. The target drafts for itself, so every
    tick accepts all K drafts, and the EOS is a token that first appears
    in the middle of a tick's run."""
    out = _port(weights, draft=True).generate_ids(PROMPTS[0], SPEC)
    i = next(i for i in range(2, MAX_NEW) if i % (K + 1) not in (0, 1) and out[i] not in out[:i])
    gen_eos = _port(weights, draft=True, eos=[out[i]])
    assert gen_eos.generate_ids(PROMPTS[0], SPEC) == out[:i]
    engine = _engine(gen_eos, kind)
    try:
        req = engine.submit_full(PROMPTS[0], SPEC, timeout=TIMEOUT)
    finally:
        engine.close()
    assert req.result == out[:i] and req.draft_tokens_accepted > 0


def test_paged_variable_acceptance_across_block_boundaries(gen):
    """40 tokens at block_len 4 over a bf16-layout pool: the verify writes
    cross many block boundaries with per-slot acceptance varying; the
    blocks in use return to the prefix cache's alone after the requests."""
    cfg = GenerationConfig(max_new_tokens=40, do_sample=False, speculative_lookup=K)
    want = [gen.generate_ids(p, cfg) for p in PROMPTS[:2]]
    engine = _engine(gen, "paged")
    try:
        reqs = _concurrent([lambda p=p: engine.submit_full(p, cfg, timeout=TIMEOUT)
                            for p in PROMPTS[:2]])
        snap = engine.stats_snapshot()
    finally:
        engine.close()
    assert [r.result for r in reqs] == want
    assert all(0 < r.draft_tokens_accepted < r.draft_tokens_proposed for r in reqs)
    assert snap["blocks_in_use"] == snap["prefix_cache_blocks"]


@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_per_request_telemetry_and_stats(gen, kind):
    """A speculative and a plain request together: each reports its own
    draft counts (the plain one none), and the stats hold the totals."""
    engine = _engine(gen, kind)
    try:
        spec, plain = _concurrent([
            lambda: engine.submit_full(PROMPTS[0], SPEC, timeout=TIMEOUT),
            lambda: engine.submit_full(PROMPTS[2], GREEDY, timeout=TIMEOUT),
        ])
        snap = engine.stats_snapshot()
        runs = engine.stats.hist["spec_run_len"]
    finally:
        engine.close()
    assert 0 < spec.draft_tokens_accepted <= spec.draft_tokens_proposed
    assert spec.spec_acceptance == spec.draft_tokens_accepted / spec.draft_tokens_proposed
    assert plain.draft_tokens_proposed == 0 and plain.spec_acceptance is None
    assert snap["draft_tokens_proposed"] == spec.draft_tokens_proposed
    assert snap["draft_tokens_accepted"] == spec.draft_tokens_accepted
    assert runs.sum == spec.draft_tokens_accepted and runs.total > 0  # one per drafting tick
    assert snap["mean_tokens_per_step"] > 1.0


@pytest.mark.parametrize("kind", KINDS)
def test_draft_model_self_draft_accepts_everything(weights, solo, kind):
    """The target as its own draft: every proposal is accepted and the
    tokens stay the solo ones. The engine's K is 4, the request asks 3."""
    engine = _engine(_port(weights, draft=True), kind)
    cfg = GenerationConfig(max_new_tokens=MAX_NEW, do_sample=False, speculative_lookup=3)
    try:
        req = engine.submit_full(PROMPTS[2], cfg, timeout=TIMEOUT)
    finally:
        engine.close()
    assert req.result == solo[2]
    assert req.draft_tokens_proposed > 0 and req.spec_acceptance == 1.0
    assert req.draft_tokens_accepted == req.draft_tokens_proposed


def test_stream_rides_speculative_batch(gen, solo):
    engine = _engine(gen, "continuous")
    try:
        got = list(engine.stream(PROMPTS[0], SPEC, timeout=TIMEOUT))
    finally:
        engine.close()
    assert got == solo[0]


def test_non_spec_engine_rejects_nothing_and_stays_plain(gen, solo):
    """A request asking for speculation on an engine without it decodes
    plainly: no drafts, no acceptance."""
    engine = ContinuousBatchingEngine(gen, slots=2, buf_len=96, prompt_bucket=16)
    try:
        req = engine.submit_full(PROMPTS[0], SPEC, timeout=TIMEOUT)
    finally:
        engine.close()
    assert req.result == solo[0]
    assert req.draft_tokens_proposed == 0 and req.spec_acceptance is None


def test_prompt_lookup_host_helper():
    """The JAX test's cases."""
    ctx = np.asarray([5, 6, 7, 8, 5, 6])
    assert _prompt_lookup(ctx, 3).tolist() == [7, 8, 5]
    assert _prompt_lookup(ctx, 8).tolist() == [7, 8, 5, 6]
    assert _prompt_lookup(np.asarray([1, 2, 3]), 4).size == 0
    assert _prompt_lookup(np.asarray([1, 2]), 4).size == 0


# ------------------------------------------------------------ host syncs

_READS = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")


@pytest.fixture
def host_reads(monkeypatch):
    """Every tensor method that reads values back to the host, counted:
    [(method, the tensor came out of ``.cpu()``)]."""
    calls = []
    from_cpu = set()
    for name in _READS:
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _name=name, _orig=orig, **kw):
            calls.append((_name, id(self) in from_cpu))
            out = _orig(self, *a, **kw)
            if _name == "cpu":
                from_cpu.add(id(out))
            return out

        monkeypatch.setattr(torch.Tensor, name, counted)
    return calls


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "mixed"])
def test_a_spec_tick_reads_the_host_once(gen, host_reads, kind, sampled):
    """One ``spec_slot_step`` / ``spec_paged_step`` over two live slots
    (one of them sampled in the mixed case), with drafts: the only read
    back is the one transfer of ``toks`` and ``n_emit`` (``.cpu()``, then
    ``.numpy()`` of that host copy)."""
    slots, L = 4, 4
    prompts = [PROMPTS[0], PROMPTS[1]]
    cfgs = [GenerationConfig(max_new_tokens=8, do_sample=False, speculative_lookup=K),
            GenerationConfig(max_new_tokens=8, do_sample=sampled, temperature=1.0,
                             speculative_lookup=K)]
    if kind == "dense":
        cache, state = gen.init_slot_state(slots, 64)
    else:
        cache, state = gen.init_paged_state(slots, 1 + slots * 8, L)
        tables = np.zeros((slots, 8), np.int32)
    for slot, (p, c) in enumerate(zip(prompts, cfgs)):
        padded = np.zeros((1, 16), np.int64)
        padded[0, : len(p)] = p
        if kind == "dense":
            gen.slot_prefill(cache, state, padded, len(p), slot, c, seed=slot)
        else:
            tables[slot] = np.arange(1 + 8 * slot, 9 + 8 * slot)
            seen = np.zeros((1, gen.config.vocab_size), bool)
            seen[0, p] = True
            gen.paged_prefill_final(cache, state, tables[slot: slot + 1], padded, 0, len(p),
                                    seen, slot, c, seed=slot)
    live = np.arange(slots) < 2
    drafts = np.array([[1, 2, 3, 4]] * slots, np.int64)
    n_draft = np.array([K, 2, 0, 0], np.int64)
    host_reads.clear()
    if kind == "dense":
        toks, n_emit = gen.spec_slot_step(cache, state, live, drafts, n_draft)
    else:
        toks, n_emit = gen.spec_paged_step(cache, state, live, tables, drafts, n_draft)
    assert host_reads == [("cpu", False), ("numpy", True)]
    assert toks.shape == (slots, K + 1) and list(n_emit[2:]) == [0, 0]
    assert all(1 <= n <= K + 1 for n in n_emit[:2])
