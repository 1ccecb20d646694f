"""Weight-only int8 inference in the port against the JAX package's, on the
``tiny`` preset in f32: ``quantize_params_int8``'s leaves, ``int8_matmul`` on
row-major and K-major codes, the forward and greedy generation over int8
weights, the paged engine over int8 weights (and an int8 KV pool), the
frozen trunk's w8a8 routing, and the errors; ``maybe_quantize(params,
"nf4")`` against the JAX ``quantize_params_nf4``, leaf for leaf, and the
forward and greedy tokens over NF4 weights.

Tolerances: codes and scales bitwise; ``int8_matmul`` 1e-6 of the largest
|output| (f32 products summed in another order); logits 1e-4 absolute;
tokens identical. The kernels are scaled x10 (see tests/test_torch_generate.py).
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
from llm_fine_tune_distributed_tpu.infer.engine import (
    PagedContinuousBatchingEngine as JaxPagedEngine,
)
from llm_fine_tune_distributed_tpu.models import transformer as jax_tf
from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_get_preset
from llm_fine_tune_distributed_tpu.ops import int8 as jax_int8
from llm_fine_tune_distributed_tpu.utils.tree import flatten_dict
from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer import GenerationConfig, Generator
from llm_fine_tune_distributed_tpu_torch.infer.engine import PagedContinuousBatchingEngine
from llm_fine_tune_distributed_tpu_torch.models import configs
from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax
from llm_fine_tune_distributed_tpu_torch.ops import int8
from llm_fine_tune_distributed_tpu_torch.ops.int8_matmul import kmajor

LOGIT_TOL, MATMUL_REL = 1e-4, 1e-6
GREEDY = dict(max_new_tokens=8, do_sample=False)
PROMPTS = ("the quick brown fox", "hi", "water purification methods in the wild")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _jax_params(dtype=jnp.float32):
    jmc = jax_get_preset("tiny")
    jparams = jax_tf.init_params(jax.random.PRNGKey(0), jmc, dtype=dtype)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x * 10.0 if path[-1].key == "kernel" else x, jparams
    ), jmc


def _flat_np(jparams):
    return {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(jparams)).items()}


@pytest.fixture(scope="module")
def models():
    """(JAX int8 params, JAX config, port int8 params quantized by the port,
    port config)."""
    jparams, jmc = _jax_params()
    mc = configs.get_preset("tiny")
    params = int8.quantize_params_int8(params_from_jax(_flat_np(jparams), mc))
    return jax_int8.quantize_params_int8(jparams), jmc, params, mc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_leaves_are_jaxs_bit_for_bit(dtype):
    """Same leaf names, codes and scales, from f32 and from bf16 weights;
    everything outside the blocks' kernels is untouched."""
    jparams, jmc = _jax_params(getattr(jnp, dtype))
    mc = configs.get_preset("tiny")
    flat = _flat_np(jparams)
    params = params_from_jax(flat, mc, dtype=getattr(torch, dtype))
    before = {k: v.clone() for k, v in params.items()}
    out = int8.quantize_params_int8(params)
    assert out is params  # in place
    want = {k.replace("/", "."): np.asarray(v)
            for k, v in flatten_dict(jax_int8.quantize_params_int8(jparams)).items()}
    assert set(out) == set(want)
    n_int8 = 0
    for name, t in out.items():
        if name.endswith("_int8") or name.endswith("_int8_scale"):
            assert t.dtype == (torch.int8 if name.endswith("_int8") else torch.float32)
            np.testing.assert_array_equal(t.numpy(), want[name])
            n_int8 += 1
        else:
            assert torch.equal(t, before[name])
    assert n_int8 == 2 * 7 * mc.num_layers
    assert not any(k.endswith(".kernel") for k in out)


def test_embedding_lm_head_and_norms_stay_full_precision():
    mc = dataclasses.replace(configs.get_preset("tiny"), tie_word_embeddings=False)
    params = tf.init_params(mc, seed=0)
    kept = {k: v for k, v in params.items() if ".layers." not in k or k.endswith("norm.weight")}
    assert "lm_head.kernel" in kept and "model.embed_tokens.weight" in kept
    out = int8.quantize_params_int8(params)
    for name, t in kept.items():
        assert out[name] is t


@pytest.mark.parametrize("layout", ["row_major", "k_major"])
def test_int8_matmul_matches_jax(layout):
    rng = np.random.RandomState(3)
    w = rng.randn(96, 80).astype(np.float32)
    x = rng.randn(5, 96).astype(np.float32)
    jq = jax_int8.quantize_int8(jnp.asarray(w))
    want = np.asarray(jax_int8.int8_matmul(jnp.asarray(x), jq, compute_dtype=jnp.float32))
    q = int8.quantize_int8(torch.from_numpy(w))
    if layout == "k_major":
        q["int8"] = kmajor(q["int8"])
        assert q["int8"].stride() == (1, 96)
    got = int8.int8_matmul(torch.from_numpy(x), q, torch.float32).numpy()
    assert np.abs(got - want).max() <= MATMUL_REL * np.abs(want).max()


def test_int8_matmul_in_bf16_rounds_the_f32_dequant_once():
    q = int8.quantize_int8(torch.randn(64, 48, generator=torch.Generator().manual_seed(0)))
    x = torch.eye(64, dtype=torch.bfloat16)
    w = (q["int8"].float() * q["int8_scale"][None, :]).to(torch.bfloat16)
    assert torch.equal(int8.int8_matmul(x, q, torch.bfloat16), w)


@pytest.mark.parametrize("carried", [False, True], ids=["port_quantized", "carried_k_major"])
def test_int8_forward_logits_match_jax(models, carried):
    """The port's own codes (row-major) and JAX's carried across (K-major)."""
    jq, jmc, params, mc = models
    if carried:
        params = params_from_jax(_flat_np(jq), mc)
        assert params["model.layers.0.mlp.up_proj.kernel_int8"].stride()[0] == 1
    ids = np.random.RandomState(0).randint(0, mc.vocab_size, (2, 16))
    want, _ = jax_tf.forward(jq, jnp.asarray(ids), jmc, compute_dtype=jnp.float32)
    got, _ = tf.forward(params, torch.from_numpy(ids), mc, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_TOL)


@pytest.fixture(scope="module")
def int8_generator(models):
    _, _, params, mc = models
    return Generator(params, mc, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                     eos_token_ids=[], device="cpu")


@pytest.mark.parametrize("text", PROMPTS)
def test_int8_greedy_generate_ids_equals_jax(models, int8_generator, text):
    jq, jmc, _, _ = models
    jgen = JaxGenerator(jq, jmc, JaxTokenizer(), compute_dtype=jnp.float32, eos_token_ids=[])
    prompt = list(text.encode())
    want = jgen.generate_ids(prompt, JaxGenerationConfig(**GREEDY))
    got = int8_generator.generate_ids(prompt, GenerationConfig(**GREEDY))
    assert got == want
    assert got != [prompt[-1]] * len(got)


def _paged(generator, kv_quant, engine_cls=PagedContinuousBatchingEngine):
    return engine_cls(generator, slots=4, buf_len=96, prompt_bucket=16, block_len=16,
                      prefill_chunk=32, kv_quant=kv_quant)


def test_paged_engine_over_int8_weights_equals_solo(int8_generator):
    """Int8 weights on the paged engine (bf16-layout pool) emit solo
    ``generate_ids``'s greedy tokens."""
    eng = _paged(int8_generator, "none")
    try:
        for text in PROMPTS:
            prompt = list(text.encode())
            solo = int8_generator.generate_ids(prompt, GenerationConfig(**GREEDY))
            assert eng.submit(prompt, GenerationConfig(**GREEDY), timeout=240) == solo
    finally:
        eng.close()


def test_paged_engine_over_int8_weights_and_kv_equals_jax(models, int8_generator):
    """The whole quantized stack, int8 weights and an int8 KV pool, emits the
    JAX paged engine's greedy tokens over the same requests in the same
    order, each of the JAX engine's on a fresh pool: the port's rule for a
    block a request is given (its K/V scales start from zero), which the
    JAX engine's pool keeps only until a freed block is handed out again.
    (Not solo ``generate_ids``'s: the pool's 8-bit rounding changes
    tokens of this non-echoing model, in the JAX package too; the JAX
    package's own solo comparison runs the echoing 0.02-init model.)"""
    jq, jmc, _, _ = models
    jgen = JaxGenerator(jq, jmc, JaxTokenizer(), compute_dtype=jnp.float32, eos_token_ids=[])
    eng = _paged(int8_generator, "int8")
    try:
        for text in PROMPTS:
            prompt = list(text.encode())
            jeng = _paged(jgen, "int8", JaxPagedEngine)
            want = jeng.submit(prompt, JaxGenerationConfig(**GREEDY), timeout=240)
            assert eng.submit(prompt, GenerationConfig(**GREEDY), timeout=240) == want
    finally:
        eng.close()


def test_frozen_trunk_int8_leaves_stay_w8a8(models):
    """With ``frozen_compute="int8"`` the trunk's int8 leaves go through
    ``trunk_matmul`` (w8a8) and no other layer's do; the layers past the
    trunk run weight-only. Without the trunk every int8 leaf is weight-only."""
    _, _, params, mc = models
    calls = []

    def trunk_matmul(x, q, compute_dtype):
        calls.append(q["int8"].data_ptr())
        return int8.int8_matmul(x, q, compute_dtype)

    ids = torch.from_numpy(np.random.RandomState(0).randint(0, mc.vocab_size, (1, 8)))
    plain, _ = tf.forward(params, ids, mc, compute_dtype=torch.float32)
    trunk, _ = tf.forward(params, ids, mc, compute_dtype=torch.float32, frozen_layers=2,
                          frozen_compute="int8", trunk_matmul=trunk_matmul)
    trunk_codes = {params[k].data_ptr() for k in params
                   if k.endswith("_int8") and k.split(".")[2] in ("0", "1")}
    assert len(calls) == 2 * 7 and set(calls) == trunk_codes
    torch.testing.assert_close(trunk, plain, rtol=0, atol=0)
    calls.clear()
    tf.forward(params, ids, mc, compute_dtype=torch.float32, trunk_matmul=trunk_matmul)
    assert calls == []


def test_errors():
    params = tf.init_params(configs.get_preset("tiny"), seed=0)
    with pytest.raises(ValueError, match="unknown quantize mode"):
        int8.maybe_quantize(params, "int4")
    with pytest.raises(ValueError, match="predicate matched"):
        int8.quantize_params_int8(params, predicate=lambda p: p.endswith("embed_tokens.weight"))
    experts = {"model.layers.0.block_sparse_moe.experts.w1": torch.zeros(2, 4, 4)}
    with pytest.raises(NotImplementedError, match="quantize_int8_stacked"):
        int8.quantize_params_int8(experts)
    # nothing changed before the error
    assert not any(k.endswith("_int8") for k in params)
    assert int8.maybe_quantize(params, "none") is params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maybe_quantize_nf4_equals_jax_leaf_for_leaf(dtype):
    """``--quantize nf4``: the same leaf names and NF4 leaves bit for bit as
    the JAX ``quantize_params_nf4``, from f32 and from bf16 weights; the
    embedding and the norms untouched."""
    from llm_fine_tune_distributed_tpu.ops.nf4 import quantize_params_nf4 as jax_nf4

    jparams, _ = _jax_params(getattr(jnp, dtype))
    mc = configs.get_preset("tiny")
    port = int8.maybe_quantize(params_from_jax(_flat_np(jparams), mc, dtype=getattr(torch, dtype)),
                               "nf4")
    want = {k.replace("/", "."): np.asarray(v) for k, v in flatten_dict(jax_nf4(jparams)).items()}
    assert set(port) == set(want)
    for k, v in want.items():
        got = port[k].float().numpy() if port[k].dtype == torch.bfloat16 else port[k].numpy()
        assert got.shape == v.shape, k
        np.testing.assert_array_equal(got, v.astype(got.dtype), err_msg=k)
    assert not any(k.endswith(".kernel") and ".layers." in k for k in port)


def test_nf4_weights_forward_and_tokens_equal_jax():
    """Over NF4 weights the port's forward is within 1e-4 of the JAX
    forward, and its greedy tokens are the JAX Generator's."""
    from llm_fine_tune_distributed_tpu.ops.nf4 import quantize_params_nf4 as jax_nf4

    jparams, jmc = _jax_params()
    mc = configs.get_preset("tiny")
    jq = jax_nf4(jparams)
    params = int8.maybe_quantize(params_from_jax(_flat_np(jparams), mc), "nf4")
    ids = np.random.RandomState(0).randint(0, mc.vocab_size, (2, 12))
    want, _ = jax_tf.forward(jq, jnp.asarray(ids), jmc, compute_dtype=jnp.float32)
    got, _ = tf.forward(params, torch.from_numpy(ids), mc, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_TOL)
    jgen = JaxGenerator(jq, jmc, JaxTokenizer(), compute_dtype=jnp.float32, eos_token_ids=[])
    gen = Generator(params, mc, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                    eos_token_ids=[], device="cpu")
    for prompt in PROMPTS[:2]:
        ids = list(prompt.encode())
        assert (list(gen.generate_ids(ids, GenerationConfig(**GREEDY)))
                == list(jgen.generate_ids(ids, JaxGenerationConfig(**GREEDY))))
