"""The port's transformer and checkpoint I/O against the JAX package's, on
the ``tiny`` preset in f32.

Tolerances: logits to 1e-4 (f32 matmuls summed in another order by the two
frameworks), int8 pool codes bit-equal, parameters exactly equal after a
save/load round trip.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu.infer.generate import load_model_dir as jax_load_model_dir
from llm_fine_tune_distributed_tpu.models import configs as jax_configs
from llm_fine_tune_distributed_tpu.models import hf_io as jax_hf_io
from llm_fine_tune_distributed_tpu.models import transformer as jax_tf
from llm_fine_tune_distributed_tpu_torch.infer.generate import load_model_dir
from llm_fine_tune_distributed_tpu_torch.models import configs, hf_io
from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax

LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def jax_tiny():
    mc = jax_configs.get_preset("tiny")
    params = jax_tf.init_params(jax.random.PRNGKey(0), mc, dtype=jnp.float32)
    return mc, params


@pytest.fixture(scope="module")
def torch_tiny(jax_tiny):
    _, params = jax_tiny
    mc = configs.get_preset("tiny")
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(params)).items()}
    return mc, params_from_jax(flat, mc, device="cpu", dtype=torch.float32)


def _ids(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def test_preset_and_config_round_trip():
    for name in ("tiny", "smollm3_3b"):
        ours, ref = configs.get_preset(name), jax_configs.get_preset(name)
        assert configs.to_hf_dict(ours) == jax_configs.to_hf_dict(ref)
        assert configs.from_hf_config(type("C", (), configs.to_hf_dict(ours))) == ours
    mc = configs.get_preset("smollm3_3b")
    assert [mc.uses_rope(i) for i in range(8)] == [True, True, True, False] * 2


def test_no_cache_forward_matches_jax(jax_tiny, torch_tiny):
    jmc, jparams = jax_tiny
    mc, params = torch_tiny
    ids = _ids(0, 2, 24)
    ref, _ = jax_tf.forward(jparams, jnp.asarray(ids), jmc, compute_dtype=jnp.float32)
    got, _ = tf.forward(params, torch.from_numpy(ids).long(), mc, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("kv_quant", ["int8", "none"])
def test_paged_prefill_then_decode_matches_jax(jax_tiny, torch_tiny, kv_quant):
    """A prefill chunk through the block tables, then single-token decode
    steps through ``forward(block_tables=...)``: the int8 decode runs the
    port's paged decode path and the JAX dequantizing gather."""
    jmc, jparams = jax_tiny
    mc, params = torch_tiny
    L, nb, num_blocks = 8, 4, 10
    tables = np.asarray([[3, 5, 7, 0], [2, 4, 6, 8]], np.int32)
    jcache = jax_tf.init_paged_cache(jmc, num_blocks, L, dtype=jnp.float32, kv_quant=kv_quant)
    tcache = tf.init_paged_cache(mc, num_blocks, L, dtype=torch.float32, kv_quant=kv_quant)
    prompt = _ids(1, 2, 13)
    jlog, jcache = jax_tf.forward(
        jparams, jnp.asarray(prompt), jmc, cache=jcache, cache_pos=0,
        block_tables=jnp.asarray(tables), compute_dtype=jnp.float32,
    )
    tlog, _ = tf.forward(
        params, torch.from_numpy(prompt).long(), mc, cache=tcache, cache_pos=0,
        block_tables=torch.from_numpy(tables), compute_dtype=torch.float32,
    )
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    pos = np.asarray([13, 13], np.int32)
    for step in range(4):
        tok = _ids(10 + step, 2, 1)
        jlog, jcache = jax_tf.forward(
            jparams, jnp.asarray(tok), jmc, cache=jcache, cache_pos=jnp.asarray(pos),
            block_tables=jnp.asarray(tables), compute_dtype=jnp.float32,
        )
        tlog, _ = tf.forward(
            params, torch.from_numpy(tok).long(), mc, cache=tcache,
            cache_pos=torch.from_numpy(pos).long(), block_tables=torch.from_numpy(tables),
            compute_dtype=torch.float32,
        )
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_TOL, rtol=LOGIT_TOL)
        pos = pos + 1
    for i in range(mc.num_layers):
        for name, t in tcache["layers"][str(i)].items():
            ref = np.asarray(jcache["layers"][str(i)][name])
            if kv_quant == "int8" and name in ("k", "v"):
                np.testing.assert_array_equal(t.numpy(), ref)
            else:
                np.testing.assert_allclose(t.numpy(), ref, atol=1e-5, rtol=1e-5)


def _jax_model_dir(path, jmc, jparams):
    jax_hf_io.save_hf_checkpoint(jax.device_get(jparams), str(path))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(jax_configs.to_hf_dict(jmc), f)
    ByteChatMLTokenizer().save_pretrained(str(path))
    return str(path)


def test_jax_written_model_dir_loads_with_same_logits(tmp_path, jax_tiny):
    jmc, jparams = jax_tiny
    path = _jax_model_dir(tmp_path / "best_model", jmc, jparams)
    params, mc = load_model_dir(path, device="cpu")
    assert mc == configs.get_preset("tiny")
    ids = _ids(2, 1, 17)
    ref, _ = jax_tf.forward(jparams, jnp.asarray(ids), jmc, compute_dtype=jnp.float32)
    got, _ = tf.forward(params, torch.from_numpy(ids).long(), mc, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("save_dtype", [None, torch.bfloat16])
def test_port_written_model_dir_loads_in_jax(tmp_path, torch_tiny, save_dtype):
    mc, params = torch_tiny
    path = tmp_path / "best_model"
    hf_io.save_hf_checkpoint(params, str(path), save_dtype=save_dtype)
    with open(path / "config.json", "w") as f:
        json.dump(configs.to_hf_dict(mc), f)
    jparams, jmc = jax_load_model_dir(str(path))
    assert jax_configs.to_hf_dict(jmc) == configs.to_hf_dict(mc)
    flat = flatten_tree(jax.device_get(jparams))
    assert set(flat) == set(params)
    for name, t in params.items():
        want = t if save_dtype is None else t.to(save_dtype)
        np.testing.assert_array_equal(np.asarray(flat[name], np.float32), want.float().numpy())


def test_safetensors_codec_matches_the_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    tensors = {
        "a": torch.randn(3, 5),
        "b": torch.randn(7).to(torch.bfloat16),
        "c": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "d": torch.zeros(0, 4),
    }
    ours = str(tmp_path / "ours.safetensors")
    theirs = str(tmp_path / "theirs.safetensors")
    hf_io.write_safetensors(ours, tensors, {"format": "pt"})
    st.save_file(tensors, theirs)
    for got in (st.load_file(ours), hf_io.read_safetensors(theirs)):
        assert set(got) == set(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v)


def test_read_safetensors_shares_one_buffer_that_outlives_the_file(tmp_path):
    """``read_safetensors`` reads the data section once into one buffer and
    returns views of it (no per-tensor copy): the values are unchanged, the
    views share one storage, they stay valid once the file is gone, and a
    tensor at an offset off its element size is copied out right."""
    import gc
    import os
    import struct

    tensors = {"a": torch.randn(3, 5), "b": torch.randn(7).to(torch.bfloat16),
               "c": torch.arange(6, dtype=torch.int32).reshape(2, 3), "d": torch.zeros(0, 4),
               "e": torch.tensor([True, False, True]), "s": torch.tensor(2.5)}
    path = str(tmp_path / "w.safetensors")
    hf_io.write_safetensors(path, tensors)
    got = hf_io.read_safetensors(path)
    os.unlink(path)
    gc.collect()
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and tuple(got[k].shape) == tuple(v.shape)
        assert torch.equal(got[k], v), k
    storages = {got[k].untyped_storage().data_ptr() for k in ("a", "b", "c", "e", "s")}
    assert len(storages) == 1
    got["a"].add_(1.0)  # the views are writable and apart
    assert torch.equal(got["a"], tensors["a"] + 1.0) and torch.equal(got["c"], tensors["c"])
    # a hand-made file whose f32 tensor starts 2 bytes into the data section
    header = json.dumps({"x": {"dtype": "F32", "shape": [2], "data_offsets": [2, 10]},
                         "y": {"dtype": "I8", "shape": [2], "data_offsets": [0, 2]}}).encode()
    x = torch.tensor([1.5, -2.0])
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header + bytes([7, 9])
                + x.numpy().tobytes())
    odd = hf_io.read_safetensors(path)
    assert torch.equal(odd["x"], x) and odd["y"].tolist() == [7, 9]


def test_unported_branches_raise():
    mc = configs.get_preset("tiny").replace(sliding_window=8)
    with pytest.raises(NotImplementedError, match="sliding_window"):
        tf.init_params(mc)
    mc = configs.get_preset("tiny")
    with pytest.raises(NotImplementedError, match="padding_mask with a KV cache"):
        tf.forward(tf.init_params(mc), torch.zeros(1, 2, dtype=torch.long), mc,
                   cache=tf.init_cache(mc, 1, 8), padding_mask=torch.ones(1, 8))
    # the dense cache is ported; a paged pool without its block tables is refused
    with pytest.raises(ValueError, match="needs block_tables"):
        tf.forward(tf.init_params(mc), torch.zeros(1, 2, dtype=torch.long), mc,
                   cache=tf.init_paged_cache(mc, 4, 8))
