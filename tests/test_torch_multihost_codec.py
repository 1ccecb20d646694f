"""The tick bridge's host codecs (mirrors ``tests/test_multihost_codec.py``),
each also held byte for byte to the JAX package's codec on the same inputs:
the window protocol's GenerationConfig JSON, the slot protocol's knob vector
and sized-tree manifests, and the fixed header lengths."""

import dataclasses

import numpy as np
import pytest

from llm_fine_tune_distributed_tpu_torch.infer import multihost as port
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig

KNOBS = [
    {"temperature": np.float32(0.7), "top_p": np.float32(0.95), "top_k": np.int32(40),
     "repetition_penalty": np.float32(1.1), "do_sample": np.bool_(True), "adapter_idx": np.int32(3)},
    {"temperature": 1.0, "top_p": 1.0, "top_k": 0, "repetition_penalty": 1.0, "do_sample": False,
     "adapter_idx": 0},
    {"temperature": 0.1, "top_p": 0.5, "top_k": 512, "repetition_penalty": 1.3, "do_sample": True,
     "adapter_idx": 7},
]
TREE = {
    "model/layers/0/self_attn/q_proj/kernel": np.arange(12, dtype=np.float32).reshape(3, 4),
    "model/embed_tokens/weight": np.ones((2, 2), np.int8),
    "a/scalarish": np.asarray([1.5], np.float64),
}


def _every_field_overridden():
    fields = {f.name: f.default for f in dataclasses.fields(GenerationConfig)}
    out = {}
    for name, default in fields.items():
        if isinstance(default, bool):
            out[name] = not default
        elif isinstance(default, int):
            out[name] = default + 3
        elif isinstance(default, float):
            out[name] = default * 0.5 + 0.125
    return out


# ------------------------------------------------------- window cfg codec


def test_cfg_roundtrips_every_field():
    gen = GenerationConfig(**_every_field_overridden())
    buf, length = port._encode_cfg(gen)
    assert port._decode_cfg(buf, length) == gen


def test_cfg_default_roundtrip_and_fixed_buffer_shape():
    g1, g2 = GenerationConfig(), GenerationConfig(max_new_tokens=999, temperature=0.123, top_k=7)
    (b1, l1), (b2, l2) = port._encode_cfg(g1), port._encode_cfg(g2)
    assert b1.shape == b2.shape == (port._CFG_BUF,)
    assert b1.dtype == b2.dtype == np.uint8
    assert port._decode_cfg(b1, l1) == g1 and port._decode_cfg(b2, l2) == g2


def test_cfg_overflow_raises_cleanly():
    huge = dataclasses.replace(GenerationConfig(), top_k="x" * (port._CFG_BUF + 1))
    with pytest.raises(ValueError, match=str(port._CFG_BUF)):
        port._encode_cfg(huge)


def test_header_lengths_are_constants():
    assert port._HEADER_LEN == 5
    assert port._SLOT_HEADER_LEN == 10


@pytest.mark.parametrize("overrides", [{}, {"max_new_tokens": 999, "temperature": 0.123,
                                             "top_k": 7}, "every"])
def test_cfg_bytes_equal_the_jax_codec(overrides):
    from llm_fine_tune_distributed_tpu.infer import multihost as jax_mh
    from llm_fine_tune_distributed_tpu.infer.sampling import GenerationConfig as JaxCfg

    kw = _every_field_overridden() if overrides == "every" else overrides
    ours, theirs = port._encode_cfg(GenerationConfig(**kw)), jax_mh._encode_cfg(JaxCfg(**kw))
    assert ours[1] == theirs[1]
    assert ours[0].tobytes() == theirs[0].tobytes()
    assert dataclasses.asdict(port._decode_cfg(*theirs)) == dataclasses.asdict(JaxCfg(**kw))


# ----------------------------------------------------- slot bridge codecs


def test_knob_vector_roundtrips_exactly():
    knobs = KNOBS[0]
    vec = port._encode_knobs(knobs)
    assert vec.shape == (len(port._KNOB_FIELDS),) and vec.dtype == np.float64
    out = port._decode_knobs(vec)
    for field in port._KNOB_FIELDS:
        assert out[field] == knobs[field]
        assert out[field].dtype == knobs[field].dtype


def test_knob_vector_shape_fixed_across_values():
    assert port._encode_knobs(KNOBS[1]).shape == port._encode_knobs(KNOBS[2]).shape


@pytest.mark.parametrize("i", range(len(KNOBS)))
def test_knob_bytes_equal_the_jax_codec(i):
    from llm_fine_tune_distributed_tpu.infer import multihost as jax_mh

    assert port._KNOB_FIELDS == jax_mh._KNOB_FIELDS
    vec = port._encode_knobs(KNOBS[i])
    assert vec.tobytes() == jax_mh._encode_knobs(KNOBS[i]).tobytes()
    ours, theirs = port._decode_knobs(vec), jax_mh._decode_knobs(vec)
    assert {k: (v, v.dtype) for k, v in ours.items()} == {k: (v, v.dtype) for k, v in theirs.items()}


def test_request_knobs_ride_exactly():
    """A follower samples with rank 0's own Python values: the f64 wire
    carries them without the f32 rounding of ``_decode_knobs``."""
    gen = GenerationConfig(temperature=0.7, top_p=0.95, top_k=None, repetition_penalty=1.1,
                           do_sample=True)
    cfg, adapter = port._knobs_config(port._encode_knobs(port.request_knobs(gen, 5)))
    assert (cfg.temperature, cfg.top_p, cfg.top_k, cfg.repetition_penalty, cfg.do_sample) == (
        0.7, 0.95, 0, 1.1, True)
    assert adapter == 5


def test_tree_manifest_roundtrips_shapes_dtypes_order():
    manifest, entries = port._tree_manifest(TREE)
    assert manifest.dtype == np.uint8
    decoded = port._manifest_entries(manifest)
    assert [p for p, _, _ in decoded] == sorted(TREE)
    for (path, shape, dtype), (spath, arr) in zip(decoded, entries):
        assert path == spath
        assert shape == arr.shape and dtype == arr.dtype
        np.testing.assert_array_equal(arr, TREE[path])


def test_tree_manifest_bytes_equal_the_jax_codec():
    from llm_fine_tune_distributed_tpu.infer import multihost as jax_mh

    ours, theirs = port._tree_manifest(TREE), jax_mh._tree_manifest(TREE)
    assert ours[0].tobytes() == theirs[0].tobytes()
    assert [p for p, _ in ours[1]] == [p for p, _ in theirs[1]]
    for (_, a), (_, b) in zip(ours[1], theirs[1]):
        assert a.tobytes() == b.tobytes()
    assert port._manifest_entries(theirs[0]) == jax_mh._manifest_entries(ours[0])


def test_slot_ops_are_the_jax_numbers():
    from llm_fine_tune_distributed_tpu.infer import multihost as jax_mh

    names = [n for n in dir(jax_mh) if n.startswith("SLOT_")]
    assert names and all(getattr(port, n) == getattr(jax_mh, n) for n in names)


def test_the_bridge_needs_a_multi_process_mesh():
    class Solo:
        mesh = None

    for make in (port.SlotBridge, port.MultihostCoordinator):
        with pytest.raises(ValueError, match="tensor-parallel mesh"):
            make(Solo())
