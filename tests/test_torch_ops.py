"""The port's norms, rope and plain attention against the JAX package's, in
f32 to 1e-5 (the two frameworks sum in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu.ops.attention import xla_attention as jax_xla_attention
from llm_fine_tune_distributed_tpu.ops import norms as jax_norms
from llm_fine_tune_distributed_tpu.ops import rope as jax_rope
from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_get_preset
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.ops import attention, norms, rope

TOL = 1e-5


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=tol)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    w = rng.normal(size=(64,)).astype(np.float32)
    _close(norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jax_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("scaling", [None, "linear", "llama3"])
def test_rope_matches_jax(scaling):
    rng = np.random.default_rng(1)
    mc = get_preset("tiny")
    if scaling:
        mc = mc.replace(rope_scaling_type=scaling, rope_scaling_factor=8.0,
                        rope_original_max_position=64)
    jmc = jax_get_preset("tiny").replace(**{k: getattr(mc, k) for k in (
        "rope_scaling_type", "rope_scaling_factor", "rope_original_max_position")})
    positions = rng.integers(0, 4000, size=(2, 7)).astype(np.int32)
    d = mc.resolved_head_dim
    cos, sin = rope.rope_cos_sin(torch.from_numpy(positions), d, mc.rope_theta, config=mc)
    jcos, jsin = jax_rope.rope_cos_sin(jnp.asarray(positions), d, jmc.rope_theta, config=jmc)
    _close(cos, jcos)
    _close(sin, jsin)
    q = rng.normal(size=(2, 7, 4, d)).astype(np.float32)
    k = rng.normal(size=(2, 7, 2, d)).astype(np.float32)
    tq, tk = rope.apply_rope(torch.from_numpy(q), torch.from_numpy(k), cos, sin)
    rq, rk = jax_rope.apply_rope(jnp.asarray(q), jnp.asarray(k), jcos, jsin)
    _close(tq, rq)
    _close(tk, rk)


def test_nope_layer_flags_match_jax():
    for name in ("tiny", "smollm3_3b"):
        mc, jmc = get_preset(name), jax_get_preset(name)
        assert [mc.uses_rope(i) for i in range(mc.num_layers)] == [
            jmc.uses_rope(i) for i in range(jmc.num_layers)
        ]


def _qkv(seed, b=2, sq=6, sk=6, hq=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, hq, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32))


def test_xla_attention_causal_matches_jax():
    q, k, v = _qkv(2)
    got = attention.xla_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    ref = jax_xla_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    _close(got, ref)


def test_xla_attention_explicit_mask_with_fully_masked_row():
    """An explicit [b, q, kv] mask (the paged prefill path) whose first
    query row masks every key: both fall back to a uniform average, not NaN."""
    q, k, v = _qkv(3, sq=4, sk=10)
    mask = np.arange(10)[None, None, :] <= (np.arange(4) + 5)[None, :, None]
    mask = np.broadcast_to(mask, (2, 4, 10)).copy()
    mask[0, 0, :] = False
    got = attention.xla_attention(*map(torch.from_numpy, (q, k, v)),
                                  mask=torch.from_numpy(mask), causal=False)
    ref = jax_xla_attention(*map(jnp.asarray, (q, k, v)),
                            mask=jnp.asarray(mask), causal=False)
    assert torch.isfinite(got).all()
    _close(got, ref)


def test_xla_attention_padding_and_segments_match_jax():
    q, k, v = _qkv(4)
    pad = np.asarray([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], np.int32)
    seg = np.asarray([[1, 1, 2, 2, 0, 0], [1, 1, 1, 2, 2, 2]], np.int32)
    got = attention.xla_attention(*map(torch.from_numpy, (q, k, v)),
                                  padding_mask=torch.from_numpy(pad),
                                  segment_ids=torch.from_numpy(seg))
    ref = jax_xla_attention(*map(jnp.asarray, (q, k, v)),
                            padding_mask=jnp.asarray(pad),
                            segment_ids=jnp.asarray(seg))
    _close(got, ref)
