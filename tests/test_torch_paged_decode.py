"""The paged decode attention's plain version against the JAX package's
Pallas kernel (``pl.pallas_call(interpret=True)`` on the CPU), and the
wrapper's routing and checks.

Tolerance 1e-5: both compute in f32 and differ only in summation order (the
band the JAX package pins between its kernel and its XLA reference).

JAX is imported inside the test that needs it, so the card-only test runs on
a machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_paged_decode.py``.
"""

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.ops.flash_attention import (
    paged_decode_attention,
    paged_decode_attention_reference,
)

TOL = 1e-5


def _case(seed, b, hkv, groups, d, L, nb, num_blocks, lengths, tables):
    """Random int8 pools with the null block zeroed, and null-padded tables
    (which may share blocks between rows)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, size=(num_blocks, L, hkv, d)).astype(np.int8)
    v = rng.integers(-127, 128, size=(num_blocks, L, hkv, d)).astype(np.int8)
    ks = rng.uniform(0.1, 3.0, size=(num_blocks, hkv)).astype(np.float32)
    vs = rng.uniform(0.1, 3.0, size=(num_blocks, hkv)).astype(np.float32)
    k[0] = 0
    v[0] = 0
    ks[0] = 0.0
    vs[0] = 0.0
    q = rng.normal(size=(b, 1, hkv * groups, d)).astype(np.float32)
    return (q, k, v, ks, vs, np.asarray(tables, np.int32), np.asarray(lengths, np.int32))


CASES = {
    # G = 2, L = 16, ragged lengths, null-padded second row
    "g2_l16": dict(b=2, hkv=2, groups=2, d=16, L=16, nb=3, num_blocks=8,
                   lengths=[37, 19], tables=[[1, 2, 3], [4, 5, 0]]),
    # G = 1 (hq == hkv), L = 8, a block shared by both rows, a length-1 row
    "g1_l8": dict(b=3, hkv=2, groups=1, d=16, L=8, nb=3, num_blocks=8,
                  lengths=[20, 1, 11], tables=[[1, 2, 3], [6, 0, 0], [1, 7, 0]]),
    # G = 4 (SmolLM3's grouping) at head_dim 32, full and exactly-full rows
    "g4_l16": dict(b=2, hkv=1, groups=4, d=32, L=16, nb=2, num_blocks=5,
                   lengths=[32, 16], tables=[[3, 4], [2, 0]]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax_kernel_interpret(name):
    jnp = pytest.importorskip("jax.numpy")
    from llm_fine_tune_distributed_tpu.ops.flash_attention import (
        paged_decode_attention as jax_paged_decode_attention,
    )

    q, k, v, ks, vs, tables, lengths = _case(0, **CASES[name])
    ref = jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(tables), lengths=jnp.asarray(lengths), interpret=True,
    )
    args = [torch.from_numpy(a) for a in (q, k, v, ks, vs, tables)]
    got = paged_decode_attention_reference(*args, lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_cpu_tensor_takes_the_plain_version_without_launching():
    q, k, v, ks, vs, tables, lengths = _case(1, **CASES["g2_l16"])
    args = [torch.from_numpy(a) for a in (q, k, v, ks, vs, tables)]
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args, lengths=torch.from_numpy(lengths))
    want = paged_decode_attention_reference(*args, lengths=torch.from_numpy(lengths))
    assert torch.equal(got, want)
    assert paged_decode_attention.launches == before


@pytest.mark.parametrize("bad", ["s2", "f16_q", "i32_pool", "i64_tables", "d8", "groups32", "strided"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v, ks, vs, tables, lengths = (
        torch.from_numpy(a) for a in _case(2, **CASES["g2_l16"])
    )
    if bad == "s2":
        q = torch.cat([q, q], dim=1)
    elif bad == "f16_q":
        q = q.half()
    elif bad == "i32_pool":
        k = k.int()
    elif bad == "i64_tables":
        tables = tables.long()
    elif bad == "d8":
        q, k, v = q[..., :8].contiguous(), k[..., :8].contiguous(), v[..., :8].contiguous()
    elif bad == "groups32":
        q = q.repeat(1, 1, 16, 1)
    elif bad == "strided":
        q = q.transpose(0, 2).contiguous().transpose(0, 2)
    with pytest.raises((TypeError, ValueError)):
        paged_decode_attention(q, k, v, ks, vs, tables, lengths=lengths)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(cuda, dtype):
    """On the card: the kernel against its plain version on the same inputs,
    f32 to 1e-5; in bf16 both round one f32 result, so they differ by at
    most one bf16 ulp (rtol 2**-7, atol 1e-5 near zero)."""
    atol, rtol = (TOL, TOL) if dtype == torch.float32 else (1e-5, 2.0**-7)
    for name in sorted(CASES):
        q, k, v, ks, vs, tables, lengths = (
            torch.from_numpy(a).to(cuda) for a in _case(3, **CASES[name])
        )
        q = q.to(dtype)
        before = paged_decode_attention.launches
        got = paged_decode_attention(q, k, v, ks, vs, tables, lengths=lengths)
        torch.cuda.synchronize()
        assert paged_decode_attention.launches == before + 1
        want = paged_decode_attention_reference(q, k, v, ks, vs, tables, lengths=lengths)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
