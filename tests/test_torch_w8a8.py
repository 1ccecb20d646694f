"""The port's int8 quantizers and w8a8 matmul against the JAX package's, on
the same numpy inputs; the kernel wrapper's refusals; the CUDA kernel
against its plain version on the card.

The band is bitwise everywhere: both packages quantize with the same f32
division and round-half-to-even, the int32 accumulation is exact in any
order (the port's plain version takes it as an f64 matmul, exact while
|acc| <= K * 127^2 < 2^53), and the epilogue multiplies in f32 in one order
and rounds once.

JAX is imported inside the tests that need it, so the card-only test runs on
a machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_w8a8.py``.
"""

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.ops import int8 as pint8
from llm_fine_tune_distributed_tpu_torch.ops import int8_matmul as pmm

# (M, K, N): ragged M and N, K off the kernel's 128-byte step
SHAPES = [(13, 64, 48), (96, 128, 100), (70, 80, 129)]


def _x(m, k, seed):
    """Activations with an all-zero row and a row of one repeated value."""
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    x[min(3, m - 1)] = 0.0
    x[0] = 0.5
    return x


def _w(k, n, seed):
    """A weight with an all-zero column."""
    w = (0.02 * np.random.default_rng(seed).standard_normal((k, n))).astype(np.float32)
    w[:, min(5, n - 1)] = 0.0
    return w


@pytest.mark.parametrize("k,n", [(64, 48), (128, 100), (2048, 512)])
def test_quantize_int8_matches_jax_bitwise(k, n):
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.ops import int8 as jint8

    w = _w(k, n, k + n)
    want = jint8.quantize_int8(jnp.asarray(w))
    got = pint8.quantize_int8(torch.from_numpy(w))
    assert got["int8"].dtype == torch.int8 and got["int8_scale"].dtype == torch.float32
    for suffix in pint8.INT8_SUFFIXES:
        np.testing.assert_array_equal(got[suffix].numpy(), np.asarray(want[suffix]), err_msg=suffix)
    back = pint8.dequantize_int8(got, torch.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jint8.dequantize_int8(want, jnp.float32)))


@pytest.mark.parametrize("shape", [(5, 64), (2, 3, 128), (4, 8)])
def test_quantize_rows_matches_jax_bitwise(shape):
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.ops import int8_matmul as jmm

    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    x.reshape(-1, shape[-1])[1] = 0.0  # an all-zero row: scale 1/127, zero codes
    want_codes, want_scale = jmm.quantize_rows_int8(jnp.asarray(x))
    codes, scale = pmm.quantize_rows_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want_scale))
    assert codes.reshape(-1, shape[-1])[1].abs().max() == 0


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_w8a8_matches_jax_bitwise(m, k, n, dtype, impl):
    """The port's entry on CPU tensors (its plain version) against JAX's
    ``int8_w8a8_matmul`` through XLA and through the Pallas kernel in
    interpret mode."""
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.ops import int8 as jint8
    from llm_fine_tune_distributed_tpu.ops import int8_matmul as jmm

    x, w = _x(m, k, m), _w(k, n, n)
    want = jmm.int8_w8a8_matmul(jnp.asarray(x), jint8.quantize_int8(jnp.asarray(w)),
                                getattr(jnp, dtype), impl=impl)
    got = pmm.int8_w8a8_matmul(torch.from_numpy(x), pint8.quantize_int8(torch.from_numpy(w)),
                               getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, n)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_plain_product_is_exact_at_full_codes():
    """Every code at +-127 over K = 11008 (SmolLM3's down_proj): the f64
    product equals the int64 one."""
    rng = np.random.default_rng(0)
    xq = (127 * rng.choice([-1, 1], (8, 11008))).astype(np.int8)
    wq = (127 * rng.choice([-1, 1], (11008, 16))).astype(np.int8)
    ones_m, ones_n = torch.ones(8), torch.ones(16)
    got = pmm.int8_w8a8_matmul_reference(torch.from_numpy(xq), ones_m, torch.from_numpy(wq),
                                         ones_n, torch.float32)
    want = (xq.astype(np.int64) @ wq.astype(np.int64)).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_leading_dims_and_cpu_counter():
    before = pmm.w8a8_matmul.launches
    x = torch.from_numpy(_x(12, 64, 1)).reshape(2, 6, 64)
    q = pint8.quantize_int8(torch.from_numpy(_w(64, 32, 2)))
    out = pmm.int8_w8a8_matmul(x, q, torch.float32)
    flat = pmm.int8_w8a8_matmul(x.reshape(12, 64), q, torch.float32)
    assert out.shape == (2, 6, 32)
    assert torch.equal(out.reshape(12, 32), flat)
    assert pmm.w8a8_matmul.launches == before == 0


def _operands(m=4, k=64, n=8):
    xq, xs = pmm.quantize_rows_int8(torch.from_numpy(_x(m, k, 0)))
    q = pint8.quantize_int8(torch.from_numpy(_w(k, n, 0)))
    return xq, xs, q["int8"], q["int8_scale"]


def test_wrapper_refuses_wrong_dtypes_and_shapes():
    xq, xs, wq, ws = _operands()
    with pytest.raises(TypeError, match="xq must be torch.int8"):
        pmm.w8a8_matmul(xq.float(), xs, wq, ws)
    with pytest.raises(TypeError, match="wq must be torch.int8"):
        pmm.w8a8_matmul(xq, xs, wq.to(torch.int16), ws)
    with pytest.raises(TypeError, match="w_scale must be torch.float32"):
        pmm.w8a8_matmul(xq, xs, wq, ws.double())
    with pytest.raises(TypeError, match="bf16 or f32"):
        pmm.w8a8_matmul(xq, xs, wq, ws, torch.float16)
    with pytest.raises(ValueError, match="inner dims"):
        pmm.w8a8_matmul(xq, xs, wq[:32], ws)
    with pytest.raises(ValueError, match="scales"):
        pmm.w8a8_matmul(xq, xs[:2], wq, ws)
    with pytest.raises(ValueError, match="contiguous"):
        pmm.w8a8_matmul(xq.t().contiguous().t(), xs, wq, ws)


def test_kmajor_check_names_the_layout():
    """The CUDA kernel reads wq [K, N] K-major (strides (1, K)); on the card
    the wrapper's check refuses the N-major codes ``quantize_int8`` returns,
    naming the layout, and takes what ``kmajor`` makes of them: the same
    values in another memory order."""
    _, _, wq, _ = _operands(k=64, n=8)
    assert wq.stride() == (8, 1)
    with pytest.raises(ValueError, match=r"K-major.*strides \(1, K\)"):
        pmm._check_kmajor(wq)
    km = pmm.kmajor(wq)
    assert km.shape == wq.shape and km.stride() == (1, 64) and torch.equal(km, wq)
    pmm._check_kmajor(km)
    pmm._check_kmajor(pmm.kmajor(torch.zeros(16, 1, dtype=torch.int8)))  # one column


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_version_takes_either_layout_bitwise(m, k, n, dtype):
    """The plain version (and the wrapper on CPU tensors) gives the same bits
    for N-major and K-major codes."""
    dt = getattr(torch, dtype)
    xq, xs = pmm.quantize_rows_int8(torch.from_numpy(_x(m, k, m)))
    q = pint8.quantize_int8(torch.from_numpy(_w(k, n, n)))
    km = pmm.kmajor(q["int8"])
    want = pmm.int8_w8a8_matmul_reference(xq, xs, q["int8"], q["int8_scale"], dt)
    assert torch.equal(pmm.int8_w8a8_matmul_reference(xq, xs, km, q["int8_scale"], dt), want)
    assert torch.equal(pmm.w8a8_matmul(xq, xs, km, q["int8_scale"], dt), want)
    assert torch.equal(pmm.w8a8_matmul(xq, xs, q["int8"], q["int8_scale"], dt), want)


def test_wrapper_refuses_k_that_would_overflow_int32():
    k = pmm.MAX_K + 1
    assert pmm.MAX_K * 127**2 <= 2**31 - 1 < k * 127**2
    xq = torch.zeros(1, k, dtype=torch.int8)
    wq = torch.zeros(k, 1, dtype=torch.int8)
    with pytest.raises(ValueError, match="overflow the int32"):
        pmm.w8a8_matmul(xq, torch.ones(1), wq, torch.ones(1))
    # the largest K that fits is taken, and its all-127 product is exact
    xq = torch.full((1, pmm.MAX_K), 127, dtype=torch.int8)
    wq = torch.full((pmm.MAX_K, 1), 127, dtype=torch.int8)
    out = pmm.w8a8_matmul(xq, torch.ones(1), wq, torch.ones(1), torch.float32)
    assert out.item() == np.float32(pmm.MAX_K * 127**2)


def test_entry_refuses_grad():
    x = torch.from_numpy(_x(4, 64, 0)).requires_grad_()
    q = pint8.quantize_int8(torch.from_numpy(_w(64, 8, 0)))
    with pytest.raises(RuntimeError, match="no gradient"):
        pmm.int8_w8a8_matmul(x, q)
    with torch.no_grad():
        assert pmm.int8_w8a8_matmul(x, q).shape == (4, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_the_card(dtype):
    """The CUDA kernel on K-major codes against its plain version, bitwise:
    ragged M and N, K off the 128-byte step (K = 2000: the last step
    zero-filled), K off 16 (the kernel's byte-wise loads), odd N (no paired
    stores)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the w8a8 kernel has no CPU mode")
    dt = getattr(torch, dtype)
    for m, k, n in SHAPES + [(1, 16, 1), (300, 100, 257), (256, 2048, 512), (300, 2000, 257)]:
        x = torch.from_numpy(_x(m, k, m + k)).cuda()
        q = {key: v.cuda() for key, v in pint8.quantize_int8(torch.from_numpy(_w(k, n, n))).items()}
        wq = pmm.kmajor(q["int8"])
        xq, xs = pmm.quantize_rows_int8(x)
        before = pmm.w8a8_matmul.launches
        got = pmm.w8a8_matmul(xq, xs, wq, q["int8_scale"], dt)
        torch.cuda.synchronize()
        assert pmm.w8a8_matmul.launches == before + 1
        want = pmm.int8_w8a8_matmul_reference(xq, xs, q["int8"], q["int8_scale"], dt)
        assert torch.equal(got, want), f"{(m, k, n)}: max|d| {(got.float() - want.float()).abs().max()}"


@pytest.mark.cuda
def test_kernel_refuses_n_major_codes_on_the_card():
    """N-major codes on the card raise, naming the layout; nothing launches
    and nothing falls back."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the w8a8 kernel has no CPU mode")
    xq, xs, wq, ws = (t.cuda() for t in _operands())
    before = pmm.w8a8_matmul.launches
    with pytest.raises(ValueError, match="K-major"):
        pmm.w8a8_matmul(xq, xs, wq, ws)
    assert pmm.w8a8_matmul.launches == before
