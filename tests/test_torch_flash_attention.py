"""The port's flash attention against the JAX package's Pallas kernels run in
interpret mode on the CPU, on the same numpy inputs.

On a CPU tensor the port runs the kernels' plain versions, so these tests
hold the plain forward (O and LSE) and the plain backward (through the
port's ``torch.autograd.Function``) to the TPU kernels' arithmetic, pad rows
included: both follow the segment rule (pad queries see the pad keys at or
before them). Tolerances are the JAX package's own for its kernels
(tests/test_flash_attention.py): 2e-5 forward, 5e-5 gradients, in f32.

JAX is imported inside the tests that need it, so the card-only tests run
on a machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_flash_attention.py``.
"""

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.ops import attention as port_attention
from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa

FWD_TOL = 2e-5
GRAD_TOL = 5e-5
S, D = 256, 32


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the test workers share the machine's cores, and
    more threads per worker only oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _inputs(seed, b, hq, hkv, s=S, d=D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    do = rng.standard_normal((b, s, hq, d), dtype=np.float32)
    return q, k, v, do


def _segments(kind, b, s=S):
    """None (all ones), right padding of lengths [256, 100, 17], or packed
    segment ids with a pad tail."""
    if kind == "none":
        return None
    if kind == "padding":
        lengths = np.asarray([256, 100, 17][:b])
        return (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    seg = np.zeros((b, s), np.int32)
    for r in range(b):
        cuts = [0, 40 + 30 * r, 120 + 7 * r, 200 - 20 * r]
        for sid, (lo, hi) in enumerate(zip(cuts, cuts[1:]), start=1):
            seg[r, lo:hi] = sid
    return seg


def _jax_fwd(q, k, v, seg):
    """(O, LSE [b, hq, s]) from the Pallas forward kernel in interpret mode."""
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.ops import flash_attention as jax_fa

    b, s, hq, d = q.shape
    segments = jnp.ones((b, s), jnp.int32) if seg is None else jnp.asarray(seg)
    block = jax_fa._pick_block(s)
    o, lse = jax_fa._fwd(
        jnp.asarray(q).transpose(0, 2, 1, 3), jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3), segments,
        scale=float(1.0 / np.sqrt(d)), block_q=block, block_k=block,
        groups=hq // k.shape[2], interpret=True,
    )
    return np.asarray(o).transpose(0, 2, 1, 3), np.asarray(lse)[..., 0]


def _port_segments(seg, b, s=S):
    return torch.ones(b, s, dtype=torch.int32) if seg is None else torch.from_numpy(seg)


@pytest.mark.parametrize("kind", ["none", "padding", "segments"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)])
def test_plain_forward_matches_pallas_kernel(hq, hkv, kind):
    b = 3 if kind == "padding" else 2
    q, k, v, _ = _inputs(hq * 10 + hkv, b, hq, hkv)
    seg = _segments(kind, b)
    o_ref, lse_ref = _jax_fwd(q, k, v, seg)
    o, lse = fa.flash_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          _port_segments(seg, b))
    np.testing.assert_allclose(o.numpy(), o_ref, atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("kind", ["padding", "segments"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_gradients_match_pallas_kernels(hq, hkv, kind):
    """jax.grad through the Pallas custom_vjp (dq and dk/dv kernels in
    interpret mode) against the port's autograd Function on every row."""
    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.ops import flash_attention as jax_fa

    b = 3 if kind == "padding" else 2
    q, k, v, cot = _inputs(7 + hq, b, hq, hkv)
    seg = _segments(kind, b)
    kw = {"padding_mask": jnp.asarray(seg)} if kind == "padding" else {"segment_ids": jnp.asarray(seg)}

    def loss(q_, k_, v_):
        out = jax_fa.pallas_flash_attention(q_, k_, v_, interpret=True, **kw)
        return jnp.sum(out * jnp.asarray(cot))

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tkw = {("padding_mask" if kind == "padding" else "segment_ids"): torch.from_numpy(seg)}
    out = fa.flash_attention(qt, kt, vt, **tkw)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), (qt, kt, vt))
    for name, got, want in zip("qkv", grads, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")


def test_bwd_reference_matches_autograd_of_forward_reference():
    """The plain backward formulas against autograd through a plain
    differentiable attention with the same mask (ragged s, GQA)."""
    b, s, hq, hkv = 2, 77, 4, 2
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(3, b, hq, hkv, s=s))
    seg = torch.ones(b, s, dtype=torch.int32)
    seg[1, 50:] = 0
    o, lse = fa.flash_attention_fwd_reference(q, k, v, seg)
    dq, dk, dv = fa.flash_attention_bwd_reference(q, k, v, seg, o, lse, do)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    mask = fa._flash_mask(seg)
    kf = kr.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
    vf = vr.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
    scores = (qr.transpose(1, 2) @ kf.transpose(-1, -2)) / np.sqrt(D)
    probs = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
    out = (probs @ vf).transpose(1, 2)
    want = torch.autograd.grad((out * do).sum(), (qr, kr, vr))
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, ref, atol=GRAD_TOL, rtol=GRAD_TOL)


def test_cpu_tensors_leave_the_launch_counters_at_zero():
    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [c.launches for c in counters]
    q, k, v, _ = (torch.from_numpy(x).requires_grad_() for x in _inputs(1, 1, 4, 2, s=64))
    out = port_attention.attention(q, k, v, impl="flash")
    out.sum().backward()
    assert q.grad is not None and k.grad is not None
    assert [c.launches for c in counters] == before == [0, 0, 0]


def test_flash_attention_refuses_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 4, 24)
    with pytest.raises(ValueError, match="multiple of 16"):
        fa.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros(1, 8, 4, 32)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        fa.flash_attention(q, q[:, :, :3], q[:, :, :3])
    with pytest.raises(TypeError, match="bf16 or f32"):
        fa.flash_attention(q.half(), q[:, :, :2].half(), q[:, :, :2].half())
    with pytest.raises(ValueError, match="causal only"):
        port_attention.attention(q, q[:, :, :2], q[:, :, :2], impl="flash", causal=False)
    with pytest.raises(NotImplementedError, match="ring"):
        port_attention.attention(q, q[:, :, :2], q[:, :, :2], impl="ring")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_versions_on_the_card(dtype):
    """The three CUDA kernels against their plain versions on the card (ragged
    s, GQA, padding): f32 to the bands above; bf16 to the f32 band plus one
    bf16 ulp (2**-7 of the value), since both compute in f32 and round once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels have no CPU mode")
    dt = getattr(torch, dtype)
    b, s, hq, hkv, d = 2, 200, 8, 2, 64
    q, k, v, do = (torch.from_numpy(x).cuda().to(dt) for x in _inputs(5, b, hq, hkv, s=s, d=d))
    seg = torch.ones(b, s, dtype=torch.int32, device="cuda")
    seg[1, 150:] = 0
    counts = [c.launches for c in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)]
    o, lse = fa.flash_fwd(q, k, v, seg)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, seg)
    delta = fa.flash_delta(o_ref, do)
    dq = fa.flash_bwd_dq(q, k, v, seg, lse_ref, delta, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, seg, lse_ref, delta, do)
    torch.cuda.synchronize()
    dq_ref = fa.flash_bwd_dq_reference(q, k, v, seg, lse_ref, delta, do)
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(q, k, v, seg, lse_ref, delta, do)
    for got, ref, band in ((o, o_ref, FWD_TOL), (lse, lse_ref, FWD_TOL), (dq, dq_ref, GRAD_TOL),
                           (dk, dk_ref, GRAD_TOL), (dv, dv_ref, GRAD_TOL)):
        diff = (got.float() - ref.float()).abs()
        bound = band + (2.0**-7 * ref.float().abs() if got.dtype == torch.bfloat16 else 0.0)
        assert bool((diff <= bound).all()), f"max|d| {diff.max().item():.3e}"
    assert [c.launches for c in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)] == [
        n + 1 for n in counts]
