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

from llm_fine_tune_distributed_tpu_torch.data.dataset import TokenizedExample
from llm_fine_tune_distributed_tpu_torch.data.packing import pack_examples
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


def _visible_tiles(segments, tile):
    """bool [b, n, n]: tile pairs that hold at least one visible (query, key)
    pair of the dense mask."""
    b, s = segments.shape
    n = -(-s // tile)
    mask = fa._flash_mask(segments)[:, 0]
    padded = torch.zeros(b, n * tile, n * tile, dtype=torch.bool)
    padded[:, :s, :s] = mask
    return padded.reshape(b, n, tile, n, tile).any(dim=4).any(dim=2)


@pytest.mark.parametrize("s,tile", [(256, 64), (200, 64), (77, 16), (130, 32)])
@pytest.mark.parametrize("kind", ["padding", "segments", "random"])
def test_tile_pairs_cover_every_visible_pair(kind, s, tile):
    """Every visible pair of the dense mask lies in a tile pair the kernels
    visit; s need not be a multiple of the tile."""
    b = 3
    if kind == "random":
        rng = np.random.default_rng(s + tile)
        seg = torch.from_numpy(np.sort(rng.integers(0, 4, (b, s)), axis=1).astype(np.int32))
        seg[1] = torch.from_numpy(rng.integers(0, 3, s).astype(np.int32))  # unsorted ids
    elif kind == "segments":
        seg = torch.from_numpy(np.ascontiguousarray(_segments(kind, b)[:, :s]))
    else:
        seg = torch.from_numpy((np.arange(s)[None, :] < np.asarray([s, s // 2, 9])[:, None]).astype(np.int32))
    visited = fa.flash_tile_pairs(seg, tile)
    n = -(-s // tile)
    assert visited.shape == (b, n, n) and visited.dtype == torch.bool
    needed = _visible_tiles(seg, tile)
    assert bool((needed <= visited).all()), "a tile pair with a visible pair is skipped"
    assert not bool(visited.triu(1).any()), "a tile pair above the causal limit is visited"
    assert bool(visited.diagonal(dim1=1, dim2=2).all()), "a diagonal tile is skipped"


def test_tile_pairs_skip_pad_queries_against_real_key_tiles():
    """A tile of pad queries (segment 0) never visits a key tile of real
    tokens only; it does visit the key tile where the padding starts."""
    seg = torch.zeros(1, 1024, dtype=torch.int32)
    seg[0, :700] = 1  # real tiles 0-9, tile 10 mixed, tiles 11-15 padding
    visited = fa.flash_tile_pairs(seg)[0]
    assert not bool(visited[11:, :10].any())
    assert bool(visited[11:, 10].all()) and bool(visited[10, :11].all())
    assert int(visited.sum()) == 136 - 50


def test_tile_pairs_pinned_for_the_smoke_ragged_batch():
    """The ragged batch of chip_smoke.py phase 7 (b 8, s 1024, lengths
    1024 ... 1): 848 tile pairs visited of the 1088 under the causal limit."""
    lengths = (1024, 1000, 700, 513, 512, 300, 129, 1)
    seg = (torch.arange(1024)[None, :] < torch.tensor(lengths)[:, None]).to(torch.int32)
    visited = fa.flash_tile_pairs(seg)
    assert visited.sum(dim=(1, 2)).tolist() == [136, 136, 86, 80, 72, 92, 110, 136]
    assert int(visited.sum()) == 848 and 8 * 16 * 17 // 2 == 1088


def _packed_segments(rows, s):
    """int32 [len(rows), s] segment ids that ``data/packing.pack_examples``
    gives examples of these lengths, first-fit into rows of s."""
    examples = [TokenizedExample(input_ids=np.zeros(s, np.int32), loss_mask=np.zeros(s, np.float32),
                                 length=n) for n in rows]
    return torch.from_numpy(pack_examples(examples, s)["segment_ids"])


def _skipping_attention(q, k, v, seg, tile):
    """Plain attention that computes only the tile pairs
    ``flash_tile_pairs`` keeps, as the tensor-core kernels walk them: the
    dense mask further restricted to the visited pairs. (O, LSE)."""
    b, s, hq, d = q.shape
    groups = hq // k.shape[2]
    visited = fa.flash_tile_pairs(seg, tile)
    tiles = visited.repeat_interleave(tile, 1).repeat_interleave(tile, 2)[:, :s, :s]
    mask = fa._flash_mask(seg)[:, 0] & tiles
    kh = k.transpose(1, 2).repeat_interleave(groups, 1)
    vh = v.transpose(1, 2).repeat_interleave(groups, 1)
    scores = (q.transpose(1, 2) @ kh.transpose(-1, -2)) / np.sqrt(d)
    scores = scores.masked_fill(~mask[:, None], float("-inf"))
    return (torch.softmax(scores, -1) @ vh).transpose(1, 2), torch.logsumexp(scores, -1)


def test_segment_range_skipping_is_exact_on_packed_rows():
    """On rows the packer fills with several segments and a pad tail, the
    plain attention computed over the visited tile pairs only gives the O,
    LSE and gradients of the unskipped mask; the visited pairs are fewer
    than the causal ones by the block-diagonal share."""
    s, tile, hq, hkv = 256, 64, 4, 2
    seg = _packed_segments([100, 70, 40, 90, 50, 150, 30, 20, 60], s)
    b = seg.shape[0]
    assert b >= 3 and int(seg.max()) >= 3 and bool((seg == 0).any())
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(11, b, hq, hkv, s=s))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o_skip, lse_skip = _skipping_attention(*leaves, seg, tile)
    grads_skip = torch.autograd.grad(o_skip, leaves, do)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, seg)
    assert (o_skip.detach() - o_ref).abs().max() <= FWD_TOL
    assert (lse_skip.detach() - lse_ref).abs().max() <= FWD_TOL
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    grads_ref = torch.autograd.grad(fa.flash_attention_reference(*leaves, segment_ids=seg),
                                    leaves, do)
    for name, got, want in zip(("dq", "dk", "dv"), grads_skip, grads_ref):
        assert (got - want).abs().max() <= GRAD_TOL, name
    n = s // tile
    visited = fa.flash_tile_pairs(seg, tile)
    causal = b * n * (n + 1) // 2
    assert int(visited.sum()) < causal
    # tile-aligned segments: each segment (the pad tail included) visits
    # exactly its own lower triangle of tile pairs, the block-diagonal count
    aligned = _packed_segments([64, 128, 192], s)  # rows 64 + 128 + pad 64, 192 + pad 64
    assert aligned[0].unique().tolist() == [0, 1, 2] and aligned[1].unique().tolist() == [0, 1]
    per_row = fa.flash_tile_pairs(aligned, tile).sum(dim=(1, 2)).tolist()
    assert per_row == [1 + 3 + 1, 6 + 1] and n * (n + 1) // 2 == 10


def test_tile_visits_are_counted_only_by_the_tensor_core_kernels():
    """``tile_visits`` asks the bf16 kernels on the card to count their own
    walk; on the CPU (the plain versions) and for f32 it is refused, and a
    counter of the wrong shape is refused by name."""
    b, s, hq, hkv, d = 1, 130, 4, 2, 16
    seg = torch.ones(b, s, dtype=torch.int32)
    visits = torch.zeros(b, 3, 3, dtype=torch.int32)
    stats = torch.zeros(b, hq, s)
    for dt in (torch.bfloat16, torch.float32):
        q, k = torch.zeros(b, s, hq, d, dtype=dt), torch.zeros(b, s, hkv, d, dtype=dt)
        with pytest.raises(ValueError, match="on the card only"):
            fa.flash_fwd(q, k, k, seg, tile_visits=visits)
        with pytest.raises(ValueError, match="on the card only"):
            fa.flash_bwd_dq(q, k, k, seg, stats, stats, q, tile_visits=visits)
        with pytest.raises(ValueError, match="on the card only"):
            fa.flash_bwd_dkv(q, k, k, seg, stats, stats, q, tile_visits=visits)
    fa._check_tile_visits(q, None)


def test_tensor_core_layout_check_names_the_constraint():
    """The bf16 kernels copy rows in 16-byte chunks: a stride that is no
    multiple of 8 elements, or a base off 16 bytes, is refused by name."""
    fused = torch.zeros(1, 8, 4 * 20 + 4, dtype=torch.bfloat16)
    q = fused[..., : 4 * 20].view(1, 8, 4, 20)[..., :16]  # head stride 20
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        fa._check_tensor_core_layout(q)
    buf = torch.zeros(8 * 4 * 16 + 1, dtype=torch.bfloat16)
    shifted = buf[1:].view(1, 8, 4, 16)  # 2 bytes off the allocation
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fa._check_tensor_core_layout(shifted)
    fa._check_tensor_core_layout(torch.zeros(1, 8, 4, 16, dtype=torch.bfloat16))


def _sdpa_bf16(q, k, v, do, seg):
    """``scaled_dot_product_attention`` in bf16 with the same boolean mask:
    (O, dq, dk, dv) in the port's layout, dk/dv summed over each kv head's
    query group (the yardstick of the bf16 rule; the port never calls it)."""
    import torch.nn.functional as F

    b, s, hq, d = q.shape
    hkv = k.shape[2]
    groups = hq // hkv
    mask = fa._flash_mask(seg)
    qh = q.transpose(1, 2).detach().requires_grad_()
    kh = k.transpose(1, 2).repeat_interleave(groups, dim=1).detach().requires_grad_()
    vh = v.transpose(1, 2).repeat_interleave(groups, dim=1).detach().requires_grad_()
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    gq, gk, gv = torch.autograd.grad(out, (qh, kh, vh), do.transpose(1, 2))
    fold = lambda x: x.float().reshape(b, hkv, groups, s, d).sum(2).transpose(1, 2)  # noqa: E731
    return out.transpose(1, 2).float(), gq.transpose(1, 2).float(), fold(gk), fold(gv)


def _fused_views(x_q, x_k, x_v):
    """q, k, v as strided views of one fused [b, s, (hq + 2 hkv) d] tensor,
    as a fused projection gives them."""
    b, s, hq, d = x_q.shape
    hkv = x_k.shape[2]
    fused = torch.cat([x_q.reshape(b, s, -1), x_k.reshape(b, s, -1), x_v.reshape(b, s, -1)], dim=-1)
    q = fused[..., : hq * d].view(b, s, hq, d)
    k = fused[..., hq * d: (hq + hkv) * d].view(b, s, hkv, d)
    v = fused[..., (hq + hkv) * d:].view(b, s, hkv, d)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(200, 64), (200, 128), (1024, 64), (1024, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_versions_on_the_card(dtype, s, d):
    """The three CUDA kernels on the card (ragged s, GQA, packed segments with
    a pad tail, q/k/v strided views of a fused tensor). f32 (the CUDA-core
    kernels): each against its plain version to the bands above. bf16 (the
    tensor-core kernels, which round P and dS to bf16): O, dq, dk and dv
    within 2x the error of SDPA in bf16 plus 1e-5 of the f32 truth (the
    plain version on the inputs upcast), over the tensor and row by row,
    LSE within 1e-4 of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels have no CPU mode")
    dt = getattr(torch, dtype)
    b, hq, hkv = 2, 8, 2
    q, k, v, do = (torch.from_numpy(x).cuda().to(dt) for x in _inputs(5, b, hq, hkv, s=s, d=d))
    q, k, v = _fused_views(q, k, v)
    seg = torch.from_numpy(np.ascontiguousarray(np.resize(_segments("segments", b), (b, s)))).cuda()
    seg[1, s - s // 5:] = 0
    counts = [c.launches for c in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)]
    o, lse = fa.flash_fwd(q, k, v, seg)
    delta = fa.flash_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, seg, lse, delta, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, seg, lse, delta, do)
    torch.cuda.synchronize()
    assert [c.launches for c in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)] == [
        n + 1 for n in counts]
    if dt == torch.float32:
        o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, seg)
        dq_ref = fa.flash_bwd_dq_reference(q, k, v, seg, lse, delta, do)
        dk_ref, dv_ref = fa.flash_bwd_dkv_reference(q, k, v, seg, lse, delta, do)
        for name, got, ref, band in (("o", o, o_ref, FWD_TOL), ("lse", lse, lse_ref, FWD_TOL),
                                     ("dq", dq, dq_ref, GRAD_TOL), ("dk", dk, dk_ref, GRAD_TOL),
                                     ("dv", dv, dv_ref, GRAD_TOL)):
            err = (got - ref).abs().max().item()
            assert err <= band, f"{name} max|d| {err:.3e}"
        return
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    o32, lse32 = fa.flash_attention_fwd_reference(q32, k32, v32, seg)
    delta32 = fa.flash_delta(o32, do32)
    dq32 = fa.flash_bwd_dq_reference(q32, k32, v32, seg, lse32, delta32, do32)
    dk32, dv32 = fa.flash_bwd_dkv_reference(q32, k32, v32, seg, lse32, delta32, do32)
    o_sd, dq_sd, dk_sd, dv_sd = _sdpa_bf16(q, k, v, do, seg)
    assert (lse - lse32).abs().max().item() <= 1e-4
    for name, got, sdpa, truth in (("o", o, o_sd, o32), ("dq", dq, dq_sd, dq32),
                                   ("dk", dk, dk_sd, dk32), ("dv", dv, dv_sd, dv32)):
        err = (got.float() - truth).abs().max().item()
        limit = 2 * (sdpa - truth).abs().max().item() + 1e-5
        assert err <= limit, f"{name}: max|kernel - f32| {err:.3e} > 2 x SDPA's + 1e-5 = {limit:.3e}"
        # row by row (the d entries of one position and head), so that small
        # rows are held to their own scale: + half a bf16 ulp of the row's max
        row_err = (got.float() - truth).abs().amax(-1)
        row_limit = (2 * (sdpa - truth).abs().amax(-1) + 2.0**-8 * truth.abs().amax(-1) + 1e-5)
        over = int((row_err > row_limit).sum())
        assert over == 0, f"{name}: {over} rows beyond 2 x SDPA's error in the row + 2**-8 x max|row| + 1e-5"


@pytest.mark.cuda
@pytest.mark.parametrize("s", [200, 1024])
@pytest.mark.parametrize("kind", ["padding", "segments", "random"])
def test_tensor_core_kernels_count_the_tile_pairs_of_flash_tile_pairs_on_the_card(kind, s):
    """The bf16 forward, dq and dk/dv count every tile pair they compute, once
    per query head: pair by pair that is ``flash_tile_pairs`` x hq, so the
    kernels' own skip rule is the one the CPU tests hold to the dense mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels have no CPU mode")
    b, hq, hkv, d = 3, 8, 2, 64
    q, k, v, do = (torch.from_numpy(x).cuda().to(torch.bfloat16) for x in _inputs(9, b, hq, hkv, s=s, d=d))
    if kind == "random":
        rng = np.random.default_rng(s)
        seg = np.sort(rng.integers(0, 4, (b, s)), axis=1)
        seg[1] = rng.integers(0, 3, s)  # unsorted ids
    elif kind == "segments":
        seg = np.resize(_segments(kind, b), (b, s))
    else:
        seg = np.arange(s)[None, :] < np.asarray([s, s // 2, 9])[:, None]
    seg = torch.from_numpy(np.ascontiguousarray(seg, dtype=np.int32)).cuda()
    n = -(-s // fa.FLASH_TILE)
    fwd_visits = torch.zeros(b, n, n, dtype=torch.int32, device="cuda")
    dq_visits = torch.zeros_like(fwd_visits)
    dkv_visits = torch.zeros_like(fwd_visits)
    o, lse = fa.flash_fwd(q, k, v, seg, tile_visits=fwd_visits)
    delta = fa.flash_delta(o, do)
    fa.flash_bwd_dq(q, k, v, seg, lse, delta, do, tile_visits=dq_visits)
    fa.flash_bwd_dkv(q, k, v, seg, lse, delta, do, tile_visits=dkv_visits)
    predicted = fa.flash_tile_pairs(seg.cpu()).to(torch.int32) * hq
    assert torch.equal(fwd_visits.cpu(), predicted)
    assert torch.equal(dq_visits.cpu(), predicted)
    assert torch.equal(dkv_visits.cpu(), predicted)


@pytest.mark.cuda
def test_packed_rows_through_the_kernels_match_plain_on_the_card():
    """Rows the packer fills (several segments, a pad tail) at the model's
    attention shape: the f32 kernels' O and gradients through the training
    path's autograd function against the plain versions', and the bf16
    kernels' own tile-pair count against ``flash_tile_pairs``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels have no CPU mode")
    s, hq, hkv, d = 1024, 16, 4, 128
    seg = _packed_segments([300, 250, 280, 200, 310, 330, 120, 290, 260, 180, 350], s).cuda()
    b = seg.shape[0]
    q, k, v, do = (torch.from_numpy(x).cuda() for x in _inputs(13, b, hq, hkv, s=s, d=d))
    out = {}
    for name, fn in (("kernel", fa.flash_attention), ("plain", fa.flash_attention_reference)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fn(*leaves, segment_ids=seg)
        out[name] = (o.detach(), *torch.autograd.grad(o, leaves, do))
    for name, got, want, band in zip(("o", "dq", "dk", "dv"), out["kernel"], out["plain"],
                                     (FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        assert (got - want).abs().max().item() <= band, name
    n = s // fa.FLASH_TILE
    visits = torch.zeros(b, n, n, dtype=torch.int32, device="cuda")
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    fa.flash_fwd(qb, kb, vb, seg, tile_visits=visits)
    predicted = fa.flash_tile_pairs(seg.cpu()).to(torch.int32) * hq
    assert torch.equal(visits.cpu(), predicted)
    assert int(predicted.sum()) < b * n * (n + 1) // 2 * hq


@pytest.mark.cuda
def test_tensor_core_kernels_refuse_a_misaligned_stride_on_the_card():
    """A bf16 CUDA tensor the tensor-core kernels cannot copy raises; it never
    falls back to another path, and no launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels have no CPU mode")
    b, s, hq, hkv, d = 1, 64, 4, 2, 16
    fused = torch.zeros(b, s, (hq + 2 * hkv) * d + 4, dtype=torch.bfloat16, device="cuda")
    q = fused[..., : hq * d].view(b, s, hq, d)  # position stride (hq + 2 hkv) d + 4
    k = torch.zeros(b, s, hkv, d, dtype=torch.bfloat16, device="cuda")
    seg = torch.ones(b, s, dtype=torch.int32, device="cuda")
    stats = torch.zeros(b, hq, s, device="cuda")
    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    counts = [c.launches for c in counters]
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        fa.flash_fwd(q, k, k, seg)
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        fa.flash_bwd_dq(q, k, k, seg, stats, stats, q)
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        fa.flash_bwd_dkv(q, k, k, seg, stats, stats, q)
    assert [c.launches for c in counters] == counts
