"""The paged decode attention's plain version, and the plain version of the
kernel's split-and-merge, against the JAX package's Pallas kernel
(``pl.pallas_call(interpret=True)`` on the CPU); the wrapper's routing and
checks, and the split length it picks from host shapes.

Tolerance 1e-5: both compute in f32 and differ only in summation order (the
band the JAX package pins between its kernel and its XLA reference).

JAX is imported inside the test that needs it, so the card-only test runs on
a machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_paged_decode.py``.
"""

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.ops import flash_attention as fa
from llm_fine_tune_distributed_tpu_torch.ops.flash_attention import (
    paged_decode_attention,
    paged_decode_attention_reference,
    paged_decode_split_len,
    paged_decode_split_reference,
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


def _split_case(groups, hkv, d, L):
    """Rows of lengths 0, 1, L, L+1, a dead row (null table) whose stale
    length is above nb * L, and a long row; rows 1, 3 and 5 share block 1,
    rows 3 and 5 block 3 too (the prefix cache's layout)."""
    nb = 4
    return dict(
        b=6, hkv=hkv, groups=groups, d=d, L=L, nb=nb, num_blocks=8,
        lengths=[0, 1, L, L + 1, nb * L + 5, nb * L - 3],
        tables=[[0, 0, 0, 0], [1, 0, 0, 0], [2, 0, 0, 0], [1, 3, 0, 0], [0, 0, 0, 0],
                [1, 3, 4, 5]],
    )


SPLIT_CASES = {
    "g1": _split_case(groups=1, hkv=2, d=16, L=16),
    "g4": _split_case(groups=4, hkv=1, d=32, L=16),
    "g16": _split_case(groups=16, hkv=1, d=16, L=8),
}
# positions per split: one pool block, and a length that divides neither the
# blocks nor the rows (so a split straddles blocks and the last one is short)
SPLITS = {"one_block": lambda L: L, "ragged": lambda L: L + L // 2}


def _split_inputs(name):
    q, k, v, ks, vs, tables, lengths = _case(4, **SPLIT_CASES[name])
    return [torch.from_numpy(a) for a in (q, k, v, ks, vs, tables)], torch.from_numpy(lengths)


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_reference_matches_plain_version(name, split):
    """The kernel's split-and-merge arithmetic against the unsplit plain
    version: splits with no visible position, empty and dead rows and shared
    blocks change nothing beyond f32 rounding."""
    args, lengths = _split_inputs(name)
    split_len = SPLITS[split](SPLIT_CASES[name]["L"])
    got = paged_decode_split_reference(*args, lengths=lengths, split_len=split_len)
    want = paged_decode_attention_reference(*args, lengths=lengths)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    assert not got[0].any(), "a row of length 0 gives zeros"
    assert not got[4].any(), "a dead row on the null table gives zeros"


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_reference_matches_jax_kernel_interpret(name, split):
    jnp = pytest.importorskip("jax.numpy")
    from llm_fine_tune_distributed_tpu.ops.flash_attention import (
        paged_decode_attention as jax_paged_decode_attention,
    )

    args, lengths = _split_inputs(name)
    ref = jax_paged_decode_attention(
        *(jnp.asarray(a.numpy()) for a in args), lengths=jnp.asarray(lengths.numpy()),
        interpret=True,
    )
    split_len = SPLITS[split](SPLIT_CASES[name]["L"])
    got = paged_decode_split_reference(*args, lengths=lengths, split_len=split_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape, want", [
    ((8, 4, 16, 256), 256),  # the smoke's full shape: 512 blocks
    ((8, 4, 8, 256), 256),   # its live shape: 256 blocks
    ((1, 4, 16, 256), 128),  # one row of 4096: 128 blocks
    ((1, 1, 16, 256), 64),   # one kv head: 64 blocks, the shortest split
    ((2, 1, 3, 16), 64),     # fewer positions than one split: one split
])
def test_split_len_fills_the_card_from_host_shapes(shape, want):
    """The split follows b, hkv, nb and L (never the lengths): 256
    positions, halved down to 64 while the grid would fill at most half of
    a 132-SM card."""
    b, hkv, nb, L = shape
    split = paged_decode_split_len(b, hkv, nb, L, 132)
    assert split == want
    assert split % 64 == 0 and split <= 256


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


def test_launch_count_is_exact_under_threads():
    """The replicas of a fleet launch the kernel from one worker thread
    each: the count loses no increment when more threads than cores (at
    least 8) add at once under a 1 us switch interval (a bare ``+= 1`` on
    the attribute is a read-modify-write that can)."""
    import os
    import sys
    import threading

    n = max(8, (os.cpu_count() or 1) + 1)
    start = fa.paged_decode_attention.launches
    go = threading.Barrier(n)

    def count():
        go.wait()
        for _ in range(5000):
            fa._count_launch()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=count) for _ in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert fa.paged_decode_attention.launches - start == n * 5000
    finally:
        sys.setswitchinterval(interval)
        fa.paged_decode_attention.launches = start


def test_ticket_table_is_built_once_under_threads():
    """Eight workers asking for one (device, stream)'s tickets at once get
    one table between them."""
    import threading

    key_stream = 0x5EED  # a stream handle no launch uses
    go = threading.Barrier(8)
    got = []

    def ask():
        go.wait()
        got.append(fa._tickets(torch.device("cpu"), key_stream, 64))

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    try:
        assert not any(t.is_alive() for t in threads)
        assert len({id(t) for t in got}) == 1 and not got[0].any()
    finally:
        fa._TICKETS.pop((None, key_stream), None)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs an NVIDIA GPU")
    return torch.device("cuda")


# SmolLM3's geometry on the card (G 4, d 128, L 256): lengths 1, 256, 257
# and 4096 (16 blocks, every split merged), and a dead row on the null table
# with a stale length; other groupings and head dims
CARD_CASES = {
    "smollm3": dict(b=5, hkv=4, groups=4, d=128, L=256, nb=16, num_blocks=21,
                    lengths=[1, 256, 257, 4096, 5000],
                    tables=[[1] + [0] * 15, [2] + [0] * 15, [3, 4] + [0] * 14,
                            list(range(5, 21)), [0] * 16]),
    # the logit pass's head groups (G 16 at d 64) and a padded head count (G 3)
    "g16_d64": dict(b=2, hkv=1, groups=16, d=64, L=16, nb=3, num_blocks=5,
                    lengths=[40, 17], tables=[[1, 2, 3], [4, 2, 0]]),
    "g3_d128": dict(b=2, hkv=2, groups=3, d=128, L=32, nb=4, num_blocks=7,
                    lengths=[100, 33], tables=[[1, 2, 3, 4], [5, 6, 0, 0]]),
    # shared memory near and above the 48 KB a launch gets without asking
    "g16_d112": dict(b=1, hkv=1, groups=16, d=112, L=16, nb=2, num_blocks=3,
                     lengths=[30], tables=[[1, 2]]),
    "g16_d256": dict(b=1, hkv=2, groups=16, d=256, L=16, nb=2, num_blocks=3,
                     lengths=[25], tables=[[2, 1]]),
}


def _card_case(name, seed, cuda, dtype):
    cases = {**CASES, **CARD_CASES}
    q, k, v, ks, vs, tables, lengths = (
        torch.from_numpy(a).to(cuda) for a in _case(seed, **cases[name])
    )
    return (q.to(dtype), k, v, ks, vs, tables), lengths


def _tolerance(dtype):
    return (TOL, TOL) if dtype == torch.float32 else (1e-5, 2.0**-7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(cuda, dtype):
    """On the card: the kernel against its plain version on the same inputs,
    f32 to 1e-5; in bf16 both round one f32 result, so they differ by at
    most one bf16 ulp (rtol 2**-7, atol 1e-5 near zero). One launch per
    call, and the merge's tickets are back at zero after it."""
    atol, rtol = _tolerance(dtype)
    for name in sorted(CASES) + sorted(CARD_CASES):
        args, lengths = _card_case(name, 3, cuda, dtype)
        before = paged_decode_attention.launches
        got = paged_decode_attention(*args, lengths=lengths)
        torch.cuda.synchronize()
        assert paged_decode_attention.launches == before + 1
        want = paged_decode_attention_reference(*args, lengths=lengths)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
        assert all(not t.any() for t in fa._TICKETS.values()), "tickets left nonzero"
        if name == "smollm3":
            assert not got[-1].float().any(), "the dead row gives zeros"


@pytest.mark.cuda
@pytest.mark.parametrize("split_len", [64, 128, 256])
def test_cuda_kernel_matches_plain_version_at_every_split_len(cuda, split_len):
    """Each split length the wrapper's rule can pick, at SmolLM3's geometry,
    merged in the same launch, bf16 and f32; several launches each, since a
    race in the merge need not show in one."""
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = _tolerance(dtype)
        args, lengths = _card_case("smollm3", 5, cuda, dtype)
        want = paged_decode_attention_reference(*args, lengths=lengths)
        for _ in range(8):
            got = fa._paged_decode_launch(*args, lengths, None, split_len)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
            assert all(not t.any() for t in fa._TICKETS.values()), "tickets left nonzero"
