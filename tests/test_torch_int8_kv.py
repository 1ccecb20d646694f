"""The port's int8 paged KV pool against the JAX package's.

Every write sequence goes through both ``quantize_kv_write``s from the same
numpy inputs; the int8 codes must be bit-equal and the scales equal, and
``dequantize_kv_gather`` must agree exactly. The port rescales either one
block per token (the JAX formulation) or each written block once, plus a
repeated id and the null block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu.ops import int8 as jax_int8
from llm_fine_tune_distributed_tpu_torch.ops import int8 as torch_int8


@pytest.fixture(params=["per_token", "named_blocks"])
def touched(request):
    return request.param


class _Pools:
    """The same pool in both packages, written in lock step."""

    def __init__(self, touched="per_token", num_blocks=8, block_len=8, heads=2, head_dim=16):
        self.touched = touched
        shape = (num_blocks, block_len, heads, head_dim)
        self.jc = jnp.zeros(shape, jnp.int8)
        self.js = jnp.zeros((num_blocks, heads), jnp.float32)
        self.tc = torch.zeros(shape, dtype=torch.int8)
        self.ts = torch.zeros((num_blocks, heads), dtype=torch.float32)

    def write(self, blk, off, x):
        blk = np.asarray(blk, np.int32)
        off = np.asarray(off, np.int32)
        x = np.asarray(x, np.float32)
        self.jc, self.js = jax_int8.quantize_kv_write(
            self.jc, self.js, jnp.asarray(blk), jnp.asarray(off), jnp.asarray(x)
        )
        named = blk
        if self.touched == "named_blocks":
            ids = np.unique(blk)
            named = np.concatenate([ids, ids[:1], [0]])
        torch_int8.quantize_kv_write(
            self.tc, self.ts, torch.from_numpy(blk), torch.from_numpy(off), torch.from_numpy(x),
            torch.from_numpy(named),
        )
        self.check()

    def check(self):
        np.testing.assert_array_equal(self.tc.numpy(), np.asarray(self.jc))
        np.testing.assert_array_equal(self.ts.numpy(), np.asarray(self.js))


def _rows(rng, b, s, heads=2, d=16, scale=1.0):
    return rng.normal(size=(b, s, heads, d)) * scale


def test_prefill_chunk_spanning_blocks_with_duplicate_ids(touched):
    rng = np.random.default_rng(0)
    pools = _Pools(touched)
    # one row, 12 tokens over blocks 3 and 5: each id repeats within the call
    blk = [[3] * 8 + [5] * 4]
    off = [list(range(8)) + list(range(4))]
    pools.write(blk, off, _rows(rng, 1, 12))
    # two rows in one call, second row spanning three blocks
    blk = [[1] * 4 + [0] * 4, [2] * 2 + [4] * 6]
    off = [[0, 1, 2, 3, 0, 1, 2, 3], [6, 7, 0, 1, 2, 3, 4, 5]]
    pools.write(blk, off, _rows(rng, 2, 8))


def test_scale_growth_rescales_resident_codes_bit_equal(touched):
    rng = np.random.default_rng(1)
    pools = _Pools(touched)
    pools.write([[2] * 4], [[0, 1, 2, 3]], _rows(rng, 1, 4, scale=0.1))
    before = pools.tc[2].clone()
    # a larger write into the same block grows its scale and rescales
    pools.write([[2] * 4], [[4, 5, 6, 7]], _rows(rng, 1, 4, scale=10.0))
    assert not torch.equal(pools.tc[2, :4], before[:4])
    # a smaller write leaves the scale and the resident codes as they were
    frozen = pools.tc[2, :4].clone()
    pools.write([[2]], [[7]], _rows(rng, 1, 1, scale=0.01))
    torch.testing.assert_close(pools.tc[2, :4], frozen, rtol=0, atol=0)


def test_null_block_writes_stay_zero(touched):
    rng = np.random.default_rng(2)
    pools = _Pools(touched)
    pools.write([[0, 0, 1, 1]], [[0, 1, 0, 1]], _rows(rng, 1, 4, scale=7.5))
    assert int(pools.tc[0].abs().max()) == 0
    assert float(pools.ts[0].abs().max()) == 0.0
    assert float(pools.ts[1].min()) > 0.0


def test_single_token_decode_writes(touched):
    rng = np.random.default_rng(3)
    pools = _Pools(touched)
    pools.write([[1] * 5, [2] * 5], [list(range(5))] * 2, _rows(rng, 2, 5))
    for step in range(6):
        pos = 5 + step
        blk = [[1 if pos < 8 else 3], [0]]  # second row dead: null table
        pools.write(blk, [[pos % 8], [pos % 8]], _rows(rng, 2, 1, scale=1.0 + step))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_gather_exact(dtype):
    rng = np.random.default_rng(4)
    pools = _Pools()
    pools.write([[1] * 8 + [2] * 3], [list(range(8)) + [0, 1, 2]], _rows(rng, 1, 11))
    pools.write([[4] * 6], [list(range(6))], _rows(rng, 1, 6, scale=3.0))
    tables = np.asarray([[1, 2, 0], [4, 1, 0]], np.int32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    got = torch_int8.dequantize_kv_gather(pools.tc, pools.ts, torch.from_numpy(tables), td)
    ref = jax_int8.dequantize_kv_gather(pools.jc, pools.js, jnp.asarray(tables), jd)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    assert torch_int8.KV_QUANT_MODES == jax_int8.KV_QUANT_MODES
