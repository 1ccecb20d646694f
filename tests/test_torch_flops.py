"""The port's analytic work counts and roofline gauges
(``observe/flops.py``, ``observe/profiler.py``) against the JAX package's:
the train-step FLOP model equal on ``tiny`` and ``smollm3_3b``;
``decode_tick_cost`` against a hand count on ``tiny`` (dead rows left out,
a verify row with drafts), in isolation, summed over dispatches by
``DecodeWork`` and as the slot engines sum it over their timed ticks;
``utilization_from_cost`` equal to the JAX function; ``device_peak_specs``
(0, 0) on the CPU and the H100 rows for their names."""

import math

import pytest
import torch

from llm_fine_tune_distributed_tpu.models import configs as jax_configs
from llm_fine_tune_distributed_tpu.observe import flops as jax_flops
from llm_fine_tune_distributed_tpu.observe import xla as jax_xla
from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.observe import flops, profiler

PRESETS = ("tiny", "smollm3_3b")
# tiny: h 64, 4 heads of 16, 2 KV heads, intermediate 128, 4 layers, vocab
# 512. One query at P attended positions: per layer 2 x (64*64 + 2*64*32 +
# 64*64 + 3*64*128) = 73728 projection FLOPs + 2 x 2*P*4*16 = 256 P
# attention FLOPs; 4 layers and the 2*64*512 unembed give 360448 + 1024 P
TINY_QUERY_FLOPS, TINY_FLOPS_PER_POSITION = 360448, 1024
# one position's K and V over the 4 layers: 4 x 2 x 2 heads x 16 elements
TINY_KV_ELEMENTS = 256
TINY_LOGIT_BYTES = 512 * 4  # one query's f32 logits
TINY_SCALE_BYTES = 4 * 2 * 2 * 4  # one block's f32 K and V scales, 4 layers x 2 heads


@pytest.mark.parametrize("preset", PRESETS)
def test_train_flop_model_matches_jax(preset):
    mine, theirs = get_preset(preset), jax_configs.get_preset(preset)
    for seq in (1, 128, 1024, 4096):
        assert flops.layer_matmul_flops_per_token(mine, seq) == \
            jax_flops.layer_matmul_flops_per_token(theirs, seq)
        for frozen in (0, 2, mine.num_layers, mine.num_layers + 5):
            for remat in (True, False):
                assert flops.train_step_flop_split(mine, seq, frozen, remat) == \
                    jax_flops.train_step_flop_split(theirs, seq, frozen, remat)


def test_decode_tick_cost_against_a_hand_count():
    """Two live rows (the dead ones are simply not passed): a plain row at
    20 positions and a verify row at 33 positions with 4 drafts."""
    mc = get_preset("tiny")
    positions, queries = [20, 33], [1, 5]
    want_flops = sum(q * (TINY_QUERY_FLOPS + TINY_FLOPS_PER_POSITION * p)
                     for p, q in zip(positions, queries))
    assert want_flops == 380928 + 5 * 394240
    got = flops.decode_tick_cost(mc, positions, queries, weight_bytes=1000, kv_itemsize=4)
    # dense f32 cache: 53 positions read, 6 written, 6 queries' logits
    assert got == (want_flops, 1000 + (53 + 6) * TINY_KV_ELEMENTS * 4 + 6 * TINY_LOGIT_BYTES)
    # int8 pool of 16-position blocks: 2 + 3 blocks' scales read besides
    got = flops.decode_tick_cost(mc, positions, queries, weight_bytes=1000, kv_itemsize=1,
                                 block_len=16, scale_itemsize=4)
    assert got == (want_flops, 1000 + 59 * TINY_KV_ELEMENTS + 6 * TINY_LOGIT_BYTES
                   + 5 * TINY_SCALE_BYTES)
    # the FLOPs are the JAX model's per-token layer count at each row's length
    jmc = jax_configs.get_preset("tiny")
    assert got[0] == sum(q * (mc.num_layers * jax_flops.layer_matmul_flops_per_token(jmc, p)
                              + 2 * mc.hidden_size * mc.vocab_size)
                         for p, q in zip(positions, queries))
    assert flops.decode_tick_cost(mc, [], [], weight_bytes=7, kv_itemsize=2) == (0.0, 7.0)


@pytest.fixture(scope="module")
def gen():
    mc = get_preset("tiny")
    params = tf.init_params(mc, seed=0, device="cpu", dtype=torch.float32)
    return Generator(params, mc, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                     eos_token_ids=[], device="cpu")


def test_decode_work_sums_the_dispatches_costs():
    """``DecodeWork`` over three dispatches (a plain tick, a verify, an
    empty tick) gives the sum of their ``decode_tick_cost``s, on a dense
    cache and on an int8 pool, and the summed seconds."""
    mc = get_preset("tiny")
    dispatches = [([20, 33], [1, 5]), ([17], [1]), ([], [])]
    for kv_itemsize, block_len, scale_itemsize in ((4, 0, 0), (1, 16, 4)):
        work = flops.DecodeWork()
        want = [0.0, 0.0]
        for i, (positions, queries) in enumerate(dispatches):
            work.add(positions, queries, block_len, seconds=0.25 * (i + 1))
            one = flops.decode_tick_cost(mc, positions, queries, weight_bytes=1000,
                                         kv_itemsize=kv_itemsize, block_len=block_len,
                                         scale_itemsize=scale_itemsize)
            want = [want[0] + one[0], want[1] + one[1]]
        assert work.sums[0] == 3 and work.sums[-1] == 1.5
        assert flops.decode_work_cost(mc, work.sums, weight_bytes=1000, kv_itemsize=kv_itemsize,
                                      scale_itemsize=scale_itemsize) == tuple(want)


@pytest.mark.parametrize("kind", ["continuous", "paged_int8"])
def test_engine_records_the_last_dispatch_of_its_live_rows(gen, kind):
    """One request on a 4-slot engine (3 dead rows): its first token comes
    from prefill, and each of its 5 decode ticks fed one query with the row
    attending plen + 1 ... plen + 5 positions (the last dispatch is the
    latest of them). ``decode_cost`` sums the hand count over those ticks
    with the engine's own weight bytes, beside the ticks' count and time
    that ``decode_tick_s`` holds."""
    prompt = list(b"the quick brown fox")
    if kind == "continuous":
        eng = ContinuousBatchingEngine(gen, slots=4, buf_len=96, prompt_bucket=16)
    else:
        eng = PagedContinuousBatchingEngine(gen, slots=4, buf_len=96, prompt_bucket=16,
                                            block_len=16, prefill_chunk=32, kv_quant="int8")
    try:
        assert eng.decode_cost() == (0, 0.0, 0.0, 0.0)  # nothing dispatched yet
        out = eng.submit(prompt, GenerationConfig(max_new_tokens=6, do_sample=False), timeout=240)
        assert len(out) == 6
        weight_bytes = eng.memory_breakdown()["weight_bytes"]
        ps = [len(prompt) + k for k in range(1, 6)]
        assert eng._dispatched == ([ps[-1]], [1], 0)  # no adapter gathered
        ticks, seconds, got_flops, got_bytes = eng.decode_cost()
        _, hist_ticks, hist_seconds = eng.stats.hist["decode_tick_s"]._state()
    finally:
        eng.close()
    assert weight_bytes == sum(t.nbytes for t in gen.params.values())
    assert ticks == hist_ticks == 5 and seconds == pytest.approx(hist_seconds, rel=1e-12)
    kv = sum(p + 1 for p in ps) * TINY_KV_ELEMENTS * (4 if kind == "continuous" else 1)
    scales = sum(math.ceil(p / 16) for p in ps) * TINY_SCALE_BYTES if kind == "paged_int8" else 0
    assert (got_flops, got_bytes) == (
        sum(TINY_QUERY_FLOPS + TINY_FLOPS_PER_POSITION * p for p in ps),
        5 * weight_bytes + kv + 5 * TINY_LOGIT_BYTES + scales)


def test_utilization_from_cost_matches_jax():
    cases = [(1e12, 3e9, 0.05, 989e12, 3.35e12), (0.0, 3e9, 0.05, 989e12, 3.35e12),
             (1e12, 3e9, 0.0, 989e12, 3.35e12), (1e12, 3e9, 0.05, 0.0, 0.0),
             (1e17, 1e15, 0.05, 989e12, 3.35e12), (-1.0, -1.0, 0.05, 1.0, 1.0),
             (26e9, 6.4e9, 0.08, 989e12, 3.35e12)]
    for case in cases:
        assert profiler.utilization_from_cost(*case) == jax_xla.utilization_from_cost(*case)
    assert profiler.utilization_from_cost(*cases[4]) == (1.0, 1.0)  # clamped


def test_device_peak_specs(monkeypatch):
    for var in ("SERVE_PEAK_FLOPS", "SERVE_PEAK_HBM_BPS"):
        monkeypatch.delenv(var, raising=False)
    assert profiler.device_peak_specs("cpu") == (0.0, 0.0)
    assert profiler.device_peak_specs(torch.device("cpu")) == (0.0, 0.0)
    assert profiler.device_memory_report() == {}  # no GPU here, as the JAX CPU report
    rows = {"NVIDIA H100 80GB HBM3": (989e12, 3.35e12), "NVIDIA H100 PCIe": (756e12, 2.0e12),
            "NVIDIA H100 NVL": (835e12, 3.9e12), "NVIDIA A100-SXM4-80GB": (0.0, 0.0),
            "cpu": (0.0, 0.0)}
    for name, want in rows.items():
        assert profiler.peaks_for_name(name) == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda index=None: "NVIDIA H100 80GB HBM3")
    assert profiler.device_peak_specs() == profiler.device_peak_specs("cuda:0") == (989e12, 3.35e12)
    assert profiler.device_peak_specs("cpu") == (0.0, 0.0)
    # the overrides read the JAX package's variables, with its precedence
    monkeypatch.setenv("SERVE_PEAK_FLOPS", "5e14")
    assert profiler.device_peak_specs() == jax_xla.device_peak_specs() == (5e14, 0.0)
