"""NF4 quantization and QLoRA in the port (``ops/nf4.py``,
``parallel/qlora.py``, the NF4 branch of ``models/transformer._linear``,
``freeze_strategy="qlora"``) against the JAX package, case for case with
``tests/test_nf4.py``, on the same numpy inputs:

- the packed codes, the absmax and its double quantization equal the JAX
  ``quantize_nf4``'s bit for bit (single and double quant, an exact-midpoint
  case pinning the tie to the lower code, an all-zero block), and unpacking
  inverts the packing with every nibble in 0..15;
- the dequantized weights agree with the JAX ones to 1e-6, within the
  codebook's error bound of the originals;
- ``nf4_matmul`` equals ``x @ dequantize`` and its gradient, and keeps
  only the codes for its backward;
- ``quantize_frozen`` / ``dequantize_frozen`` / ``quantized_fraction`` equal
  the JAX functions' leaf for leaf, and a stacked leaf raises naming the
  JAX functions;
- the QLoRA forward agrees with the JAX one to 1e-5, and with the forward
  over the dequantized weights;
- a QLoRA run's history is within 1e-4 of the JAX trainer's (the adapters'
  A carried across), and ``best_model/`` holds plain kernels.

Not mirrored: the Pallas kernel's retirement (the port has no such
kernel), and the layered, stacked and pipe layouts (MoE and pipeline
parallelism are not ported).

JAX is imported inside the tests that need it, so the card-only case runs on
a machine without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_nf4.py``.
"""

import os

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.ops import nf4
from llm_fine_tune_distributed_tpu_torch.parallel import qlora


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _w(k, n, seed, heavy=False):
    rng = np.random.RandomState(seed)
    w = rng.randn(k, n).astype(np.float32)
    if heavy:
        w = (w * rng.gamma(2.0, 1.0, (k, n))).astype(np.float32)
    return w


def _midpoint_weight():
    """Column 0 of block 0 holds every midpoint exactly (block absmax 1, so
    the normalized value is the midpoint itself) and its negation; block 1
    of column 1 is all zero."""
    w = _w(128, 8, 5) * 0.1
    w[0, 0] = 1.0
    w[1:16, 0] = nf4._MIDS
    w[16:31, 0] = -nf4._MIDS
    w[64:, 1] = 0.0
    return w


def _assert_equal_to_jax(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        g = got[k].numpy()
        assert g.dtype == v.dtype and g.shape == v.shape, k
        np.testing.assert_array_equal(g, v, err_msg=k)


@pytest.mark.parametrize("double_quant", [False, True])
@pytest.mark.parametrize("case", ["normal", "heavy", "midpoints"])
def test_codes_and_scales_equal_jax_bit_for_bit(case, double_quant):
    from llm_fine_tune_distributed_tpu.ops.nf4 import quantize_nf4 as jax_quantize_nf4

    w = {"normal": lambda: _w(256, 128, 1), "heavy": lambda: _w(512, 128, 2, heavy=True),
         "midpoints": _midpoint_weight}[case]()
    got = nf4.quantize_nf4(torch.from_numpy(w), 64, double_quant)
    _assert_equal_to_jax(got, jax_quantize_nf4(w, 64, double_quant))


def test_midpoints_round_to_the_lower_code():
    """A normalized value on a midpoint takes the lower code
    (``np.searchsorted`` side left, ``torch.bucketize`` right=False)."""
    q = nf4.quantize_nf4(torch.from_numpy(_midpoint_weight()), 64, double_quant=False)
    codes = nf4.unpack_codes(q["nf4"])[:, 0].numpy()
    np.testing.assert_array_equal(codes[1:16], np.arange(15))
    np.testing.assert_array_equal(codes[16:31], np.searchsorted(nf4._MIDS, -nf4._MIDS))
    assert codes[0] == 15


def test_pack_unpack_roundtrip():
    w = _w(128, 64, 0)
    q = nf4.quantize_nf4(torch.from_numpy(w), block_size=64, double_quant=False)
    assert q["nf4"].shape == (16, 64) and q["nf4"].dtype == torch.int32
    codes = nf4.unpack_codes(q["nf4"])
    assert codes.shape == (128, 64) and int(codes.min()) >= 0 and int(codes.max()) <= 15
    assert torch.equal(nf4.pack_codes(codes), q["nf4"])
    top = torch.full((8, 4), 15, dtype=torch.int32)  # every nibble set: the word is -1
    assert torch.equal(nf4.pack_codes(top), torch.full((1, 4), -1, dtype=torch.int32))
    assert torch.equal(nf4.unpack_codes(nf4.pack_codes(top)), top)


@pytest.mark.parametrize("double_quant", [False, True])
def test_dequantized_weights_agree_with_jax(double_quant):
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.ops import nf4 as jnf4

    w = _w(512, 128, 2, heavy=True)
    q = nf4.quantize_nf4(torch.from_numpy(w), 64, double_quant)
    got = nf4.dequantize_nf4(q, torch.float32).numpy()
    want = np.asarray(jnf4.dequantize_nf4({k: jnp.asarray(v.numpy()) for k, v in q.items()},
                                          jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_roundtrip_error_bounds():
    """The error within a block is at most half the largest codebook gap
    times the block's absmax."""
    w = _w(256, 128, 1)
    deq = nf4.dequantize_nf4(nf4.quantize_nf4(torch.from_numpy(w), 64, False), torch.float32)
    blocks = w.reshape(-1, 64, 128)
    absmax = np.abs(blocks).max(1, keepdims=True)
    bound = (np.diff(nf4.NF4_CODEBOOK).max() / 2 + 1e-6) * absmax
    assert (np.abs(deq.numpy().reshape(-1, 64, 128) - blocks) <= bound + 1e-6).all()


def test_double_quant_close_to_single():
    w = _w(512, 128, 2, heavy=True)
    single = nf4.dequantize_nf4(nf4.quantize_nf4(torch.from_numpy(w), 64, False), torch.float32)
    double = nf4.dequantize_nf4(nf4.quantize_nf4(torch.from_numpy(w), 64, True), torch.float32)
    assert ((double - single).abs().mean() / single.abs().mean()) < 0.02
    q = nf4.quantize_nf4(torch.from_numpy(w), 64, True)
    assert q["absmax_q"].dtype == torch.int8
    bits = sum(q[k].numel() * q[k].element_size() for k in ("nf4", "absmax_q", "absmax_scale")) * 8
    assert bits / w.size < 4.3
    for key, (shape, dtype) in nf4.quantized_layout(w.shape, 64, True).items():
        assert tuple(q[key].shape) == shape and q[key].dtype == dtype, key


def test_nf4_matmul_close_to_dense_and_keeps_only_codes():
    w = _w(512, 256, 3)
    x = torch.from_numpy(np.random.RandomState(4).randn(8, 512).astype(np.float32))
    q = nf4.quantize_nf4(torch.from_numpy(w), 64, True)
    deq = nf4.dequantize_nf4(q, torch.float32)
    x.requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        y = nf4.nf4_matmul(x, q, compute_dtype=torch.float32)
    assert {t.data_ptr() for t in saved} <= {t.data_ptr() for t in q.values()}
    np.testing.assert_allclose(y.detach().numpy(), (x.detach() @ deq).numpy(), rtol=1e-4,
                               atol=1e-3)
    dy = torch.randn_like(y)
    (gx,) = torch.autograd.grad(y, x, dy)
    np.testing.assert_allclose(gx.numpy(), (dy @ deq.T).numpy(), rtol=1e-5, atol=1e-5)
    rel = (y.detach() - x.detach() @ torch.from_numpy(w)).abs().mean() / (
        x.detach() @ torch.from_numpy(w)).abs().mean()
    assert rel < 0.2


def _frozen():
    rng = np.random.RandomState(4)
    return {
        "model.layers.0.self_attn.q_proj.kernel": rng.randn(64, 64).astype(np.float32),
        "model.layers.0.mlp.down_proj.kernel": rng.randn(128, 64).astype(np.float32),
        "model.layers.0.input_layernorm.weight": np.ones((64,), np.float32),
        "model.embed_tokens.weight": rng.randn(512, 64).astype(np.float32),
        "model.layers.0.self_attn.q_proj.lora_scale": np.asarray(0.5, np.float32),
    }


def test_quantize_frozen_tree_and_inverse_equal_jax():
    from llm_fine_tune_distributed_tpu.parallel import qlora as jqlora

    frozen = _frozen()
    q = qlora.quantize_frozen({k: torch.from_numpy(v) for k, v in frozen.items()}, 64, True)
    jq = jqlora.quantize_frozen({k.replace(".", "/"): v for k, v in frozen.items()}, 64, True)
    _assert_equal_to_jax(q, {k.replace("/", "."): v for k, v in jq.items()})
    assert "model.layers.0.self_attn.q_proj.kernel_nf4" in q
    assert "model.layers.0.self_attn.q_proj.kernel" not in q
    assert 0.0 < qlora.quantized_fraction(q) < 0.5
    assert qlora.quantized_fraction(q) == pytest.approx(jqlora.quantized_fraction(jq), rel=1e-12)
    back = qlora.dequantize_frozen(q, torch.float32)
    assert list(back) == list(frozen)  # each kernel back at its place
    jback = jqlora.dequantize_frozen(jq, np.float32)
    for k, v in back.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jback[k.replace(".", "/")]), rtol=0,
                                   atol=1e-6, err_msg=k)
    orig = frozen["model.layers.0.mlp.down_proj.kernel"]
    rec = back["model.layers.0.mlp.down_proj.kernel"].numpy()
    assert np.abs(rec - orig).mean() / np.abs(orig).mean() < 0.1


def test_stacked_leaves_raise_naming_the_jax_functions():
    w = torch.zeros(2, 64, 32)
    with pytest.raises(NotImplementedError, match="quantize_nf4_stacked / quantize_nf4_layered"):
        nf4.quantize_nf4(w)
    gate = {"model.layers.0.block_sparse_moe.gate.kernel": torch.zeros(64, 8)}
    assert qlora.quantize_frozen(gate) == gate  # the router stays exact


def test_qlora_forward_matches_jax_and_the_dequantized_dense():
    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.models.configs import get_preset as jax_get_preset
    from llm_fine_tune_distributed_tpu.models.transformer import forward as jax_forward
    from llm_fine_tune_distributed_tpu.models.transformer import init_params as jax_init
    from llm_fine_tune_distributed_tpu.parallel import lora as jlora
    from llm_fine_tune_distributed_tpu.parallel import qlora as jqlora
    from llm_fine_tune_distributed_tpu.utils.tree import flatten_dict, unflatten_dict
    from llm_fine_tune_distributed_tpu_torch.models.carry import params_from_jax
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
    from llm_fine_tune_distributed_tpu_torch.models.transformer import forward

    jmc, mc = jax_get_preset("tiny"), get_preset("tiny")
    jparams = jlora.add_lora_params(jax_init(jax.random.PRNGKey(0), jmc, dtype=jnp.float32),
                                    jax.random.PRNGKey(1), rank=4)
    flat = {k: np.asarray(v) for k, v in flatten_dict(jparams).items()}
    flat = {k: (v + 0.01 if k.endswith("lora_b") else v) for k, v in flat.items()}
    jq = jqlora.quantize_frozen({k: v for k, v in flat.items() if not k.endswith("lora_b")})
    jq.update({k: v for k, v in flat.items() if k.endswith("lora_b")})
    params = params_from_jax({k.replace("/", "."): np.asarray(v) for k, v in jq.items()}, mc)
    assert any(k.endswith(".kernel_nf4") for k in params)
    ids = np.random.RandomState(5).randint(0, 512, (2, 32))
    want, _ = jax_forward(unflatten_dict({k: jnp.asarray(v) for k, v in jq.items()}),
                          jnp.asarray(ids), jmc, compute_dtype=jnp.float32,
                          logits_dtype=jnp.float32)
    want = np.asarray(want)
    got, _ = forward(params, torch.from_numpy(ids), mc, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    dense, _ = forward(qlora.dequantize_frozen(params, torch.float32), torch.from_numpy(ids), mc,
                       compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# a QLoRA run against the JAX trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import test_torch_lora_train as lt

    from llm_fine_tune_distributed_tpu.config import MeshConfig as JaxMeshConfig
    from llm_fine_tune_distributed_tpu.config import TrainConfig as JaxTrainConfig
    from llm_fine_tune_distributed_tpu.train.trainer import SFTTrainer as JaxSFTTrainer
    from llm_fine_tune_distributed_tpu_torch.config import TrainConfig
    from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

    workdir = lt.make_workdir(tmp_path_factory.mktemp("qlora_sft"))
    jtrainer = JaxSFTTrainer(JaxTrainConfig(**lt.recipe(
        workdir, "jax_out", dataset_file="qa.parquet", freeze_strategy="qlora",
        mesh=JaxMeshConfig(data=1, fsdp=1))))
    ptrainer = SFTTrainer(TrainConfig(**lt.recipe(workdir, "port_out", dataset_file="qa.jsonl",
                                                  freeze_strategy="qlora")), device="cpu")
    lt.carry_adapters_from_jax(jtrainer, ptrainer)
    jfrozen = {k.replace("/", "."): np.asarray(v) for k, v in jtrainer.state.frozen.items()}
    jtrainer.train()
    ptrainer.train()
    return jtrainer, ptrainer, jfrozen, workdir


def test_qlora_history_matches_jax(runs):
    jtrainer, ptrainer, jfrozen, _ = runs
    # the frozen base is NF4 (the JAX trainer's leaves bit for bit); only adapters train
    frozen = ptrainer.state.frozen
    assert set(frozen) == set(jfrozen)
    for k, v in frozen.items():
        np.testing.assert_array_equal(v.detach().numpy(), jfrozen[k], err_msg=k)
    assert not any(k.endswith(".kernel") and "_proj" in k for k in frozen)
    assert all(k.endswith((".lora_a", ".lora_b")) for k in ptrainer.state.trainable)
    assert ptrainer.quantize_seconds is not None and ptrainer.export_merge_seconds is not None
    import test_torch_lora_train as lt

    lt.assert_history_matches(jtrainer, ptrainer)


def test_qlora_best_model_holds_plain_kernels(runs):
    _, ptrainer, _, workdir = runs
    from llm_fine_tune_distributed_tpu_torch.models.hf_io import read_safetensors

    out = workdir / "port_out"
    names = set(read_safetensors(os.path.join(out, "best_model", "model.safetensors")))
    assert any(k.endswith("q_proj.kernel") or k.endswith("q_proj.weight") for k in names)
    assert not any("nf4" in k or "absmax" in k or "lora" in k for k in names)
    assert (out / "adapter" / "adapter_model.safetensors").exists()


@pytest.mark.parametrize("trainable_only", [False, True], ids=["full", "trainable_only"])
def test_qlora_checkpoint_restores_into_a_fresh_trainer(runs, tmp_path, trainable_only):
    """A QLoRA state saved and restored into a fresh QLoRA trainer: the
    adapters and AdamW moments bit for bit, the NF4 codes (int32), their
    int8 and f32 scales and 0-d offsets through the payload (full) or
    verified by the frozen fingerprint, whose integer sums cover the codes
    (trainable-only); a code leaf with its rows reversed is refused."""
    import test_torch_lora_train as lt

    from llm_fine_tune_distributed_tpu_torch.config import TrainConfig
    from llm_fine_tune_distributed_tpu_torch.train.checkpoints import (
        CheckpointManager,
        FingerprintMismatch,
        frozen_fingerprint,
    )
    from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

    _, ptrainer, _, workdir = runs
    ckpt = CheckpointManager(str(tmp_path / "ck"), trainable_only=trainable_only)
    ckpt.save(ptrainer.state.step, ptrainer.state,
              fingerprint=frozen_fingerprint(ptrainer.state.frozen))
    fresh = SFTTrainer(TrainConfig(**lt.recipe(workdir, "port_fresh", dataset_file="qa.jsonl",
                                               freeze_strategy="qlora")), device="cpu")
    restored = ckpt.restore(ptrainer.state.step, fresh.state)
    assert restored.step == ptrainer.state.step
    for k, v in ptrainer.state.trainable.items():
        assert torch.equal(restored.trainable[k], v.detach()), k
    for m in ("mu", "nu"):
        for k, v in ptrainer.state.opt_state[m].items():
            assert torch.equal(restored.opt_state[m][k], v), (m, k)
    for k, v in ptrainer.state.frozen.items():
        got = restored.frozen[k]
        assert got.dtype == v.dtype and got.shape == v.shape and torch.equal(got, v), k
    if trainable_only:
        name = next(k for k in fresh.state.frozen if k.endswith(".kernel_nf4"))
        fresh.state.frozen[name] = fresh.state.frozen[name].flip(0)  # another base: rows reversed
        with pytest.raises(FingerprintMismatch):
            ckpt.restore(ptrainer.state.step, fresh.state)
    ckpt.close()


@pytest.mark.cuda
def test_quantize_on_the_card_equals_the_cpu():
    """The codes, absmax and double quant made on the card (f32 division,
    ``torch.bucketize``) equal the CPU's bit for bit, from f32 and from bf16
    weights at a trunk projection's shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for dtype in (torch.float32, torch.bfloat16):
        w = torch.from_numpy(_w(2048, 512, 9, heavy=True)).to(dtype)
        w[0, :64] = torch.from_numpy(nf4._MIDS.repeat(5)[:64]).to(dtype)
        cpu = nf4.quantize_nf4(w, 64, True)
        card = nf4.quantize_nf4(w.cuda(), 64, True)
        for k, v in cpu.items():
            assert torch.equal(card[k].cpu(), v), k
        x = torch.randn(8, 2048, device="cuda", dtype=dtype)
        y = nf4.nf4_matmul(x, card, compute_dtype=dtype)
        want = x @ nf4.dequantize_nf4(cpu, dtype).cuda()
        torch.testing.assert_close(y, want, rtol=0, atol=0)
