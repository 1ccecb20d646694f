"""Sequence packing in the port (``data/packing.py``, the packed forward of
``models/transformer``, the packed branches of ``train/trainer``) against
the JAX package, case for case with ``tests/test_packing.py``, on the
``tiny`` preset in f32 with inputs from a numpy seed:

- the packed arrays equal the JAX ``pack_examples`` / ``build_packed_sft_arrays``
  bit for bit, with the layout the JAX file checks;
- the port's packed forward matches the JAX packed forward (1e-5 of the
  largest logit) and each example's own solo forward (the same rule), on
  the plain attention and on the flash kernels' plain versions;
- the loss mask never crosses a segment;
- the packed trainer's history is within 1e-4 of the JAX trainer's, eval
  pad rows carry segment 1, and the completion mask's layout is checked.

Not mirrored: ``test_packed_training_with_seq_axis_matches_flat`` (ring and
Ulysses sequence parallelism over a mesh wait for multi-device training).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu.config import MeshConfig as JaxMeshConfig
from llm_fine_tune_distributed_tpu.config import TrainConfig as JaxTrainConfig
from llm_fine_tune_distributed_tpu.data import dataset as jax_dataset
from llm_fine_tune_distributed_tpu.data import packing as jax_packing
from llm_fine_tune_distributed_tpu.data.convert import convert_jsonl_to_parquet
from llm_fine_tune_distributed_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from llm_fine_tune_distributed_tpu.models import configs as jax_configs
from llm_fine_tune_distributed_tpu.models import hf_io as jax_hf_io
from llm_fine_tune_distributed_tpu.models import transformer as jax_tf
from llm_fine_tune_distributed_tpu_torch.config import TrainConfig
from llm_fine_tune_distributed_tpu_torch.data import dataset, packing
from llm_fine_tune_distributed_tpu_torch.data.tokenizer import load_tokenizer
from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.models.transformer import forward
from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYS = "You are a helpful expert."
SEQ = 256
REL = 1e-4
LOGIT_TOL = 1e-5  # of the largest logit
COMPARED = ("loss", "grad_norm", "learning_rate", "eval_loss", "eval_loss_answer")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _rows(n):
    return [{"full-question": f"q {i}?", "answer": f"answer {i} " + "word " * (3 + i % 5)}
            for i in range(n)]


def _examples(mod, tok, rows):
    return [mod.tokenize_example(mod.format_chat_example(r, SYS)["messages"], tok, SEQ)
            for r in rows]


@pytest.fixture(scope="module")
def toks():
    return jax_load_tokenizer("byte-chatml"), load_tokenizer("byte-chatml")


def _sharp_jax_params(seed):
    """JAX-initialized tiny weights with q and k scaled x20: at the 0.02
    init the attention is near uniform and the logits barely see the
    positions, so a wrong RoPE position would hide."""
    jparams = jax_tf.init_params(jax.random.PRNGKey(seed), jax_configs.get_preset("tiny"),
                                 dtype=jnp.float32)
    for layer in jparams["model"]["layers"].values():
        for name in ("q_proj", "k_proj"):
            layer["self_attn"][name]["kernel"] = layer["self_attn"][name]["kernel"] * 8.0
    mc = get_preset("tiny")
    return jparams, params_from_jax({k: np.asarray(v) for k, v in
                                     flatten_tree(jax.device_get(jparams)).items()}, mc)


def _assert_arrays_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_pack_examples_layout(toks):
    jtok, tok = toks
    examples = _examples(dataset, tok, _rows(8))
    packed = packing.pack_examples(examples, SEQ)
    _assert_arrays_equal(packed, jax_packing.pack_examples(_examples(jax_dataset, jtok, _rows(8)),
                                                           SEQ))
    n_rows = packed["input_ids"].shape[0]
    assert n_rows < 8, "short examples should share rows"
    for r in range(n_rows):
        seg = packed["segment_ids"][r]
        real = seg > 0
        assert packed["attention_mask"][r][real].all()
        assert not packed["attention_mask"][r][~real].any()
        segs = np.unique(seg[real])
        assert (segs == np.arange(1, len(segs) + 1)).all()
        for sid in segs:  # positions restart at each segment
            pos = packed["positions"][r][seg == sid]
            assert (pos == np.arange(len(pos))).all()
    assert packed["attention_mask"].sum() == sum(e.length for e in examples)
    assert 0.0 < packing.packing_efficiency(packed) <= 1.0
    assert packing.packing_efficiency(packed) == jax_packing.packing_efficiency(packed)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_packed_forward_matches_jax_and_each_example_alone(toks, impl):
    """Each packed segment's logits equal the JAX packed forward's and the
    example's own solo forward; the pad tail is compared flash to flash only
    (ops/attention: pad queries follow the segment rule there)."""
    _, tok = toks
    jparams, params = _sharp_jax_params(0)
    mc = get_preset("tiny")
    examples = _examples(dataset, tok, _rows(5))
    packed = packing.pack_examples(examples, SEQ)
    kw = {k: packed[k] for k in ("segment_ids", "positions")}
    want, _ = jax_tf.forward(jparams, jnp.asarray(packed["input_ids"]),
                             jax_configs.get_preset("tiny"),
                             padding_mask=jnp.asarray(packed["attention_mask"]),
                             **{k: jnp.asarray(v) for k, v in kw.items()},
                             compute_dtype=jnp.float32, logits_dtype=jnp.float32)
    want = np.asarray(want)
    got, _ = forward(params, torch.from_numpy(packed["input_ids"]), mc,
                     padding_mask=torch.from_numpy(packed["attention_mask"]),
                     **{k: torch.from_numpy(v) for k, v in kw.items()}, attention_impl=impl,
                     compute_dtype=torch.float32)
    got = got.numpy()
    real = packed["segment_ids"] > 0
    scale = np.abs(want).max()
    np.testing.assert_allclose(got[real], want[real], rtol=0, atol=LOGIT_TOL * scale)
    for ex in examples:
        ln = ex.length
        solo, _ = forward(params, torch.from_numpy(ex.input_ids[None, :ln]), mc,
                          attention_impl=impl, compute_dtype=torch.float32)
        hits = [(r, sid) for r in range(len(packed["input_ids"]))
                for sid in np.unique(packed["segment_ids"][r][real[r]])
                if (packed["segment_ids"][r] == sid).sum() == ln
                and (packed["input_ids"][r][packed["segment_ids"][r] == sid]
                     == ex.input_ids[:ln]).all()]
        assert hits, "packed segment not found for example"
        r, sid = hits[0]
        np.testing.assert_allclose(got[r][packed["segment_ids"][r] == sid], solo[0].numpy(),
                                   rtol=0, atol=LOGIT_TOL * scale)


def test_packed_forward_reads_the_given_positions(toks):
    """``positions`` reach RoPE: all-zero positions change the logits, while
    positions that run on from one segment into the next (``arange``) give
    the per-segment restart's logits up to rounding, since RoPE sees only
    the distance between a query and a key of the same segment."""
    _, tok = toks
    mc = get_preset("tiny")
    _, params = _sharp_jax_params(1)
    packed = packing.pack_examples(_examples(dataset, tok, _rows(5)), SEQ)
    ids = torch.from_numpy(packed["input_ids"])
    common = dict(padding_mask=torch.from_numpy(packed["attention_mask"]),
                  segment_ids=torch.from_numpy(packed["segment_ids"]),
                  compute_dtype=torch.float32)
    restart, _ = forward(params, ids, mc, positions=torch.from_numpy(packed["positions"]),
                         **common)
    running, _ = forward(params, ids, mc, **common)
    zeros, _ = forward(params, ids, mc, positions=torch.zeros_like(ids), **common)
    real = torch.from_numpy(packed["segment_ids"] > 0)
    scale = restart.abs().max()
    assert (running - restart).abs()[real].max() <= LOGIT_TOL * scale
    assert (zeros - restart).abs()[real].max() > 100 * LOGIT_TOL * scale


def test_packed_arrays_loss_mask_never_crosses_segments(toks):
    jtok, tok = toks
    packed = packing.build_packed_sft_arrays(_rows(12), tok, SEQ, system_prompt=SYS)
    _assert_arrays_equal(packed, jax_packing.build_packed_sft_arrays(_rows(12), jtok, SEQ,
                                                                     system_prompt=SYS))
    seg, lm = packed["segment_ids"], packed["loss_mask"]
    starts = (seg[:, 1:] != seg[:, :-1]) & (seg[:, 1:] > 0)
    assert (lm[:, 1:][starts] == 0).all()


def test_packed_rows_refuse_a_kv_cache_and_a_sliding_window():
    from dataclasses import replace

    from llm_fine_tune_distributed_tpu_torch.models.transformer import init_cache, init_params

    mc = get_preset("tiny")
    params = init_params(mc)
    ids = torch.zeros(1, 8, dtype=torch.long)
    seg = torch.ones(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="exclusive"):
        forward(params, ids, mc, segment_ids=seg, cache=init_cache(mc, 1, 16, dtype=torch.float32),
                compute_dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        forward(params, ids, replace(mc, sliding_window=4), segment_ids=seg)


# ---------------------------------------------------------------------------
# the packed trainer against the JAX trainer
# ---------------------------------------------------------------------------

N_ROWS = 48


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("packed")
    data = tmp / "data"
    data.mkdir()
    with open(os.path.join(ROOT, "data", "final_qa_data_unique.jsonl")) as f:
        lines = [next(f) for _ in range(N_ROWS)]
    (data / "qa.jsonl").write_text("".join(lines))
    convert_jsonl_to_parquet(str(data / "qa.jsonl"), str(data / "qa.parquet"), verbose=False)
    mc = jax_configs.get_preset("tiny")
    params = jax_tf.init_params(jax.random.PRNGKey(3), mc, dtype=jnp.float32)
    model = tmp / "model"
    jax_hf_io.save_hf_checkpoint(jax.device_get(params), str(model))
    (model / "config.json").write_text(json.dumps(jax_configs.to_hf_dict(mc)))
    return tmp


def _recipe(workdir, out, **kw):
    return dict(model_name=str(workdir / "model"), model_preset="tiny",
                tokenizer_path="byte-chatml", data_dir=str(workdir / "data"),
                output_dir=str(workdir / out), epochs=1, per_device_batch_size=2,
                gradient_accumulation_steps=2, eval_steps=2, max_seq_length=512,
                system_prompt=SYS, compute_dtype="float32", use_native_loader=False,
                packing=True, save_steps=0, **kw)


@pytest.fixture(scope="module")
def runs(workdir):
    from llm_fine_tune_distributed_tpu.train.trainer import SFTTrainer as JaxSFTTrainer

    jtrainer = JaxSFTTrainer(JaxTrainConfig(**_recipe(
        workdir, "jax_out", dataset_file="qa.parquet", mesh=JaxMeshConfig(data=1, fsdp=1))))
    jtrainer.train()
    ptrainer = SFTTrainer(TrainConfig(**_recipe(workdir, "port_out", dataset_file="qa.jsonl")),
                          device="cpu")
    ptrainer.train()
    return jtrainer, ptrainer


def test_packed_trainer_history_matches_jax(runs):
    jtrainer, ptrainer = runs
    assert (ptrainer.n_train, ptrainer.n_val) == (jtrainer.n_train, jtrainer.n_val)
    assert ptrainer.n_train < int(N_ROWS * 0.9), "packing made no fewer rows"
    for k in ("train_arrays", "val_arrays"):
        _assert_arrays_equal(getattr(ptrainer, k), {key: np.asarray(v) for key, v in
                                                    getattr(jtrainer, k).items()})
    jhist, phist = jtrainer.metrics.history, ptrainer.metrics.history
    assert [h["step"] for h in phist] == [h["step"] for h in jhist]
    assert sum("eval_loss" in h for h in phist) >= 1
    for want, got in zip(jhist, phist):
        for key in COMPARED:
            assert (key in got) == (key in want), (got["step"], key)
            if key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=REL,
                                           err_msg=f"step {want['step']} {key}")
    # the meter counts the real tokens of the packed rows it trained on
    assert ptrainer.throughput.real_tokens == sum(
        int(b["attention_mask"].sum()) for b in ptrainer.loader.epoch(0))


def test_eval_pad_rows_get_segment_one_and_the_mask_layout_is_checked(runs, workdir):
    _, ptrainer = runs
    seg = SFTTrainer._pad_eval_rows("segment_ids", np.zeros((1, 4), np.int32), 2)
    np.testing.assert_array_equal(seg[1:], 1)
    np.testing.assert_array_equal(SFTTrainer._pad_eval_rows("loss_mask", np.ones((1, 4)), 2)[1:], 0)
    _, val_rows = dataset.train_validation_split(
        dataset.load_qa_dataset(str(workdir / "data" / "qa.jsonl")), 0.1, 42)
    kept = ptrainer.val_arrays
    ptrainer.val_arrays = {k: v[:-1] for k, v in kept.items()}  # one packed row short
    try:
        with pytest.raises(ValueError, match="different layout"):
            ptrainer._attach_completion_mask(val_rows, ptrainer._prompt_kwargs())
    finally:
        ptrainer.val_arrays = kept
