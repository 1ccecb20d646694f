"""DPO in the port (``data/preference.py``, ``train/dpo.py``) against the JAX
package, case for case with ``tests/test_dpo.py``, on the ``tiny`` preset in
f32 with the same inputs:

- the loss at init is ln 2 (the reference equals the policy), and equals
  the JAX loss function's on the same leaves;
- the chunked logprobs (``loss_chunk_size``) match the full ones;
- the loss matches a computation from the raw logits;
- the synthesis and loading of preference rows, and the DPO arrays, equal
  the JAX package's (the repo's source-schema JSONL read as QA rows);
- a ``DPOTrainer`` run's history (loss, grad norm, the ``rewards_*``, the
  eval loss and ``eval_rewards_accuracy``) is within 1e-4 of the JAX
  trainer's, and the artifact contract holds.

Not mirrored: ``test_dpo_pipeline_end_to_end`` (the pipeline DPO builders
wait for pipeline parallelism).
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu.config import MeshConfig as JaxMeshConfig
from llm_fine_tune_distributed_tpu.config import TrainConfig as JaxTrainConfig
from llm_fine_tune_distributed_tpu.data import preference as jax_preference
from llm_fine_tune_distributed_tpu.data.convert import convert_jsonl_to_parquet
from llm_fine_tune_distributed_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from llm_fine_tune_distributed_tpu.models import configs as jax_configs
from llm_fine_tune_distributed_tpu.models import hf_io as jax_hf_io
from llm_fine_tune_distributed_tpu.models import transformer as jax_tf
from llm_fine_tune_distributed_tpu.parallel.freeze import trainable_mask as jax_trainable_mask
from llm_fine_tune_distributed_tpu.train.dpo import make_dpo_loss_fn as jax_make_dpo_loss_fn
from llm_fine_tune_distributed_tpu.utils.tree import split_by_mask as jax_split_by_mask
from llm_fine_tune_distributed_tpu_torch.config import TrainConfig
from llm_fine_tune_distributed_tpu_torch.data import preference
from llm_fine_tune_distributed_tpu_torch.data.tokenizer import load_tokenizer
from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.models.transformer import forward
from llm_fine_tune_distributed_tpu_torch.parallel.freeze import trainable_mask
from llm_fine_tune_distributed_tpu_torch.train.dpo import DPOTrainer, make_dpo_loss_fn
from llm_fine_tune_distributed_tpu_torch.utils.tree import split_by_mask

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 96
SYS = "You are a helpful expert."
REL = 1e-4
CFG = get_preset("tiny")
COMPARED = ("loss", "grad_norm", "learning_rate", "eval_loss", "rewards_chosen",
            "rewards_rejected", "rewards_margin", "rewards_accuracy", "eval_rewards_accuracy")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _rows(n=12):
    return [{"prompt": f"question {i}?", "chosen": f"the correct answer {i} with words",
             "rejected": f"wrong {i}"} for i in range(n)]


@pytest.fixture(scope="module")
def setup():
    """JAX tiny weights (q and k x5, so that the logprobs vary), the port's
    copy, the split of each by the default freeze, and one batch of 4
    pairs."""
    jmc = jax_configs.get_preset("tiny")
    jparams = jax_tf.init_params(jax.random.PRNGKey(0), jmc, dtype=jnp.float32)
    for layer in jparams["model"]["layers"].values():
        for name in ("q_proj", "k_proj"):
            layer["self_attn"][name]["kernel"] = layer["self_attn"][name]["kernel"] * 5.0
    jcfg = JaxTrainConfig(model_preset="tiny", max_seq_length=SEQ)
    jtrainable, jfrozen = jax_split_by_mask(jparams, jax_trainable_mask(jparams, jmc, jcfg))
    params = params_from_jax({k: np.asarray(v) for k, v in
                              flatten_tree(jax.device_get(jparams)).items()}, CFG)
    trainable, frozen = split_by_mask(params, trainable_mask(params, CFG, TrainConfig(
        model_preset="tiny", max_seq_length=SEQ)))
    arrays = preference.build_dpo_arrays(_rows(4), load_tokenizer("byte-chatml"), SEQ,
                                         system_prompt=SYS)
    return jparams, jtrainable, jfrozen, trainable, frozen, arrays


def _port_batch(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def _cfg(**kw):
    return dict(model_preset="tiny", max_seq_length=SEQ, attention_impl="xla",
                gradient_checkpointing=False, compute_dtype="float32", **kw)


def _jax_loss(setup, pol, ref, **kw):
    jparams, jtrainable, jfrozen, _, _, arrays = setup
    fn = jax.jit(jax_make_dpo_loss_fn(jax_configs.get_preset("tiny"), JaxTrainConfig(**_cfg(**kw))))
    loss, aux = fn(pol, ref, jfrozen, {k: jnp.asarray(v) for k, v in arrays.items()})
    return float(loss), {k: np.asarray(v) for k, v in aux.items()}


def _perturbed(trainable, delta):
    """Each trainable leaf plus a fixed per-leaf offset (by its sorted
    index), so that the policy moves away from the reference."""
    return {k: v + delta * ((i % 7) - 3) for i, (k, v) in enumerate(sorted(trainable.items()))}


def test_dpo_loss_at_init_is_log2(setup):
    """The reference is the policy in bf16: the margin is ~0 and the loss
    ~ln 2, and the port's loss is the JAX loss function's."""
    _, jtrainable, _, trainable, frozen, arrays = setup
    loss_fn = make_dpo_loss_fn(CFG, TrainConfig(**_cfg()))
    ref = {k: v.to(torch.bfloat16) for k, v in trainable.items()}
    loss, aux = loss_fn(trainable, ref, frozen, _port_batch(arrays))
    assert abs(float(loss) - math.log(2.0)) < 2e-2
    assert abs(float(aux["rewards_margin"])) < 1e-2
    jloss, _ = _jax_loss(setup, jtrainable, {k: v.astype(jnp.bfloat16) for k, v in jtrainable.items()})
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    exact, _ = loss_fn(trainable, trainable, frozen, _port_batch(arrays))
    assert float(exact) == pytest.approx(math.log(2.0), abs=1e-6)  # ref == policy exactly


def test_dpo_chunked_matches_full_and_jax(setup):
    """``loss_chunk_size`` matches the single unembed; both match the JAX
    loss function on the same perturbed policy, loss and reward aux."""
    _, jtrainable, _, trainable, frozen, arrays = setup
    pol = _perturbed(trainable, 0.01)
    ref = {k: v.to(torch.bfloat16) for k, v in trainable.items()}
    jpol = {k: jnp.asarray(pol[k.replace("/", ".")].numpy()) for k in jtrainable}
    jref = {k: v.astype(jnp.bfloat16) for k, v in jtrainable.items()}
    out = {}
    for chunk in (None, 32):
        loss, aux = make_dpo_loss_fn(CFG, TrainConfig(**_cfg(loss_chunk_size=chunk)))(
            pol, ref, frozen, _port_batch(arrays))
        out[chunk] = (float(loss), float(aux["rewards_margin"]))
    assert out[None][0] == pytest.approx(out[32][0], rel=1e-5)
    assert out[None][1] == pytest.approx(out[32][1], rel=1e-4, abs=1e-6)
    jloss, jaux = _jax_loss(setup, jpol, jref)
    assert out[None][0] == pytest.approx(jloss, rel=1e-5)
    assert out[None][1] == pytest.approx(float(jaux["rewards_margin"]), rel=1e-4, abs=1e-6)


def test_dpo_chunked_gradients_match_full(setup):
    _, _, _, trainable, frozen, arrays = setup
    ref = {k: v.to(torch.bfloat16) for k, v in trainable.items()}
    grads = {}
    for chunk in (None, 32):
        pol = {k: v.clone().requires_grad_() for k, v in _perturbed(trainable, 0.01).items()}
        loss, _ = make_dpo_loss_fn(CFG, TrainConfig(**_cfg(loss_chunk_size=chunk)))(
            pol, ref, frozen, _port_batch(arrays))
        loss.backward()
        grads[chunk] = {k: v.grad for k, v in pol.items()}
    for k, g in grads[None].items():
        torch.testing.assert_close(grads[32][k], g, rtol=1e-4, atol=1e-4 * float(g.abs().max()))


def test_dpo_loss_matches_manual_logits(setup):
    """The framework's sequence logprobs against a log_softmax gather from
    full logits, beta 0.25."""
    _, _, _, trainable, frozen, arrays = setup
    pol = {k: v + 0.02 for k, v in trainable.items()}
    ref = {k: v.to(torch.bfloat16) for k, v in trainable.items()}
    loss, _ = make_dpo_loss_fn(CFG, TrainConfig(**_cfg(dpo_beta=0.25)))(
        pol, ref, frozen, _port_batch(arrays))
    batch = _port_batch(arrays)

    def seq_logprob(params, side):
        ids = batch[f"{side}_input_ids"]
        logits, _ = forward({**params, **frozen}, ids, CFG,
                            padding_mask=batch[f"{side}_attention_mask"],
                            compute_dtype=torch.float32)
        logp = torch.log_softmax(logits.float(), dim=-1)
        tgt = torch.gather(logp[:, :-1], 2, ids[:, 1:, None].long())[..., 0]
        return (tgt * batch[f"{side}_loss_mask"][:, 1:]).sum(-1)

    ref32 = {k: v.float() for k, v in ref.items()}
    margin = ((seq_logprob(pol, "chosen") - seq_logprob(pol, "rejected"))
              - (seq_logprob(ref32, "chosen") - seq_logprob(ref32, "rejected")))
    expected = float((-torch.nn.functional.logsigmoid(0.25 * margin)).mean())
    assert float(loss) == pytest.approx(expected, rel=1e-5, abs=1e-6)


def test_dpo_label_smoothing_matches_jax(setup):
    """Conservative DPO, eps 0.1 at beta 0.25: the loss and the reward aux
    equal the JAX loss function's on the same perturbed policy, and the loss
    is the eps = 0 loss plus eps times the mean beta margin (-log sigma(z) +
    eps (log sigma(z) - log sigma(-z)), and log sigma(z) - log sigma(-z) = z)."""
    _, jtrainable, _, trainable, frozen, arrays = setup
    pol = _perturbed(trainable, 0.01)
    ref = {k: v.to(torch.bfloat16) for k, v in trainable.items()}
    jpol = {k: jnp.asarray(pol[k.replace("/", ".")].numpy()) for k in jtrainable}
    jref = {k: v.astype(jnp.bfloat16) for k, v in jtrainable.items()}
    kw = dict(dpo_beta=0.25, dpo_label_smoothing=0.1)
    loss, aux = make_dpo_loss_fn(CFG, TrainConfig(**_cfg(**kw)))(pol, ref, frozen,
                                                                 _port_batch(arrays))
    jloss, jaux = _jax_loss(setup, jpol, jref, **kw)
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    for key in ("rewards_chosen", "rewards_rejected", "rewards_margin"):
        assert float(aux[key]) == pytest.approx(float(jaux[key]), rel=1e-4, abs=1e-6), key
    plain, _ = make_dpo_loss_fn(CFG, TrainConfig(**_cfg(dpo_beta=0.25)))(pol, ref, frozen,
                                                                        _port_batch(arrays))
    margin = float(aux["rewards_margin"])
    assert abs(margin) > 1e-3  # the policy moved, so eps changes the loss
    assert float(loss) == pytest.approx(float(plain) + 0.1 * margin, rel=1e-5, abs=1e-7)


def test_loss_vocab_chunk_is_refused():
    with pytest.raises(ValueError, match="loss_vocab_chunk is not supported"):
        make_dpo_loss_fn(CFG, TrainConfig(**_cfg(loss_vocab_chunk=128)))


def test_preference_synthesis_and_loading(tmp_path):
    qa = [{"full-question": f"q{i}", "answer": f"a{i}"} for i in range(10)]
    rows = preference.synthesize_preference_rows(qa, seed=3)
    assert rows == jax_preference.synthesize_preference_rows(qa, seed=3)
    assert len(rows) == 10 and all(r["chosen"] != r["rejected"] for r in rows)
    assert preference.synthesize_preference_rows(qa[:1]) == []
    p = tmp_path / "prefs.jsonl"
    p.write_text("".join(json.dumps(r) + "\n" for r in rows))
    assert preference.load_preference_dataset(str(p)) == rows
    assert jax_preference.load_preference_dataset(str(p)) == rows
    # the repo's source schema reads as QA rows (the parquet's), then synthesizes
    src = tmp_path / "qa.jsonl"
    with open(os.path.join(ROOT, "data", "final_qa_data_unique.jsonl")) as f:
        src.write_text("".join(next(f) for _ in range(12)))
    convert_jsonl_to_parquet(str(src), str(tmp_path / "qa.parquet"), verbose=False)
    assert preference.preference_schema(preference.load_rows(str(src))) == "qa"
    assert (preference.load_preference_dataset(str(src), seed=5)
            == jax_preference.load_preference_dataset(str(tmp_path / "qa.parquet"), seed=5))
    with pytest.raises(ValueError, match="unrecognized preference schema"):
        preference.preference_schema([{"x": 1}])


def test_dpo_arrays_equal_jax():
    tok, jtok = load_tokenizer("byte-chatml"), jax_load_tokenizer("byte-chatml")
    got = preference.build_dpo_arrays(_rows(6), tok, SEQ, system_prompt=SYS)
    want = jax_preference.build_dpo_arrays(_rows(6), jtok, SEQ, system_prompt=SYS)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    empty = preference.build_dpo_arrays([], tok, SEQ)
    assert all(v.shape == (0, SEQ) for v in empty.values())
    with pytest.raises(ValueError, match="lost its completion"):
        preference.build_dpo_arrays(_rows(2), tok, 16, system_prompt=SYS)


# ---------------------------------------------------------------------------
# a DPOTrainer run against the JAX one
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from llm_fine_tune_distributed_tpu.train.dpo import DPOTrainer as JaxDPOTrainer

    tmp = tmp_path_factory.mktemp("dpo")
    data = tmp / "data"
    data.mkdir()
    with open(os.path.join(ROOT, "data", "final_qa_data_unique.jsonl")) as f:
        (data / "qa.jsonl").write_text("".join(next(f) for _ in range(40)))
    convert_jsonl_to_parquet(str(data / "qa.jsonl"), str(data / "qa.parquet"), verbose=False)
    mc = jax_configs.get_preset("tiny")
    jax_hf_io.save_hf_checkpoint(jax.device_get(jax_tf.init_params(
        jax.random.PRNGKey(3), mc, dtype=jnp.float32)), str(tmp / "model"))
    (tmp / "model" / "config.json").write_text(json.dumps(jax_configs.to_hf_dict(mc)))

    def recipe(out, **kw):
        return dict(model_name=str(tmp / "model"), model_preset="tiny",
                    tokenizer_path="byte-chatml", data_dir=str(data), output_dir=str(tmp / out),
                    objective="dpo", system_prompt="You are a wilderness survival expert.",
                    dpo_beta=0.5, epochs=1, per_device_batch_size=4,
                    gradient_accumulation_steps=2, learning_rate=2e-3, max_seq_length=256,
                    eval_steps=2, logging_steps=1, save_steps=0, compute_dtype="float32",
                    use_native_loader=False, **kw)

    jtrainer = JaxDPOTrainer(JaxTrainConfig(**recipe("jax_out", dataset_file="qa.parquet",
                                                     mesh=JaxMeshConfig(data=1, fsdp=1))))
    # in f32 the JAX reference leaves alias the trainable buffers its step
    # donates; the same values in buffers of their own
    jtrainer.ref_trainable = {k: jax.device_put(jnp.array(v, copy=True), v.sharding)
                              for k, v in jtrainer.ref_trainable.items()}
    jtrainer.train()
    ptrainer = DPOTrainer(TrainConfig(**recipe("port_out", dataset_file="qa.jsonl")),
                          device="cpu")
    summary = ptrainer.train()
    return jtrainer, ptrainer, summary, tmp


def test_dpo_history_matches_jax(runs):
    jtrainer, ptrainer, _, _ = runs
    assert (ptrainer.n_train, ptrainer.n_val) == (jtrainer.n_train, jtrainer.n_val)
    for k, v in jtrainer.train_arrays.items():
        np.testing.assert_array_equal(ptrainer.train_arrays[k], np.asarray(v), err_msg=k)
    jhist, phist = jtrainer.metrics.history, ptrainer.metrics.history
    assert [h["step"] for h in phist] == [h["step"] for h in jhist]
    assert sum("eval_rewards_accuracy" in h for h in phist) >= 2
    assert phist[0]["loss"] == pytest.approx(math.log(2.0), abs=1e-6)
    for want, got in zip(jhist, phist):
        for key in COMPARED:
            assert (key in got) == (key in want), (got["step"], key)
            if key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=REL, atol=1e-7,
                                           err_msg=f"step {want['step']} {key}")


def test_dpo_artifacts_and_throughput(runs):
    _, ptrainer, summary, tmp = runs
    out = tmp / "port_out"
    for name in ("best_model/model.safetensors", "training_summary.json",
                 "training_history.json"):
        assert (out / name).exists(), name
    assert 0.0 <= ptrainer.extra_eval_logs["eval_rewards_accuracy"] <= 1.0
    meter = ptrainer.throughput
    assert meter.tokens_per_sample == 2 * 256
    assert meter.real_tokens == sum(
        int(b["chosen_attention_mask"].sum() + b["rejected_attention_mask"].sum())
        for b in ptrainer.loader.epoch(0))
    assert summary["training_samples"] == ptrainer.n_train
