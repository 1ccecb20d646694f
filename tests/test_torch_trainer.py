"""The port's ``SFTTrainer`` against the JAX package's on the ``tiny``
preset in f32, from the same model directory and the same 120 rows; the
training entry point's device contract; every unported knob raises.

The JAX trainer runs on the CPU, where its ``attention_impl="flash"`` takes
the XLA attention; the port's CPU path runs the flash kernels' plain
versions. The two differ only on pad query rows, which carry no loss, so the
histories agree to f32 rounding: 1e-4 relative over 6 steps and 3 evals.
The fine-tuning recipes (packing, DPO, LoRA, QLoRA) train through the
training entry point; their parity with the JAX trainer is in
``tests/test_torch_{packing,dpo,lora_train,nf4}.py``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu.config import MeshConfig as JaxMeshConfig
from llm_fine_tune_distributed_tpu.config import TrainConfig as JaxTrainConfig
from llm_fine_tune_distributed_tpu.data.convert import convert_jsonl_to_parquet
from llm_fine_tune_distributed_tpu.infer.generate import load_model_dir as jax_load_model_dir
from llm_fine_tune_distributed_tpu.models import configs as jax_configs
from llm_fine_tune_distributed_tpu.models import hf_io as jax_hf_io
from llm_fine_tune_distributed_tpu.models import transformer as jax_tf
from llm_fine_tune_distributed_tpu_torch import cli
from llm_fine_tune_distributed_tpu_torch.config import MeshConfig, TrainConfig
from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree
from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4
SHORT_PROMPT = "You are a wilderness survival expert."
COMPARED = ("loss", "grad_norm", "learning_rate", "eval_loss", "eval_loss_answer")
# training_summary.json keys of the reference (train/trainer.py _save_artifacts)
SUMMARY_KEYS = ("model_name", "dataset_path", "epochs", "batch_size", "learning_rate",
                "trainable_params", "total_params", "training_samples", "validation_samples",
                "final_train_loss", "world_size", "distributed_training", "final_eval_loss",
                "wall_clock_seconds", "samples_per_second_per_chip")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the test workers share the machine's cores, and
    more threads per worker only oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """120 rows as JSONL (the port) and parquet (JAX), and a tiny model
    directory holding JAX-initialized f32 weights."""
    tmp = tmp_path_factory.mktemp("sft")
    data = tmp / "data"
    data.mkdir()
    with open(os.path.join(ROOT, "data", "final_qa_data_unique.jsonl")) as f:
        lines = [next(f) for _ in range(120)]
    (data / "qa.jsonl").write_text("".join(lines))
    convert_jsonl_to_parquet(str(data / "qa.jsonl"), str(data / "qa.parquet"), verbose=False)
    mc = jax_configs.get_preset("tiny")
    params = jax_tf.init_params(jax.random.PRNGKey(3), mc, dtype=jnp.float32)
    model = tmp / "model"
    jax_hf_io.save_hf_checkpoint(jax.device_get(params), str(model))
    (model / "config.json").write_text(json.dumps(jax_configs.to_hf_dict(mc)))
    return tmp


def _recipe(workdir, out, **kw):
    return dict(model_name=str(workdir / "model"), model_preset="tiny", tokenizer_path="byte-chatml",
                data_dir=str(workdir / "data"), output_dir=str(workdir / out), epochs=2,
                eval_steps=2, max_seq_length=256, system_prompt=SHORT_PROMPT,
                compute_dtype="float32", use_native_loader=False, **kw)


@pytest.fixture(scope="module")
def runs(workdir):
    jcfg = JaxTrainConfig(**_recipe(workdir, "jax_out", dataset_file="qa.parquet",
                                    mesh=JaxMeshConfig(data=1, fsdp=1)))
    from llm_fine_tune_distributed_tpu.train.trainer import SFTTrainer as JaxSFTTrainer

    jtrainer = JaxSFTTrainer(jcfg)
    jsummary = jtrainer.train()
    ptrainer = SFTTrainer(TrainConfig(**_recipe(workdir, "port_out", dataset_file="qa.jsonl")),
                          device="cpu")
    psummary = ptrainer.train()
    return jtrainer, jsummary, ptrainer, psummary


def test_history_matches_the_jax_trainer(runs):
    jtrainer, _, ptrainer, _ = runs
    jhist, phist = jtrainer.metrics.history, ptrainer.metrics.history
    assert [h["step"] for h in phist] == [h["step"] for h in jhist] == [1, 2, 4, 6]
    for want, got in zip(jhist, phist):
        assert got["epoch"] == want["epoch"]
        for key in COMPARED:
            assert (key in got) == (key in want), (got["step"], key)
            if key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=REL,
                                           err_msg=f"step {want['step']} {key}")
    assert sum("eval_loss" in h for h in phist) == 3


def test_artifacts_and_summary(runs, workdir):
    _, jsummary, ptrainer, psummary = runs
    out = workdir / "port_out"
    for name in ("training_history.json", "training_summary.json", "best_model/model.safetensors",
                 "best_model/config.json", "best_model/byte_chatml_tokenizer.json"):
        assert (out / name).exists(), name
    with open(out / "training_summary.json") as f:
        summary = json.load(f)
    for key in SUMMARY_KEYS:
        assert key in summary and key in jsummary, key
    for key in ("trainable_params", "total_params", "training_samples", "validation_samples",
                "epochs", "batch_size"):
        assert summary[key] == jsummary[key], key
    np.testing.assert_allclose(summary["final_eval_loss"], jsummary["final_eval_loss"], rtol=REL)
    with open(out / "training_history.json") as f:
        assert json.load(f) == json.loads(json.dumps(ptrainer.metrics.history))


def test_best_model_loads_in_the_jax_package(runs, workdir):
    """best_model/ (bf16) loads through the JAX ``load_model_dir`` to the
    port's final parameters rounded to bf16."""
    _, _, ptrainer, _ = runs
    jparams, jmc = jax_load_model_dir(str(workdir / "port_out" / "best_model"))
    assert jmc == jax_configs.get_preset("tiny")
    loaded = {k: np.asarray(v, np.float32) for k, v in flatten_tree(jax.device_get(jparams)).items()}
    state = {**ptrainer.state.trainable, **ptrainer.state.frozen}
    assert set(loaded) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(loaded[k], v.detach().to(torch.bfloat16).float().numpy(),
                                      err_msg=k)


def test_train_main_without_a_card_exits_naming_it(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    assert cli.train_main([]) != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_module_without_a_card_exits_non_zero(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="", OUTPUT_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-m", "llm_fine_tune_distributed_tpu_torch.cli"],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


UNPORTED = {
    "loss_chunk_size": dict(loss_chunk_size=64),
    "loss_vocab_chunk": dict(loss_vocab_chunk=128),
    "adafactor": dict(optimizer="adafactor"),
    "lion": dict(optimizer="lion"),
    "ring": dict(attention_impl="ring"),
    "ulysses": dict(attention_impl="ulysses"),
    "mesh": dict(mesh=MeshConfig(data=2, fsdp=1)),
    "train_port": dict(train_port=0),
    "native_loader": dict(use_native_loader=True),
    "remat_mlp": dict(remat_policy="mlp"),
}


RECIPES = {
    "packing": dict(packing=True, max_seq_length=512),  # rows of ~300 tokens pack at 512
    "dpo": dict(objective="dpo"),
    "lora": dict(freeze_strategy="lora", lora_rank=4),
    "qlora": dict(freeze_strategy="qlora", lora_rank=4),
}


@pytest.mark.parametrize("knob", sorted(RECIPES))
def test_recipe_knobs_train_through_the_entry_point(workdir, knob, capsys):
    """``train_main --config`` with each recipe's knob trains (DPO routed to
    ``DPOTrainer`` as the JAX entry point routes it): finite losses at every
    logged step, a finite final eval, and each recipe's own artifact."""
    out = workdir / f"recipe_{knob}"
    kw = _recipe(workdir, f"recipe_{knob}", dataset_file="qa.jsonl")
    kw.update(epochs=1, eval_steps=0, save_steps=0)
    kw.update(RECIPES[knob])
    config = out.parent / f"recipe_{knob}.json"
    TrainConfig(**kw).save(str(config))
    assert cli.train_main(["--config", str(config), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    history = json.loads((out / "training_history.json").read_text())
    assert history and all(np.isfinite(h["loss"]) for h in history)
    summary = json.loads((out / "training_summary.json").read_text())
    assert np.isfinite(summary["final_eval_loss"])
    assert (out / "best_model" / "model.safetensors").exists()
    if knob == "packing":
        assert "token occupancy" in printed
    if knob == "dpo":
        assert printed.count("DPO on cpu") == 1 and "rewards_accuracy" in history[0]
    if knob in ("lora", "qlora"):
        assert (out / "adapter" / "adapter_model.safetensors").exists()
        assert ("QLoRA: " in printed) == (knob == "qlora")


@pytest.mark.parametrize("knob", sorted(UNPORTED))
def test_unported_knobs_raise(workdir, knob):
    kw = _recipe(workdir, f"refused_{knob}", dataset_file="qa.jsonl")
    kw.update(UNPORTED[knob])
    with pytest.raises(NotImplementedError):
        SFTTrainer(TrainConfig(**kw), device="cpu")


def test_int8_trunk_refuses_dpo(workdir):
    """The JAX trainer refuses the int8 trunk outside SFT too."""
    kw = _recipe(workdir, "refused_int8_dpo", dataset_file="qa.jsonl")
    with pytest.raises(ValueError, match="objective='sft' only"):
        SFTTrainer(TrainConfig(**kw, frozen_compute="int8", objective="dpo"), device="cpu")
    with pytest.raises(ValueError, match="unknown frozen_compute"):
        SFTTrainer(TrainConfig(**kw, frozen_compute="fp8"), device="cpu")


def test_unported_env_vars_raise():
    with pytest.raises(NotImplementedError, match="AIM_REPO"):
        TrainConfig().apply_env_overrides({"AIM_REPO": "/tmp/aim"})
    cfg = TrainConfig().apply_env_overrides({"EPOCHS": "3", "MODEL_PRESET": "none", "SEED": "7"})
    assert (cfg.epochs, cfg.model_preset, cfg.seed) == (3, None, 7)
