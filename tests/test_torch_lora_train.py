"""LoRA training in the port (``parallel/lora.add_lora_params``, the LoRA
freeze of ``parallel/freeze``, ``freeze_strategy="lora"`` in
``train/trainer``) against the JAX package, the training cases of
``tests/test_lora.py`` on the ``tiny`` preset in f32:

- the identity at init (B = 0), the adapters' coverage and shapes, the
  port's init deterministic and independent of the leaves' order;
- the freeze trains ``lora_a`` / ``lora_b`` only, as the JAX mask does;
- the merge against the adapted forward, and the PEFT round trip;
- a LoRA SFT run whose history is within 1e-4 of the JAX trainer's with the
  JAX package's A carried across (the two packages draw A from different
  generators); its ``adapter/`` loads in the JAX ``load_lora_adapter`` and
  in the port's ``AdapterRegistry``, whose greedy tokens equal the merged
  ``best_model/``'s.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu.config import MeshConfig as JaxMeshConfig
from llm_fine_tune_distributed_tpu.config import TrainConfig as JaxTrainConfig
from llm_fine_tune_distributed_tpu.data.convert import convert_jsonl_to_parquet
from llm_fine_tune_distributed_tpu.models import configs as jax_configs
from llm_fine_tune_distributed_tpu.models import hf_io as jax_hf_io
from llm_fine_tune_distributed_tpu.models import transformer as jax_tf
from llm_fine_tune_distributed_tpu.parallel import freeze as jax_freeze
from llm_fine_tune_distributed_tpu.parallel import lora as jax_lora
from llm_fine_tune_distributed_tpu.utils.tree import flatten_dict as jax_flatten
from llm_fine_tune_distributed_tpu_torch.config import TrainConfig
from llm_fine_tune_distributed_tpu_torch.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu_torch.infer.adapters import AdapterRegistry
from llm_fine_tune_distributed_tpu_torch.infer.engine import ContinuousBatchingEngine
from llm_fine_tune_distributed_tpu_torch.infer.generate import Generator, load_model_dir
from llm_fine_tune_distributed_tpu_torch.infer.sampling import GenerationConfig
from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree
from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
from llm_fine_tune_distributed_tpu_torch.models.transformer import forward, init_params
from llm_fine_tune_distributed_tpu_torch.parallel import lora
from llm_fine_tune_distributed_tpu_torch.parallel.freeze import trainable_mask
from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer
from llm_fine_tune_distributed_tpu_torch.utils.tree import split_by_mask

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = get_preset("tiny")
REL = 1e-4
COMPARED = ("loss", "grad_norm", "learning_rate", "eval_loss", "eval_loss_answer")
SYS = "You are a wilderness survival expert."


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _ids():
    return torch.from_numpy(np.random.RandomState(1).randint(0, CFG.vocab_size, (2, 32)))


def test_init_is_identity():
    """B = 0 at init: the adapted forward equals the base forward exactly."""
    params = init_params(CFG, seed=0)
    adapted = lora.add_lora_params(params, seed=7, rank=4)
    ref, _ = forward(params, _ids(), CFG, compute_dtype=torch.float32)
    out, _ = forward(adapted, _ids(), CFG, compute_dtype=torch.float32)
    assert torch.equal(out, ref)


def test_adapter_coverage_and_shapes():
    adapted = lora.add_lora_params(init_params(CFG, seed=0), seed=7, rank=4, alpha=8.0)
    assert sum(k.endswith(".lora_a") for k in adapted) == CFG.num_layers * 7
    assert sum(k.endswith(".lora_b") for k in adapted) == CFG.num_layers * 7
    q = "model.layers.0.self_attn.q_proj."
    assert adapted[q + "lora_a"].shape == (CFG.hidden_size, 4)
    assert adapted[q + "lora_b"].shape[0] == 4 and not adapted[q + "lora_b"].any()
    assert float(adapted[q + "lora_scale"]) == 2.0
    bound = float(np.sqrt(3.0) * np.sqrt(1.0 / CFG.hidden_size))
    assert adapted[q + "lora_a"].abs().max() <= bound
    # the same leaf set as the JAX init, name for name
    jadapted = jax_lora.add_lora_params(jax_tf.init_params(jax.random.PRNGKey(0),
                                                           jax_configs.get_preset("tiny")),
                                        jax.random.PRNGKey(7), rank=4)
    assert set(adapted) == set(flatten_tree(jadapted))


def test_init_is_deterministic_and_order_independent():
    params = init_params(CFG, seed=0)
    a = lora.add_lora_params(params, seed=7, rank=4)
    b = lora.add_lora_params(dict(reversed(list(params.items()))), seed=7, rank=4)
    c = lora.add_lora_params(params, seed=8, rank=4)
    for k in a:
        if k.endswith(".lora_a"):
            assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k]), k
    a1, a2 = (a[f"model.layers.0.self_attn.{m}.lora_a"] for m in ("q_proj", "o_proj"))
    assert not torch.equal(a1, a2)  # each module draws its own A


def test_freeze_mask_trains_only_adapters():
    adapted = lora.add_lora_params(init_params(CFG, seed=0), seed=7, rank=4)
    for strategy in ("lora", "qlora"):
        mask = trainable_mask(adapted, CFG, TrainConfig(freeze_strategy=strategy,
                                                        model_preset="tiny"))
        trainable, frozen = split_by_mask(adapted, mask)
        assert trainable and all(k.endswith((".lora_a", ".lora_b")) for k in trainable)
        assert all(not k.endswith((".lora_a", ".lora_b")) for k in frozen)
        jadapted = jax_lora.add_lora_params(jax_tf.init_params(jax.random.PRNGKey(0),
                                                               jax_configs.get_preset("tiny")),
                                            jax.random.PRNGKey(7), rank=4)
        jmask = jax_flatten(jax_freeze.trainable_mask(
            jadapted, jax_configs.get_preset("tiny"),
            JaxTrainConfig(freeze_strategy=strategy, model_preset="tiny")))
        assert {k.replace("/", "."): v for k, v in jmask.items()} == mask


def test_merge_matches_adapted_forward():
    params = lora.add_lora_params(init_params(CFG, seed=0), seed=7, rank=4)
    params = {k: torch.full_like(v, 0.01) if k.endswith(".lora_b") else v
              for k, v in params.items()}
    adapted, _ = forward(params, _ids(), CFG, compute_dtype=torch.float32)
    merged = lora.merge_lora(params)
    assert not any(k.endswith((".lora_a", ".lora_b")) for k in merged)
    merged_out, _ = forward(merged, _ids(), CFG, compute_dtype=torch.float32)
    np.testing.assert_allclose(merged_out.numpy(), adapted.numpy(), atol=1e-4)
    base, _ = forward(lora.strip_lora(params), _ids(), CFG, compute_dtype=torch.float32)
    assert (merged_out - base).abs().max() > 1e-4


def test_dots_no_batch_saves_the_rank_r_product_only(monkeypatch):
    """Under remat's ``dots_no_batch`` (it keeps the outputs of ``mm``) the
    adapters add only their rank-r ``x @ A`` per projection to the saved
    set; the full-width delta is recomputed in the backward, where saving
    it would keep as much again as the projections' own outputs."""
    from llm_fine_tune_distributed_tpu_torch.models import transformer

    plain, saved = transformer._dots_no_batch_policy, []

    def recording(ctx, op, *args, **kwargs):
        policy = plain(ctx, op, *args, **kwargs)
        if policy == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            saved.append(args[0].shape[0] * args[1].shape[1])  # the mm's output elements
        return policy

    monkeypatch.setattr(transformer, "_dots_no_batch_policy", recording)
    base = init_params(CFG, seed=0)
    counts = {}
    for name, params in (("base", base), ("lora", lora.add_lora_params(base, seed=7, rank=4))):
        params = {k: v.clone().requires_grad_(v.is_floating_point()) for k, v in params.items()}
        saved.clear()
        logits, _ = forward(params, _ids(), CFG, compute_dtype=torch.float32, remat=True,
                            remat_policy="dots_no_batch")
        logits.sum().backward()
        counts[name] = sum(saved)
    assert counts["base"] > 0
    assert counts["lora"] - counts["base"] == CFG.num_layers * 7 * _ids().numel() * 4


def test_peft_roundtrip(tmp_path):
    params = lora.add_lora_params(init_params(CFG, seed=0), seed=7, rank=4, alpha=8.0)
    params = {k: torch.full_like(v, 0.01) if k.endswith(".lora_b") else v
              for k, v in params.items()}
    lora.save_lora_adapter(params, str(tmp_path / "adapter"),
                           TrainConfig(freeze_strategy="lora", lora_rank=4, lora_alpha=8.0))
    acfg = json.loads((tmp_path / "adapter" / "adapter_config.json").read_text())
    assert (acfg["r"], acfg["lora_alpha"], acfg["lora_dropout"]) == (4, 8.0, 0.05)
    restored = lora.load_lora_adapter(init_params(CFG, seed=0), str(tmp_path / "adapter"))
    a, _ = forward(params, _ids(), CFG, compute_dtype=torch.float32)
    b, _ = forward(restored, _ids(), CFG, compute_dtype=torch.float32)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert float(restored["model.layers.0.self_attn.q_proj.lora_scale"]) == 2.0


# ---------------------------------------------------------------------------
# a LoRA SFT run against the JAX trainer
# ---------------------------------------------------------------------------

N_ROWS = 40


def make_workdir(tmp):
    """``tmp/data`` with the first rows as JSONL (the port) and parquet
    (JAX), and ``tmp/model``, a tiny model directory of JAX-initialized f32
    weights both trainers start from."""
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


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return make_workdir(tmp_path_factory.mktemp("lora_sft"))


def recipe(workdir, out, **kw):
    """A short LoRA (or QLoRA) SFT recipe over ``workdir``: 4 steps, 2 evals."""
    return dict(model_name=str(workdir / "model"), model_preset="tiny",
                tokenizer_path="byte-chatml", data_dir=str(workdir / "data"),
                output_dir=str(workdir / out), epochs=1, per_device_batch_size=4,
                gradient_accumulation_steps=2, eval_steps=2, max_seq_length=256,
                system_prompt=SYS, compute_dtype="float32", use_native_loader=False,
                lora_rank=4, learning_rate=5e-3, save_steps=0, **kw)


def carry_adapters_from_jax(jtrainer, ptrainer):
    """The JAX trainer's initial trainable leaves into the port trainer
    (the adapters' A: the two packages draw it from different generators)."""
    jinit = {k.replace("/", "."): np.array(v) for k, v in
             jax_flatten(jtrainer.state.trainable).items()}
    assert set(jinit) == set(ptrainer.state.trainable)
    with torch.no_grad():
        for k, v in ptrainer.state.trainable.items():
            v.copy_(torch.from_numpy(jinit[k]))


def assert_history_matches(jtrainer, ptrainer):
    jhist, phist = jtrainer.metrics.history, ptrainer.metrics.history
    assert [h["step"] for h in phist] == [h["step"] for h in jhist]
    assert sum("eval_loss" in h for h in phist) >= 2
    for want, got in zip(jhist, phist):
        for key in COMPARED:
            assert (key in got) == (key in want), (got["step"], key)
            if key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=REL,
                                           err_msg=f"step {want['step']} {key}")


@pytest.fixture(scope="module")
def runs(workdir):
    from llm_fine_tune_distributed_tpu.train.trainer import SFTTrainer as JaxSFTTrainer

    jtrainer = JaxSFTTrainer(JaxTrainConfig(**recipe(
        workdir, "jax_out", dataset_file="qa.parquet", freeze_strategy="lora",
        mesh=JaxMeshConfig(data=1, fsdp=1))))
    ptrainer = SFTTrainer(TrainConfig(**recipe(workdir, "port_out", dataset_file="qa.jsonl",
                                               freeze_strategy="lora")), device="cpu")
    carry_adapters_from_jax(jtrainer, ptrainer)
    jtrainer.train()
    summary = ptrainer.train()
    return jtrainer, ptrainer, summary


def test_lora_sft_history_matches_jax(runs):
    jtrainer, ptrainer, summary = runs
    assert_history_matches(jtrainer, ptrainer)
    assert all(k.endswith((".lora_a", ".lora_b")) for k in ptrainer.state.trainable)
    assert summary["trainable_params"] == jtrainer.trainable_report["trainable_parameters"]
    assert summary["total_params"] == jtrainer.trainable_report["total_parameters"]
    assert summary["trainable_params"] < 0.12 * summary["total_params"]


def test_lora_adapter_loads_in_jax_and_in_the_registry(runs, workdir, tmp_path):
    """``adapter/`` through the JAX ``load_lora_adapter`` gives the port's
    adapted forward; through the port's registry, served greedy, the tokens
    of the merged ``best_model/``."""
    _, ptrainer, _ = runs
    out = workdir / "port_out"
    assert (out / "adapter" / "adapter_model.safetensors").exists()
    jbase, _ = jax_lora_base(workdir)
    jadapted = jax_lora.load_lora_adapter(jbase, str(out / "adapter"))
    want, _ = jax_tf.forward(jadapted, jnp.asarray(_ids().numpy()), jax_configs.get_preset("tiny"),
                             compute_dtype=jnp.float32, logits_dtype=jnp.float32)
    state = {**ptrainer.state.trainable, **ptrainer.state.frozen}
    got, _ = forward({k: v.detach() for k, v in state.items()}, _ids(), CFG,
                     compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(want)).max()))

    base, _ = load_model_dir(str(workdir / "model"), device="cpu", dtype=torch.float32)
    root = tmp_path / "adapters"
    shutil.copytree(out / "adapter", root / "trained")
    gen = Generator(base, CFG, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                    eos_token_ids=[], device="cpu")
    merged, _ = load_model_dir(str(out / "best_model"), device="cpu", dtype=torch.float32)
    merged_gen = Generator(merged, CFG, ByteChatMLTokenizer(), compute_dtype=torch.float32,
                           eos_token_ids=[], device="cpu")
    prompt = list(b"How do I purify water?")
    cfg = GenerationConfig(max_new_tokens=8, do_sample=False)
    eng = ContinuousBatchingEngine(gen, adapters=AdapterRegistry(base, str(root)), slots=2,
                                   buf_len=64, prompt_bucket=32)
    try:
        served = list(eng.submit(prompt, cfg, adapter="trained", timeout=120))
    finally:
        eng.close()
    assert served == list(merged_gen.generate_ids(prompt, cfg))


def jax_lora_base(workdir):
    """The JAX tree of the model directory both trainers start from."""
    from llm_fine_tune_distributed_tpu.infer.generate import load_model_dir as jax_load

    return jax_load(str(workdir / "model"))
