"""The frozen trunk in w8a8 int8 (``frozen_compute="int8"``) against the JAX
package's, on the ``tiny`` preset in f32 (the counterparts of
tests/test_frozen_trunk.py): the boundary rule, the trunk's quantization,
the carried int8 leaves, the loss and gradients of one microbatch, the
trunk's matmul count and saved tensors, and the trainer.

Tolerances: quantization bitwise; loss to 1e-5 relative and each trainable
gradient to 1e-4 of its leaf's largest entry (f32 sums in another order, so
the row quantizer sees hidden states that differ in the last bits: on this
batch 18 of the 466,944 activation codes of real rows differ by one between
the packages; pad rows differ more, by the pad-row attention rule, and
carry no loss); the trainer's history to 1e-4 relative, as in
tests/test_torch_trainer.py; int8 against the plain trunk to 2% of the loss,
the JAX test's band for two 8-bit roundings.
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
from llm_fine_tune_distributed_tpu.data.convert import convert_jsonl_to_parquet
from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu.infer.generate import load_model_dir as jax_load_model_dir
from llm_fine_tune_distributed_tpu.models import configs as jax_configs
from llm_fine_tune_distributed_tpu.models import hf_io as jax_hf_io
from llm_fine_tune_distributed_tpu.models import transformer as jax_tf
from llm_fine_tune_distributed_tpu.parallel import freeze as jax_freeze
from llm_fine_tune_distributed_tpu.train import step as jax_step
from llm_fine_tune_distributed_tpu.utils.tree import flatten_dict
from llm_fine_tune_distributed_tpu_torch.config import TrainConfig
from llm_fine_tune_distributed_tpu_torch.models import configs
from llm_fine_tune_distributed_tpu_torch.models import transformer as tf
from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax
from llm_fine_tune_distributed_tpu_torch.ops import int8_matmul as pmm
from llm_fine_tune_distributed_tpu_torch.ops.int8 import dequantize_int8
from llm_fine_tune_distributed_tpu_torch.parallel import freeze
from llm_fine_tune_distributed_tpu_torch.train import step
from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROJECTIONS_PER_LAYER = 7  # q, k, v, o, gate, up, down
LOSS_REL, GRAD_REL, HIST_REL = 1e-5, 1e-4, 1e-4
RECIPE = dict(compute_dtype="float32", max_seq_length=256, per_device_batch_size=2,
              gradient_accumulation_steps=1, attention_impl="flash")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the test workers share the machine's cores, and
    more threads per worker only oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _dot(path):
    return path.replace("/", ".")


@pytest.fixture(scope="module")
def setup():
    """JAX tiny f32 params (flat, ``/`` paths), the JAX trunk split and
    quantized, and one [2, 256] batch of real, right-padded rows."""
    mc = jax_configs.get_preset("tiny")
    params = jax_tf.init_params(jax.random.PRNGKey(0), mc, dtype=jnp.float32)
    jcfg = JaxTrainConfig(**RECIPE, frozen_compute="int8")
    flat_mask = flatten_dict(jax_freeze.trainable_mask(params, mc, jcfg))
    flat = flatten_dict(params)
    boundary = jax_freeze.frozen_trunk_boundary(flat_mask, mc.num_layers)
    trainable = {k: v for k, v in flat.items() if flat_mask[k]}
    frozen = {k: v for k, v in flat.items() if not flat_mask[k]}
    frozen_i8, _ = jax_freeze.quantize_trunk_int8(frozen, boundary)
    rows = jax_dataset.load_qa_dataset(f"{ROOT}/data/qa_dataset.parquet")[:2]
    arrays = jax_dataset.build_sft_arrays(rows, ByteChatMLTokenizer(), 256,
                                          system_prompt="You are a survival expert.")
    assert arrays["attention_mask"].min() == 0  # some rows are padded
    batch = {k: v for k, v in arrays.items() if k != "lengths"}
    return dict(mc=mc, boundary=boundary, trainable=trainable, frozen=frozen,
                frozen_i8=frozen_i8, batch=batch)


def _port(leaves, mc):
    """JAX flat leaves -> the port's parameters through ``params_from_jax``."""
    return params_from_jax({_dot(k): np.asarray(v) for k, v in leaves.items()}, mc)


def _port_loss(setup, frozen_compute, **kw):
    """(loss, trainable leaves) of the port's loss on the setup's batch; the
    frozen leaves are the JAX ones carried over."""
    pmc = configs.get_preset("tiny")
    cfg = TrainConfig(**RECIPE, frozen_compute=frozen_compute,
                      gradient_checkpointing=kw.pop("remat", True))
    trainable = {k: v.requires_grad_() for k, v in _port(setup["trainable"], pmc).items()}
    int8 = frozen_compute == "int8"
    frozen = _port(setup["frozen_i8" if int8 else "frozen"], pmc)
    boundary = setup["boundary"] if int8 else 0
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in setup["batch"].items()}
    loss, _ = step.make_loss_fn(pmc, cfg, frozen_layers=boundary, **kw)(trainable, frozen, batch)
    return loss, trainable


# ------------------------------------------------------------- the boundary


@pytest.mark.parametrize("strategy,expected", [("last_n_and_head", 2), ("none", 0)])
def test_boundary_rule_matches_jax(strategy, expected):
    mc, pmc = jax_configs.get_preset("tiny"), configs.get_preset("tiny")
    shapes = jax.eval_shape(lambda: jax_tf.init_params(jax.random.PRNGKey(0), mc))
    jcfg = JaxTrainConfig(model_preset="tiny", freeze_strategy=strategy)
    jmask = flatten_dict(jax_freeze.trainable_mask(shapes, mc, jcfg))
    meta = {k: torch.empty(s, device="meta") for k, s in tf.param_shapes(pmc).items()}
    pmask = freeze.trainable_mask(meta, pmc, TrainConfig(freeze_strategy=strategy))
    got = freeze.frozen_trunk_boundary(pmask, pmc.num_layers)
    assert got == jax_freeze.frozen_trunk_boundary(jmask, mc.num_layers) == expected


def test_quantize_trunk_matches_jax_bitwise(setup):
    """The port's quantize_trunk_int8 on the same f32 leaves gives exactly the
    JAX leaves: boundary x 7 projections, norms untouched."""
    pmc = configs.get_preset("tiny")
    got, n_quant = freeze.quantize_trunk_int8(_port(setup["frozen"], pmc), setup["boundary"])
    want = setup["frozen_i8"]
    assert n_quant == setup["boundary"] * PROJECTIONS_PER_LAYER
    assert set(got) == {_dot(k) for k in want}
    codes = [k for k in got if k.endswith(".kernel_int8")]
    assert len(codes) == n_quant
    for k in codes:
        assert int(k.split(".")[2]) < setup["boundary"] and k + "_scale" in got
        # K-major memory, the kernel's layout: strides (1, in), no second copy
        assert got[k].stride() == (1, got[k].shape[0]), (k, got[k].stride())
    for k, v in want.items():
        np.testing.assert_array_equal(got[_dot(k)].numpy(), np.asarray(v), err_msg=k)
    assert "model.layers.0.input_layernorm.weight" in got


def test_params_from_jax_carries_int8_leaves(setup):
    pmc = configs.get_preset("tiny")
    carried = _port(setup["frozen_i8"], pmc)
    name = "model.layers.1.mlp.down_proj.kernel_int8"
    assert carried[name].dtype == torch.int8
    assert carried[name + "_scale"].dtype == torch.float32
    for k, v in setup["frozen_i8"].items():
        np.testing.assert_array_equal(carried[_dot(k)].numpy(), np.asarray(v), err_msg=k)
        if k.endswith("kernel_int8"):  # K-major, as quantize_trunk_int8 makes them
            assert carried[_dot(k)].stride() == (1, v.shape[0]), k


def test_make_loss_fn_rejects_unknown_frozen_compute():
    with pytest.raises(ValueError, match="unknown frozen_compute"):
        step.make_loss_fn(configs.get_preset("tiny"), TrainConfig(frozen_compute="fp8"))


# ----------------------------------------------------------------- parity


def test_int8_loss_and_grads_match_jax(setup):
    """The port's int8 make_loss_fn against JAX make_loss_fn(frozen_layers=
    boundary) on the same carried weights and batch; every trainable
    gradient is nonzero (the trunk drops only the embedding's path through
    it)."""
    jcfg = JaxTrainConfig(**RECIPE, frozen_compute="int8")
    jloss_fn = jax_step.make_loss_fn(setup["mc"], jcfg, frozen_layers=setup["boundary"])
    jbatch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        setup["trainable"], setup["frozen_i8"], jbatch)
    ploss, trainable = _port_loss(setup, "int8")
    pgrads = torch.autograd.grad(ploss, list(trainable.values()))
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=LOSS_REL)
    for name, g in zip(trainable, pgrads):
        want = np.asarray(jgrads[name.replace(".", "/")])
        assert np.abs(g.numpy()).max() > 0.0, f"dead gradient for {name}"
        err = np.abs(g.numpy() - want).max()
        assert err <= GRAD_REL * np.abs(want).max(), f"{name}: max|d| {err:.3e}"


def test_trunk_matmul_runs_every_trunk_projection(setup):
    calls = []

    def counting(x, q, compute_dtype):
        calls.append(tuple(q["int8"].shape))
        return pmm.int8_w8a8_matmul(x, q, compute_dtype)

    loss, _ = _port_loss(setup, "int8", trunk_matmul=counting)
    assert len(calls) == setup["boundary"] * PROJECTIONS_PER_LAYER
    mc = setup["mc"]
    assert (mc.hidden_size, mc.intermediate_size) in calls and torch.isfinite(loss)


def test_trunk_saves_nothing_for_the_backward(setup):
    """The counterpart of JAX's backward-DCE guard: bytes saved for the
    backward (saved_tensors_hooks, no remat) are fewer with the int8 trunk,
    and none are saved between the trunk's first and last projection."""
    n_trunk = setup["boundary"] * PROJECTIONS_PER_LAYER
    saved = {}
    for mode in ("bf16", "int8"):
        count = {"calls": 0, "total": 0, "in_trunk": 0}

        def counting(x, q, compute_dtype):
            count["calls"] += 1
            return pmm.int8_w8a8_matmul(x, q, compute_dtype)

        def pack(t):
            nbytes = t.numel() * t.element_size()
            count["total"] += nbytes
            count["in_trunk"] += nbytes if 0 < count["calls"] < n_trunk else 0
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            _port_loss(setup, mode, remat=False, trunk_matmul=counting)
        saved[mode] = count
    assert saved["int8"]["calls"] == n_trunk and saved["bf16"]["calls"] == 0
    assert saved["int8"]["in_trunk"] == 0, saved
    assert saved["int8"]["total"] < saved["bf16"]["total"], saved


def test_int8_loss_close_to_plain_trunk(setup):
    loss_plain, _ = _port_loss(setup, "bf16")
    loss_i8, _ = _port_loss(setup, "int8")
    loss_plain, loss_i8 = loss_plain.item(), loss_i8.item()
    assert abs(loss_i8 - loss_plain) < 0.02 * loss_plain


def test_plain_compute_ignores_frozen_layers(setup):
    """``frozen_compute="bf16"`` leaves the forward bit-identical whatever
    ``frozen_layers`` says."""
    pmc = configs.get_preset("tiny")
    params = _port({**setup["trainable"], **setup["frozen"]}, pmc)
    ids = torch.from_numpy(setup["batch"]["input_ids"]).long()
    base, _ = tf.forward(params, ids, pmc, compute_dtype=torch.float32)
    same, _ = tf.forward(params, ids, pmc, compute_dtype=torch.float32, frozen_layers=2)
    assert torch.equal(base, same)


# ---------------------------------------------------------------- trainer


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both trainers with the int8 trunk, one epoch over the same 120 rows
    from the same tiny f32 model directory."""
    tmp = tmp_path_factory.mktemp("sft_int8")
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

    def recipe(out, **kw):
        return dict(model_name=str(model), model_preset="tiny", tokenizer_path="byte-chatml",
                    data_dir=str(data), output_dir=str(tmp / out), epochs=1, eval_steps=2,
                    max_seq_length=256, system_prompt="You are a wilderness survival expert.",
                    compute_dtype="float32", use_native_loader=False, frozen_compute="int8", **kw)

    from llm_fine_tune_distributed_tpu.train.trainer import SFTTrainer as JaxSFTTrainer

    jtrainer = JaxSFTTrainer(JaxTrainConfig(**recipe("jax_out", dataset_file="qa.parquet",
                                                     mesh=JaxMeshConfig(data=1, fsdp=1))))
    jsummary = jtrainer.train()
    ptrainer = SFTTrainer(TrainConfig(**recipe("port_out", dataset_file="qa.jsonl")), device="cpu")
    codes_before = {k: v.clone() for k, v in ptrainer.state.frozen.items() if "_int8" in k}
    psummary = ptrainer.train()
    return dict(tmp=tmp, jtrainer=jtrainer, jsummary=jsummary, ptrainer=ptrainer,
                psummary=psummary, codes_before=codes_before)


def test_int8_trainer_history_matches_jax(runs):
    jhist, phist = runs["jtrainer"].metrics.history, runs["ptrainer"].metrics.history
    assert [h["step"] for h in phist] == [h["step"] for h in jhist] == [1, 2]
    for want, got in zip(jhist, phist):
        for key in ("loss", "grad_norm", "learning_rate", "eval_loss", "eval_loss_answer"):
            assert (key in got) == (key in want), (got["step"], key)
            if key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=HIST_REL,
                                           err_msg=f"step {want['step']} {key}")
    np.testing.assert_allclose(runs["psummary"]["final_eval_loss"],
                               runs["jsummary"]["final_eval_loss"], rtol=HIST_REL)


def test_int8_trainer_state_matches_jax_and_keeps_the_trunk(runs):
    """The port's trunk equals the JAX trainer's bit for bit and training
    left it unchanged; codes stay int8 and scales f32."""
    ptrainer, jtrainer = runs["ptrainer"], runs["jtrainer"]
    boundary = ptrainer.frozen_boundary
    assert boundary == 2
    jfrozen = {_dot(k): np.asarray(v) for k, v in flatten_tree(jax.device_get(
        jtrainer.state.frozen)).items() if "_int8" in k}
    codes = {k: v for k, v in ptrainer.state.frozen.items() if "_int8" in k}
    assert len(codes) == 2 * boundary * PROJECTIONS_PER_LAYER
    assert set(codes) == set(jfrozen) == set(runs["codes_before"])
    for k, v in codes.items():
        assert v.dtype == (torch.int8 if k.endswith("_int8") else torch.float32), k
        assert torch.equal(v, runs["codes_before"][k]), k
        np.testing.assert_array_equal(v.numpy(), jfrozen[k], err_msg=k)


def test_int8_best_model_holds_the_decoded_trunk(runs):
    """best_model/ holds plain kernels (the trunk decoded), loads through the
    JAX ``load_model_dir`` and equals the port's state in bf16."""
    ptrainer = runs["ptrainer"]
    jparams, _ = jax_load_model_dir(str(runs["tmp"] / "port_out" / "best_model"))
    loaded = {k: np.asarray(v, np.float32) for k, v in flatten_tree(jax.device_get(jparams)).items()}
    state = {**ptrainer.state.trainable, **ptrainer.state.frozen}
    want = {}
    for k, v in state.items():
        if k.endswith(".kernel_int8"):
            want[k[: -len("_int8")]] = dequantize_int8({"int8": v, "int8_scale": state[k + "_scale"]},
                                                       torch.float32)
        elif not k.endswith(".kernel_int8_scale"):
            want[k] = v.detach()
    assert set(loaded) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(loaded[k], v.to(torch.bfloat16).float().numpy(), err_msg=k)
