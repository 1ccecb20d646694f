"""The port's train and eval steps, optimizer and freezing policy against the
JAX package's, on the ``tiny`` preset in f32 with the same parameters
(carried over with ``params_from_jax``) and the same batch.

Tolerances: loss and grad_norm to 1e-5 relative (f32 sums taken in another
order by the two frameworks); updated parameters and gradients to 1e-5 of
each leaf's largest entry (Adam's first update, lr * g / (|g| + eps),
amplifies f32 noise in gradient entries near eps); the optimizer alone to 1e-6 relative; frozen
leaves bit-unchanged; masks and counts exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu.config import TrainConfig as JaxTrainConfig
from llm_fine_tune_distributed_tpu.data import dataset as jax_dataset
from llm_fine_tune_distributed_tpu.data.tokenizer import ByteChatMLTokenizer
from llm_fine_tune_distributed_tpu.models import configs as jax_configs
from llm_fine_tune_distributed_tpu.models import transformer as jax_tf
from llm_fine_tune_distributed_tpu.parallel import freeze as jax_freeze
from llm_fine_tune_distributed_tpu.parallel import optimizer as jax_opt
from llm_fine_tune_distributed_tpu.train import step as jax_step
from llm_fine_tune_distributed_tpu.train.state import TrainState as JaxTrainState
from llm_fine_tune_distributed_tpu.utils.tree import split_by_mask as jax_split
from llm_fine_tune_distributed_tpu_torch.config import TrainConfig
from llm_fine_tune_distributed_tpu_torch.models import configs
from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree, params_from_jax
from llm_fine_tune_distributed_tpu_torch.models.transformer import param_shapes
from llm_fine_tune_distributed_tpu_torch.parallel import freeze, optimizer
from llm_fine_tune_distributed_tpu_torch.train import step
from llm_fine_tune_distributed_tpu_torch.train.state import TrainState

ROOT = __import__("os").path.dirname(__import__("os").path.dirname(__import__("os").path.abspath(__file__)))
REL = 1e-5
RECIPE = dict(compute_dtype="float32", learning_rate=5e-5, max_seq_length=256,
              gradient_accumulation_steps=2, per_device_batch_size=2, attention_impl="flash")


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
    """JAX tiny params, the port's copy, and one [accum=2, 2, 256] batch of
    real rows (ragged, right-padded) with a completion mask."""
    mc = jax_configs.get_preset("tiny")
    params = jax_tf.init_params(jax.random.PRNGKey(0), mc, dtype=jnp.float32)
    flat = {k: np.asarray(v) for k, v in flatten_tree(jax.device_get(params)).items()}
    rows = jax_dataset.load_qa_dataset(f"{ROOT}/data/qa_dataset.parquet")[:4]
    kw = {"system_prompt": "You are a survival expert."}
    arrays = jax_dataset.build_sft_arrays(rows, ByteChatMLTokenizer(), 256, **kw)
    arrays["completion_mask"] = jax_dataset.build_sft_arrays(
        rows, ByteChatMLTokenizer(), 256, True, **kw)["loss_mask"]
    assert arrays["attention_mask"].min() == 0  # some rows are padded
    batch = {k: v.reshape(2, 2, 256) for k, v in arrays.items() if k != "lengths"}
    return mc, params, flat, batch


def _jax_state(mc, params, cfg, total_steps=10):
    mask = jax_freeze.trainable_mask(params, mc, cfg)
    trainable, frozen = jax_split(params, mask)
    opt = jax_opt.build_optimizer(cfg, None, total_steps=total_steps, data_parallel_size=1)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), trainable=trainable, frozen=frozen,
                         opt_state=opt.init(trainable)), opt


def _port_state(mc, flat, cfg, total_steps=10):
    params = params_from_jax(flat, mc)
    mask = freeze.trainable_mask(params, mc, cfg)
    trainable = {k: v.clone().requires_grad_() for k, v in params.items() if mask[k]}
    frozen = {k: v.clone() for k, v in params.items() if not mask[k]}
    opt = optimizer.build_optimizer(cfg, total_steps=total_steps)
    return TrainState(step=0, trainable=trainable, frozen=frozen, opt_state=opt.init(trainable)), opt


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def test_train_and_eval_step_match_jax(setup):
    mc, params, flat, batch = setup
    jcfg, pcfg = JaxTrainConfig(**RECIPE), TrainConfig(**RECIPE)
    jstate, jopt = _jax_state(mc, params, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k != "completion_mask"}
    jnew, jm = jax.jit(jax_step.build_train_step(mc, jcfg, jopt))(jstate, jbatch)

    pmc = configs.get_preset("tiny")
    pstate, popt = _port_state(pmc, flat, pcfg)
    frozen_before = {k: v.clone() for k, v in pstate.frozen.items()}
    tbatch = _torch_batch({k: v for k, v in batch.items() if k != "completion_mask"})
    pnew, pm = step.build_train_step(pmc, pcfg, popt)(pstate, tbatch)

    assert pnew.step == int(jnew.step) == 1
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=REL)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=REL)
    assert set(pnew.trainable) == {_dot(k) for k in jnew.trainable}
    for k, v in jnew.trainable.items():
        want = np.asarray(v)
        np.testing.assert_allclose(pnew.trainable[_dot(k)].detach().numpy(), want,
                                   rtol=REL, atol=REL * np.abs(want).max(), err_msg=k)
    for k, v in pnew.frozen.items():
        assert torch.equal(v, frozen_before[k]), k

    # eval on the updated state: sums (ce, tokens, answer ce, answer tokens)
    ebatch = {k: v[0] for k, v in batch.items()}
    jout = jax.jit(jax_step.build_eval_step(mc, jcfg))(jnew, {k: jnp.asarray(v) for k, v in ebatch.items()})
    pout = step.build_eval_step(pmc, pcfg)(pnew, _torch_batch(ebatch))
    assert len(pout) == len(jout) == 4
    for got, want in zip(pout, jout):
        np.testing.assert_allclose(float(got), float(want), rtol=REL)


def test_microbatch_gradients_match_jax(setup):
    mc, params, flat, batch = setup
    jcfg, pcfg = JaxTrainConfig(**RECIPE), TrainConfig(**RECIPE)
    jstate, _ = _jax_state(mc, params, jcfg)
    micro = {k: v[1] for k, v in batch.items() if k != "completion_mask"}
    jloss_fn = jax_step.make_loss_fn(mc, jcfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        jstate.trainable, jstate.frozen, {k: jnp.asarray(v) for k, v in micro.items()})
    pmc = configs.get_preset("tiny")
    pstate, _ = _port_state(pmc, flat, pcfg)
    ploss, _ = step.make_loss_fn(pmc, pcfg)(pstate.trainable, pstate.frozen, _torch_batch(micro))
    pgrads = torch.autograd.grad(ploss, list(pstate.trainable.values()))
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=REL)
    for (name, _), g in zip(pstate.trainable.items(), pgrads):
        want = np.asarray(jgrads[name.replace(".", "/")])
        err = np.abs(g.numpy() - want).max()
        assert err <= REL * np.abs(want).max(), f"{name}: max|d| {err:.3e}"


@pytest.mark.parametrize("policy", ["full", "dots_no_batch"])
def test_remat_gives_the_gradients_of_no_remat(setup, policy):
    _, _, flat, batch = setup
    pmc = configs.get_preset("tiny")
    micro = _torch_batch({k: v[0] for k, v in batch.items() if k != "completion_mask"})
    grads = {}
    for remat in (False, True):
        cfg = TrainConfig(**RECIPE, gradient_checkpointing=remat, remat_policy=policy)
        state, _ = _port_state(pmc, flat, cfg)
        loss, _ = step.make_loss_fn(pmc, cfg)(state.trainable, state.frozen, micro)
        grads[remat] = torch.autograd.grad(loss, list(state.trainable.values()))
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_unported_remat_policy_raises(setup):
    _, _, flat, batch = setup
    pmc = configs.get_preset("tiny")
    cfg = TrainConfig(**RECIPE, remat_policy="mlp")
    state, _ = _port_state(pmc, flat, cfg)
    micro = _torch_batch({k: v[0] for k, v in batch.items() if k != "completion_mask"})
    with pytest.raises(NotImplementedError, match="mlp"):
        step.make_loss_fn(pmc, cfg)(state.trainable, state.frozen, micro)


@pytest.mark.parametrize("schedule,warmup", [("linear", 0.0), ("linear", 0.25),
                                             ("constant", 0.0), ("cosine", 0.25)])
def test_schedule_clip_and_adamw_match_optax(schedule, warmup):
    """Six updates of random gradients, some above the clip norm, with
    weight decay: the lr at every count to 1e-6 relative, parameters to 1e-6
    of each leaf's largest entry (XLA may fuse the moment updates into FMAs,
    and Adam amplifies the last-bit differences where a moment cancels)."""
    kw = dict(learning_rate=1e-2, lr_schedule=schedule, warmup_ratio=warmup, weight_decay=0.01,
              max_grad_norm=1.0)
    total = 8
    jopt = jax_opt.build_optimizer(JaxTrainConfig(**kw), None, total_steps=total, data_parallel_size=1)
    jsched = jax_opt.build_lr_schedule(JaxTrainConfig(**kw), total, 1)
    popt = optimizer.build_optimizer(TrainConfig(**kw), total_steps=total)
    rng = np.random.default_rng(0)
    init = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": rng.standard_normal((11,)).astype(np.float32)}
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    pparams = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    pstate = popt.init(pparams)
    for t in range(6):
        scale = 3.0 if t % 2 else 0.05  # alternate clipped / unclipped
        grads = {k: (scale * rng.standard_normal(v.shape)).astype(np.float32) for k, v in init.items()}
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        norm = popt.step(pparams, {k: torch.from_numpy(v) for k, v in grads.items()}, pstate)
        want_norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
        np.testing.assert_allclose(popt.schedule(t), float(jsched(t)), rtol=1e-6)
        for k in init:
            want = np.asarray(jparams[k])
            np.testing.assert_allclose(pparams[k].numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(), err_msg=f"{k} after update {t + 1}")


@pytest.mark.parametrize("preset", ["tiny", "smollm3_3b"])
def test_freeze_mask_and_counts_match_jax(preset):
    """Names and shapes only (no weights): the trainable set, tested on the
    port's dotted names, and describe_trainable's counts."""
    mc = jax_configs.get_preset(preset)
    shapes = jax.eval_shape(lambda: jax_tf.init_params(jax.random.PRNGKey(0), mc))
    jcfg = JaxTrainConfig()
    jmask = {_dot(k): bool(v) for k, v in flatten_tree(jax_freeze.trainable_mask(shapes, mc, jcfg),
                                                       prefix="").items()}
    jreport = jax_freeze.describe_trainable(shapes, jax_freeze.trainable_mask(shapes, mc, jcfg))
    pmc = configs.get_preset(preset)
    meta = {k: torch.empty(s, device="meta") for k, s in param_shapes(pmc).items()}
    pmask = freeze.trainable_mask(meta, pmc, TrainConfig())
    assert pmask == jmask
    assert freeze.describe_trainable(meta, pmask) == jreport
    n = pmc.num_layers
    assert pmask[f"model.layers.{n - 1}.mlp.up_proj.kernel"] and pmask["model.embed_tokens.weight"]
    assert not pmask[f"model.layers.{n - 3}.self_attn.q_proj.kernel"]
    assert not pmask["model.norm.weight"]
    assert pmc.num_params == mc.num_params
