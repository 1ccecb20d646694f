"""Tensor-parallel training in the port over gloo processes on the CPU,
against the JAX trainers on 2 and 4 of the conftest's 8 virtual devices, on
the ``tiny`` preset in f32 (``tests/test_torch_data_parallel.py``'s recipe
and model directory):

- ``SFTTrainer`` at ``tensor=2`` (two ranks) and at ``fsdp=2 x tensor=2``
  (four ranks): the history (loss, grad norm, lr, eval losses) within 1e-4
  of the JAX trainer's on the same mesh, and the final trainable leaves
  within 1e-4 of each leaf's max; at init each rank holds, bit for bit, the
  JAX trainer's addressable shard of every leaf on the device of its rank;
  the loss never forms the whole vocab: the largest logits a rank holds
  are ``[b, s, vocab / 2]``, and the logits' all-gather is never called;
  the tensor group's collectives per microbatch are the count
  ``tensor_collectives`` states;
- LoRA, QLoRA (NF4 base, on ``tiny`` widened to hidden 256 and
  intermediate 512 so the row-parallel NF4 rows split into whole blocks),
  DPO and the int8 trunk (bf16 compute) at ``tensor=2``, each against its
  JAX run on 2 devices with the tolerance stated beside it;
- checkpoints: one written at ``tensor=2`` resumes bit for bit at
  ``tensor=2`` (to the uninterrupted run's final state), restores bit for
  bit at world 1 and at ``fsdp=2``, and a world-1 checkpoint restores bit
  for bit at ``tensor=2``;
- planted faults: "copy to tensor" without its backward all-reduce fails
  the gradient check against world 1, and a global norm that counts the
  leaves every tensor rank holds whole once per rank fails the norm check.

The two worlds run this file as a script (``_launch``), each once with all
its scenarios, while this process runs the JAX trainers.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.config import MeshConfig, TrainConfig
from llm_fine_tune_distributed_tpu_torch.runtime import distributed

ROOT = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(ROOT)
REL = 1e-4  # tests/test_torch_trainer.py's
ROWS = 24
LAUNCH_TIMEOUT_S = 420
SHORT_PROMPT = "You are a wilderness survival expert."
COMPARED = ("loss", "grad_norm", "learning_rate", "eval_loss", "eval_loss_answer")
DPO_COMPARED = ("loss", "grad_norm", "learning_rate", "eval_loss", "rewards_chosen",
                "rewards_rejected", "rewards_margin", "rewards_accuracy", "eval_rewards_accuracy")
RESUME_STEP = 4
WIDE = dict(hidden_size=256, intermediate_size=512)
# the int8 trunk in bf16 against the JAX run: the history and the leaves
# within 1e-2 relative. Both round every product to bf16; the port sums the
# row-parallel trunk's f32 partial products and the JAX run its int32 ones
# before the scales, and each package's bf16 matmuls accumulate in their own
# order, so a few bf16 roundings differ by one ulp (2^-8 relative).
INT8_BF16_REL = 1e-2
# LoRA's adapters against the JAX run: each leaf within 1e-2 of its norm
# (Frobenius), not elementwise. At the lr of 5e-3 Adam moves every entry by
# about the lr whatever its gradient, so an entry whose gradient is near
# zero can move the other way on a rounding-sized difference (one entry of
# 2048 by 3.3% of the leaf's max, 4.5e-4 of its norm, the worst seen)
LORA_LEAF_REL = 1e-2


def _recipe(workdir, out, **kw):
    """tests/test_torch_data_parallel.py's recipe at 2 rows x 2 microbatches
    per data-parallel rank, every step logged, a save every 2 steps."""
    return dict(dict(model_name=str(workdir / "model"), model_preset="tiny",
                     tokenizer_path="byte-chatml", data_dir=str(workdir / "data"),
                     dataset_file="qa.jsonl", output_dir=str(workdir / out), epochs=1,
                     eval_steps=2, logging_steps=1, max_seq_length=256,
                     system_prompt=SHORT_PROMPT, compute_dtype="float32",
                     per_device_batch_size=2, gradient_accumulation_steps=2, save_steps=0,
                     save_total_limit=10, use_native_loader=False), **kw)


def _lora_recipe(workdir, out, **kw):
    return _recipe(workdir, out, freeze_strategy="lora", lora_rank=4, learning_rate=5e-3, **kw)


def _qlora_recipe(workdir, out, **kw):
    return _recipe(workdir, out, model_name=str(workdir / "model_wide"), model_preset="none",
                   freeze_strategy="qlora", lora_rank=4, learning_rate=5e-3, **kw)


def _dpo_recipe(workdir, out, **kw):
    return _recipe(workdir, out, objective="dpo", dpo_beta=0.5, learning_rate=2e-3,
                   max_seq_length=192, **kw)


def _int8_recipe(workdir, out, **kw):
    return _recipe(workdir, out, frozen_compute="int8", compute_dtype="bfloat16", **kw)


TP2 = dict(data=1, fsdp=1, tensor=2)


# ------------------------------------------------------------- the ranks


def _state(trainer):
    """The whole trainable leaves and moments (a collective)."""
    opt = trainer._full_opt_state()
    return {"step": trainer.state.step, "count": opt["count"],
            "trainable": {k: v.detach().clone() for k, v in trainer._full_trainable().items()},
            "mu": {k: v.clone() for k, v in opt["mu"].items()},
            "nu": {k: v.clone() for k, v in opt["nu"].items()}}


def _micro_grads(trainer):
    """Loss, whole gradients and the tensor group's collectives (forward,
    backward) of the first microbatch of the first step, from the init
    state; the gradients stay off the leaves."""
    from llm_fine_tune_distributed_tpu_torch.runtime.distributed import tensor_collectives
    from llm_fine_tune_distributed_tpu_torch.train.step import make_loss_fn

    loss_fn = make_loss_fn(trainer.model_config, trainer.config, shards=trainer.shards,
                           tensor=trainer.tensor)
    full = next(iter(trainer.loader.global_epoch(0)))
    mb = {k: v[0] for k, v in trainer._device_batch(trainer.loader.local_rows(full)).items()}
    tokens = torch.as_tensor(trainer._loss_tokens(full)[0])
    tensor_collectives.reset()
    loss, _ = loss_fn(trainer.state.trainable, trainer.state.frozen, mb, tokens)
    forward = tensor_collectives.forward
    loss.backward()
    counts = {"forward": forward, "backward": tensor_collectives.backward,
              "replays": tensor_collectives.forward - forward}
    grads = {k: p.grad.detach().clone() for k, p in trainer.state.trainable.items()}
    for p in trainer.state.trainable.values():
        p.grad = None
    whole = {k: trainer.tensor.whole(k, g) for k, g in grads.items()}
    return float(loss.detach()), whole, grads, counts


def _planted(trainer):
    """The first microbatch's loss, gradients and global norm, and its
    gradients with "copy to tensor"'s backward all-reduce removed."""
    from llm_fine_tune_distributed_tpu_torch.parallel import optimizer as opt_mod
    from llm_fine_tune_distributed_tpu_torch.runtime.distributed import _CopyToTensor

    loss, whole, grads, counts = _micro_grads(trainer)
    right_norm = float(opt_mod.layout_global_norm(grads, trainer.shards, trainer.tensor))
    backward = _CopyToTensor.backward
    _CopyToTensor.backward = staticmethod(lambda ctx, grad: (grad, None))
    try:
        _, no_reduce, _, _ = _micro_grads(trainer)
    finally:
        _CopyToTensor.backward = backward
    return {"loss": loss, "grads": whole, "counts": counts, "norm": right_norm,
            "no_backward_reduce": no_reduce}


def _norm_counted_twice(trainer):
    """The first step's grad norm with every leaf's squares summed over the
    tensor group, the leaves each rank holds whole (LoRA's A and B) too."""
    from llm_fine_tune_distributed_tpu_torch.parallel import optimizer as opt_mod

    full = next(iter(trainer.loader.global_epoch(0)))
    batch = trainer._device_batch(trainer.loader.local_rows(full))
    sliced = opt_mod._tensor_sliced
    opt_mod._tensor_sliced = lambda tensor, name: True
    try:
        _, metrics = trainer.train_step(trainer.state, batch, trainer._loss_tokens(full))
    finally:
        opt_mod._tensor_sliced = sliced
    return float(metrics["grad_norm"])


def _rank_main(workdir, world):
    """Every scenario of the module docstring for this world, in turn."""
    from llm_fine_tune_distributed_tpu_torch.models import transformer as tf_mod
    from llm_fine_tune_distributed_tpu_torch.models.configs import get_preset
    from llm_fine_tune_distributed_tpu_torch.train import step as step_mod
    from llm_fine_tune_distributed_tpu_torch.train import trainer as trainer_mod
    from llm_fine_tune_distributed_tpu_torch.train.dpo import DPOTrainer

    distributed.initialize_distributed(device="cpu")
    rank = distributed.process_index()
    out = {"logits_shapes": set(), "gathers": 0}
    vp_ce = step_mod.vocab_parallel_ce

    def recording_ce(logits, targets, tensor):
        out["logits_shapes"].add(tuple(logits.shape))
        return vp_ce(logits, targets, tensor)

    step_mod.vocab_parallel_ce = recording_ce
    gather_last = tf_mod.tp_all_gather_last

    def counting_gather(*a, **kw):
        out["gathers"] += 1
        return gather_last(*a, **kw)

    tf_mod.tp_all_gather_last = counting_gather
    writes = {"checkpoint": 0}
    write = trainer_mod.CheckpointManager._write

    def counted_write(*a, **kw):
        writes["checkpoint"] += 1
        return write(*a, **kw)

    trainer_mod.CheckpointManager._write = counted_write
    saves = {}

    def keep_saves(trainer):
        save = trainer._ckpt_save

        def saving(ckpt, step, metrics):
            save(ckpt, step, metrics)
            saves[(os.path.basename(trainer.config.output_dir), step)] = _state(trainer)
        trainer._ckpt_save = saving

    def carry(name):
        """The JAX trainer's initial adapters (written by the test process)."""
        def before(trainer):
            init = torch.load(workdir / f"{name}_init.pt")
            assert set(init) == set(trainer.state.trainable)
            with torch.no_grad():
                for k, v in trainer.state.trainable.items():
                    v.copy_(init[k])
        return before

    def run(name, recipe, cls=trainer_mod.SFTTrainer, before=None, model_config=None,
            train=True, **kw):
        trainer = cls(TrainConfig(**recipe(workdir, name, **kw)), model_config=model_config,
                      device="cpu")
        init = {k: v.detach().clone() for k, v in {**trainer.state.trainable,
                                                    **trainer.state.frozen}.items()}
        if before is not None:
            before(trainer)
        summary = trainer.train() if train else None
        out[name] = {"history": trainer.metrics.history, "summary": summary, "init": init,
                     "state": _state(trainer), "writes": dict(writes)}
        writes["checkpoint"] = 0
        return trainer

    if world == 4:
        run("fsdp_tp", _recipe, mesh=MeshConfig(data=1, fsdp=2, tensor=2), desync_check_steps=1)
    else:
        trainer = run("tp", _recipe, before=keep_saves, mesh=MeshConfig(**TP2), save_steps=2,
                      desync_check_steps=1)
        out["desync_checks"] = trainer.desync.checks
        trainer = trainer_mod.SFTTrainer(TrainConfig(**_recipe(
            workdir, "planted", mesh=MeshConfig(**TP2))), device="cpu")
        out["planted"] = _planted(trainer)
        del trainer
        # (resume) the tensor=2 checkpoint at tensor=2, and restored at fsdp=2;
        # the world-1 one restored at tensor=2
        if rank == 0:
            for name in ("tp_resume", "fsdp_restore"):
                shutil.copytree(workdir / "tp" / "checkpoints", workdir / name / "checkpoints")
            shutil.copytree(workdir / "solo" / "checkpoints", workdir / "w1_restore" / "checkpoints")
        distributed.barrier("cpu")
        run("tp_resume", _recipe, before=keep_saves, mesh=MeshConfig(**TP2), save_steps=2,
            resume_from_checkpoint=str(RESUME_STEP))
        for name, mesh in (("fsdp_restore", MeshConfig(data=1, fsdp=2)),
                           ("w1_restore", MeshConfig(**TP2))):
            trainer = trainer_mod.SFTTrainer(TrainConfig(**_recipe(workdir, name, mesh=mesh)),
                                             device="cpu")
            trainer.state = trainer._restore(trainer._checkpoint_manager(), RESUME_STEP)
            out[name] = {"state": _state(trainer)}
            del trainer
        run("lora", _lora_recipe, before=carry("lora"), mesh=MeshConfig(**TP2))
        trainer = trainer_mod.SFTTrainer(TrainConfig(**_lora_recipe(
            workdir, "lora_planted", mesh=MeshConfig(**TP2))), device="cpu")
        carry("lora")(trainer)
        out["lora_norm_twice"] = _norm_counted_twice(trainer)
        del trainer
        wide = get_preset("tiny").replace(**WIDE)
        run("qlora", _qlora_recipe, before=carry("qlora"), model_config=wide,
            mesh=MeshConfig(**TP2))
        run("dpo", _dpo_recipe, cls=DPOTrainer, mesh=MeshConfig(**TP2))
        run("int8", _int8_recipe, mesh=MeshConfig(**TP2))
        out["saves"] = saves
    torch.save(out, workdir / f"world{world}_rank{rank}.pt")
    distributed.destroy()


def _launch(workdir, world):
    port = distributed.free_port()
    procs = []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
        env.update(distributed.rendezvous_env(rank, world, port), PYTHONPATH=ROOT,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(workdir), str(world)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
    return procs


def _wait(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (o, e)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{o[-3000:]}\n{e[-6000:]}"
    return outs


# -------------------------------------------------------------- the tests


def _dot(k):
    return k.replace("/", ".")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX trainers' initial adapters and the port's world-1 run (its
    checkpoints), then both worlds' launches, and meanwhile here the JAX
    trainers on 2 and 4 devices."""
    import jax
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.config import MeshConfig as JaxMeshConfig
    from llm_fine_tune_distributed_tpu.config import TrainConfig as JaxTrainConfig
    from llm_fine_tune_distributed_tpu.data.convert import convert_jsonl_to_parquet
    from llm_fine_tune_distributed_tpu.models import configs as jax_configs
    from llm_fine_tune_distributed_tpu.models import hf_io as jax_hf_io
    from llm_fine_tune_distributed_tpu.models import transformer as jax_tf
    from llm_fine_tune_distributed_tpu.train.dpo import DPOTrainer as JaxDPOTrainer
    from llm_fine_tune_distributed_tpu.train.trainer import SFTTrainer as JaxSFTTrainer
    from llm_fine_tune_distributed_tpu_torch.models.carry import flatten_tree
    from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

    tmp = tmp_path_factory.mktemp("tp")
    data = tmp / "data"
    data.mkdir()
    with open(os.path.join(ROOT, "data", "final_qa_data_unique.jsonl")) as f:
        (data / "qa.jsonl").write_text("".join(next(f) for _ in range(ROWS)))
    convert_jsonl_to_parquet(str(data / "qa.jsonl"), str(data / "qa.parquet"), verbose=False)
    mc = jax_configs.get_preset("tiny")
    wide = dataclasses.replace(mc, **WIDE)
    for name, cfg in (("model", mc), ("model_wide", wide)):
        jax_hf_io.save_hf_checkpoint(jax.device_get(jax_tf.init_params(
            jax.random.PRNGKey(3), cfg, dtype=jnp.float32)), str(tmp / name))
        (tmp / name / "config.json").write_text(json.dumps(jax_configs.to_hf_dict(cfg)))

    def jax_trainer(cls, recipe, out, model_config=None, **kw):
        trainer = cls(JaxTrainConfig(**recipe(tmp, out, dataset_file="qa.parquet", **kw)),
                      model_config=model_config)
        if cls is JaxDPOTrainer:  # tests/test_torch_dpo.py: unalias the f32 reference
            trainer.ref_trainable = {k: jax.device_put(jnp.array(v, copy=True), v.sharding)
                                     for k, v in trainer.ref_trainable.items()}
        return trainer

    tp2, fsdp_tp = JaxMeshConfig(**TP2), JaxMeshConfig(data=1, fsdp=2, tensor=2)
    trainers = {
        "tp": jax_trainer(JaxSFTTrainer, _recipe, "jax_tp", mesh=tp2),
        "fsdp_tp": jax_trainer(JaxSFTTrainer, _recipe, "jax_fsdp_tp", mesh=fsdp_tp),
        "lora": jax_trainer(JaxSFTTrainer, _lora_recipe, "jax_lora", mesh=tp2),
        "qlora": jax_trainer(JaxSFTTrainer, _qlora_recipe, "jax_qlora", model_config=wide,
                             mesh=tp2),
        "dpo": jax_trainer(JaxDPOTrainer, _dpo_recipe, "jax_dpo", mesh=tp2),
        "int8": jax_trainer(JaxSFTTrainer, _int8_recipe, "jax_int8", mesh=tp2),
    }
    for name in ("lora", "qlora"):
        torch.save({_dot(k): torch.from_numpy(np.array(v)) for k, v in flatten_tree(
            jax.device_get(trainers[name].state.trainable)).items()}, tmp / f"{name}_init.pt")

    # the port at world 1, same global batch: the checkpoints the ranks
    # restore at tensor=2, and the reference of the planted faults
    solo_saves = {}
    solo = SFTTrainer(TrainConfig(**_recipe(tmp, "solo", save_steps=2)), device="cpu")
    full = next(iter(solo.loader.global_epoch(0)))
    mb = {k: torch.from_numpy(np.ascontiguousarray(v[0])) for k, v in full.items()}
    from llm_fine_tune_distributed_tpu_torch.train.step import make_loss_fn

    loss = make_loss_fn(solo.model_config, solo.config)(solo.state.trainable, solo.state.frozen,
                                                        mb)[0]
    loss.backward()
    solo_grads = {k: p.grad.detach().clone() for k, p in solo.state.trainable.items()}
    from llm_fine_tune_distributed_tpu_torch.parallel.optimizer import global_norm

    solo_micro = {"loss": float(loss.detach()), "grads": solo_grads,
                  "norm": float(global_norm(solo_grads.values()))}
    for p in solo.state.trainable.values():
        p.grad = None
    save = solo._ckpt_save

    def saving(ckpt, step, metrics):
        save(ckpt, step, metrics)
        solo_saves[step] = {k: v.detach().clone() for k, v in solo.state.trainable.items()}
    solo._ckpt_save = saving
    solo.train()
    solo_run = {"history": solo.metrics.history, "saves": solo_saves, "micro": solo_micro}

    procs = {world: _launch(tmp, world) for world in (2, 4)}
    try:
        def device_shards(leaves, mesh):
            """{name: [the addressable shard on mesh device r, for each r]} of
            the JAX rules' placement on the trainer's mesh."""
            from llm_fine_tune_distributed_tpu.parallel.sharding import shard_params as jax_shard

            devices = list(np.asarray(mesh.devices).reshape(-1))
            out = {}
            for k, v in jax_shard(leaves, mesh).items():
                by_device = {s.device: s for s in v.addressable_shards}
                out[_dot(k)] = [np.asarray(jax.device_get(by_device[d].data)) for d in devices]
            return out

        jax_runs = {}
        for name, trainer in trainers.items():
            init = (device_shards({**trainer.state.trainable, **trainer.state.frozen},
                                  trainer.mesh) if name in ("tp", "fsdp_tp") else None)
            trainer.train()
            leaves = flatten_tree(jax.device_get(trainer.state.trainable))
            jax_runs[name] = {"history": trainer.metrics.history, "init_shards": init,
                              "trainable": {_dot(k): np.asarray(v, np.float32)
                                            for k, v in leaves.items()}}
        outs = {world: _wait(p) for world, p in procs.items()}
    finally:
        for p in [q for ps in procs.values() for q in ps]:
            if p.poll() is None:
                p.kill()
    ranks = {world: [torch.load(tmp / f"world{world}_rank{r}.pt") for r in range(world)]
             for world in (2, 4)}
    return {"tmp": tmp, "jax": jax_runs, "solo": solo_run, "ranks": ranks, "outs": outs}


def _hold_history(got, want, keys, rtol, atol=0.0):
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for w, g in zip(want, got):
        for key in keys:
            assert (key in g) == (key in w), (g["step"], key)
            if key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=rtol, atol=atol,
                                           err_msg=f"step {w['step']} {key}")


def _hold_leaves(got, want, rel):
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(np.asarray(got[k].float(), np.float32), w, rtol=0,
                                   atol=rel * float(np.abs(w).max()), err_msg=k)


def _leaves_close(got, want, rel):
    try:
        _hold_leaves(got, want, rel)
        return True
    except AssertionError:
        return False


@pytest.mark.parametrize("name,world", [("tp", 2), ("fsdp_tp", 4)])
def test_tensor_parallel_sft_matches_the_jax_trainer(runs, name, world):
    want = runs["jax"][name]
    for rank in runs["ranks"][world]:
        got = rank[name]
        _hold_history(got["history"], want["history"], COMPARED, REL)
        assert sum("eval_loss" in h for h in got["history"]) >= 1
        _hold_leaves(got["state"]["trainable"], want["trainable"], REL)
        summary = got["summary"]
        assert summary["world_size"] == world and summary["distributed_training"] is True
        assert summary["mesh"]["tensor"] == 2 and summary["mesh"]["fsdp"] == world // 2


@pytest.mark.parametrize("name,world", [("tp", 2), ("fsdp_tp", 4)])
def test_init_slices_are_the_jax_addressable_shards(runs, name, world):
    """Each rank's leaves at init, trainable and frozen, equal bit for bit the
    shard the JAX trainer places on the device of its rank: the tensor slice,
    then the fsdp slice of it; a replicated leaf whole."""
    want = runs["jax"][name]["init_shards"]
    for r, rank in enumerate(runs["ranks"][world]):
        got = rank[name]["init"]
        assert set(got) == set(want)
        for k, shards in want.items():
            assert tuple(got[k].shape) == shards[r].shape, (k, r)
            np.testing.assert_array_equal(got[k].float().numpy(), shards[r].astype(np.float32),
                                          err_msg=f"{k} rank {r}")
    # the vocab rows over tensor (and the hidden over fsdp)
    assert want["model.embed_tokens.weight"][0].shape == (512 // 2, 64 // (world // 2))


def test_the_loss_never_forms_the_whole_vocab(runs):
    """Every logits tensor the cross-entropy reads is a rank's vocab slice
    [b, s, vocab / 2] (flattened to [b * s, vocab / 2]); the serving
    forward's logits all-gather never runs in training."""
    for world in (2, 4):
        for rank in runs["ranks"][world]:
            assert rank["logits_shapes"] and {s[-1] for s in rank["logits_shapes"]} == {512 // 2}
            assert rank["gathers"] == 0


def test_collectives_per_microbatch_are_the_stated_count(runs):
    """Per microbatch of the 4-layer model under remat: forward 1 (the
    embedding) + 2 per layer (o_proj, down_proj) + 2 (the cross-entropy's
    max and sums); backward 2 per layer (the attention and MLP inputs) + 1
    (the unembed's input), and the replays under remat 1 per layer: the
    o_proj sum, whose output the block's norm saves. The replay stops
    there (``torch.utils.checkpoint``'s early stop): nothing after the
    down_proj sum is saved, so its all-reduce is not replayed."""
    layers = 4
    for rank in runs["ranks"][2]:
        counts = rank["planted"]["counts"]
        assert counts == {"forward": 1 + 2 * layers + 2, "backward": 2 * layers + 1,
                          "replays": layers}, counts


def _save_steps(first, last):
    """The steps a run from ``first`` to ``last`` saves at: every 2, and the
    last."""
    return sorted(set(range(first + 2 - first % 2, last + 1, 2)) | {last})


def test_rank_zero_alone_writes_and_the_desync_checks_pass(runs):
    r0, r1 = runs["ranks"][2]
    steps = len(r0["tp"]["history"])
    assert r0["tp"]["writes"]["checkpoint"] == len(_save_steps(0, steps))
    assert r1["tp"]["writes"]["checkpoint"] == 0
    assert r0["desync_checks"] == r1["desync_checks"] == 1 + len(
        [h for h in r0["tp"]["history"]])
    out0, out1 = (o for o, _ in runs["outs"][2])
    assert "Best model saved" in out0 and "Best model saved" not in out1
    assert (runs["tmp"] / "tp" / "best_model" / "config.json").exists()


def test_tensor_two_checkpoint_resumes_bit_for_bit_across_layouts(runs):
    """The step-4 checkpoint of the tensor=2 run resumes at tensor=2 to the
    uninterrupted run's final state bit for bit, and restores at fsdp=2 and
    at world 1 to the step-4 state bit for bit; the world-1 run's step-4
    checkpoint restores at tensor=2 bit for bit."""
    from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

    steps = len(runs["jax"]["tp"]["history"])
    for rank in runs["ranks"][2]:
        saves = rank["saves"]
        assert sorted(saves) == sorted([("tp", s) for s in _save_steps(0, steps)]
                                       + [("tp_resume", s) for s in _save_steps(RESUME_STEP, steps)])
        resumed, final = saves[("tp_resume", steps)], saves[("tp", steps)]
        assert resumed["step"] == final["step"] == steps and resumed["count"] == final["count"]
        for part in ("trainable", "mu", "nu"):
            for k, v in final[part].items():
                assert torch.equal(resumed[part][k], v), (part, k)
        at = saves[("tp", RESUME_STEP)]
        got = rank["fsdp_restore"]["state"]
        assert got["step"] == RESUME_STEP and got["count"] == at["count"]
        for part in ("trainable", "mu", "nu"):
            for k, v in at[part].items():
                assert torch.equal(got[part][k], v), ("fsdp=2", part, k)
        w1 = rank["w1_restore"]["state"]
        want = runs["solo"]["saves"][RESUME_STEP]
        assert w1["step"] == RESUME_STEP and set(w1["trainable"]) == set(want)
        for k, v in want.items():
            assert torch.equal(w1["trainable"][k], v), ("world 1 -> tensor=2", k)
    at = runs["ranks"][2][0]["saves"][("tp", RESUME_STEP)]
    tmp = runs["tmp"]
    solo = SFTTrainer(TrainConfig(**_recipe(tmp, "tp")), device="cpu")
    state = solo._restore(solo._checkpoint_manager(), RESUME_STEP)
    assert state.step == RESUME_STEP and state.opt_state["count"] == at["count"]
    for k, v in at["trainable"].items():
        assert torch.equal(state.trainable[k].detach(), v), k
    for part in ("mu", "nu"):
        for k, v in at[part].items():
            assert torch.equal(state.opt_state[part][k], v), (part, k)


def _hold_leaves_by_norm(got, want, rel):
    assert set(got) == set(want)
    for k, w in want.items():
        g = np.asarray(got[k].float(), np.float32)
        assert np.linalg.norm(g - w) <= rel * np.linalg.norm(w), k


@pytest.mark.parametrize("name,keys,rel,atol", [
    ("lora", COMPARED, REL, 0.0),
    ("qlora", COMPARED, REL, 0.0),
    ("dpo", DPO_COMPARED, REL, 1e-7),
    ("int8", COMPARED, INT8_BF16_REL, 0.0),
])
def test_recipes_at_tensor_two_match_their_jax_runs(runs, name, keys, rel, atol):
    """LoRA and QLoRA (history within 1e-4, each adapter leaf within
    ``LORA_LEAF_REL`` of its norm), DPO (history within 1e-4, as
    tests/test_torch_data_parallel.py holds it: its lr of 2e-3 moves
    near-zero-gradient entries by a rounding-sized share of the lr, so its
    leaves are not held) and the int8 trunk in bf16 (history and leaves
    within ``INT8_BF16_REL``), each at tensor=2 against the JAX run on 2
    devices."""
    want = runs["jax"][name]
    for rank in runs["ranks"][2]:
        got = rank[name]
        _hold_history(got["history"], want["history"], keys, rel, atol)
        if name in ("lora", "qlora"):
            _hold_leaves_by_norm(got["state"]["trainable"], want["trainable"], LORA_LEAF_REL)
        elif name == "int8":
            _hold_leaves(got["state"]["trainable"], want["trainable"], INT8_BF16_REL)
        assert got["summary"]["mesh"]["tensor"] == 2


def test_lora_factors_are_whole_on_every_rank(runs):
    """The JAX rules give LoRA A and B no tensor axis: each rank holds them
    whole, equal on both ranks after training (their shares' gradients are
    summed over the tensor group)."""
    r0, r1 = runs["ranks"][2]
    for name in ("lora", "qlora"):
        init = r0[name]["init"]
        factors = [k for k in init if k.endswith((".lora_a", ".lora_b"))]
        assert factors
        for k in factors:
            assert r0[name]["state"]["trainable"][k].shape == init[k].shape
            assert torch.equal(r0[name]["state"]["trainable"][k], r1[name]["state"]["trainable"][k])


def test_planted_faults_fail_their_checks(runs):
    """At tensor=2, the first microbatch's loss, gradients and global norm
    equal world 1's within 1e-4, and with "copy to tensor"'s backward
    all-reduce removed the gradients fail that check. The LoRA run's first
    grad norm equals the JAX run's within 1e-4; one that sums the squares of
    the leaves every tensor rank holds whole (the adapters) over the tensor
    group fails it."""
    solo = runs["solo"]["micro"]
    want_norm = runs["jax"]["lora"]["history"][0]["grad_norm"]
    for rank in runs["ranks"][2]:
        got = rank["planted"]
        np.testing.assert_allclose(got["loss"], solo["loss"], rtol=REL)
        want = {k: v.numpy() for k, v in solo["grads"].items()}
        _hold_leaves(got["grads"], want, REL)
        np.testing.assert_allclose(got["norm"], solo["norm"], rtol=REL)
        assert not _leaves_close(got["no_backward_reduce"], want, REL)
        np.testing.assert_allclose(rank["lora"]["history"][0]["grad_norm"], want_norm, rtol=REL)
        assert abs(rank["lora_norm_twice"] - want_norm) > REL * want_norm


if __name__ == "__main__":
    torch.set_num_threads(1)
    from pathlib import Path

    _rank_main(Path(sys.argv[1]), int(sys.argv[2]))
