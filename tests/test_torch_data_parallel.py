"""Data-parallel training in the port over two gloo processes on the CPU,
against the JAX trainers on a 2-device mesh (a prefix of the conftest's 8
virtual devices) and against the port at one process, on the ``tiny``
preset in f32 with the same model directory and rows:

- ``SFTTrainer`` at ``fsdp=2`` and at ``data=2``: history (loss, grad norm,
  lr, eval losses) and the final trainable leaves within the 1e-4 that
  ``tests/test_torch_trainer.py`` holds the one-device run to; the summary
  says world 2; rank 0 alone writes and prints;
- world 2 against world 1 at the same global batch and one peak lr
  (``scale_lr_by_data_parallel=False``): losses to 1e-6 relative, leaves to
  1e-5 of each leaf's max; the eval loss equal, each rank running its share
  of the eval forwards;
- ZeRO-3 at ``fsdp=2``: each rank holds, at init, exactly the JAX
  trainer's fsdp addressable shard of every leaf (trainable and frozen),
  and half the bytes of every sharded leaf; it takes the model one leaf at
  a time, so no whole leaf it sliced before is alive when it takes the
  next;
- a checkpoint written at world 2 (fsdp-sharded leaves and moments,
  gathered whole) resumes bit for bit at world 2 and at world 1, and so
  does a trainable-only one at world 2 (the frozen leaves' fingerprint
  gathered leaf by leaf, the frozen slices kept);
- ``request_preemption`` on rank 1 alone stops both ranks at one step with
  one emergency checkpoint;
- ``DPOTrainer`` at ``fsdp=2`` against the JAX one on 2 devices.

The two ranks run this file as a script (``_launch``), all their scenarios
in one launch, while this process runs the JAX trainers.
"""

import itertools
import json
import os
import shutil
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.config import MeshConfig, TrainConfig
from llm_fine_tune_distributed_tpu_torch.runtime import distributed
from llm_fine_tune_distributed_tpu_torch.parallel.optimizer import FsdpShards

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-4  # tests/test_torch_trainer.py's
ROWS = 48
LAUNCH_TIMEOUT_S = 420
SHORT_PROMPT = "You are a wilderness survival expert."
COMPARED = ("loss", "grad_norm", "learning_rate", "eval_loss", "eval_loss_answer")
DPO_COMPARED = ("loss", "grad_norm", "learning_rate", "eval_loss", "rewards_chosen",
                "rewards_rejected", "rewards_margin", "rewards_accuracy", "eval_rewards_accuracy")
RESUME_STEP = 4


def _recipe(workdir, out, **kw):
    """tests/test_torch_trainer.py's recipe at a global batch of 8 (2 rows x
    2 microbatches x 2 ranks), every step logged, a save every 2 steps."""
    kw = dict(dict(model_name=str(workdir / "model"), model_preset="tiny",
                   tokenizer_path="byte-chatml", data_dir=str(workdir / "data"),
                   dataset_file="qa.jsonl", output_dir=str(workdir / out), epochs=1,
                   eval_steps=2, logging_steps=1, max_seq_length=256, system_prompt=SHORT_PROMPT, compute_dtype="float32",
                   per_device_batch_size=2, gradient_accumulation_steps=2, save_steps=2,
                   save_total_limit=10, use_native_loader=False), **kw)
    return kw


def _dpo_recipe(workdir, out, **kw):
    return _recipe(workdir, out, objective="dpo", dpo_beta=0.5, learning_rate=2e-3,
                   max_seq_length=192, save_steps=0, **kw)


# ------------------------------------------------------------- the ranks


def _counting(trainer_mod, counts):
    """Count every artifact write of this rank (checkpoint payloads, the
    history, best_model/)."""
    from llm_fine_tune_distributed_tpu_torch.observe.metrics import MetricLogger
    from llm_fine_tune_distributed_tpu_torch.train.checkpoints import CheckpointManager

    def wrap(owner, name, key):
        orig = getattr(owner, name)

        def counted(*a, **kw):
            counts[key] = counts.get(key, 0) + 1
            return orig(*a, **kw)
        setattr(owner, name, counted)

    wrap(CheckpointManager, "_write", "checkpoint")
    wrap(MetricLogger, "save_history", "history")
    wrap(trainer_mod, "save_hf_checkpoint", "best_model")


def _state(trainer):
    """The whole trainable leaves and moments (a collective)."""
    opt = trainer._full_opt_state()
    return {"step": trainer.state.step, "count": opt["count"],
            "trainable": {k: v.detach().clone() for k, v in trainer._full_trainable().items()},
            "mu": {k: v.clone() for k, v in opt["mu"].items()},
            "nu": {k: v.clone() for k, v in opt["nu"].items()}}


def _rank_main(workdir):
    """Every scenario of the module docstring at world 2, in turn."""
    from llm_fine_tune_distributed_tpu_torch.train import trainer as trainer_mod
    from llm_fine_tune_distributed_tpu_torch.train.dpo import DPOTrainer

    distributed.initialize_distributed(device="cpu")
    rank = distributed.process_index()
    out = {}
    counts = {}
    _counting(trainer_mod, counts)
    # every whole leaf ZeRO-3's init takes: how many it took at once, and
    # how many of those it sliced before are still alive
    sliced, takes = [], out.setdefault("takes", [])
    take = FsdpShards.take

    def tracking(self, whole):
        if not whole:
            return take(self, whole)
        takes.append((len(whole), sum(ref() is not None for ref in sliced)))
        local = take(self, whole)
        sliced.extend(weakref.ref(v) for k, v in whole.items() if k in self.dims)
        return local

    FsdpShards.take = tracking

    def run(name, cls=trainer_mod.SFTTrainer, before=None, **kw):
        counts.clear()
        trainer = cls(TrainConfig(**kw), device="cpu")
        evals = []
        step_fn = trainer.eval_step if cls is trainer_mod.SFTTrainer else trainer._dpo_eval

        def counted_eval(*a):
            evals.append(1)
            return step_fn(*a)
        if cls is trainer_mod.SFTTrainer:
            trainer.eval_step = counted_eval
        else:
            trainer._dpo_eval = counted_eval
        if before is not None:
            before(trainer)
        summary = trainer.train()
        out[name] = {"history": trainer.metrics.history, "summary": summary,
                     "evals": len(evals), "counts": dict(counts), "state": _state(trainer),
                     "shards": sorted(trainer.shards.dims) if trainer.shards else [],
                     "moment_numel": sum(v.numel() for v in trainer.state.opt_state["mu"].values())}
        return trainer

    # (d, e, g, h) fsdp=2 at one peak lr; the state at each save kept (the
    # final one is taken before the best eval's weights are restored)
    saves = {}

    def keep_state(trainer):
        leaves = {**trainer.state.trainable, **trainer.state.frozen}
        out.setdefault("init_leaves", {})[trainer.config.output_dir] = {
            k: v.detach().clone() for k, v in leaves.items()}
        save = trainer._ckpt_save

        def saving(ckpt, step, metrics):
            save(ckpt, step, metrics)
            saves[(trainer.config.output_dir, step)] = _state(trainer)
        trainer._ckpt_save = saving

    run("fsdp", before=keep_state, **_recipe(workdir, "fsdp", scale_lr_by_data_parallel=False,
                                              mesh=MeshConfig(data=1, fsdp=2)))
    # (d) data=2, the default lr x world rule
    run("data", **_recipe(workdir, "data", mesh=MeshConfig(data=2, fsdp=1), save_steps=0))
    # (h) resume at world 2 from the fsdp run's checkpoint
    if rank == 0:
        shutil.copytree(workdir / "fsdp" / "checkpoints", workdir / "resume2" / "checkpoints")
    distributed.barrier("cpu")
    run("resume2", before=keep_state, **_recipe(workdir, "resume2", scale_lr_by_data_parallel=False,
                             mesh=MeshConfig(data=1, fsdp=2),
                             resume_from_checkpoint=str(RESUME_STEP)))

    # (i) trainable-only checkpoints at fsdp=2, resumed at world 2
    tonly = {}

    def keep_saves(trainer):
        save = trainer._ckpt_save

        def saving(ckpt, step, metrics):
            save(ckpt, step, metrics)
            tonly[(os.path.basename(trainer.config.output_dir), step)] = _state(trainer)
        trainer._ckpt_save = saving

    for name, resume in (("tonly", None), ("tonly_resume", str(RESUME_STEP))):
        if resume and rank == 0:
            shutil.copytree(workdir / "tonly" / "checkpoints",
                            workdir / "tonly_resume" / "checkpoints")
        distributed.barrier("cpu")
        run(name, before=keep_saves, **_recipe(
            workdir, name, scale_lr_by_data_parallel=False, mesh=MeshConfig(data=1, fsdp=2),
            checkpoint_trainable_only=True, resume_from_checkpoint=resume))
    out["tonly_saves"] = tonly

    # (j) a preemption requested on rank 1 alone, after step 3
    def preempt_on_rank1(trainer):
        step_fn = trainer.train_step

        def stepping(*a):
            result = step_fn(*a)
            if rank == 1 and trainer.state.step == 3:
                trainer.request_preemption()
            return result
        trainer.train_step = stepping

    run("preempt", before=preempt_on_rank1, **_recipe(workdir, "preempt",
                                                      mesh=MeshConfig(data=1, fsdp=2)))
    # (k) DPO at fsdp=2
    run("dpo", cls=DPOTrainer, **_dpo_recipe(workdir, "dpo", mesh=MeshConfig(data=1, fsdp=2)))
    out["saves"] = {(os.path.basename(d), step): v for (d, step), v in saves.items()}
    out["init_leaves"] = {os.path.basename(d): v for d, v in out["init_leaves"].items()}
    torch.save(out, workdir / f"rank{rank}.pt")
    distributed.destroy()


def _launch(workdir):
    port = distributed.free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
        env.update(distributed.rendezvous_env(rank, 2, port), PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), str(workdir)],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                      env=env))
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' launch, and meanwhile here the JAX trainers (SFT at
    fsdp=2 and data=2, DPO at fsdp=2 on 2 devices) and the port at one
    process (the same global batch, and the world-1 resume)."""
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

    tmp = tmp_path_factory.mktemp("dp")
    data = tmp / "data"
    data.mkdir()
    with open(os.path.join(ROOT, "data", "final_qa_data_unique.jsonl")) as f:
        (data / "qa.jsonl").write_text("".join(next(f) for _ in range(ROWS)))
    convert_jsonl_to_parquet(str(data / "qa.jsonl"), str(data / "qa.parquet"), verbose=False)
    mc = jax_configs.get_preset("tiny")
    jax_hf_io.save_hf_checkpoint(jax.device_get(jax_tf.init_params(
        jax.random.PRNGKey(3), mc, dtype=jnp.float32)), str(tmp / "model"))
    (tmp / "model" / "config.json").write_text(json.dumps(jax_configs.to_hf_dict(mc)))
    procs = _launch(tmp)
    try:
        def fsdp_shards(leaves, mesh):
            """{name: [the addressable shard of fsdp coordinate 0, 1]} of
            the JAX rules' placement on the trainer's mesh (only fsdp
            splits: a shard's place in the leaf is its coordinate)."""
            from llm_fine_tune_distributed_tpu.parallel.sharding import shard_params as jax_shard

            out = {}
            for k, v in jax_shard(leaves, mesh).items():
                shards = sorted(v.addressable_shards,
                                key=lambda s: tuple(sl.start or 0 for sl in s.index))
                assert len(shards) == 2, k
                out[k.replace("/", ".")] = [np.asarray(jax.device_get(s.data)) for s in shards]
            return out

        def jax_run(cls, recipe, out, **kw):
            trainer = cls(JaxTrainConfig(**recipe(tmp, out, dataset_file="qa.parquet", **kw)))
            if cls is JaxDPOTrainer:  # tests/test_torch_dpo.py: unalias the f32 reference
                trainer.ref_trainable = {k: jax.device_put(jnp.array(v, copy=True), v.sharding)
                                         for k, v in trainer.ref_trainable.items()}
            init = fsdp_shards({**trainer.state.trainable, **trainer.state.frozen}, trainer.mesh)
            trainer.train()
            leaves = flatten_tree(jax.device_get(trainer.state.trainable))
            return {"history": trainer.metrics.history, "init_shards": init,
                    "trainable": {k.replace("/", "."): np.asarray(v) for k, v in leaves.items()}}

        jax_runs = {
            "fsdp": jax_run(JaxSFTTrainer, _recipe, "jax_fsdp", scale_lr_by_data_parallel=False,
                            mesh=JaxMeshConfig(data=1, fsdp=2), save_steps=0),
            "data": jax_run(JaxSFTTrainer, _recipe, "jax_data", mesh=JaxMeshConfig(data=2, fsdp=1),
                            save_steps=0),
            "dpo": jax_run(JaxDPOTrainer, _dpo_recipe, "jax_dpo", mesh=JaxMeshConfig(data=1, fsdp=2)),
        }
        # the port at one process: the same global batch (4 rows x 2
        # microbatches) and peak lr as the fsdp run
        solo = SFTTrainer(TrainConfig(**_recipe(tmp, "solo", per_device_batch_size=4, save_steps=0,
                                                scale_lr_by_data_parallel=False)), device="cpu")
        evals = []
        eval_step = solo.eval_step
        solo.eval_step = lambda *a: (evals.append(1), eval_step(*a))[1]
        solo.train()
        solo_run = {"history": solo.metrics.history, "evals": len(evals),
                    "trainable": {k: v.detach().clone() for k, v in solo.state.trainable.items()},
                    "leaf_bytes": {k: v.numel() * v.element_size() for k, v in itertools.chain(
                        solo.state.trainable.items(), solo.state.frozen.items())}}
        outs = _wait(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(2)]
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
        np.testing.assert_allclose(np.asarray(got[k], np.float32), w, rtol=0,
                                   atol=rel * float(np.abs(w).max()), err_msg=k)


@pytest.mark.parametrize("name", ["fsdp", "data"])
def test_world_two_matches_the_jax_trainer_on_two_devices(runs, name):
    want = runs["jax"][name]
    for rank in runs["ranks"]:
        got = rank[name]
        _hold_history(got["history"], want["history"], COMPARED, REL)
        assert sum("eval_loss" in h for h in got["history"]) == 2
        _hold_leaves(got["state"]["trainable"], want["trainable"], REL)
        summary = got["summary"]
        assert summary["world_size"] == 2 and summary["distributed_training"] is True
        assert summary["mesh"][name] == 2
    lr = [h["learning_rate"] for h in runs["ranks"][0][name]["history"]]
    assert lr[0] == pytest.approx(5e-5 * (2 if name == "data" else 1))


def test_rank_zero_alone_writes_and_prints(runs):
    """Artifacts written once: the checkpoints (steps 2, 4 and the final 5),
    the history and best_model/ by rank 0; rank 1 writes and prints none."""
    r0, r1 = (rank["fsdp"]["counts"] for rank in runs["ranks"])
    assert r0.get("checkpoint") == 3 and r0.get("best_model") == 1 and r0.get("history", 0) >= 2
    assert r1 == {}
    out0, out1 = (o for o, _ in runs["outs"])
    assert "[train] step=1" in out0 and "Best model saved" in out0
    assert "[train]" not in out1 and "Best model saved" not in out1 and "Trainable" not in out1
    ckpts = sorted(p.name for p in (runs["tmp"] / "fsdp" / "checkpoints").iterdir() if p.is_dir())
    assert ckpts == ["2", "4", "5"]


def test_world_two_matches_world_one_at_the_same_global_batch(runs):
    solo = runs["solo"]
    for rank in runs["ranks"]:
        got = rank["fsdp"]
        _hold_history(got["history"], solo["history"], ("loss", "eval_loss", "eval_loss_answer"),
                      1e-6)
        _hold_history(got["history"], solo["history"], ("grad_norm", "learning_rate"), 1e-5)
        _hold_leaves(got["state"]["trainable"], solo["trainable"], 1e-5)


def test_eval_is_sharded_over_the_ranks(runs):
    """Each rank runs ceil(n_val / (2 x 2)) forwards of 2 rows per eval, as
    many as the one-process run's forwards of 4 rows at the same global
    batch: half the rows each, and the same eval loss (held above)."""
    solo = runs["solo"]
    evals = [rank["fsdp"]["evals"] for rank in runs["ranks"]]
    assert evals[0] == evals[1] == solo["evals"] > 0


def test_fsdp_shards_the_moments_and_resumes_bit_for_bit(runs, tmp_path):
    """fsdp=2 holds half of every sharded leaf's moments on each rank; the
    checkpoint of step 4 resumes at world 2 to the uninterrupted run's
    final state bit for bit, and at world 1 to the step-4 state bit for
    bit."""
    from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

    r0 = runs["ranks"][0]
    fsdp, data = r0["fsdp"], r0["data"]
    assert fsdp["shards"] and not data["shards"]
    whole = sum(v.numel() for v in fsdp["state"]["mu"].values())
    split = sum(v.numel() for k, v in fsdp["state"]["mu"].items() if k in fsdp["shards"])
    assert fsdp["moment_numel"] == whole - split // 2 and data["moment_numel"] == whole
    for rank in runs["ranks"]:
        assert sorted(rank["saves"]) == [("fsdp", 2), ("fsdp", 4), ("fsdp", 5), ("resume2", 5)]
        resumed, final = rank["saves"][("resume2", 5)], rank["saves"][("fsdp", 5)]
        assert resumed["step"] == final["step"] == 5 and resumed["count"] == final["count"]
        for part in ("trainable", "mu", "nu"):
            for k, v in final[part].items():
                assert torch.equal(resumed[part][k], v), (part, k)
    at = r0["saves"][("fsdp", RESUME_STEP)]
    shutil.copytree(runs["tmp"] / "fsdp" / "checkpoints", tmp_path / "solo" / "checkpoints")
    solo = SFTTrainer(TrainConfig(**_recipe(runs["tmp"], "unused", output_dir=str(tmp_path / "solo"),
                                            per_device_batch_size=4)), device="cpu")
    assert solo.shards is None
    state = solo._restore(solo._checkpoint_manager(), RESUME_STEP)
    assert state.step == at["step"] == RESUME_STEP and state.opt_state["count"] == at["count"]
    for k, v in at["trainable"].items():
        assert torch.equal(state.trainable[k].detach(), v), k
    for part in ("mu", "nu"):
        for k, v in at[part].items():
            assert torch.equal(state.opt_state[part][k], v), (part, k)


def test_zero3_rank_leaves_are_the_jax_fsdp_addressable_shards(runs):
    """At init each rank holds, bit for bit, the shard of every leaf
    (trainable and frozen) that the JAX trainer places on the device with
    its fsdp coordinate: a sharded leaf's slice, a whole leaf whole."""
    want = runs["jax"]["fsdp"]["init_shards"]
    for rank, got in enumerate(r["init_leaves"]["fsdp"] for r in runs["ranks"]):
        assert set(got) == set(want)
        for k, parts in want.items():
            assert tuple(got[k].shape) == parts[rank].shape, k
            np.testing.assert_array_equal(got[k].float().numpy(), parts[rank].astype(np.float32),
                                          err_msg=k)


def test_zero3_halves_the_sharded_leaves_bytes_per_rank(runs):
    """A rank's leaves take world 1's bytes less half of every sharded
    leaf's, exactly; the embedding and the block kernels are among them."""
    solo = runs["solo"]["leaf_bytes"]
    sharded = set(runs["ranks"][0]["fsdp"]["shards"])
    assert "model.embed_tokens.weight" in sharded
    assert any(k.endswith("self_attn.q_proj.kernel") for k in sharded)
    want = sum(solo.values()) - sum(solo[k] for k in sharded) // 2
    for rank in runs["ranks"]:
        leaves = rank["init_leaves"]["fsdp"]
        assert sum(v.numel() * v.element_size() for v in leaves.values()) == want
        for k in sharded:
            assert leaves[k].numel() * leaves[k].element_size() * 2 == solo[k], k


def test_zero3_takes_the_model_one_leaf_at_a_time(runs):
    """ZeRO-3's init hands ``FsdpShards.take`` one whole leaf at a time,
    and none of the whole leaves it sliced before is alive by then: a rank
    never holds more of the model whole than one leaf (beside the small
    ones that the fsdp rules keep whole)."""
    for rank in runs["ranks"]:
        takes = rank["takes"]
        assert len(takes) >= len(rank["init_leaves"]["fsdp"])
        assert {n for n, _ in takes} == {1}
        assert max(alive for _, alive in takes) == 0


def test_zero3_trainable_only_checkpoint_resumes_bit_for_bit(runs):
    """Trainable-only checkpoints at fsdp=2 (the frozen fingerprint
    gathered one leaf at a time) resume at world 2 to the uninterrupted
    run's final state bit for bit."""
    for rank in runs["ranks"]:
        saves = rank["tonly_saves"]
        assert sorted(saves) == [("tonly", 2), ("tonly", 4), ("tonly", 5), ("tonly_resume", 5)]
        resumed, final = saves[("tonly_resume", 5)], saves[("tonly", 5)]
        assert resumed["step"] == final["step"] == 5 and resumed["count"] == final["count"]
        for part in ("trainable", "mu", "nu"):
            for k, v in final[part].items():
                assert torch.equal(resumed[part][k], v), (part, k)


def test_preemption_on_one_rank_stops_both_at_one_step(runs):
    for rank in runs["ranks"]:
        got = rank["preempt"]
        assert got["summary"]["preempted"] is True and got["summary"]["step"] == 3
        assert got["state"]["step"] == 3
    r0, r1 = (rank["preempt"]["counts"] for rank in runs["ranks"])
    assert r0.get("checkpoint") == 2 and r1 == {}  # step 2's save and the emergency one
    ckpts = sorted(p.name for p in (runs["tmp"] / "preempt" / "checkpoints").iterdir() if p.is_dir())
    assert ckpts == ["2", "3"]


def test_dpo_world_two_matches_the_jax_trainer(runs):
    """The history to tests/test_torch_dpo.py's tolerance, as that file
    holds the one-device run (its lr of 2e-3 moves the few entries whose
    gradient is near zero by a rounding-sized fraction of the lr, so the
    leaves are not held here)."""
    want = runs["jax"]["dpo"]
    for rank in runs["ranks"]:
        got = rank["dpo"]
        _hold_history(got["history"], want["history"], DPO_COMPARED, REL, atol=1e-7)
        assert sum("eval_rewards_accuracy" in h for h in got["history"]) == 2
        assert got["summary"]["world_size"] == 2 and got["summary"]["mesh"]["fsdp"] == 2


if __name__ == "__main__":
    torch.set_num_threads(1)
    from pathlib import Path

    _rank_main(Path(sys.argv[1]))
