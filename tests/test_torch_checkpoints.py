"""The port's checkpoints (``train/checkpoints.py`` and the trainer's save,
resume and best-checkpoint restore), case by case as
``tests/test_checkpoints_lean.py`` pins the JAX package's (its
``parallel_device_get`` case is JAX-only), on the ``tiny`` preset:

- the trainable-only payload is smaller than the full one, trains the same
  trajectory, and restores the trainable leaves, both AdamW moments and the
  step bit for bit with the frozen leaves carried through;
- a changed base (another init seed) is a ``FingerprintMismatch`` at restore
  and through the trainer's resume, never buried under its fallbacks;
- a background snapshot writes what a synchronous save writes;
- a full checkpoint resumes into a trainable-only run and the reverse;
- checkpoint-mode best tracking restores the best saved step after a
  divergence, and refuses a save cadence that is not a multiple of the eval
  cadence;
- the port's ``frozen_fingerprint`` (float64 sums) passes the JAX
  ``verify_fingerprint`` against the JAX fingerprint of the same leaves, and
  a permuted or transposed leaf fails both packages' checks; the tolerance
  grows with the leaf's size;
- a save or a restore joins a pending background snapshot first, and a
  background failure surfaces at the next save;
- beyond the JAX file: rotation keeps the best and the latest steps, and a
  pipeline-stacked checkpoint is refused, naming what it waits for.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.config import TrainConfig
from llm_fine_tune_distributed_tpu_torch.train.checkpoints import (
    CheckpointManager,
    FingerprintMismatch,
    frozen_fingerprint,
    verify_fingerprint,
)
from llm_fine_tune_distributed_tpu_torch.train.state import TrainState
from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def qa_jsonl(tmp_path_factory):
    """96 synthetic QA rows (the JAX file's ``qa_parquet`` rows, as JSONL)."""
    tmp = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    topics = ["Knots", "First Aid", "Cooking"]
    with open(tmp / "qa.jsonl", "w") as f:
        for i in range(96):
            t = topics[i % 3]
            f.write(json.dumps({
                "topic": t, "question": f"question number {i} about {t.lower()}?",
                "answer": f"answer {i}: " + " ".join(["word"] * int(rng.randint(3, 10))),
            }) + "\n")
    return tmp


def make_config(out, data_dir, **overrides):
    base = dict(model_name="tiny-random", model_preset="tiny", tokenizer_path="byte-chatml",
                data_dir=str(data_dir), dataset_file="qa.jsonl", output_dir=str(out), epochs=2,
                per_device_batch_size=2, gradient_accumulation_steps=2, learning_rate=2e-3,
                max_seq_length=128, eval_steps=5, logging_steps=2, save_steps=8,
                gradient_checkpointing=True, system_prompt="You are an expert.",
                compute_dtype="float32")
    base.update(overrides)
    return TrainConfig(**base)


def _du(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _train(cfg):
    trainer = SFTTrainer(cfg, device="cpu")
    trainer.train()
    return trainer


def _assert_state_equal(a: TrainState, b: TrainState):
    assert a.step == b.step and a.opt_state["count"] == b.opt_state["count"]
    for k in a.trainable:
        assert torch.equal(a.trainable[k], b.trainable[k]), k
        assert a.trainable[k].dtype == b.trainable[k].dtype
    for m in ("mu", "nu"):
        for k in a.opt_state[m]:
            assert torch.equal(a.opt_state[m][k], b.opt_state[m][k]), (m, k)


def test_trainable_only_checkpoint_roundtrip_and_size(qa_jsonl, tmp_path):
    full = _train(make_config(tmp_path / "full", qa_jsonl, epochs=1, save_steps=5,
                              checkpoint_trainable_only=False, checkpoint_async_snapshot=False,
                              load_best_model_at_end=False))
    # no best-model restore, so the trainer's final state is the last save's
    lean = _train(make_config(tmp_path / "lean", qa_jsonl, epochs=1, save_steps=5,
                              checkpoint_trainable_only=True, checkpoint_async_snapshot=False,
                              load_best_model_at_end=False))
    f_losses = [h["loss"] for h in full.metrics.history]
    l_losses = [h["loss"] for h in lean.metrics.history]
    np.testing.assert_allclose(l_losses, f_losses, rtol=1e-6)
    assert _du(tmp_path / "lean" / "checkpoints") < _du(tmp_path / "full" / "checkpoints")

    resumed = SFTTrainer(make_config(tmp_path / "lean", qa_jsonl, epochs=1, save_steps=5,
                                     checkpoint_trainable_only=True,
                                     checkpoint_async_snapshot=False,
                                     resume_from_checkpoint="latest"), device="cpu")
    ckpt = CheckpointManager(str(tmp_path / "lean" / "checkpoints"), trainable_only=True)
    step = ckpt.latest_step
    assert step == lean.state.step
    restored = ckpt.restore(step, resumed.state)
    _assert_state_equal(restored, lean.state)
    for k in restored.frozen:  # carried through, the same objects
        assert restored.frozen[k] is resumed.state.frozen[k]
    ckpt.close()


def test_fingerprint_rejects_changed_base_weights(qa_jsonl, tmp_path):
    _train(make_config(tmp_path / "a", qa_jsonl, epochs=1, save_steps=5,
                       checkpoint_trainable_only=True, checkpoint_async_snapshot=False))
    other = SFTTrainer(make_config(tmp_path / "b", qa_jsonl, epochs=1, seed=123,
                                   checkpoint_trainable_only=True), device="cpu")
    ckpt = CheckpointManager(str(tmp_path / "a" / "checkpoints"), trainable_only=True)
    with pytest.raises(FingerprintMismatch, match="does not match"):
        ckpt.restore(ckpt.latest_step, other.state)
    ckpt.close()
    # the trainer's resume surfaces the same diagnosis, not a fallback's
    bad_resume = SFTTrainer(make_config(tmp_path / "a", qa_jsonl, epochs=2, seed=123,
                                        checkpoint_trainable_only=True,
                                        resume_from_checkpoint="latest"), device="cpu")
    with pytest.raises(FingerprintMismatch, match="does not match"):
        bad_resume.train()


def test_async_snapshot_save_matches_sync(qa_jsonl, tmp_path):
    restored = {}
    for name, async_snap in (("sync", False), ("async", True)):
        tr = _train(make_config(tmp_path / name, qa_jsonl, epochs=1, save_steps=3,
                                checkpoint_trainable_only=True,
                                checkpoint_async_snapshot=async_snap))
        ckpt = CheckpointManager(str(tmp_path / name / "checkpoints"), trainable_only=True)
        restored[name] = ckpt.restore(ckpt.latest_step, tr.state)
        assert ckpt.all_steps() == CheckpointManager(
            str(tmp_path / "sync" / "checkpoints")).all_steps()
        ckpt.close()
        assert tr.last_checkpoint["async"] is async_snap
    _assert_state_equal(restored["sync"], restored["async"])


def test_cross_mode_resume_both_directions(qa_jsonl, tmp_path, capsys):
    for first, then in ((False, True), (True, False)):
        out = tmp_path / f"mode_{int(first)}"
        _train(make_config(out, qa_jsonl, epochs=1, save_steps=5,
                           checkpoint_trainable_only=first, checkpoint_async_snapshot=False))
        trainer = SFTTrainer(make_config(out, qa_jsonl, epochs=2, save_steps=5,
                                         checkpoint_trainable_only=then,
                                         checkpoint_async_snapshot=False,
                                         resume_from_checkpoint="latest"), device="cpu")
        summary = trainer.train()
        assert summary["final_train_loss"] is not None
        assert trainer.metrics.history, "resumed run logged no steps"
        assert ("Resumed FULL checkpoint" if then else "Resumed trainable-only checkpoint") \
            in capsys.readouterr().out


def test_checkpoint_mode_best_restore_on_divergence(qa_jsonl, tmp_path, capsys):
    trainer = _train(make_config(tmp_path / "div", qa_jsonl, epochs=1, learning_rate=2.0,
                                 eval_steps=3, save_steps=3, checkpoint_trainable_only=True,
                                 checkpoint_async_snapshot=False,
                                 best_model_tracking="checkpoint"))
    out = capsys.readouterr().out
    mgr = CheckpointManager(str(tmp_path / "div" / "checkpoints"), trainable_only=True)
    best, latest = mgr.best_step, mgr.latest_step
    assert best is not None
    evals = [h["eval_loss"] for h in trainer.metrics.history if "eval_loss" in h]
    if best != latest:
        assert "Restored best checkpoint step" in out
        restored = mgr.restore(best, trainer.state)
        for k, v in restored.trainable.items():
            assert torch.equal(v, trainer.state.trainable[k]), k
    assert evals[-1] > evals[0] or best == latest


def test_checkpoint_mode_rejects_unaligned_save_eval_cadence(qa_jsonl, tmp_path):
    trainer = SFTTrainer(make_config(tmp_path / "bad", qa_jsonl, epochs=1, eval_steps=4,
                                     save_steps=6, best_model_tracking="checkpoint"),
                         device="cpu")
    with pytest.raises(ValueError, match="multiple of eval_steps"):
        trainer.train()


def _leaves():
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((8, 16)).astype(np.float32),
        "big": rng.standard_normal((300, 70)).astype(np.float32),
        "codes": rng.integers(-127, 128, (16, 12)).astype(np.int8),
    }


def test_port_fingerprint_passes_the_jax_check():
    """The same leaves fingerprinted by both packages pass both packages'
    verification, in both directions; bf16 leaves too (the trainer keeps
    its frozen leaves in bf16)."""
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.train import checkpoints as jax_ck

    leaves = _leaves()
    port_fp = frozen_fingerprint({k: torch.from_numpy(v.copy()) for k, v in leaves.items()})
    jax_fp = jax_ck.frozen_fingerprint({k: jnp.asarray(v) for k, v in leaves.items()})
    assert all(v.dtype == np.float64 for v in port_fp.values())
    jax_ck.verify_fingerprint(jax_fp, port_fp)
    jax_ck.verify_fingerprint(port_fp, jax_fp)
    verify_fingerprint(jax_fp, port_fp)
    bf = {k: torch.from_numpy(v.copy()).to(torch.bfloat16) for k, v in leaves.items()
          if v.dtype == np.float32}
    jbf = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in leaves.items()
           if v.dtype == np.float32}
    jax_ck.verify_fingerprint(jax_ck.frozen_fingerprint(jbf), frozen_fingerprint(bf))


def test_fingerprint_rejects_permuted_base_weights():
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.train import checkpoints as jax_ck

    w = _leaves()["w"]
    saved = frozen_fingerprint({"w": torch.from_numpy(w.copy())})
    verify_fingerprint(saved, frozen_fingerprint({"w": torch.from_numpy(w.copy())}))
    rev = w[::-1, ::-1].copy()
    reversed_fp = frozen_fingerprint({"w": torch.from_numpy(rev)})
    np.testing.assert_allclose(saved["w"][:2], reversed_fp["w"][:2], rtol=1e-12)
    with pytest.raises(FingerprintMismatch, match="does not match"):
        verify_fingerprint(saved, reversed_fp)
    with pytest.raises(jax_ck.FingerprintMismatch, match="does not match"):
        jax_ck.verify_fingerprint(saved, jax_ck.frozen_fingerprint({"w": jnp.asarray(rev)}))
    transposed = np.ascontiguousarray(w.T).reshape(w.shape)
    with pytest.raises(FingerprintMismatch, match="does not match"):
        verify_fingerprint(saved, frozen_fingerprint({"w": torch.from_numpy(transposed)}))


def test_fingerprint_tolerance_scales_with_leaf_count():
    drift = 1 + 3e-4
    big_n = 1e8
    verify_fingerprint({"w": np.array([5.0e7, 1.0e8, 2.5e7, big_n])},
                       {"w": np.array([5.0e7 * drift, 1.0e8 * drift, 2.5e7 * drift, big_n])})
    small = {"w": np.array([50.0, 100.0, 25.0, 100.0])}
    with pytest.raises(FingerprintMismatch, match="does not match"):
        verify_fingerprint(small, {"w": np.array([50.0 * drift, 100.0 * drift, 25.0 * drift,
                                                  100.0])})
    with pytest.raises(FingerprintMismatch, match="changed size"):
        verify_fingerprint(small, {"w": np.array([50.0, 100.0, 25.0, 101.0])})


def _tiny_state():
    return TrainState(step=1, trainable={"w": torch.ones(4, requires_grad=True)},
                      frozen={"f": torch.zeros(4)},
                      opt_state={"count": 1, "mu": {"w": torch.zeros(4)},
                                 "nu": {"w": torch.zeros(4)}})


def test_sync_save_and_restore_join_pending_background_snapshot(tmp_path):
    state = _tiny_state()
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2, metric_name="")
    finished = threading.Event()

    def slow_snapshot():
        time.sleep(0.5)
        finished.set()

    for op in ("save", "restore"):
        t = threading.Thread(target=slow_snapshot)
        mgr._snapshot_thread = t
        t.start()
        if op == "save":
            mgr.save(1, state)
        else:
            mgr.restore(1, state)
        assert finished.is_set(), f"{op}() ran without joining the snapshot"
        assert mgr._snapshot_thread is None
        finished.clear()
    mgr._snapshot_error = RuntimeError("disk full")
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.save(2, state)
    mgr.close()


def test_rotation_keeps_best_and_latest(tmp_path):
    """max_to_keep 2 over five saves: the best-ranked two (a missing metric
    ranks worst) and always the latest; best_step is the best with a metric."""
    state = _tiny_state()
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for step, loss in ((1, 3.0), (2, 1.0), (3, None), (4, 2.0), (5, 4.0)):
        mgr.save(step, state, metrics=None if loss is None else {"eval_loss": loss})
    assert mgr.all_steps() == [2, 4, 5]
    assert mgr.best_step == 2 and mgr.latest_step == 5
    with open(tmp_path / "ck" / "latest.json") as f:
        assert json.load(f)["step"] == 5
    # an interrupted save (no metadata) is invisible and replaced by the next
    os.makedirs(tmp_path / "ck" / "6")
    assert mgr.latest_step == 5
    mgr.save(6, state)
    assert mgr.latest_step == 6


def test_restore_refuses_a_pipeline_stacked_checkpoint(tmp_path):
    state = _tiny_state()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    stacked = TrainState(step=1, trainable={"model.layers.@stacked.w": torch.ones(4)},
                         frozen={"f": torch.zeros(4)},
                         opt_state={"count": 1, "mu": {"model.layers.@stacked.w": torch.zeros(4)},
                                    "nu": {"model.layers.@stacked.w": torch.zeros(4)}})
    mgr.save(1, stacked)
    with pytest.raises(NotImplementedError, match="pipeline parallelism"):
        mgr.restore(1, state)


def test_reversed_rows_of_a_large_leaf_are_refused():
    """The position sum of a symmetric init is a random walk of size
    sqrt(sum x^2); the JAX rule's floor (rtol x sum |x|) is sqrt(n) times
    larger, so a 2048 x 2048 leaf (a SmolLM3 ``q_proj``) with its rows
    reversed passes the JAX check for most seeds (17 of 20; the reference's
    fault, recorded here). The port's floor, scaled by sqrt(sum x^2),
    refuses it, and still passes the same leaf summed by the JAX package in
    f32."""
    import jax.numpy as jnp

    from llm_fine_tune_distributed_tpu.train import checkpoints as jax_ck

    w = torch.randn((2048, 2048), generator=torch.Generator().manual_seed(1)) * 0.02
    saved = frozen_fingerprint({"w": w})
    flipped = frozen_fingerprint({"w": w.flip(0)})
    jax_ck.verify_fingerprint(saved, flipped)  # the reference accepts it
    with pytest.raises(FingerprintMismatch, match="does not match"):
        verify_fingerprint(saved, flipped)
    verify_fingerprint(saved, jax_ck.frozen_fingerprint({"w": jnp.asarray(w.numpy())}))


def test_checkpoint_and_publish_env_vars_equal_the_jax_configs():
    """The env vars this slice makes live set the JAX package's fields to
    the JAX package's values (the boolean spellings included)."""
    from llm_fine_tune_distributed_tpu.config import TrainConfig as JaxTrainConfig

    env = {"SAVE_TOTAL_LIMIT": "5", "CHECKPOINT_TRAINABLE_ONLY": "yes",
           "CHECKPOINT_ASYNC_SNAPSHOT": "0", "PUBLISH_DIR": "/p", "PUBLISH_KEEP_LAST": "2",
           "PUBLISH_REQUIRE_CLEAN": "on", "ANOMALY_WINDOW_STEPS": "40",
           "ANOMALY_BAND_SIGMA": "4.5", "RESUME_FROM_CHECKPOINT": "latest"}
    fields = ("save_total_limit", "checkpoint_trainable_only", "checkpoint_async_snapshot",
              "publish_dir", "publish_keep_last", "publish_require_clean",
              "anomaly_window_steps", "anomaly_band_sigma", "resume_from_checkpoint",
              "metric_for_best_model")
    port, ref = TrainConfig(), JaxTrainConfig()
    assert {f: getattr(port, f) for f in fields} == {f: getattr(ref, f) for f in fields}
    port.apply_env_overrides(env)
    ref.apply_env_overrides(env)
    assert {f: getattr(port, f) for f in fields} == {f: getattr(ref, f) for f in fields}
    assert port.checkpoint_trainable_only is True and port.checkpoint_async_snapshot is False
    with pytest.raises(ValueError, match="boolean env var"):
        TrainConfig().apply_env_overrides({"PUBLISH_REQUIRE_CLEAN": "maybe"})
