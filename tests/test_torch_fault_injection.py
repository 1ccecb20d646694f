"""The training half of ``tests/test_fault_injection.py`` on the port's
trainer (``python -m llm_fine_tune_distributed_tpu_torch.cli --device cpu``,
``tiny`` preset):

- SIGKILL once a checkpoint is committed, then a restart with
  RESUME_FROM_CHECKPOINT=latest: the resumed run starts after the resume
  point and its history equals an uninterrupted run's within 1e-4 (the
  loader goes on with the same batch order, the learning-rate schedule from
  the saved step);
- ``request_preemption()`` stops the loop at the next step boundary, writes
  an emergency checkpoint off the save cadence and returns; the resumed run
  trains no step twice;
- SIGTERM drains to an emergency checkpoint and exits 0, and a restart
  resumes from it.

Each process has its own timeout; every path is under the test's tmp_path.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.config import TrainConfig
from llm_fine_tune_distributed_tpu_torch.train.checkpoints import CheckpointManager
from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT = 240


def _rows(path, n):
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({"topic": "Knots", "question": f"question {i}?",
                                "answer": f"answer {i}: " + "word " * (3 + i % 4)}) + "\n")


def _config(tmp_path, **kw):
    _rows(tmp_path / "qa.jsonl", 64)
    cfg = dict(model_name="tiny-random", model_preset="tiny", tokenizer_path="byte-chatml",
               system_prompt="You are an expert.", data_dir=str(tmp_path),
               dataset_file="qa.jsonl", output_dir=str(tmp_path / "outputs"), epochs=2,
               per_device_batch_size=2, gradient_accumulation_steps=1, learning_rate=2e-3,
               max_seq_length=128, eval_steps=100, logging_steps=1, save_steps=3,
               compute_dtype="float32")
    cfg.update(kw)
    return cfg


def _launch(cfg_path, resume: bool):
    env = {k: v for k, v in os.environ.items() if k != "RESUME_FROM_CHECKPOINT"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    if resume:
        env["RESUME_FROM_CHECKPOINT"] = "latest"
    return subprocess.Popen(
        [sys.executable, "-m", "llm_fine_tune_distributed_tpu_torch.cli", "--device", "cpu",
         "--config", str(cfg_path)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        bufsize=1)


def _committed(out):
    ckpt = out / "checkpoints"
    return ckpt.exists() and any(
        d.isdigit() and (ckpt / d / "metadata.json").exists() for d in os.listdir(ckpt))


def _step_of(line):
    return int(line.split("step=")[1].split(",")[0])


def _run_until(proc, want, deadline_s=PROC_TIMEOUT):
    """Read the run's lines until ``want(step)``; returns (step, lines)."""
    deadline = time.time() + deadline_s
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("[train] step="):
            step = _step_of(line)
            if want(step):
                return step, lines
        if time.time() > deadline:
            break
    proc.kill()
    proc.wait(30)
    pytest.fail("the run never reached the wanted step:\n" + "".join(lines[-20:]))


def test_sigkill_then_resume(tmp_path):
    cfg = _config(tmp_path)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    out = tmp_path / "outputs"

    proc = _launch(cfg_path, resume=False)
    killed_after, _ = _run_until(proc, lambda step: step >= 4 and _committed(out))
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=60)
    assert proc.returncode != 0
    assert not (out / "training_summary.json").exists()

    proc2 = _launch(cfg_path, resume=True)
    stdout, _ = proc2.communicate(timeout=PROC_TIMEOUT)
    assert proc2.returncode == 0, stdout[-4000:]
    assert "Resumed from checkpoint step" in stdout
    resumed_step = int(stdout.split("Resumed from checkpoint step")[1].split()[0])
    assert 0 < resumed_step <= killed_after
    assert (out / "training_summary.json").exists()
    assert (out / "best_model" / "model.safetensors").exists()
    history = json.loads((out / "training_history.json").read_text())
    assert history and history[0]["step"] == resumed_step + 1

    # the same run without the kill, in this process
    torch.set_num_threads(2)
    whole = SFTTrainer(TrainConfig(**{**cfg, "output_dir": str(tmp_path / "whole")}),
                       device="cpu")
    whole.train()
    want = {h["step"]: h for h in whole.metrics.history}
    assert history[-1]["step"] == whole.total_steps
    for h in history:
        for key in ("loss", "grad_norm", "learning_rate"):
            np.testing.assert_allclose(h[key], want[h["step"]][key], rtol=1e-4,
                                       err_msg=f"step {h['step']} {key}")


def test_preemption_flag_checkpoints_and_returns(tmp_path):
    cfg = _config(tmp_path, epochs=1, save_steps=100)  # only the emergency save lands
    trainer = SFTTrainer(TrainConfig(**cfg), device="cpu")
    trainer.request_preemption()  # before the loop: stops at step 1
    summary = trainer.train()
    assert summary["preempted"] is True and summary["step"] == 1
    assert CheckpointManager(str(tmp_path / "outputs" / "checkpoints")).latest_step == 1
    kinds = [e["kind"] for e in trainer.telemetry.recorder.events()]
    assert "preemption_requested" in kinds and "emergency_checkpoint" in kinds

    resumed = SFTTrainer(TrainConfig(**cfg, resume_from_checkpoint="latest"), device="cpu")
    summary2 = resumed.train()
    assert "preempted" not in summary2
    steps = [h["step"] for h in resumed.metrics.history]
    assert steps and steps[0] == 2  # no step trained twice


def test_sigterm_drains_to_checkpoint_and_exits_zero(tmp_path):
    cfg = _config(tmp_path, save_steps=100)  # the cadence never fires before the signal
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    out = tmp_path / "outputs"

    proc = _launch(cfg_path, resume=False)
    _, lines = _run_until(proc, lambda step: step >= 3)
    proc.send_signal(signal.SIGTERM)
    rest, _ = proc.communicate(timeout=PROC_TIMEOUT)
    output = "".join(lines) + rest
    assert proc.returncode == 0, output[-4000:]
    assert "preempted at step" in output
    assert _committed(out)

    proc2 = _launch(cfg_path, resume=True)
    stdout, _ = proc2.communicate(timeout=PROC_TIMEOUT)
    assert proc2.returncode == 0, stdout[-4000:]
    resumed_step = int(stdout.split("Resumed from checkpoint step")[1].split()[0])
    assert resumed_step >= 3  # the emergency save, not a cadence one
    assert (out / "training_summary.json").exists()
