"""The port's step watchdog (``runtime/watchdog.py``) against the JAX
package's: the six cases of ``tests/test_watchdog.py``, each run on both
classes where it is the class alone, and the trainer case on the port's
``SFTTrainer`` (``tiny``, f32, the CPU) with ``watchdog_action="abort"``.

The waits are polls with a deadline wherever a trip is expected; a fixed
sleep remains only where the case is that nothing happens within the
window, and there the window is several times the sleep.
"""

import json
import time

import numpy as np
import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.runtime.watchdog import StepWatchdog

IMPLS = ("port", "jax")


def _cls(impl):
    if impl == "jax":
        from llm_fine_tune_distributed_tpu.runtime.watchdog import StepWatchdog as JaxWatchdog

        return JaxWatchdog
    return StepWatchdog


def _until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached in time"
        time.sleep(0.01)


@pytest.mark.parametrize("impl", IMPLS)
def test_trips_after_silence_and_rearms(impl):
    wd = _cls(impl)(timeout_s=1.0, action="warn", poll_s=0.05)
    try:
        wd.poke(1)
        time.sleep(0.2)
        assert wd.trips == 0  # still inside the window
        _until(lambda: wd.trips >= 1)  # the silence tripped it
        first = wd.trips
        wd.poke(2)
        time.sleep(0.2)
        assert wd.trips == first  # the poke re-armed it
    finally:
        wd.stop()


@pytest.mark.parametrize("impl", IMPLS)
def test_pause_suppresses_and_resume_rearms(impl):
    wd = _cls(impl)(timeout_s=0.3, action="warn", poll_s=0.05)
    try:
        wd.pause()
        time.sleep(0.8)
        assert wd.trips == 0  # paused: a long silence is fine
        wd.resume()
        time.sleep(0.05)
        assert wd.trips == 0  # resume stamps the time
        _until(lambda: wd.trips >= 1)  # armed again
    finally:
        wd.stop()


@pytest.mark.parametrize("impl", IMPLS)
def test_abort_action_fires_hook_instead_of_exit(impl):
    fired = []
    wd = _cls(impl)(timeout_s=0.2, action="abort", poll_s=0.05, on_trip=lambda: fired.append(1))
    try:
        _until(lambda: fired)
        time.sleep(0.4)
        assert fired == [1] and wd.trips == 1  # the abort path ran once; its thread ended
        assert not wd._thread.is_alive()
    finally:
        wd.stop()


@pytest.mark.parametrize("impl", IMPLS)
def test_rejects_unknown_action(impl):
    with pytest.raises(ValueError, match="warn|abort"):
        _cls(impl)(timeout_s=1, action="explode")


@pytest.mark.parametrize("impl", IMPLS)
def test_start_paused_arms_on_first_poke(impl):
    """Disarmed through the start (the first step's builds), armed from the
    first poke."""
    wd = _cls(impl)(timeout_s=0.3, action="warn", poll_s=0.05, start_paused=True)
    try:
        time.sleep(0.8)
        assert wd.trips == 0  # startup silence never trips
        wd.poke(1)
        _until(lambda: wd.trips >= 1)  # armed after the first poke
    finally:
        wd.stop()


def test_recorder_gets_trips_and_rearms():
    from llm_fine_tune_distributed_tpu_torch.observe.tracing import FlightRecorder

    rec = FlightRecorder()
    wd = StepWatchdog(timeout_s=0.2, action="warn", poll_s=0.05, start_paused=True, recorder=rec)
    try:
        wd.poke(3)
        _until(lambda: wd.trips >= 1)
    finally:
        wd.stop()
    kinds = [e["kind"] for e in rec.events()]
    assert kinds[0] == "watchdog_rearm" and "watchdog_trip" in kinds
    trip = rec.events()[kinds.index("watchdog_trip")]
    assert trip["last_step"] == 3 and trip["action"] == "warn"


def test_trainer_runs_clean_with_watchdog(tmp_path):
    """A normal training run with an aborting watchdog never trips: each
    optimizer step pokes it, each eval pauses it, and the run stops it."""
    from llm_fine_tune_distributed_tpu_torch.config import TrainConfig
    from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

    data = tmp_path / "data"
    data.mkdir()
    with open(data / "qa.jsonl", "w") as f:
        for i in range(48):
            f.write(json.dumps({"topic": "Knots", "question": f"q {i}?",
                                "answer": f"a {i}: pull the loop."}) + "\n")
    cfg = TrainConfig(model_name="tiny-random", model_preset="tiny", tokenizer_path="byte-chatml",
                      data_dir=str(data), dataset_file="qa.jsonl",
                      output_dir=str(tmp_path / "out"), epochs=1, per_device_batch_size=4,
                      gradient_accumulation_steps=1, eval_steps=5, max_seq_length=128,
                      system_prompt="Be brief.", compute_dtype="float32",
                      watchdog_timeout_s=300.0, watchdog_action="abort")
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        trainer = SFTTrainer(cfg, device="cpu")
        summary = trainer.train()  # a trip would os._exit(42) and end the test run
    finally:
        torch.set_num_threads(threads)
    assert np.isfinite(summary["final_train_loss"])
    wd = trainer.watchdog
    assert wd is not None and wd.trips == 0 and wd.action == "abort"
    assert wd._last_step == trainer.total_steps  # poked at every step
    assert wd._stop.is_set()  # stopped at the end of the run


def test_env_sets_the_watchdog():
    """``WATCHDOG_TIMEOUT_S`` and ``WATCHDOG_ACTION`` are the JAX package's
    env names and defaults."""
    from llm_fine_tune_distributed_tpu.config import TrainConfig as JaxTrainConfig
    from llm_fine_tune_distributed_tpu_torch.config import TrainConfig

    env = {"WATCHDOG_TIMEOUT_S": "12.5", "WATCHDOG_ACTION": "abort"}
    for cfg in (TrainConfig(), JaxTrainConfig()):
        assert (cfg.watchdog_timeout_s, cfg.watchdog_action) == (0.0, "warn")
    got = TrainConfig().apply_env_overrides(env)
    want = JaxTrainConfig().apply_env_overrides(env)
    assert (got.watchdog_timeout_s, got.watchdog_action) == (
        want.watchdog_timeout_s, want.watchdog_action) == (12.5, "abort")
