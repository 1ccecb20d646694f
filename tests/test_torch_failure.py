"""The port's heartbeat failure detector (``runtime/failure.py`` over its own
``native/heartbeat.cc``, built by ``runtime/native.py``), on the CPU:

- the library is built from the port's copy of the C++ into ``build/native``;
- the port's detector against the JAX package's ``runtime/failure``
  (which imports no JAX of its own): the same start/stop scenario gives the
  same ``dead_ranks()`` and ``rank_age_ms`` (a live rank, a stopped one, one
  never seen, one out of range) on each, and crossed on the wire (the port's
  workers into the JAX coordinator and the JAX workers into the port's);
- a coordinator on port 0 (an ephemeral port) with three ranks heartbeating
  reports the rank whose worker stopped, and no live one;
- over two gloo processes, ``FailureDetector.for_group`` shares rank 0's
  ephemeral port, a planted silent rank 1 shows in rank 0's
  ``dead_ranks()`` within the timeout, and the trainer's step boundary
  stops both ranks at the same step.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from llm_fine_tune_distributed_tpu_torch.runtime import distributed, native
from llm_fine_tune_distributed_tpu_torch.runtime.failure import FailureDetector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_MS = 600
INTERVAL_MS = 100
LAUNCH_TIMEOUT_S = 120


def _wait_for(cond, seconds):
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        if cond():
            return time.monotonic() - t0
        time.sleep(0.02)
    return None


def test_the_library_is_built_from_the_ports_own_source():
    assert native.load() is not None, native.build_error()
    pkg = os.path.join(ROOT, "llm_fine_tune_distributed_tpu_torch")
    assert str(native.SOURCE) == os.path.join(pkg, "native", "heartbeat.cc")
    assert str(native.lib_path().parent) == os.path.join(ROOT, "build", "native")
    assert native.lib_path().exists()


def test_a_stopped_worker_is_reported_and_no_live_one():
    coord = FailureDetector(rank=0, world_size=3, port=0, interval_ms=INTERVAL_MS,
                            timeout_ms=TIMEOUT_MS)
    workers = [FailureDetector(rank=r, world_size=3, port=coord.port, interval_ms=INTERVAL_MS,
                               timeout_ms=TIMEOUT_MS) for r in (1, 2)]
    try:
        assert coord.port > 0
        assert _wait_for(lambda: all(coord.rank_age_ms(r) >= 0 for r in range(3)), 5) is not None
        assert coord.dead_ranks() == [] and coord.all_alive()
        assert workers[0].dead_ranks() == []  # a worker has no coordinator view
        workers[1].stop()
        seen = _wait_for(lambda: coord.dead_ranks() == [2], 5)
        assert seen is not None and seen >= TIMEOUT_MS / 1e3 - 0.3
        assert coord.rank_age_ms(1) < TIMEOUT_MS and not coord.all_alive()
    finally:
        for d in [coord] + workers:
            d.stop()


def _jax_detector():
    from llm_fine_tune_distributed_tpu.runtime.failure import FailureDetector as JaxDetector

    return JaxDetector


def _scenario(coord_cls, worker_cls) -> dict:
    """A world of 4 on port 0: rank 0's coordinator (``coord_cls``), ranks 1
    and 2 heartbeating (``worker_cls``), rank 3 never started; rank 2 stops
    once every started rank was seen. What the coordinator then reports."""
    coord = coord_cls(rank=0, world_size=4, port=0, interval_ms=INTERVAL_MS,
                      timeout_ms=TIMEOUT_MS)
    workers = [worker_cls(rank=r, world_size=4, port=coord.port, interval_ms=INTERVAL_MS,
                          timeout_ms=TIMEOUT_MS) for r in (1, 2)]
    try:
        seen = _wait_for(lambda: all(coord.rank_age_ms(r) >= 0 for r in range(3)), 5)
        out = {"all_seen": seen is not None,
               "alive_before": coord.dead_ranks(timeout_ms=60_000),
               "never_seen_age": coord.rank_age_ms(3),
               "out_of_range_age": [coord.rank_age_ms(-1), coord.rank_age_ms(4)],
               "worker_view": [workers[0].dead_ranks(), workers[0].rank_age_ms(1)]}
        workers[1].stop()
        t0 = time.monotonic()
        dead = _wait_for(lambda: coord.dead_ranks() == [2, 3], 5)
        out.update(
            dead_after=coord.dead_ranks(),
            dead_within_timeout=dead is not None and time.monotonic() - t0 <= TIMEOUT_MS / 1e3 + 1,
            live_under_timeout=[0 <= coord.rank_age_ms(r) < TIMEOUT_MS for r in (0, 1)],
            stopped_past_timeout=coord.rank_age_ms(2) >= TIMEOUT_MS,
            never_seen_after=coord.rank_age_ms(3), all_alive=coord.all_alive())
        return out
    finally:
        for d in workers + [coord]:
            d.stop()


@pytest.mark.parametrize("coord_impl,worker_impl",
                         [("port", "port"), ("port", "jax"), ("jax", "port")])
def test_the_detector_matches_the_jax_one(coord_impl, worker_impl):
    """The same scenario on the JAX package's detector (its own build of
    its own C++) and on the port's, alone and crossed on the wire: the
    coordinator's view is the same."""
    impls = {"port": FailureDetector, "jax": _jax_detector()}
    want = _scenario(impls["jax"], impls["jax"])
    assert want == {"all_seen": True, "alive_before": [], "never_seen_age": -1,
                    "out_of_range_age": [-1, -1], "worker_view": [[], -1],
                    "dead_after": [2, 3], "dead_within_timeout": True,
                    "live_under_timeout": [True, True], "stopped_past_timeout": True,
                    "never_seen_after": -1, "all_alive": False}
    assert _scenario(impls[coord_impl], impls[worker_impl]) == want


def _rank_main(outdir) -> None:
    """One of two ranks: the detector over the group on port 0; rank 1
    falls silent; rank 0 waits to see it; both take the step boundary."""
    from llm_fine_tune_distributed_tpu_torch.train.trainer import SFTTrainer

    distributed.initialize_distributed(device="cpu")
    rank = distributed.process_index()
    det = FailureDetector.for_group("cpu", port=0, interval_ms=INTERVAL_MS, timeout_ms=TIMEOUT_MS)
    out = {"port": det.port}
    distributed.barrier("cpu")
    out["alive_before"] = det.dead_ranks()
    if rank == 1:
        det.stop_worker()
    else:
        out["seen_s"] = _wait_for(lambda: det.dead_ranks() == [1], 10)
    distributed.barrier("cpu")

    class Boundary:  # what SFTTrainer._step_boundary reads
        detector, device = det, torch.device("cpu")
        _preempt = _watchdog_abort = threading.Event()

    try:
        SFTTrainer._step_boundary(Boundary(), 3)
        out["stopped"] = None
    except RuntimeError as e:
        out["stopped"] = str(e)
    det.stop()
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.destroy()


def test_a_silent_rank_stops_both_ranks_at_one_step(tmp_path):
    port = distributed.free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
        env.update(distributed.rendezvous_env(rank, 2, port), PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), str(tmp_path)],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                      env=env))
    try:
        outs = [p.communicate(timeout=LAUNCH_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (o, e)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{o[-2000:]}\n{e[-4000:]}"
    r0, r1 = (json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2))
    assert r0["port"] == r1["port"] > 0  # rank 0's ephemeral port, broadcast
    assert r0["alive_before"] == [] == r1["alive_before"]
    assert r0["seen_s"] is not None and r0["seen_s"] <= 5
    assert "[1] stopped heartbeating at step 3" in r0["stopped"]
    assert "stopped heartbeating at step 3" in r1["stopped"]


if __name__ == "__main__":
    torch.set_num_threads(1)
    _rank_main(sys.argv[1])
