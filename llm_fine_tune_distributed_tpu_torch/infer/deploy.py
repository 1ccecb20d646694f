"""Live deployment, the serving half of the train→serve loop (counterpart of
the JAX ``infer/deploy.py``): a ``CheckpointWatcher`` polls a trainer's
publish directory (``train/publish.py``) and a ``HotSwapManager`` rolls
each new publish across the serving engines without dropping a request.

- **Watch.** The watcher targets the newest committed publish (a manifest
  is written last). Torn, malformed or half-deleted publishes are logged and
  skipped, never raised into serving.
- **Eval gate.** A publish whose manifest metric (``eval_loss``, lower is
  better) is worse than the resident generation's is refused
  (``publish_rejected_eval`` flight event).
- **Verify.** The manifest's frozen fingerprint is checked against the
  resident base (``train/checkpoints.verify_fingerprint`` over the resident
  leaves the publish does not carry, adapter pools excluded): a delta
  trained against other base weights is refused at the door.
- **Swap.** The weights are read into host memory first; each engine
  applies them copy-on-write at a drained tick boundary
  (``engine.request_weight_swap``). A fleet swaps one replica at a time,
  each first evacuated to its siblings when the fleet migrates
  (``EngineFleet.evacuate_replica``); a replica mid-swap reports
  ``swap_pending`` and the router sheds it. A failure part-way rolls the
  swapped replicas back and raises.
- **Canary.** With a ``CanaryJudge`` (``observe/slo.py``) and more than one
  replica, the roll pauses after replica 0 for the judge's window; a
  regression verdict rolls replica 0 back and holds the publish, so it never
  reaches replica 1.
- **Rollback.** The resident values of every swapped leaf are kept in host
  memory (read off replica 0). ``rollback()`` swaps them back in (a forward
  swap: the generation goes up) and holds the fled step, so the poller does
  not redeploy it; an optional watch rolls back by itself when the post-swap
  error rate trips its threshold.
- **Lineage.** Every outcome is a record (``lineage()``, ``GET
  /v1/lineage``): the generation, the step, the manifest's ``run_id``,
  ``hparams_digest``, ``anomaly_clean`` and metrics.

The port's ``base_params`` may be a callable returning the resident dict,
so the watcher never holds a generation's leaves alive. The watcher keeps
its last load's and fingerprint's seconds (``last_load_s``,
``last_fingerprint_s``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from llm_fine_tune_distributed_tpu_torch.observe.slo import CanaryJudge
from llm_fine_tune_distributed_tpu_torch.train.checkpoints import (
    FingerprintMismatch,
    frozen_fingerprint,
    verify_fingerprint,
)
from llm_fine_tune_distributed_tpu_torch.train.publish import (
    list_published,
    load_manifest,
    load_weights,
)

__all__ = ["CheckpointWatcher", "HotSwapManager"]

log = logging.getLogger(__name__)


class CheckpointWatcher:
    """Polls a publish directory for new deployment candidates.

    ``check(min_step)`` returns the newest verified candidate beyond
    ``min_step`` as ``{"step", "fingerprint", "weights", "manifest",
    "path"}``, its weights in host memory, or None when there is nothing new
    or nothing valid. ``base_params`` (the resident flat dict, or a
    zero-argument callable returning it; pooled adapter leaves are ignored)
    enables the frozen-fingerprint check. ``eval_gate_metric`` names the
    manifest metric that gates promotion (``eval_gate_mode`` "min": lower is
    better); the gate engages when both the candidate's and the resident
    generation's manifests carry it (``note_deployed``)."""

    def __init__(self, publish_dir: str, *, base_params=None, verify_frozen: bool = True,
                 eval_gate_metric: str = "eval_loss", eval_gate_mode: str = "min",
                 recorder=None):
        self.publish_dir = publish_dir
        self._base = base_params
        self._verify = bool(verify_frozen) and base_params is not None
        if eval_gate_mode not in ("min", "max"):
            raise ValueError(f"eval_gate_mode must be 'min' or 'max', got {eval_gate_mode!r}")
        self.eval_gate_metric = eval_gate_metric
        self.eval_gate_mode = eval_gate_mode
        self.recorder = recorder
        self._resident_metrics: Optional[Dict[str, Any]] = None
        # (step, fingerprint) pairs the eval gate or the fingerprint check
        # refused: one warning and one flight event each
        self._eval_rejected: set = set()
        self._fp_rejected: set = set()
        # the resident frozen fingerprint per published key set (the frozen
        # leaves are the ones a publish does not carry, and a swap never
        # changes them)
        self._resident_fp: Dict[frozenset, Dict[str, Any]] = {}
        self.last_load_s: Optional[float] = None
        self.last_fingerprint_s: Optional[float] = None

    def note_deployed(self, metrics: Optional[Dict[str, Any]]) -> None:
        """The manifest metrics of the generation now resident: the eval
        gate's baseline."""
        self._resident_metrics = dict(metrics) if metrics else None

    def _eval_regresses(self, manifest: Dict[str, Any], path: str) -> bool:
        metric = self.eval_gate_metric
        if not metric or self._resident_metrics is None:
            return False
        cand = (manifest.get("metrics") or {}).get(metric)
        resident = self._resident_metrics.get(metric)
        if cand is None or resident is None:
            return False
        worse = (float(cand) > float(resident) if self.eval_gate_mode == "min"
                 else float(cand) < float(resident))
        if not worse:
            return False
        key = (int(manifest["step"]), str(manifest.get("weight_fingerprint")))
        if key not in self._eval_rejected:
            self._eval_rejected.add(key)
            log.warning("rejecting publish %s: %s %.6g regresses vs resident %.6g",
                        path, metric, float(cand), float(resident))
            if self.recorder is not None:
                self.recorder.record("publish_rejected_eval", step=int(manifest["step"]),
                                     metric=metric, candidate=float(cand),
                                     resident=float(resident))
        return True

    def _resident_frozen_fp(self, trainable_keys: frozenset) -> Dict[str, Any]:
        cached = self._resident_fp.get(trainable_keys)
        if cached is None:
            base = self._base() if callable(self._base) else self._base
            # adapter pool leaves ride in a serving view but exist on no
            # trainer: neither trainable nor frozen for the protocol
            frozen = {k: v for k, v in base.items()
                      if k not in trainable_keys and "_pool" not in k.rsplit(".", 1)[-1]}
            t0 = time.perf_counter()
            cached = frozen_fingerprint(frozen)
            self.last_fingerprint_s = time.perf_counter() - t0
            self._resident_fp[trainable_keys] = cached
        return cached

    def check(self, min_step: int = -1) -> Optional[Dict[str, Any]]:
        """The newest verified publish with a step above ``min_step``, or None."""
        for step, path in reversed(list_published(self.publish_dir)):
            if step <= min_step:
                return None
            manifest = load_manifest(path)
            if manifest is None:
                continue  # torn or malformed: the loader logged it
            if self._eval_regresses(manifest, path):
                continue
            t0 = time.perf_counter()
            try:
                weights = load_weights(path, manifest)
            except Exception as e:  # noqa: BLE001 — skip it, never crash serving
                log.warning("ignoring unloadable publish %s: %s", path, e)
                continue
            self.last_load_s = time.perf_counter() - t0
            if self._verify:
                try:
                    verify_fingerprint(manifest["frozen_fp"],
                                       self._resident_frozen_fp(frozenset(weights)))
                except FingerprintMismatch as e:
                    log.warning("rejecting publish %s: frozen params do not match the resident "
                                "base (%s)", path, e)
                    key = (step, str(manifest["weight_fingerprint"]))
                    if self.recorder is not None and key not in self._fp_rejected:
                        self.recorder.record("publish_rejected_fingerprint", step=step,
                                             error=str(e)[:200])
                    self._fp_rejected.add(key)
                    continue
            return {"step": int(manifest["step"]),
                    "fingerprint": str(manifest["weight_fingerprint"]),
                    "weights": weights, "manifest": manifest, "path": path}
        return None


class HotSwapManager:
    """Rolls verified publishes across a fleet (``.replicas``) or one engine
    and keeps the previous values for rollback. ``poll_once()`` is the
    on-demand deploy (``POST /v1/deploy``); ``start()`` runs it on a poll
    loop that also watches the post-swap error rate."""

    def __init__(self, target, watcher: CheckpointWatcher, *, poll_s: float = 2.0,
                 swap_timeout_s: float = 600.0, auto_rollback_window_s: float = 0.0,
                 auto_rollback_error_rate: float = 0.5, auto_rollback_min_requests: int = 8,
                 canary: Optional[CanaryJudge] = None):
        self.watcher = watcher
        self.engines = list(getattr(target, "replicas", None) or [target])
        self._target = target
        self.poll_s = max(0.05, float(poll_s))
        self.swap_timeout_s = float(swap_timeout_s)
        self.auto_rollback_window_s = float(auto_rollback_window_s)
        self.auto_rollback_error_rate = float(auto_rollback_error_rate)
        self.auto_rollback_min_requests = int(auto_rollback_min_requests)
        self.canary = canary
        self.last_canary: Optional[Dict[str, Any]] = None
        if watcher.recorder is None:  # the gate's refusals land on replica 0's timeline
            watcher.recorder = getattr(self.engines[0], "recorder", None)
        self._lock = threading.Lock()
        self.deployed_step = -1
        self.deployed_fingerprint: Optional[str] = None
        # manifest metrics and manifests mirroring the resident and the
        # rollback buffers (the eval gate's baseline and the lineage)
        self._resident_metrics: Optional[Dict[str, Any]] = None
        self._prev_metrics: Optional[Dict[str, Any]] = None
        self._resident_manifest: Optional[Dict[str, Any]] = None
        self._prev_manifest: Optional[Dict[str, Any]] = None
        self._lineage_by_gen: Dict[int, Dict[str, Any]] = {}
        self._lineage_history: List[Dict[str, Any]] = []
        # a rollback holds the fled step: publishes at or below it are not
        # redeployed; a newer publish supersedes the hold
        self._hold_step = -1
        # the rollback buffer: the previous values of the last deploy's
        # leaves (host tensors) and the identity they served under
        self._prev_weights: Optional[Dict[str, torch.Tensor]] = None
        self._prev_fingerprint: Optional[str] = None
        self._prev_step = -1
        self._watch_deadline: Optional[float] = None  # the post-swap error watch
        self._watch_base = (0, 0)  # (completed, failed) at the swap
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- deploys

    def poll_once(self) -> Optional[Dict[str, Any]]:
        """Deploy the newest verified publish beyond the resident one;
        returns the deploy's result, or None when there is nothing newer."""
        with self._lock:
            dep = self.watcher.check(max(self.deployed_step, self._hold_step))
            if dep is None:
                return None
            return self._deploy(dep["weights"], dep["fingerprint"], dep["step"], kind="deploy",
                                metrics=dep["manifest"].get("metrics") or None,
                                manifest=dep["manifest"])

    def rollback(self) -> Dict[str, Any]:
        """Swap the previous values back in (``POST /v1/deploy/rollback``).
        RuntimeError when no deploy has displaced anything yet."""
        with self._lock:
            if self._prev_weights is None:
                raise RuntimeError("nothing to roll back to: no hot-swap has completed on this "
                                   "manager (the boot weights were never displaced)")
            fled = self.deployed_step
            result = self._deploy(self._prev_weights, self._prev_fingerprint, self._prev_step,
                                  kind="rollback", metrics=self._prev_metrics,
                                  manifest=self._prev_manifest)
            self._hold_step = max(self._hold_step, fled)
            return result

    def _swap(self, eng, weights, fingerprint, step) -> dict:
        return eng.request_weight_swap(weights, fingerprint=fingerprint, step=step,
                                       timeout=self.swap_timeout_s)

    def _deploy(self, weights: Dict[str, torch.Tensor], fingerprint: Optional[str], step: int,
                kind: str, metrics: Optional[Dict[str, Any]] = None,
                manifest: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Rolling swap of ``weights`` over every engine (lock held): the
        resident values are captured first (the next rollback buffer), then
        one replica at a time swaps, replica 0 judged by the canary first.
        A failure part-way restores the swapped replicas and raises."""
        prev = self._capture(weights)
        t0 = time.monotonic()
        done: List[Any] = []
        results = []
        canary_verdict: Optional[Dict[str, Any]] = None
        evacuate = getattr(self._target, "evacuate_replica", None)
        try:
            for i, eng in enumerate(self.engines):
                if evacuate is not None:
                    # with fleet migration on, empty the replica onto its
                    # siblings so the drained boundary comes at once; any
                    # failure just means the swap waits for the drain
                    try:
                        evacuate(eng)
                    except Exception:  # noqa: BLE001
                        pass
                results.append(self._swap(eng, weights, fingerprint, step))
                done.append(eng)
                if i == 0 and kind == "deploy" and self.canary is not None and len(self.engines) > 1:
                    canary_verdict = self.canary.judge(eng, self.engines[1:],
                                                       results[0]["weight_generation"])
                    self.last_canary = canary_verdict
                    if canary_verdict.get("verdict") == "regression":
                        return self._reject_canary(eng, prev, fingerprint, step, canary_verdict,
                                                   manifest=manifest)
        except BaseException:
            for eng in done:  # restore the pre-deploy values where they changed
                try:
                    self._swap(eng, prev, self.deployed_fingerprint, self.deployed_step)
                except Exception:  # noqa: BLE001 — the original error wins
                    pass
            raise
        if kind == "rollback":
            for eng in self.engines:
                eng.stats.incr("weight_rollbacks")
        self._prev_weights = prev
        self._prev_fingerprint = self.deployed_fingerprint
        self._prev_step = self.deployed_step
        self._prev_metrics = self._resident_metrics
        self._prev_manifest = self._resident_manifest
        self._resident_metrics = dict(metrics) if metrics else None
        self._resident_manifest = dict(manifest) if manifest else None
        self.watcher.note_deployed(self._resident_metrics)
        self.deployed_step = int(step)
        self.deployed_fingerprint = fingerprint
        self._arm_watch()
        dt = time.monotonic() - t0
        print(f"[deploy] {kind}: step {step} ({fingerprint}) live on {len(self.engines)} "
              f"replica(s) in {dt:.3f}s", flush=True)
        result = {
            "kind": kind, "step": int(step), "fingerprint": fingerprint,
            "replicas": len(self.engines), "duration_s": dt,
            "weight_generation": max(r["weight_generation"] for r in results),
            "cache_invalidated": any(r["cache_invalidated"] for r in results),
            "updated_leaves": results[0]["updated_leaves"],
            "apply_s": [r["duration_s"] for r in results],
            "memory_delta_bytes": [r.get("memory_delta_bytes") for r in results],
        }
        lineage = self._lineage_note(result["weight_generation"], kind, step, fingerprint,
                                     manifest, extra={"replicas": len(self.engines),
                                                      "duration_s": round(dt, 4)})
        result["run_id"] = lineage["run_id"]
        result["anomaly_clean"] = lineage["anomaly_clean"]
        if canary_verdict is not None:
            result["canary"] = canary_verdict
        return result

    def _lineage_note(self, generation: Optional[int], kind: str, step: int,
                      fingerprint: Optional[str], manifest: Optional[Dict[str, Any]],
                      extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """One lineage record per deploy outcome (lock held); a canary
        rejection has ``generation`` None: it never became fleet-resident."""
        m = manifest or {}
        rec: Dict[str, Any] = {
            "generation": int(generation) if generation is not None else None,
            "kind": kind, "step": int(step), "fingerprint": fingerprint,
            "run_id": m.get("run_id"), "hparams_digest": m.get("hparams_digest"),
            "anomaly_clean": m.get("anomaly_clean"),
            "metrics": dict(m.get("metrics") or {}) or None,
            "deployed_unix": time.time(),
        }
        if extra:
            rec.update(extra)
        if generation is not None:
            self._lineage_by_gen[int(generation)] = rec
        self._lineage_history.append(rec)
        del self._lineage_history[:-128]
        return rec

    def lineage(self) -> Dict[str, Any]:
        """``GET /v1/lineage``: the resident generation, the records per
        generation and the deploy history (newest last)."""
        with self._lock:
            gens = [int(getattr(e, "weight_generation", 0)) for e in self.engines]
            return {
                "resident_generation": max(gens) if gens else 0,
                "weight_generations": gens,
                "deployed_step": self.deployed_step,
                "deployed_fingerprint": self.deployed_fingerprint,
                "generations": {str(g): dict(r) for g, r in self._lineage_by_gen.items()},
                "history": [dict(r) for r in self._lineage_history],
            }

    def _reject_canary(self, eng, prev: Dict[str, torch.Tensor], fingerprint: Optional[str],
                       step: int, verdict: Dict[str, Any],
                       manifest: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Roll the canary back to the pre-deploy values and hold the step
        (lock held); the deployed step and the rollback buffer stay, since
        the fleet never left the resident generation."""
        try:
            self._swap(eng, prev, self.deployed_fingerprint, self.deployed_step)
            eng.stats.incr("weight_rollbacks")
        except Exception as e:  # noqa: BLE001 — the verdict still blocks the roll
            print(f"[deploy] canary rollback failed: {e}", flush=True)
        recorder = getattr(eng, "recorder", None)
        if recorder is not None:
            recorder.record("canary_rollback", step=int(step), reason=verdict.get("reason"))
        self._hold_step = max(self._hold_step, int(step))
        print(f"[deploy] canary REJECTED step {step} ({fingerprint}): {verdict.get('reason')}",
              flush=True)
        lineage = self._lineage_note(None, "canary_rejected", step, fingerprint, manifest,
                                     extra={"canary_reason": verdict.get("reason")})
        return {"kind": "canary_rejected", "step": int(step), "fingerprint": fingerprint,
                "replicas": 1, "canary": verdict, "run_id": lineage["run_id"],
                "anomaly_clean": lineage["anomaly_clean"]}

    def _capture(self, weights: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Host copies of the values resident at ``weights``' leaves, read
        off replica 0 (a completed roll leaves every replica equal), whole
        (``resident_params``: under a multi-process ``--tp`` gathered from
        every rank's slices)."""
        resident = self.engines[0].resident_params(list(weights))
        return {k: v.detach().to("cpu", copy=True) for k, v in resident.items()}

    # ------------------------------------------------------ auto-rollback

    def _counters(self) -> tuple:
        snap = (self._target.stats_snapshot() if hasattr(self._target, "stats_snapshot")
                else self.engines[0].stats_snapshot())
        return int(snap.get("requests_completed", 0)), int(snap.get("requests_failed", 0))

    def _arm_watch(self) -> None:
        if self.auto_rollback_window_s <= 0:
            return
        self._watch_deadline = time.monotonic() + self.auto_rollback_window_s
        self._watch_base = self._counters()

    def _watch_tripped(self) -> bool:
        """True when the post-swap window's error rate reached the threshold
        over enough requests to mean anything."""
        if self._watch_deadline is None:
            return False
        if time.monotonic() > self._watch_deadline:
            self._watch_deadline = None  # the window closed clean
            return False
        completed, failed = self._counters()
        d_ok, d_bad = completed - self._watch_base[0], failed - self._watch_base[1]
        total = d_ok + d_bad
        if total < self.auto_rollback_min_requests:
            return False
        return d_bad / total >= self.auto_rollback_error_rate

    def tick(self) -> None:
        """One poll-loop iteration: the auto-rollback check, then a poll."""
        if self._watch_tripped():
            self._watch_deadline = None
            try:
                res = self.rollback()
                print(f"[deploy] auto-rollback tripped — restored step {res['step']} "
                      f"({res['fingerprint']})", flush=True)
            except Exception as e:  # noqa: BLE001 — keep the loop alive
                print(f"[deploy] auto-rollback failed: {e}", flush=True)
            return  # do not redeploy the generation just fled
        try:
            self.poll_once()
        except Exception as e:  # noqa: BLE001 — the loop keeps polling
            print(f"[deploy] deploy attempt failed: {e}", flush=True)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="hot-swap-manager", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.tick()

    def status(self) -> Dict[str, Any]:
        return {
            "deployed_step": self.deployed_step,
            "deployed_fingerprint": self.deployed_fingerprint,
            "rollback_available": self._prev_weights is not None,
            "rollback_step": self._prev_step,
            "weight_generations": [int(getattr(e, "weight_generation", 0)) for e in self.engines],
            "watching": self.watcher.publish_dir,
            "canary_armed": self.canary is not None,
            "last_canary": self.last_canary,
        }
