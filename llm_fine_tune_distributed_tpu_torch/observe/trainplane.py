"""The trainer's telemetry: run identity, anomaly sentinels and the status
the publish gate reads (counterpart of the JAX ``observe/trainplane.py``
without its HTTP control plane).

``TrainTelemetry`` is always built by the trainer and fed only at its
log/eval/save boundaries, where the metric scalars are already host floats:
a flight recorder of step milestones, evals, checkpoint saves and restores,
publishes and preemption; monotonic counters; and ``AnomalySentinels``,
which watch the loss and the grad norm for non-finite values and for
spikes above an EWMA band. A sentinel firing makes the trailing
``anomaly_window_steps`` window dirty: a checkpoint published from it
carries ``anomaly_clean: false`` (or is skipped under
``publish_require_clean``), so the serving side never promotes weights cut
mid-divergence unknowingly.

Not ported here: ``TrainControlPlane`` (the ``train_port`` HTTP server) and
``trainer_exposition``.
"""

from __future__ import annotations

import hashlib
import json
import math
import threading
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

from llm_fine_tune_distributed_tpu_torch.observe.tracing import FlightRecorder

__all__ = ["ANOMALY_KINDS", "TRAIN_COUNTERS", "AnomalySentinels", "TrainTelemetry",
           "hparams_digest", "new_run_id"]

# the sentinels' kinds, every one counted from 0
ANOMALY_KINDS = ("non_finite", "loss_spike", "grad_explosion")

# monotonic trainer counters (the JAX set)
TRAIN_COUNTERS = ("evals", "checkpoints_saved", "publishes", "publishes_skipped_dirty",
                  "watchdog_trips")


def new_run_id() -> str:
    """Short identity of one training run: the manifest's ``run_id``, which
    ties a serving weight generation back to the run that made it."""
    return uuid.uuid4().hex[:12]


def hparams_digest(hparams: Dict[str, Any]) -> str:
    """16-hex identity of a run's hyperparameters (its flattened config)."""
    try:
        blob = json.dumps(hparams, sort_keys=True, default=str)
    except (TypeError, ValueError):
        blob = repr(sorted(hparams.items(), key=lambda kv: str(kv[0])))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


class _Ewma:
    """Exponentially weighted mean and variance of a scalar stream."""

    def __init__(self, alpha: float):
        self.alpha = float(alpha)
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def update(self, x: float) -> None:
        if self.n == 0:
            self.mean = x
            self.var = 0.0
        else:
            d = x - self.mean
            self.mean += self.alpha * d
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * d * d)
        self.n += 1

    @property
    def std(self) -> float:
        return math.sqrt(max(self.var, 0.0))


class AnomalySentinels:
    """Host-side detectors over the per-step metric stream.

    - ``non_finite``: a NaN or Inf loss or grad norm, from the first step;
    - ``loss_spike``: the loss above its EWMA mean by more than
      ``band_sigma`` EW standard deviations, after ``warmup`` finite steps;
    - ``grad_explosion``: the same band on the grad norm.

    An anomalous value is not folded into its band, so a divergence does not
    widen the band that detects it. ``clean_since(step)`` is the publish
    gate: has any sentinel fired at or after ``step``?"""

    def __init__(self, *, band_sigma: float = 6.0, warmup: int = 8, ewma_alpha: float = 0.1,
                 on_anomaly=None):
        if band_sigma <= 0:
            raise ValueError(f"band_sigma must be positive, got {band_sigma}")
        self.band_sigma = float(band_sigma)
        self.warmup = max(1, int(warmup))
        self._on_anomaly = on_anomaly
        self._loss = _Ewma(ewma_alpha)
        self._grad = _Ewma(ewma_alpha)
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {k: 0 for k in ANOMALY_KINDS}
        self.last_step: Dict[str, Optional[int]] = {k: None for k in ANOMALY_KINDS}
        self.last_anomaly_step: Optional[int] = None

    def _fire(self, kind: str, step: int, **fields) -> None:
        self.counts[kind] += 1
        self.last_step[kind] = step
        self.last_anomaly_step = (step if self.last_anomaly_step is None
                                  else max(self.last_anomaly_step, step))
        if self._on_anomaly is not None:
            try:
                self._on_anomaly(kind, step, **fields)
            except Exception:
                pass  # telemetry never takes the train loop down

    def _band_check(self, kind: str, ewma: _Ewma, value: float, step: int) -> bool:
        if ewma.n >= self.warmup:
            # a floor on the band: a perfectly flat warm-up must not make
            # every later movement a 6-sigma event
            floor = max(ewma.std, 1e-3 * max(1.0, abs(ewma.mean)))
            if value - ewma.mean > self.band_sigma * floor:
                self._fire(kind, step, value=round(value, 6), band_mean=round(ewma.mean, 6),
                           band_std=round(floor, 6))
                return True
        ewma.update(value)
        return False

    def observe(self, step: int, loss: Optional[float] = None,
                grad_norm: Optional[float] = None) -> List[str]:
        """Feed one step's host scalars; returns the kinds that fired."""
        fired: List[str] = []
        with self._lock:
            for name, value in (("loss", loss), ("grad_norm", grad_norm)):
                if value is None:
                    continue
                value = float(value)
                if not math.isfinite(value):
                    self._fire("non_finite", step, signal=name, value=str(value))
                    fired.append("non_finite")
                    continue
                if name == "loss":
                    if self._band_check("loss_spike", self._loss, value, step):
                        fired.append("loss_spike")
                elif self._band_check("grad_explosion", self._grad, value, step):
                    fired.append("grad_explosion")
        return fired

    def clean_since(self, step_lo: int) -> bool:
        """True when no sentinel fired at a step >= ``step_lo``."""
        with self._lock:
            return self.last_anomaly_step is None or self.last_anomaly_step < step_lo

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"counts": dict(self.counts), "last_step": dict(self.last_step),
                    "last_anomaly_step": self.last_anomaly_step,
                    "total": sum(self.counts.values())}


class TrainTelemetry:
    """The trainer's shared observability state: the flight recorder, the
    sentinels, the counters and the status dict. Mutated at the train
    loop's log/eval/save boundaries; read as snapshots under a lock."""

    def __init__(self, *, run_id: Optional[str] = None,
                 hparams: Optional[Dict[str, Any]] = None, flight_capacity: int = 2048,
                 band_sigma: float = 6.0, anomaly_window_steps: int = 100,
                 sentinel_warmup: int = 8):
        self.run_id = run_id or new_run_id()
        self.hparams_digest = hparams_digest(hparams or {})
        self.recorder = FlightRecorder(flight_capacity)
        self.anomaly_window_steps = max(1, int(anomaly_window_steps))
        self.sentinels = AnomalySentinels(band_sigma=band_sigma, warmup=sentinel_warmup,
                                          on_anomaly=self._on_anomaly)
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {k: 0 for k in TRAIN_COUNTERS}
        self._status: Dict[str, Any] = {
            "run_id": self.run_id, "hparams_digest": self.hparams_digest,
            "state": "initializing", "step": 0, "total_steps": 0, "epoch": 0.0,
            "epochs": 0, "preempted": False,
        }
        self._checkpoints: deque = deque(maxlen=64)
        self._publishes: deque = deque(maxlen=64)

    # ----------------------------------------------------------- mutation

    def _on_anomaly(self, kind: str, step: int, **fields) -> None:
        self.recorder.record("anomaly", anomaly=kind, step=step, **fields)

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set_counter(self, name: str, value: int) -> None:
        """Fold in a monotonic counter owned elsewhere (the watchdog's trips)."""
        with self._lock:
            self._counters[name] = max(self._counters.get(name, 0), int(value))

    def update(self, **fields) -> None:
        with self._lock:
            self._status.update(fields)

    def on_step(self, step: int, logs: Dict[str, Any]) -> List[str]:
        """Fold one log record (host floats) into the sentinels, the flight
        timeline and the status; returns the anomaly kinds that fired."""
        fired = self.sentinels.observe(step, loss=logs.get("loss"),
                                       grad_norm=logs.get("grad_norm"))
        numeric = {k: float(v) for k, v in logs.items()
                   if isinstance(v, (int, float)) and not isinstance(v, bool)}
        with self._lock:
            self._status["step"] = int(step)
            self._status.update(numeric)
            self._status["state"] = "training"
        event = {"step": step}
        for key in ("loss", "grad_norm", "learning_rate"):
            if key in numeric:
                v = numeric[key]
                event[key] = round(v, 6) if math.isfinite(v) else str(v)
        self.recorder.record("step", **event)
        if "eval_loss" in logs:
            self.incr("evals")
            ev = float(logs["eval_loss"])
            self.recorder.record("eval", step=step,
                                 eval_loss=round(ev, 6) if math.isfinite(ev) else str(ev))
        return fired

    def note_checkpoint(self, step: int, duration_s: float) -> None:
        self.incr("checkpoints_saved")
        self.recorder.record("checkpoint_save", step=step, duration_s=round(duration_s, 4))
        with self._lock:
            self._checkpoints.append({"step": int(step), "duration_s": round(duration_s, 4)})

    def note_restore(self, step: int) -> None:
        self.recorder.record("checkpoint_restore", step=step)

    def note_publish(self, step: int, *, clean: bool, skipped: bool = False,
                     fingerprint: Optional[str] = None) -> None:
        self.incr("publishes_skipped_dirty" if skipped else "publishes")
        self.recorder.record("publish_skipped_dirty" if skipped else "publish", step=step,
                             anomaly_clean=clean, fingerprint=fingerprint)
        with self._lock:
            self._publishes.append({"step": int(step), "anomaly_clean": bool(clean),
                                    "skipped": bool(skipped), "fingerprint": fingerprint})

    def publish_clean(self, step: int) -> bool:
        """Is the trailing ``anomaly_window_steps`` window ending at
        ``step`` free of sentinel firings? Stamped into the manifest as
        ``anomaly_clean`` and enforced by ``publish_require_clean``."""
        return self.sentinels.clean_since(step - self.anomaly_window_steps + 1)

    # ------------------------------------------------------------ reading

    def counters_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def status(self) -> Dict[str, Any]:
        """One JSON-ready view: the status, the checkpoint and publish
        history, the counters, the sentinels and an ETA."""
        with self._lock:
            out = dict(self._status)
            out["checkpoints"] = list(self._checkpoints)
            out["publishes"] = list(self._publishes)
            out["counters"] = dict(self._counters)
        out["anomalies"] = self.sentinels.snapshot()
        sps = float(out.get("steps_per_second") or 0.0)
        total = int(out.get("total_steps") or 0)
        step = int(out.get("step") or 0)
        out["eta_s"] = round((total - step) / sps, 1) if sps > 0 and total > step else None
        out["flight_events"] = len(self.recorder)
        return out
