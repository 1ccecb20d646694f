"""Checkpoints for the port's trainer: keep-N rotation with best-metric
tracking, explicit resume, a trainable-only payload and a non-blocking
snapshot save (counterpart of the JAX ``train/checkpoints.py``).

The JAX manager writes Orbax checkpoints; the card has no Orbax, so the
port writes its own format, one directory per step under
``<output_dir>/checkpoints/<step>/``:

- ``trainable.safetensors``: the trainable masters (``models/hf_io``'s
  codec; numpy has no bf16, so no npz);
- ``opt_state.safetensors``: the AdamW moments, keyed ``mu/<leaf>`` and
  ``nu/<leaf>``;
- ``frozen.safetensors``: the frozen leaves, in the full payload only;
- ``metadata.json``, written last and atomically: the step, the update
  count, the metrics, the payload mode and (trainable-only) the frozen
  fingerprint. Its presence is the commit point: a step directory without
  it is an interrupted save and is ignored (and replaced by the next save
  of that step).

``latest.json`` beside the step directories names the newest committed
step, as in the JAX manager.

Under data parallelism the trainer gathers the fsdp-sharded moments whole
on every rank (on its own thread, before any snapshot) and rank 0 alone
saves, so the files are a one-device checkpoint's; every rank restores the
whole files and keeps its slices, so any world size resumes any other.

Trainable-only payload (``trainable_only=True``): the frozen leaves are
rebuilt from the base checkpoint or the init seed at resume, so only the
trainable masters, the optimizer moments and the step are written, with a
per-leaf fingerprint of the frozen leaves that ``restore`` verifies. A
changed base is a ``FingerprintMismatch``, not silent corruption.

Non-blocking snapshot (``save(..., snapshot_async=True)``): the payload's
mutable leaves are cloned on the device (stream-ordered before the next
optimizer step updates them in place), and a background thread copies the
clones to the host and writes them. A background failure is raised at the
next ``save``, ``wait`` or ``close``; ``save`` and ``restore`` first join a
pending snapshot (the JAX manager only checks its error).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from llm_fine_tune_distributed_tpu_torch.models.hf_io import read_safetensors, write_safetensors
from llm_fine_tune_distributed_tpu_torch.train.publish import atomic_write_bytes, atomic_write_json
from llm_fine_tune_distributed_tpu_torch.train.state import TrainState

METADATA_NAME = "metadata.json"
_FILES = {"trainable": "trainable.safetensors", "opt_state": "opt_state.safetensors",
          "frozen": "frozen.safetensors"}
_FP_CHUNK = 1 << 24  # elements per reduction chunk of the fingerprint


class FingerprintMismatch(RuntimeError):
    """The frozen parameters rebuilt for a resume (or resident in a server)
    do not match the ones a trainable-only checkpoint (or a publish) was
    trained against. The trainer's resume never falls back past it: the
    checkpoint is fine, the base weights are wrong."""


def _leaf_stats(x: torch.Tensor) -> torch.Tensor:
    """[sum |x|, sum x^2, sum x * i / n] of one leaf, in float64 on its
    device, summed chunk by chunk so the float64 copy stays small."""
    flat = x.detach().reshape(-1)
    n = flat.numel()
    acc = torch.zeros(3, dtype=torch.float64, device=flat.device)
    for lo in range(0, n, _FP_CHUNK):
        c = flat[lo: lo + _FP_CHUNK].double()
        iota = torch.arange(lo, lo + c.numel(), dtype=torch.float64, device=c.device) / max(n, 1)
        acc += torch.stack([c.abs().sum(), (c * c).sum(), (c * iota).sum()])
    return acc


def frozen_fingerprint(frozen: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Per-leaf integrity stats of the frozen parameters, computed on each
    leaf's device: ``[sum |x|, sum x^2, sum x * iota / n, n]``, the JAX
    package's four, summed in float64 (the JAX function sums in f32). The
    position-weighted third stat makes it order-sensitive: a permuted or
    transposed base keeps the first two sums but moves the third. Integer
    leaves (int8 codes) enter as their integer values. One device-to-host
    copy for all leaves."""
    names = list(frozen)
    if not names:
        return {}
    by_device: Dict[Any, List[int]] = {}
    for i, k in enumerate(names):
        by_device.setdefault(frozen[k].device, []).append(i)
    out: Dict[str, np.ndarray] = {}
    for idx in by_device.values():
        stats = torch.stack([_leaf_stats(frozen[names[i]]) for i in idx]).cpu().numpy()
        for row, i in zip(stats, idx):
            out[names[i]] = np.append(row, float(frozen[names[i]].numel()))
    return {k: out[k] for k in names}


def verify_fingerprint(saved: Dict[str, Any], current: Dict[str, Any]) -> None:
    """Raise ``FingerprintMismatch`` unless ``current`` matches ``saved``:
    the same leaves, the same element counts, and the three sums within a
    tolerance that covers reduction order only (compared in float64, rtol
    growing with sqrt(n), the JAX rule), the position sum's absolute floor
    scaled by sqrt(sum x^2) where the JAX rule takes sum |x|."""
    saved_keys, cur_keys = set(saved), set(current)
    if saved_keys != cur_keys:
        raise FingerprintMismatch(
            "trainable-only checkpoint: frozen param STRUCTURE changed since save "
            f"(missing: {sorted(saved_keys - cur_keys)[:5]}, extra: "
            f"{sorted(cur_keys - saved_keys)[:5]}) — resume with the original base "
            "checkpoint/config")
    for k in saved:
        s = np.asarray(saved[k], dtype=np.float64)
        c = np.asarray(current[k], dtype=np.float64)
        if s.shape != c.shape:
            raise FingerprintMismatch(
                f"trainable-only checkpoint: frozen leaf {k!r} carries a {s.shape}-stat "
                f"fingerprint but the current code derives {c.shape} — the checkpoint "
                "predates the fingerprint format")
        n = s[-1]
        if n != c[-1]:
            raise FingerprintMismatch(
                f"trainable-only checkpoint: frozen leaf {k!r} changed size "
                f"(saved n={n}, re-derived n={c[-1]})")
        rtol = max(1e-4, 2e-7 * math.sqrt(max(n, 1.0)))
        atol = rtol * max(float(s[0]), 1e-6)
        # the position sum of a symmetric init is a random walk of size
        # sqrt(sum x^2), and so is its rounding error (times eps sqrt(n),
        # which rtol covers). The JAX rule's floor, rtol x sum |x|, is
        # sqrt(n) times larger: a 2048 x 2048 leaf of N(0, 0.02) with its
        # rows reversed passes it for 17 of 20 seeds. The port's floor
        # scales with sqrt(sum x^2) instead.
        pos_atol = rtol * max(math.sqrt(max(float(s[1]), 0.0)), 1e-6)
        if not (np.allclose(s[:2], c[:2], rtol=rtol, atol=atol)
                and np.isclose(s[2], c[2], rtol=rtol, atol=pos_atol)):
            raise FingerprintMismatch(
                f"trainable-only checkpoint: frozen leaf {k!r} does not match the weights "
                f"it was trained against (saved [|x|,x^2,x*iota,n]={s}, re-derived={c}) — "
                "the base checkpoint or init seed changed")


def _nbytes(tensors: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors.values())


def _opt_flat(opt_state: dict) -> Dict[str, torch.Tensor]:
    return {f"{m}/{k}": v for m in ("mu", "nu") for k, v in opt_state[m].items()}


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, metric_name: str = "eval_loss",
                 greater_is_better: bool = False, trainable_only: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max(1, int(max_to_keep))
        self.metric_name = metric_name
        self.greater_is_better = greater_is_better
        self.trainable_only = trainable_only
        self._snapshot_thread: Optional[threading.Thread] = None
        self._snapshot_error: Optional[BaseException] = None
        # full payload, async: the frozen leaves never change during a run,
        # so they are fetched to the host once and reused
        self._frozen_host: Optional[Dict[str, torch.Tensor]] = None
        # the last save: step, bytes, blocking seconds and write seconds
        self.last_save: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------ save

    def save(self, step: int, state: TrainState, metrics: Optional[Dict[str, float]] = None,
             fingerprint=None, snapshot_async: bool = False) -> None:
        """Persist ``step``'s state. ``snapshot_async=True`` clones the
        mutable leaves on the device and writes them on a background thread,
        so the caller's next step is not blocked on the device-to-host copy."""
        t0 = time.perf_counter()
        self.join_snapshot()  # one writer at a time; also raises a pending error
        if self.trainable_only and not fingerprint:
            raise ValueError("trainable_only save needs the frozen-param fingerprint — a "
                             "checkpoint without one can never be restored in lean mode")
        mutable = {"trainable": state.trainable, "opt_state": _opt_flat(state.opt_state)}
        meta = {"step": int(step), "opt_count": int(state.opt_state["count"]),
                "metrics": {k: float(v) for k, v in (metrics or {}).items()},
                "trainable_only": self.trainable_only}
        if self.trainable_only:
            meta["frozen_fp"] = {k: np.asarray(v, np.float64).tolist()
                                 for k, v in fingerprint.items()}
        if not snapshot_async:
            payload = dict(mutable)
            if not self.trainable_only:
                payload["frozen"] = state.frozen
            self._write(step, payload, meta, t0, blocking_s=None)
            return
        if not self.trainable_only and self._frozen_host is None:
            self._frozen_host = {k: v.detach().to("cpu") for k, v in state.frozen.items()}
        with torch.no_grad():  # on-stream copies, ahead of the next in-place update
            snap_box = [{part: {k: v.detach().clone() for k, v in leaves.items()}
                         for part, leaves in mutable.items()}]
        blocking_s = time.perf_counter() - t0

        def _bg_save():
            try:
                snap, snap_box[0] = snap_box[0], None
                host = {part: {k: v.to("cpu") for k, v in leaves.items()}
                        for part, leaves in snap.items()}
                del snap  # frees the device copy before the file write
                if not self.trainable_only:
                    host["frozen"] = self._frozen_host
                self._write(step, host, meta, t0, blocking_s=blocking_s)
            except BaseException as e:  # raised at the next save/wait/close
                self._snapshot_error = e

        self._snapshot_thread = threading.Thread(target=_bg_save, name=f"ckpt-snapshot-{step}",
                                                 daemon=True)
        self._snapshot_thread.start()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _write(self, step: int, payload: Dict[str, Dict[str, torch.Tensor]], meta: dict,
               t0: float, blocking_s: Optional[float]) -> None:
        """Write the payload files, then the metadata (the commit point),
        then the ``latest.json`` pointer, then rotate."""
        final = self._step_dir(step)
        if os.path.isdir(final):  # an earlier save of this step: replace it
            self._remove(final)
        os.makedirs(final)
        for part, leaves in payload.items():
            host = {k: v.detach().to("cpu") for k, v in leaves.items()}
            atomic_write_bytes(os.path.join(final, _FILES[part]),
                               lambda f, host=host: write_safetensors(f, host))
        atomic_write_json(os.path.join(final, METADATA_NAME), meta)
        atomic_write_json(os.path.join(self.directory, "latest.json"),
                          {"step": meta["step"], "metrics": meta["metrics"],
                           "trainable_only": meta["trainable_only"]})
        seconds = time.perf_counter() - t0
        self.last_save = {"step": int(step), "bytes": sum(_nbytes(p) for p in payload.values()),
                          "seconds": seconds,
                          "blocking_s": seconds if blocking_s is None else blocking_s,
                          "async": blocking_s is not None,
                          "trainable_only": meta["trainable_only"]}
        self._rotate()

    @staticmethod
    def _remove(path: str) -> None:
        try:
            os.unlink(os.path.join(path, METADATA_NAME))
        except OSError:
            pass
        shutil.rmtree(path, ignore_errors=True)

    def _rotate(self) -> None:
        """Keep the ``max_to_keep`` best-ranked steps (a missing metric
        ranks worst, a tie goes to the newer step) and always the latest."""
        steps = self.all_steps()
        if len(steps) <= self.max_to_keep:
            return
        ranked = sorted(steps, key=self._rank_key, reverse=True)
        keep = set(ranked[: self.max_to_keep]) | {steps[-1]}
        for s in steps:
            if s not in keep:
                self._remove(self._step_dir(s))

    def _rank_key(self, step: int):
        value = self._metrics(step).get(self.metric_name) if self.metric_name else None
        if value is None or not math.isfinite(value):
            return (0, 0.0, step)
        return (1, value if self.greater_is_better else -value, step)

    def join_snapshot(self) -> None:
        if self._snapshot_thread is not None:
            self._snapshot_thread.join()
            self._snapshot_thread = None
        if self._snapshot_error is not None:
            e, self._snapshot_error = self._snapshot_error, None
            raise RuntimeError(f"background checkpoint save failed: {e}") from e

    def wait(self) -> None:
        self.join_snapshot()

    def close(self) -> None:
        self.join_snapshot()

    # --------------------------------------------------------------- restore

    def _metadata(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), METADATA_NAME)) as f:
            return json.load(f)

    def _metrics(self, step: int) -> dict:
        try:
            return self._metadata(step).get("metrics") or {}
        except (OSError, ValueError):
            return {}

    def all_steps(self) -> List[int]:
        """Committed steps, ascending."""
        out = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, METADATA_NAME)):
                out.append(int(name))
        return sorted(out)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @property
    def best_step(self) -> Optional[int]:
        """The best-ranked step that carries the metric (None if none does)."""
        ranked = [s for s in self.all_steps() if self._rank_key(s)[0]]
        return max(ranked, key=self._rank_key) if ranked else None

    def _read(self, step: int, part: str) -> Dict[str, torch.Tensor]:
        path = os.path.join(self._step_dir(step), _FILES[part])
        if not os.path.exists(path):
            raise ValueError(f"checkpoint step {step} has no {part} payload ({path})")
        return read_safetensors(path)

    @staticmethod
    def _place(loaded: Dict[str, torch.Tensor], like: Dict[str, torch.Tensor], what: str,
               step: int) -> Dict[str, torch.Tensor]:
        """``loaded`` onto ``like``'s devices and dtypes, key for key."""
        if any("@stacked" in k for k in loaded):
            raise NotImplementedError(
                f"checkpoint step {step} stores pipeline-stacked leaves (@stacked): a "
                "cross-layout resume (llm_fine_tune_distributed_tpu.train.layout) waits for "
                "pipeline parallelism in the port")
        if set(loaded) != set(like):
            raise ValueError(
                f"checkpoint step {step} {what} leaves differ from the state's (missing "
                f"{sorted(set(like) - set(loaded))[:5]}, extra {sorted(set(loaded) - set(like))[:5]})")
        out = {}
        for k, cur in like.items():
            t = loaded[k]
            if tuple(t.shape) != tuple(cur.shape):
                raise ValueError(f"checkpoint step {step} {what} leaf {k!r}: shape "
                                 f"{tuple(t.shape)} vs the state's {tuple(cur.shape)}")
            out[k] = t.to(device=cur.device, dtype=cur.dtype).requires_grad_(cur.requires_grad)
        return out

    def restore(self, step: int, state: TrainState, trainable_only: Optional[bool] = None,
                fingerprint=None) -> TrainState:
        """A new ``TrainState`` with ``step``'s saved leaves on ``state``'s
        devices and dtypes. ``trainable_only`` overrides the manager's mode
        for this restore (the trainer falls back to the other mode). In
        trainable-only mode ``state.frozen`` (the rebuilt frozen leaves) is
        carried over and verified against the saved fingerprint first; a
        full payload cannot restore in that mode (it has no fingerprint), nor
        a trainable-only one in full mode (it has no frozen leaves).
        ``fingerprint``: the frozen leaves' own, when ``state.frozen`` holds
        stand-ins of their shapes (ZeRO-3's trainer gathers it leaf by
        leaf)."""
        self.join_snapshot()  # a background save may still be writing this step
        if trainable_only is None:
            trainable_only = self.trainable_only
        meta = self._metadata(step)
        if trainable_only:
            if not meta.get("trainable_only"):
                raise ValueError(f"checkpoint step {step} holds a full payload, without a "
                                 "frozen fingerprint to verify a trainable-only restore")
            verify_fingerprint(meta["frozen_fp"], fingerprint if fingerprint is not None
                               else frozen_fingerprint(state.frozen))
            frozen = state.frozen
        else:
            frozen = self._place(self._read(step, "frozen"), state.frozen, "frozen", step)
        trainable = self._place(self._read(step, "trainable"), state.trainable, "trainable", step)
        like = _opt_flat(state.opt_state)
        opt = self._place(self._read(step, "opt_state"), like, "optimizer", step)
        opt_state = {"count": int(meta["opt_count"]),
                     "mu": {k: opt[f"mu/{k}"] for k in state.opt_state["mu"]},
                     "nu": {k: opt[f"nu/{k}"] for k in state.opt_state["nu"]}}
        return TrainState(step=int(meta["step"]), trainable=trainable, frozen=frozen,
                          opt_state=opt_state)
