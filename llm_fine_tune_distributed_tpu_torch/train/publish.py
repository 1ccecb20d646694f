"""Atomic publication of trainable-only checkpoints for live deployment
(counterpart of the JAX ``train/publish.py``, whose protocol and manifest
this module keeps).

The trainer's half of the train→serve loop (the serving half is
``infer/deploy.py``): after a checkpoint save the trainer drops the
trainable weights plus a manifest into a *publish directory* that a serving
engine or fleet watches, one ``step_NNNNNNNN/`` subdirectory per publish:

- every file lands through ``atomic_write_bytes`` (a temp file in the same
  directory, fsync, one ``os.replace``), so a reader sees the old bytes or
  the new ones, never a prefix;
- ``manifest.json`` is written after the weights, so its presence is the
  commit point; retention unlinks it first, so a publish being deleted stops
  being discoverable before its weights go;
- the manifest carries ``weight_fingerprint`` (a digest of the trainable
  payload, which keys the serving side's prefix-cache invalidation) and the
  per-leaf fingerprint of the frozen parameters the weights were trained
  against (``train/checkpoints.frozen_fingerprint``), which the serving
  side verifies against its resident base before a swap.

The port writes the weights as ``trainable.safetensors`` through the
``models/hf_io`` codec (numpy has no bf16) and names the file in the
manifest's ``weights_file``; ``load_weights`` reads either that or the JAX
package's ``trainable.npz``. Weights are keyed by the port's dotted leaf
names.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from llm_fine_tune_distributed_tpu_torch.models.hf_io import read_safetensors, write_safetensors

log = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.json"
WEIGHTS_NAME = "trainable.safetensors"
MANIFEST_SCHEMA = 1
_STEP_RE = re.compile(r"^step_(\d{8,})$")


# ------------------------------------------------------------ atomic writes


def atomic_write_bytes(path: str, data) -> None:
    """Write ``data`` (bytes, or a callable that writes to the open file) to
    ``path`` torn-read-proof: a temp file in the same directory (so the
    rename is atomic), fsync, then one ``os.replace``. A crash mid-write
    leaves the old file untouched."""
    path = os.path.abspath(path)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            if callable(data):
                data(f)
            else:
                f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj: Any) -> None:
    atomic_write_bytes(path, json.dumps(obj, indent=2, sort_keys=True).encode("utf-8"))


# -------------------------------------------------------------- identities


def _host_bytes(value):
    """(dtype name, shape, contiguous host buffer) of a tensor or array; the
    dtype names are numpy's (``float32``, ``bfloat16``, ``int8``), so a
    payload hashes as it does in the JAX package."""
    if isinstance(value, torch.Tensor):
        t = value.detach().to("cpu").contiguous()
        return (str(t.dtype).replace("torch.", ""), tuple(t.shape),
                t.reshape(-1).view(torch.uint8).numpy())
    a = np.ascontiguousarray(np.asarray(value))
    return str(a.dtype), a.shape, a.reshape(-1).view(np.uint8)


def weights_digest(flat: Dict[str, Any]) -> str:
    """16-hex identity of a flat ``{name: tensor or array}`` payload: exact
    bytes, order-independent. An identical republish gives the same digest
    (the serving side keeps its prefix cache); any real change a new one."""
    h = hashlib.sha256()
    for k in sorted(flat):
        dtype, shape, buf = _host_bytes(flat[k])
        h.update(k.encode("utf-8"))
        h.update(dtype.encode("utf-8"))
        h.update(np.asarray(shape, np.int64).tobytes())
        h.update(buf)
    return h.hexdigest()[:16]


def fingerprint_digest(stats: Dict[str, Any]) -> str:
    """16-hex identity of a per-leaf 4-stat fingerprint dict."""
    h = hashlib.sha256()
    for k in sorted(stats):
        h.update(k.encode("utf-8"))
        h.update(np.asarray(stats[k], np.float32).tobytes())
    return h.hexdigest()[:16]


# ------------------------------------------------------------- directories


def step_dir_name(step: int) -> str:
    return f"step_{int(step):08d}"


def parse_step(name: str) -> Optional[int]:
    m = _STEP_RE.match(name)
    return int(m.group(1)) if m else None


def list_published(publish_dir: str) -> List[Tuple[int, str]]:
    """``(step, dir)`` ascending for every step dir whose manifest exists:
    a dir mid-publish (weights written, manifest not yet) is invisible."""
    try:
        names = os.listdir(publish_dir)
    except OSError:
        return []
    out = []
    for name in names:
        step = parse_step(name)
        if step is None:
            continue
        path = os.path.join(publish_dir, name)
        if os.path.isfile(os.path.join(path, MANIFEST_NAME)):
            out.append((step, path))
    return sorted(out)


def load_manifest(path: str) -> Optional[Dict[str, Any]]:
    """``path``'s manifest, or None (logged) on any defect: a torn or
    damaged manifest reads as "no publish here", never raises into serving."""
    mpath = os.path.join(path, MANIFEST_NAME)
    try:
        with open(mpath, "rb") as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        log.warning("ignoring unreadable manifest %s: %s", mpath, e)
        return None
    required = ("schema", "step", "weights_file", "weight_fingerprint", "frozen_fp")
    missing = [k for k in required if k not in manifest]
    if missing or not isinstance(manifest.get("frozen_fp"), dict):
        log.warning("ignoring malformed manifest %s: missing %s", mpath, missing)
        return None
    return manifest


def load_weights(path: str, manifest: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The manifest's weights as CPU tensors (the serving side's host
    buffer): a ``.safetensors`` file through ``read_safetensors`` (one read,
    no per-tensor copy), an ``.npz`` (the JAX package's) through numpy.
    Raises OSError/KeyError/ValueError on a missing or torn file; the
    watcher skips the publish."""
    wpath = os.path.join(path, str(manifest["weights_file"]))
    if wpath.endswith(".npz"):
        with np.load(wpath) as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    return read_safetensors(wpath)


# --------------------------------------------------------------- publisher


class CheckpointPublisher:
    """Publishes trainable-only payloads and their manifests, keeping the
    newest ``keep_last``. One per training run; the trainer calls
    ``publish`` right after each checkpoint save."""

    def __init__(self, publish_dir: str, keep_last: int = 3):
        self.publish_dir = os.path.abspath(publish_dir)
        self.keep_last = max(1, int(keep_last))
        os.makedirs(self.publish_dir, exist_ok=True)
        self.last_write_s: Optional[float] = None  # the last publish's weights write

    def publish(self, step: int, trainable: Dict[str, Any], *, frozen_fp: Dict[str, Any],
                metrics: Optional[Dict[str, float]] = None, run_id: Optional[str] = None,
                hparams_digest: Optional[str] = None,
                anomaly_clean: Optional[bool] = None) -> str:
        """Publish ``trainable`` (flat ``{name: tensor or array}``, on any
        device) as ``step``'s deployment candidate; returns its directory.
        Weights first, manifest last, both atomically. ``run_id``,
        ``hparams_digest`` and ``anomaly_clean`` are the lineage stamps
        ``GET /v1/lineage`` serves; all optional."""
        t0 = time.perf_counter()
        host = {k: (v.detach().to("cpu") if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.ascontiguousarray(v)))
                for k, v in trainable.items()}
        final = os.path.join(self.publish_dir, step_dir_name(step))
        os.makedirs(final, exist_ok=True)
        atomic_write_bytes(os.path.join(final, WEIGHTS_NAME),
                           lambda f: write_safetensors(f, host))
        self.last_write_s = time.perf_counter() - t0
        manifest = {
            "schema": MANIFEST_SCHEMA,
            "step": int(step),
            "published_unix": time.time(),
            "weights_file": WEIGHTS_NAME,
            "weight_fingerprint": weights_digest(host),
            "num_leaves": len(host),
            "bytes": int(sum(t.numel() * t.element_size() for t in host.values())),
            "frozen_fp": {k: np.asarray(v, np.float32).tolist() for k, v in frozen_fp.items()},
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        }
        if run_id is not None:
            manifest["run_id"] = str(run_id)
        if hparams_digest is not None:
            manifest["hparams_digest"] = str(hparams_digest)
        if anomaly_clean is not None:
            manifest["anomaly_clean"] = bool(anomaly_clean)
        atomic_write_json(os.path.join(final, MANIFEST_NAME), manifest)
        log.info("published step %d (%d leaves, %d bytes) to %s",
                 step, manifest["num_leaves"], manifest["bytes"], final)
        self.retain()
        return final

    def retain(self) -> List[str]:
        """Delete all but the newest ``keep_last`` committed publishes,
        unlinking each manifest first."""
        removed = []
        for _, path in list_published(self.publish_dir)[: -self.keep_last]:
            try:
                os.unlink(os.path.join(path, MANIFEST_NAME))
                shutil.rmtree(path)
                removed.append(path)
            except OSError as e:
                log.warning("retention could not remove %s: %s", path, e)
        return removed
