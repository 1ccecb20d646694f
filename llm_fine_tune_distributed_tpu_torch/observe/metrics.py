"""Training metric logger (counterpart of the part of the JAX
``observe/metrics.MetricLogger`` the trainer needs): an in-memory history of
``{"step", "epoch", **logs}`` records with perplexity beside each loss, one
line per record on stdout, and the atomic ``training_history.json`` writer.
The Aim and JSONL sinks are not ported."""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List


def inject_perplexity(logs: Dict[str, float]) -> Dict[str, float]:
    """Add perplexity next to any loss (exp capped at 700, as the JAX
    package caps it)."""
    out = dict(logs)
    if "loss" in out:
        out["perplexity"] = math.exp(min(out["loss"], 700.0))
    if "eval_loss" in out:
        out["eval_perplexity"] = math.exp(min(out["eval_loss"], 700.0))
    return out


class MetricLogger:
    def __init__(self):
        self.history: List[Dict[str, float]] = []

    def log(self, step: int, epoch: float, logs: Dict[str, float]) -> None:
        record = {"step": step, "epoch": round(epoch, 4), **inject_perplexity(logs)}
        self.history.append(record)
        rendered = ", ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in record.items()
        )
        print(f"[train] {rendered}", flush=True)

    def save_history(self, path: str) -> None:
        """``training_history.json``, written atomically (tmp + rename)."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.history, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
