"""Learning-rate schedule, global-norm clip and AdamW (counterpart of the JAX
``parallel/optimizer.py``, which chains optax's ``clip_by_global_norm`` and
``adamw``).

The formulas are optax's, written with plain tensor ops so that a step
matches the JAX package to f32 rounding:

- clip: ``g`` if ``norm < max_norm``, else ``g / norm * max_norm`` (not
  ``torch.nn.utils.clip_grad_norm_``'s ``max_norm / (norm + 1e-6)``);
- AdamW: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, bias
  correction with the 1-based update count, ``u = mu_hat / (sqrt(nu_hat) +
  eps) + wd * p``, ``p += -lr * u`` with ``lr`` the schedule at the 0-based
  update count.

Only the trainable leaves are passed in, so frozen leaves get no state.
Parameters are updated in place (no second copy of the f32 masters).
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from llm_fine_tune_distributed_tpu_torch.config import TrainConfig

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over ``steps`` updates, then end."""
    def schedule(count: int) -> float:
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def build_lr_schedule(config: TrainConfig, total_steps: int, data_parallel_size: int = 1) -> Schedule:
    """lr as a function of the 0-based update count (optax's convention)."""
    peak = config.scaled_learning_rate(data_parallel_size)
    warmup = int(total_steps * config.warmup_ratio)
    if config.lr_schedule == "constant":
        return lambda count: peak
    if config.lr_schedule == "linear":
        decay = _linear(peak, 0.0, max(total_steps - warmup, 1) if warmup > 0 else max(total_steps, 1))
        if warmup <= 0:
            return decay
        ramp = _linear(0.0, peak, warmup)
        return lambda count: ramp(count) if count < warmup else decay(count - warmup)
    if config.lr_schedule == "cosine":
        # optax.warmup_cosine_decay_schedule(0, peak, max(warmup, 1), max(total, 2))
        warm = max(warmup, 1)
        decay_steps = max(total_steps, 2) - warm
        ramp = _linear(0.0, peak, warm)

        def cosine(count: int) -> float:
            if count < warm:
                return ramp(count)
            t = min(count - warm, decay_steps)
            return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps)) if decay_steps > 0 else peak
        return cosine
    raise ValueError(f"unknown lr_schedule {config.lr_schedule!r}")


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, f32 (optax.global_norm)."""
    total = None
    for g in grads:
        sq = g.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


class AdamW:
    """optax ``chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    eps, weight_decay))`` over a flat dict of f32 trainable leaves."""

    def __init__(self, schedule: Schedule, *, b1: float, b2: float, eps: float,
                 weight_decay: float, max_grad_norm: float):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()},
        }

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             state: dict) -> torch.Tensor:
        """Update ``params`` and ``state`` in place from ``grads``; returns
        the global norm of ``grads`` before clipping."""
        norm = global_norm(grads.values())
        max_norm = torch.tensor(self.max_grad_norm, dtype=torch.float32, device=norm.device)
        # optax keeps g when norm < max_norm, else g / norm * max_norm
        clipped = norm >= max_norm
        count = state["count"]
        t = count + 1
        dev = norm.device
        bc1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32, device=dev) ** t
        bc2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32, device=dev) ** t
        lr = torch.tensor(self.schedule(count), dtype=torch.float32, device=dev)
        for name, p in params.items():
            g = grads[name].float()
            g = torch.where(clipped, (g / norm) * max_norm, g)
            mu, nu = state["mu"][name], state["nu"][name]
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * g.square() + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_((-lr) * u)
        state["count"] = t
        return norm


def build_optimizer(config: TrainConfig, *, total_steps: int, data_parallel_size: int = 1) -> AdamW:
    """The JAX package's optimizer chain for ``optimizer="adamw"``."""
    if config.optimizer != "adamw":
        raise NotImplementedError(
            f"optimizer={config.optimizer!r} is not ported "
            "(llm_fine_tune_distributed_tpu.parallel.optimizer.build_optimizer has it)"
        )
    return AdamW(
        build_lr_schedule(config, total_steps, data_parallel_size),
        b1=config.adam_b1, b2=config.adam_b2, eps=config.adam_eps,
        weight_decay=config.weight_decay, max_grad_norm=config.max_grad_norm,
    )
