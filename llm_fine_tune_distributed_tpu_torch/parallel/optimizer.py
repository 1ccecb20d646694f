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

Over an ``fsdp`` axis larger than 1 (``FsdpShards``, ZeRO-1) each rank
holds the moments of its slice of every leaf that the sharding rules split
(``parallel/sharding.fsdp_dim``), updates that slice of the master from the
full, already reduced gradient, and the slices are all-gathered back into
the whole f32 leaf (one flat all-gather per step over the fsdp group). The
arithmetic is elementwise, so every element gets the bits a whole-leaf
update gives it; only where the state lives differs.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from llm_fine_tune_distributed_tpu_torch.config import TrainConfig
from llm_fine_tune_distributed_tpu_torch.parallel.sharding import fsdp_dim
from llm_fine_tune_distributed_tpu_torch.runtime.distributed import all_gather_flat

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


class FsdpShards:
    """Which dim of each trainable leaf the ``fsdp`` axis splits (absent:
    whole), and this rank's slice of it: index ``index`` of ``count`` equal
    slices; ``group`` is the fsdp group (None: the world)."""

    def __init__(self, dims: Dict[str, int], index: int, count: int, group=None):
        self.dims, self.index, self.count, self.group = dims, index, count, group

    @classmethod
    def from_mesh(cls, mesh, params: Dict[str, torch.Tensor]) -> Optional["FsdpShards"]:
        """None when the mesh's fsdp axis is 1 or splits no leaf."""
        dims = {k: d for k, v in params.items()
                if (d := fsdp_dim(k, tuple(v.shape), mesh.shape)) is not None}
        if not dims:
            return None
        return cls(dims, mesh.fsdp_index, mesh.shape["fsdp"], mesh.fsdp_group)

    def slice(self, name: str, t: torch.Tensor, index: Optional[int] = None) -> torch.Tensor:
        """A view of slice ``index`` (this rank's by default) of leaf
        ``name``; the tensor itself for a whole leaf."""
        d = self.dims.get(name)
        if d is None:
            return t
        n = t.shape[d] // self.count
        return t.narrow(d, (self.index if index is None else index) * n, n)

    def gather_into(self, slices: Dict[str, torch.Tensor], out: Dict[str, torch.Tensor]) -> None:
        """Every rank's ``slices`` (one per sharded leaf, in the same order
        on every rank) copied into their places in the whole ``out`` leaves."""
        names = list(slices)
        per_rank = all_gather_flat([slices[k] for k in names], self.group, self.count)
        for r, parts in enumerate(per_rank):
            for k, part in zip(names, parts):
                self.slice(k, out[k], r).copy_(part)

    def full(self, slices: Dict[str, torch.Tensor], like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole leaves (shaped as ``like``'s) from every rank's slices; a
        whole leaf passes as it is."""
        out = {k: (torch.empty(like[k].shape, dtype=v.dtype, device=v.device)
                   if k in self.dims else v) for k, v in slices.items()}
        self.gather_into({k: v for k, v in slices.items() if k in self.dims}, out)
        return out

    def local(self, whole: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's slices (contiguous copies) of whole leaves."""
        return {k: (self.slice(k, v).contiguous().clone() if k in self.dims else v)
                for k, v in whole.items()}


class AdamW:
    """optax ``chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    eps, weight_decay))`` over a flat dict of f32 trainable leaves."""

    def __init__(self, schedule: Schedule, *, b1: float, b2: float, eps: float,
                 weight_decay: float, max_grad_norm: float):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm

    def init(self, params: Dict[str, torch.Tensor], shards: Optional[FsdpShards] = None) -> dict:
        """Zero moments, over this rank's slice of each sharded leaf."""
        def zeros(k, v):
            shape = v.shape if shards is None else shards.slice(k, v).shape
            return torch.zeros(shape, dtype=torch.float32, device=v.device)
        return {"count": 0, "mu": {k: zeros(k, v) for k, v in params.items()},
                "nu": {k: zeros(k, v) for k, v in params.items()}}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             state: dict, shards: Optional[FsdpShards] = None) -> torch.Tensor:
        """Update ``params`` and ``state`` in place from ``grads`` (whole,
        already reduced across ranks); returns the global norm of ``grads``
        before clipping. With ``shards``, a sharded leaf's slice is updated
        here and the slices are all-gathered into the whole leaf."""
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
        updated = {}
        for name, p in params.items():
            g, w = grads[name].float(), p
            if shards is not None:
                g, w = shards.slice(name, g), shards.slice(name, p)
            g = torch.where(clipped, (g / norm) * max_norm, g)
            mu, nu = state["mu"][name], state["nu"][name]
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * g.square() + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * w
            if w is p:
                p.add_((-lr) * u)
            else:  # the same sum as add_, into a new slice
                updated[name] = w + (-lr) * u
        if updated:
            shards.gather_into(updated, params)
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
