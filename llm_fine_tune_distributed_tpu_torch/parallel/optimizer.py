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

Over an ``fsdp`` axis larger than 1 (``FsdpShards``, ZeRO-3, as the JAX
trainer's fsdp axis shards its leaves) each rank holds only its slice of
every leaf that the sharding rules split (``parallel/sharding.fsdp_dim``),
trainable and frozen, and AdamW's moments of its trainable slices. The
forward all-gathers a layer's leaves just before the layer runs
(``FsdpShards.gather``, inside the rematerialized block, so the backward's
replay gathers them again and no whole layer is saved), and the backward of
that gather reduce-scatters each trainable leaf's gradient onto the slice.
The global norm sums the slices' squares over the fsdp group; AdamW then
updates each slice in place. The arithmetic is elementwise, so every
element gets the update a whole-leaf step gives it; only where it lives
differs.

Beside a ``tensor`` axis (``parallel/sharding.TensorShards``) a rank's
leaves are its tensor slices, ``FsdpShards`` shards those slices in the
fsdp group of its tensor index, and the global norm adds a tensor-sliced
leaf's squares over the tensor group while a leaf every tensor rank holds
whole (a norm, a LoRA factor) counts once (``layout_global_norm``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from llm_fine_tune_distributed_tpu_torch.config import TrainConfig
from llm_fine_tune_distributed_tpu_torch.ops.int8_matmul import kmajor
from llm_fine_tune_distributed_tpu_torch.parallel.sharding import fsdp_dim
from llm_fine_tune_distributed_tpu_torch.runtime.distributed import (
    all_gather_rows,
    reduce_scatter_rows,
)

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


def _sum_squares(grads, device) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=device)
    for g in grads:
        total = total + g.float().square().sum()
    return total


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, f32 (optax.global_norm)."""
    grads = list(grads)
    return torch.sqrt(_sum_squares(grads, grads[0].device))


class _Gather(torch.autograd.Function):
    """Trainable slices -> whole leaves (one all-gather per dtype); the
    backward reduce-scatters the whole gradients onto the slices."""

    @staticmethod
    def forward(ctx, shards, names, *slices):
        ctx.shards, ctx.names = shards, names
        ctx.meta = [(s.shape, s.dtype, s.device) for s in slices]
        return tuple(shards.gather_leaves(names, slices))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(ctx.shards.shapes[n], dtype=dt, device=dev) if g is None else g
                 for n, g, (_, dt, dev) in zip(ctx.names, grads, ctx.meta)]
        return (None, None) + tuple(ctx.shards.scatter_grads(ctx.names, grads))


class FsdpShards:
    """ZeRO-3 over the ``fsdp`` axis: ``dims`` is the dim of each leaf
    (trainable and frozen) that the axis splits, ``shapes`` its whole
    shape, and this rank holds slice ``index`` of ``count`` equal slices of
    each. ``group`` is the fsdp group (None: the world); ``replica_group``
    (a data axis beside fsdp) the ranks that hold the same slices."""

    def __init__(self, mesh_shape: Dict[str, int], index: int, group=None, replica_group=None):
        self.mesh_shape, self.index, self.count = mesh_shape, index, mesh_shape["fsdp"]
        self.dims: Dict[str, int] = {}
        self.shapes: Dict[str, torch.Size] = {}
        self.group, self.replica_group = group, replica_group
        self._layers: Dict[Optional[int], List[str]] = {}

    @classmethod
    def for_mesh(cls, mesh) -> Optional["FsdpShards"]:
        """No leaf yet, on ``mesh``'s fsdp axis (``take`` adds them); None
        when the axis is 1."""
        if mesh.shape["fsdp"] <= 1:
            return None
        return cls(dict(mesh.shape), mesh.fsdp_index, mesh.fsdp_group, mesh.replica_group)

    def take(self, whole: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``local`` of whole leaves, each one that the fsdp rules split
        (``parallel/sharding.fsdp_dim``) added to the sharded leaves first:
        the caller drops the whole leaves after, so a rank never holds more
        of the model whole than it passes in at once."""
        for k, v in whole.items():
            d = fsdp_dim(k, tuple(v.shape), self.mesh_shape)
            if d is not None:
                self.dims[k], self.shapes[k] = d, v.shape
        self._layers.clear()
        return self.local(whole)

    def slice(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A view of this rank's slice of the whole leaf ``name``; the
        tensor itself for a leaf that stays whole."""
        d = self.dims.get(name)
        if d is None:
            return t
        n = t.shape[d] // self.count
        return t.narrow(d, self.index * n, n)

    def local(self, whole: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's slices (contiguous copies of their own, trainable
        ones leaves that require grad) of whole leaves."""
        out = {}
        for k, v in whole.items():
            if k not in self.dims:
                out[k] = v
                continue
            # one copy, contiguous, whether the slice is (rows) or not (columns)
            part = self.slice(k, v.detach()).clone(memory_format=torch.contiguous_format)
            out[k] = part.requires_grad_(True) if v.requires_grad else part
        return out

    def numel(self, name: str, t: torch.Tensor) -> int:
        """Elements of the whole leaf ``name`` of which ``t`` is a slice."""
        return self.shapes[name].numel() if name in self.dims else t.numel()

    def _by_dtype(self, names, tensors):
        groups: Dict[torch.dtype, list] = {}
        for n, t in zip(names, tensors):
            groups.setdefault(t.dtype, []).append((n, t))
        return groups.values()

    def gather_leaves(self, names: Sequence[str], slices: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Whole leaves from every rank's slices (a collective: every rank
        calls it with the same names), one all-gather per dtype; int8 trunk
        codes come back K-major, as the w8a8 kernel reads them."""
        out = {}
        for items in self._by_dtype(names, slices):
            flat = torch.cat([t.detach().reshape(-1) for _, t in items])
            rows = all_gather_rows(flat, self.group, self.count, self.index)
            off = 0
            for n, t in items:
                k = t.numel()
                whole = rows[:, off: off + k].reshape(self.count, *t.shape).movedim(
                    0, self.dims[n]).reshape(self.shapes[n])
                out[n] = kmajor(whole) if n.endswith(".kernel_int8") else whole
                off += k
        return [out[n] for n in names]

    def scatter_grads(self, names: Sequence[str], grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each whole gradient summed over the fsdp group, this rank's slice
        of it kept (one reduce-scatter per dtype)."""
        out = {}
        for items in self._by_dtype(names, grads):
            rows = []
            for n, g in items:
                d, shape = self.dims[n], self.shapes[n]
                split = list(shape[:d]) + [self.count, shape[d] // self.count] + list(shape[d + 1:])
                rows.append(g.reshape(split).movedim(d, 0).reshape(self.count, -1))
            mine = reduce_scatter_rows(torch.cat(rows, dim=1), self.group, self.index)
            off = 0
            for n, g in items:
                shape = list(self.shapes[n])
                shape[self.dims[n]] //= self.count
                k = g.numel() // self.count
                out[n] = mine[off: off + k].view(shape).clone()  # not a view of the buffer
                off += k
        return [out[n] for n in names]

    def _names(self, layer: Optional[int]) -> List[str]:
        if layer not in self._layers:
            prefix = f"model.layers.{layer}."
            self._layers[layer] = [k for k in self.dims if (
                k.startswith(prefix) if layer is not None else ".layers." not in k)]
        return self._layers[layer]

    def gather(self, params: Dict[str, torch.Tensor], layer: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """``params`` with the sharded leaves of block ``layer`` (None: the
        leaves outside the blocks, the embedding and the lm_head) whole: the
        trainable ones through an autograd all-gather whose backward
        reduce-scatters, the others gathered without a graph. A leaf that
        is whole already is kept. A collective: every rank calls it."""
        names = [k for k in self._names(layer) if k in params
                 and params[k].shape != self.shapes[k]]
        if not names:
            return params
        out = dict(params)
        grad = [k for k in names if params[k].requires_grad and torch.is_grad_enabled()]
        if grad:
            out.update(zip(grad, _Gather.apply(self, grad, *(params[k] for k in grad))))
        rest = [k for k in names if k not in grad]
        if rest:
            with torch.no_grad():
                out.update(zip(rest, self.gather_leaves(rest, [params[k] for k in rest])))
        return out

    def wholes(self, slices: Dict[str, torch.Tensor]):
        """(name, whole leaf, detached) from every rank's slices, one leaf
        gathered at a time, so a caller that drops each one holds at most
        one whole leaf; a whole leaf passes as it is. A collective: every
        rank runs it to its end."""
        for k, v in slices.items():
            if k in self.dims:
                with torch.no_grad():
                    v = self.gather_leaves([k], [v])[0]
            yield k, v

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``global_norm`` of the whole gradients from the slices: their
        squares summed over the fsdp group, the whole leaves' added once."""
        dev = next(iter(grads.values())).device
        sq = _sum_squares([g for k, g in grads.items() if k in self.dims], dev)
        dist.all_reduce(sq, group=self.group)
        return torch.sqrt(sq + _sum_squares([g for k, g in grads.items() if k not in self.dims],
                                            dev))


def _tensor_sliced(tensor, name: str) -> bool:
    """Whether ``name`` is a tensor slice whose squares the tensor group
    sums (a leaf every tensor rank holds whole counts once)."""
    return tensor.sliced(name)


def layout_global_norm(grads: Dict[str, torch.Tensor], shards: Optional[FsdpShards] = None,
                       tensor=None) -> torch.Tensor:
    """``global_norm`` of the whole gradients from this rank's slices: the
    fsdp-sliced leaves' squares summed over the fsdp group, then the
    tensor-sliced ones' (fsdp-sliced or not) over the tensor group, the
    leaves whole on every rank added once."""
    if tensor is None:
        return shards.global_norm(grads) if shards is not None else global_norm(grads.values())
    dev = next(iter(grads.values())).device
    fs = shards.dims if shards is not None else {}
    parts = {(f, t): _sum_squares([g for k, g in grads.items()
                                   if (k in fs) == f and _tensor_sliced(tensor, k) == t], dev)
             for f in (False, True) for t in (False, True)}
    if shards is not None:
        both = torch.stack([parts[(True, False)], parts[(True, True)]])
        dist.all_reduce(both, group=shards.group)
        parts[(True, False)], parts[(True, True)] = both.unbind()
    sliced = parts[(False, True)] + parts[(True, True)]
    dist.all_reduce(sliced, group=tensor.group)
    return torch.sqrt(parts[(False, False)] + parts[(True, False)] + sliced)


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
        """Zero moments shaped as the leaves this rank holds (its slices
        under ZeRO-3)."""
        def zeros(v):
            return torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        return {"count": 0, "mu": {k: zeros(v) for k, v in params.items()},
                "nu": {k: zeros(v) for k, v in params.items()}}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             state: dict, shards: Optional[FsdpShards] = None, tensor=None) -> torch.Tensor:
        """Update ``params`` and ``state`` in place from ``grads`` (already
        reduced across ranks; a sharded leaf's slice of its gradient under
        ``shards`` and ``tensor``); returns the global norm of the whole
        gradients before clipping."""
        norm = layout_global_norm(grads, shards, tensor)
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
            g = torch.where(clipped, (grads[name].float() / norm) * max_norm, grads[name].float())
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
