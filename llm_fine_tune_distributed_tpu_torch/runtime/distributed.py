"""Multi-process bootstrap and the collectives of data-parallel training and
tensor-parallel serving (counterpart of the JAX ``runtime/distributed.py``).

The JAX package starts ``jax.distributed`` from the reference's env names;
the port starts ``torch.distributed`` from the same names, the ones
``torchrun`` and the Kubeflow PyTorchJob operator set: ``WORLD_SIZE``,
``RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` and ``LOCAL_RANK``. One process
drives one device.

- ``WORLD_SIZE`` 1 (or unset) is a no-op, as in the JAX package, unless the
  environment also names a rendezvous (``MASTER_ADDR``), as a launcher does:
  then a group of one is made, so that a one-worker job issues the
  collectives a larger one does.
- The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``. There
  is no switch between them and no fallback from one to the other.
- A group that already exists is left alone (the JAX code's "already
  initialized"): a caller may make its own first, and the trainer uses it.
- NCCL's flight recorder (a per-collective record with its Python stack,
  for post-mortems of hangs) is off unless the environment asks for it
  (``TORCH_NCCL_TRACE_BUFFER_SIZE`` / ``TORCH_FR_BUFFER_SIZE``): its stack
  capture costs ~130 us of host time per collective on the H100 machine
  (``chip_smoke.py --tp-collective-cost``), and a tensor-parallel decode
  step issues 74 of them.

The helpers below are what the trainer calls; each is a no-op without a
process group, so a one-process run issues no collective. ZeRO-3 over the
fsdp axis (``parallel/optimizer.FsdpShards``) moves slices with
``all_gather_rows`` (every rank's flat slice, one row each) and
``reduce_scatter_rows`` (the rows summed, this rank's row kept). The tensor
group's collectives (``tp_all_reduce_``, ``tp_all_gather_last``) are what a
tensor-parallel serving forward issues under ``no_grad``; training's are
autograd functions, Megatron's conjugate pair: ``copy_to_tensor`` (the
identity, its gradient all-reduced) and ``reduce_from_tensor`` (an
out-of-place all-reduce, its gradient passed through), counted in
``tensor_collectives``. ``broadcast_host`` carries the serving tick
bridge's host arrays (``infer/multihost.py``) over a gloo group made beside
the main one.

Gloo takes only ``broadcast`` and ``all_reduce`` on CUDA tensors (and its
``all_gather_into_tensor`` refuses this layout on the CPU), so on a gloo
group an all-gather is an all-reduce of a zeroed full buffer that holds
each rank's slice in its place (every element has one nonzero addend, so
the sum is exact), and a reduce-scatter is an all-reduce of the whole
buffer of which each rank keeps its part. On NCCL both are the real
collectives.
"""

from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# a finite wait for a peer in any collective: a rank that skipped one fails
# the others after this, instead of hanging them
PROCESS_GROUP_TIMEOUT_S = 900.0
# the gradient all-reduce's flat buffers (leaves at least this large are
# reduced in place, each on its own)
BUCKET_BYTES = 256 << 20
# the NCCL flight recorder's buffer size, under its old and new names
_FLIGHT_RECORDER_ENV = ("TORCH_NCCL_TRACE_BUFFER_SIZE", "TORCH_FR_BUFFER_SIZE")


@dataclass
class RuntimeInfo:
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int
    platform: str
    hostname: str

    @property
    def is_primary(self) -> bool:
        return self.process_index == 0


def backend_for(device) -> str:
    """The collective backend of ``device``: NCCL for CUDA, gloo for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {device!r}")


def initialize_distributed(environ=None, device=None,
                           timeout_s: float = PROCESS_GROUP_TIMEOUT_S) -> RuntimeInfo:
    """Join the process group the environment describes (see the module
    docstring); ``device`` is the device this process trains on (``None``:
    CUDA), and picks the backend."""
    env = os.environ if environ is None else environ
    if is_distributed():
        return runtime_info(device)
    world = int(env.get("WORLD_SIZE", "1"))
    if world > 1 or (world == 1 and env.get("MASTER_ADDR")):
        rank = int(env.get("RANK", "0"))
        local_rank = int(env.get("LOCAL_RANK", "0"))
        addr = env.get("MASTER_ADDR", "localhost")
        port = env.get("MASTER_PORT", "23456")
        dev = torch.device("cuda" if device is None else device)
        backend = backend_for(dev)
        if dev.type == "cuda":
            torch.cuda.set_device(local_rank)
            for name in _FLIGHT_RECORDER_ENV:
                os.environ.setdefault(name, "0")
        # env:// from the process's own env (torchrun's workers then join its
        # agent's store), tcp:// from an explicit mapping
        init = "env://" if environ is None else f"tcp://{addr}:{port}"
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
    return runtime_info(device)


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def runtime_info(device=None) -> RuntimeInfo:
    dev = torch.device("cuda" if device is None else device)
    gpu = dev.type == "cuda" and torch.cuda.is_available()
    return RuntimeInfo(
        process_index=process_index(),
        process_count=process_count(),
        local_device_count=torch.cuda.device_count() if gpu else 1,
        global_device_count=process_count(),  # one device per process
        platform="gpu" if gpu else "cpu",
        hostname=socket.gethostname(),
    )


def is_primary_host() -> bool:
    """Rank 0: the one process that prints, writes the artifacts and
    publishes (the reference's rank-0 gating)."""
    return process_index() == 0


def print0(*args, **kwargs) -> None:
    """``print`` on rank 0 only."""
    if is_primary_host():
        print(*args, **kwargs)


def device_preflight(device=None, verbose: bool = True) -> dict:
    """The process's device and memory, printed on rank 0. Does not fail on
    the CPU (the tests' target)."""
    info = runtime_info(device)
    report = {"platform": info.platform, "process": f"{info.process_index}/{info.process_count}",
              "local_devices": info.local_device_count,
              "global_devices": info.global_device_count}
    if info.platform == "gpu":
        free, total = torch.cuda.mem_get_info()
        report["bytes_in_use"] = total - free
        report["bytes_limit"] = total
        report["device"] = torch.cuda.get_device_name()
    if verbose:
        print0(f"[runtime] {report}", flush=True)
    return report


# ------------------------------------------------------------- collectives


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over ``group`` (None: the world); a no-op without a
    process group."""
    if is_distributed():
        dist.all_reduce(t, group=group)
    return t


def agree(flags: Sequence[bool], device, *, every: bool = False) -> List[bool]:
    """Per-rank decisions made common: each flag is set on every rank if it
    is set on any (``every=True``: only if it is set on all). One small
    all-reduce; without a process group the flags come back as they are."""
    if not is_distributed():
        return [bool(f) for f in flags]
    t = torch.tensor([(0 if f else 1) if every else (1 if f else 0) for f in flags],
                     dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [(v == 0) if every else (v == 1) for v in t.tolist()]


def broadcast_int(value: Optional[int], device) -> Optional[int]:
    """Rank 0's ``value`` (an int >= 0, or None) on every rank, by a MAX
    all-reduce in which the other ranks put -1."""
    if not is_distributed():
        return value
    mine = -1 if (value is None or not is_primary_host()) else int(value)
    t = torch.tensor([mine], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    out = int(t.item())
    return None if out < 0 else out


def barrier(device) -> None:
    """Every rank waits for the others (an all-reduce of one element, which
    every backend takes on every device)."""
    if is_distributed():
        t = torch.zeros(1, dtype=torch.int32, device=device)
        dist.all_reduce(t)
        t.item()  # the host waits too, on every backend


def all_reduce_grads(grads: List[torch.Tensor], extras: torch.Tensor,
                     bucket_bytes: int = BUCKET_BYTES, group=None) -> torch.Tensor:
    """Sum ``grads`` (f32, contiguous) across ``group`` (None: the world) in
    place, and ``extras`` (a small f32 vector: the step's loss and scalars)
    with them; returns the summed ``extras``. Leaves of at least
    ``bucket_bytes`` are reduced in place one by one; the others go,
    ``extras`` first, through flat f32 buffers of about ``bucket_bytes``: a
    few calls per step, not one per leaf."""
    if not is_distributed():
        return extras
    small = [g for g in grads if g.numel() * 4 < bucket_bytes]
    for g in grads:
        if g.numel() * 4 >= bucket_bytes:
            dist.all_reduce(g, group=group)
    buckets: List[List[torch.Tensor]] = [[extras]]
    size = extras.numel() * 4
    for g in small:
        if size + g.numel() * 4 > bucket_bytes:
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += g.numel() * 4
    for bucket in buckets:
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in bucket:
            n = t.numel()
            t.copy_(flat[offset: offset + n].view_as(t))
            offset += n
    return extras


def all_gather_tensor(t: torch.Tensor) -> torch.Tensor:
    """``[world, *t.shape]``: every rank's ``t`` (``t[None]`` without a
    process group)."""
    if not is_distributed():
        return t[None]
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t.contiguous())
    return torch.stack(out)


def all_gather_rows(flat: torch.Tensor, group, count: int, index: int) -> torch.Tensor:
    """``[count, n]``: row ``r`` is rank ``r``'s ``flat [n]`` (``index`` is
    this rank's place in ``group``, which has ``count`` ranks)."""
    if dist.get_backend(group) == "gloo":
        out = torch.zeros((count, flat.numel()), dtype=flat.dtype, device=flat.device)
        out[index] = flat
        dist.all_reduce(out, group=group)
        return out
    out = torch.empty((count, flat.numel()), dtype=flat.dtype, device=flat.device)
    dist.all_gather_into_tensor(out, flat.contiguous(), group=group)
    return out


def reduce_scatter_rows(rows: torch.Tensor, group, index: int) -> torch.Tensor:
    """Row ``index`` of ``rows [count, n]`` summed over ``group``: each
    rank gets the sum of its own row."""
    if dist.get_backend(group) == "gloo":
        dist.all_reduce(rows, group=group)
        return rows[index]
    out = torch.empty(rows.shape[1], dtype=rows.dtype, device=rows.device)
    dist.reduce_scatter_tensor(out, rows.contiguous(), group=group)
    return out


def tp_all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over the tensor group ``group`` (serving's
    forward, under ``no_grad``)."""
    dist.all_reduce(t, group=group)
    return t


def all_reduce_max_(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``t`` over ``group``, in place (scales)."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


class _CopyToTensor(torch.autograd.Function):
    """Megatron's f: the identity forward; the backward sums the gradient
    over the tensor group (each rank's column-parallel products saw the
    whole input, and each gives its share of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        tensor_collectives.backward += 1
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTensor(torch.autograd.Function):
    """Megatron's g: the forward sums the partial products over the tensor
    group, out of place (the input, an autograd input, is not rewritten);
    the backward is the identity (every rank's partial product had the
    whole sum's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        tensor_collectives.forward += 1
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel group of products: ``x`` as it is;
    its gradient all-reduced over ``group`` in the backward."""
    return _CopyToTensor.apply(x, group)


def reduce_from_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the partial products ``x`` over ``group`` (a new tensor);
    the gradient passes through unchanged."""
    return _ReduceFromTensor.apply(x, group)


class _Collectives:
    """Counts of the training tensor group's all-reduces: ``forward`` (the
    row-parallel sums, the embedding's, and their replays under remat) and
    ``backward`` (the column-parallel inputs' gradients). The vocab-parallel
    cross-entropy's all-reduces count in ``forward`` too."""

    def __init__(self):
        self.forward = self.backward = 0

    def reset(self) -> None:
        self.forward = self.backward = 0


tensor_collectives = _Collectives()


def tp_all_gather_last(t: torch.Tensor, group, size: int, index: int) -> torch.Tensor:
    """Every rank's ``t [..., n]`` side by side along the last dim, in rank
    order: ``[..., size * n]``. ``index`` is this rank's place in the group."""
    n = t.shape[-1]
    if dist.get_backend(group) == "gloo":
        full = torch.zeros(*t.shape[:-1], size * n, dtype=t.dtype, device=t.device)
        full[..., index * n: (index + 1) * n] = t
        dist.all_reduce(full, group=group)
        return full
    out = torch.empty((size, *t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out.movedim(0, -2).reshape(*t.shape[:-1], size * n)


def broadcast_host(arr, is_source: bool, group):
    """Rank 0's host array (numpy) on every rank of ``group`` (a gloo
    group): the others pass an array of the same shape and dtype and get
    rank 0's values back. Booleans travel as bytes."""
    import numpy as np

    arr = np.ascontiguousarray(arr)
    wire = arr.view(np.uint8) if arr.dtype == np.bool_ else arr
    t = torch.from_numpy(wire.copy() if not is_source else wire)
    dist.broadcast(t, src=0, group=group)
    out = t.numpy()
    return out.view(np.bool_) if arr.dtype == np.bool_ else out


def free_port() -> int:
    """A free TCP port on localhost (bind to port 0): a rendezvous port for
    a launch on this machine."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rendezvous_env(rank: int, world: int, port: int, local_rank: Optional[int] = None) -> Dict[str, str]:
    """The env a launcher gives rank ``rank`` of ``world`` on this machine."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(
        rank if local_rank is None else local_rank), "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(port)}


def destroy() -> None:
    """Leave the process group (the end of a run)."""
    if is_distributed():
        dist.destroy_process_group()
