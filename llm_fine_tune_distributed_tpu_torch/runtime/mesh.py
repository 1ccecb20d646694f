"""The device mesh of a training run and of tensor-parallel serving
(counterpart of the JAX ``runtime/mesh.py``).

The JAX mesh lays every device out over six named axes and lets XLA emit the
collectives. The port runs one process per device and names the same axes
over the ranks of the process group, row-major in ``MESH_AXES`` order, so a
rank's coordinates are the ones its device has in the JAX mesh. Three axes
are ported:

- ``data``: pure data parallelism (splits the batch);
- ``fsdp``: data parallelism that also shards the leaves themselves,
  trainable and frozen, and the AdamW moments over the axis (ZeRO-3, as the
  JAX axis does; ``parallel/optimizer.FsdpShards``);
- ``tensor``: Megatron tensor parallelism (``parallel/sharding.
  TensorShards``): a rank holds its slice of the column- and row-parallel
  kernels and of the vocab, both ranks of a replica read the same rows, and
  the forward's collectives run on ``tensor_group``. A rank's fsdp slice is
  a slice of its tensor slice.

A training mesh with ``seq``, ``pipe`` or ``expert`` larger than 1 raises
``NotImplementedError``. A training mesh makes, on every rank and in the
same order, a tensor group per (data, fsdp) coordinate, an fsdp group per
(data, tensor) coordinate, a replica group per (fsdp, tensor) coordinate
beside a data axis, and a gradient group per tensor index (the ranks whose
whole leaves' gradients are summed). Serving shards over ``tensor``
(``make_serving_mesh``, behind ``infer/generate.make_tp_mesh``): every rank
of the process group is one tensor-parallel shard, the forward's
collectives run on ``tensor_group`` (the main group: NCCL for cuda, gloo
for cpu) and the serving tick bridge's host arrays on ``control_group``, a
gloo group made beside it. The JAX package's hybrid multi-slice mesh (the
data axis over DCN between TPU slices) is TPU topology and has no
counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch.distributed as dist

from llm_fine_tune_distributed_tpu_torch.config import MeshConfig
from llm_fine_tune_distributed_tpu_torch.runtime.distributed import is_distributed

MESH_AXES = ("data", "pipe", "fsdp", "tensor", "seq", "expert")
# the axes the port does not shard over, and the JAX code that has them
UNPORTED_AXES = {
    "seq": "parallel/ring_attention.py and parallel/ulysses.py",
    "pipe": "parallel/pipeline.py",
    "expert": "ops/moe.py",
}


@dataclass
class DeviceMesh:
    """Axis sizes (``shape``, in ``MESH_AXES`` order) over ``size`` ranks,
    this process's ``rank``, its ``fsdp`` group: the ranks that share its
    data replica (None: the whole world, or no group at all), and its
    ``replica`` group beside a data axis: the ranks that hold the same fsdp
    slices (None: there is no data axis beside fsdp). Its ``tensor_group``
    holds the ranks of its (data, fsdp) coordinate, and its ``grad_group``
    the ranks of its tensor index (None: the world when the tensor axis is
    1, or no one to sum with). A serving mesh has ``tensor_group`` (None:
    no process group, so the forward issues no collective) and, over more
    than one rank, ``control_group``."""

    shape: Dict[str, int]
    rank: int = 0
    fsdp_group: Optional[object] = field(default=None, repr=False)
    replica_group: Optional[object] = field(default=None, repr=False)
    tensor_group: Optional[object] = field(default=None, repr=False)
    control_group: Optional[object] = field(default=None, repr=False)
    grad_group: Optional[object] = field(default=None, repr=False)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    @property
    def coords(self) -> Dict[str, int]:
        out, rest = {}, self.rank
        for axis in reversed(MESH_AXES):
            out[axis] = rest % self.shape[axis]
            rest //= self.shape[axis]
        return {a: out[a] for a in MESH_AXES}

    @property
    def fsdp_index(self) -> int:
        return self.coords["fsdp"]

    @property
    def tensor_size(self) -> int:
        return self.shape["tensor"]

    @property
    def tensor_index(self) -> int:
        return self.coords["tensor"]

    @property
    def batch_block(self) -> int:
        """This rank's block of the batch, which is split over (data, fsdp):
        the ranks of one tensor group read the same rows."""
        c = self.coords
        return c["data"] * self.shape["fsdp"] + c["fsdp"]

    def rank_of(self, data: int, fsdp: int, tensor: int) -> int:
        """The rank at these coordinates (the other axes are 1)."""
        return (data * self.shape["fsdp"] + fsdp) * self.shape["tensor"] + tensor


def check_ported_axes(sizes) -> None:
    """``NotImplementedError`` for an unported axis larger than 1 in
    ``sizes`` (a ``MeshConfig`` or a dict of resolved sizes)."""
    get = sizes.get if isinstance(sizes, dict) else lambda a: getattr(sizes, a)
    for axis, where in UNPORTED_AXES.items():
        if get(axis) > 1:
            raise NotImplementedError(
                f"mesh axis {axis}={get(axis)}: the PyTorch trainer shards over data, fsdp and "
                f"tensor only: {axis} parallelism is not ported (the JAX package's {where} has "
                "it)")


def _no_group(tensor: int) -> str:
    return (f"mesh axis tensor={tensor} needs {tensor} or more processes in a torch.distributed "
            "group, one per device (torchrun or a PyTorchJob); none was started")


def make_mesh(config: Optional[MeshConfig] = None, world: Optional[int] = None,
              rank: Optional[int] = None) -> DeviceMesh:
    """The mesh of ``config`` over ``world`` ranks (the process group's by
    default, 1 without one). Sizes and their ``ValueError``s are
    ``MeshConfig.axis_sizes``'s; an unported axis larger than 1 raises
    ``NotImplementedError``, and so does ``tensor > 1`` without a process
    group. With a process group of that world the groups of the module
    docstring are made here (every rank makes every group, in the same
    order)."""
    config = config or MeshConfig()
    check_ported_axes(config)
    grouped = is_distributed()
    if config.tensor > 1 and not grouped:  # before the sizes: one process has world 1
        raise NotImplementedError(_no_group(config.tensor))
    if world is None:
        world = dist.get_world_size() if grouped else 1
    if rank is None:
        rank = dist.get_rank() if grouped else 0
    sizes = config.axis_sizes(world)
    check_ported_axes(sizes)  # an unported axis of -1 that took devices
    if sizes["tensor"] > 1 and not grouped:
        raise NotImplementedError(_no_group(sizes["tensor"]))
    mesh = DeviceMesh({a: sizes[a] for a in MESH_AXES}, rank)
    D, F, T = sizes["data"], sizes["fsdp"], sizes["tensor"]
    if not grouped or world != dist.get_world_size():
        return mesh
    c = mesh.coords

    def groups(members, mine):
        """One group per list of ``members``, in order; this rank's."""
        out = None
        for key, ranks in members:
            group = dist.new_group(ranks)
            if key == mine:
                out = group
        return out

    if T > 1:
        mesh.tensor_group = (dist.group.WORLD if T == world else groups(
            [((d, f), [mesh.rank_of(d, f, t) for t in range(T)])
             for d in range(D) for f in range(F)], (c["data"], c["fsdp"])))
    if 1 < F < world:
        mesh.fsdp_group = groups([((d, t), [mesh.rank_of(d, f, t) for f in range(F)])
                                  for d in range(D) for t in range(T)], (c["data"], c["tensor"]))
        if D > 1:
            mesh.replica_group = groups(
                [((f, t), [mesh.rank_of(d, f, t) for d in range(D)])
                 for f in range(F) for t in range(T)], (c["fsdp"], c["tensor"]))
    if T > 1 and D * F > 1:
        mesh.grad_group = groups([(t, [r for r in range(world) if r % T == t])
                                  for t in range(T)], c["tensor"])
    return mesh


def make_serving_mesh(tp: int) -> DeviceMesh:
    """The tensor-parallel serving mesh of ``tp`` ranks: the whole process
    group, one rank per shard. ``tp > 1`` needs a process group of exactly
    ``tp`` ranks (``initialize_distributed`` from the launcher's env);
    ``tp == 1`` in a group of one gives a mesh whose forward still issues
    its collectives (a one-worker launcher job), and without a group one
    that issues none. Every rank must call this, in the same order: the
    control group is made here."""
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"--tp must be >= 1, got {tp}")
    grouped = is_distributed()
    if not grouped:
        if tp > 1:
            raise ValueError(
                f"--tp {tp} needs {tp} processes in a torch.distributed group, one per "
                "device, and none was started: run under torchrun --nproc-per-node "
                f"{tp} or a PyTorchJob (WORLD_SIZE/RANK/LOCAL_RANK, MASTER_ADDR/PORT)")
        return DeviceMesh({a: 1 for a in MESH_AXES}, 0)
    world = dist.get_world_size()
    if tp != world:
        raise ValueError(f"--tp {tp} must equal the process group's size ({world}): one "
                         "process per tensor-parallel shard")
    shape = {a: 1 for a in MESH_AXES}
    shape["tensor"] = tp
    control = dist.new_group(backend="gloo") if tp > 1 else None
    return DeviceMesh(shape, dist.get_rank(), tensor_group=dist.group.WORLD,
                      control_group=control)


def grad_reduction(mesh: DeviceMesh):
    """(sum?, group) of the whole leaves' gradients and the step's scalars:
    over the world without a tensor axis (a no-op without a process group;
    a group of one still issues it, as a larger one would), over the ranks
    of this rank's tensor index with one, and not at all where those are
    only this rank."""
    if mesh.shape["tensor"] == 1:
        return True, None
    return mesh.grad_group is not None, mesh.grad_group


def data_parallel_size(mesh: DeviceMesh) -> int:
    """Data-parallel replicas = data x fsdp (the batch is split over both).
    Drives the lr x world-size rule."""
    return mesh.shape["data"] * mesh.shape["fsdp"]


def describe_mesh(mesh: DeviceMesh) -> str:
    parts = [f"{a}={mesh.shape[a]}" for a in MESH_AXES]
    return f"Mesh({', '.join(parts)}) over {mesh.size} devices"
