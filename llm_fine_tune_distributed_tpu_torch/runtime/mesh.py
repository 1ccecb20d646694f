"""The device mesh of a data-parallel run and of tensor-parallel serving
(counterpart of the JAX ``runtime/mesh.py``).

The JAX mesh lays every device out over six named axes and lets XLA emit the
collectives. The port runs one process per device and names the same axes
over the ranks of the process group, row-major in ``MESH_AXES`` order, so a
rank's coordinates are the ones its device has in the JAX mesh. Two axes are
ported, and both split the batch:

- ``data``: pure data parallelism;
- ``fsdp``: data parallelism that also shards the leaves themselves,
  trainable and frozen, and the AdamW moments over the axis (ZeRO-3, as the
  JAX axis does; ``parallel/optimizer.FsdpShards``).

A training mesh with ``tensor``, ``seq``, ``pipe`` or ``expert`` larger
than 1 raises ``NotImplementedError``. Serving shards over ``tensor``
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
    "tensor": "parallel/sharding.py's tensor rules under the trainer's pjit",
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
    slices (None: there is no data axis beside fsdp). A serving
    mesh has ``tensor_group`` (None: no process group, so the forward
    issues no collective) and, over more than one rank, ``control_group``."""

    shape: Dict[str, int]
    rank: int = 0
    fsdp_group: Optional[object] = field(default=None, repr=False)
    replica_group: Optional[object] = field(default=None, repr=False)
    tensor_group: Optional[object] = field(default=None, repr=False)
    control_group: Optional[object] = field(default=None, repr=False)

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
        """This rank's block of the batch, which is split over (data, fsdp)."""
        c = self.coords
        return c["data"] * self.shape["fsdp"] + c["fsdp"]


def check_ported_axes(sizes) -> None:
    """``NotImplementedError`` for an unported axis larger than 1 in
    ``sizes`` (a ``MeshConfig`` or a dict of resolved sizes)."""
    get = sizes.get if isinstance(sizes, dict) else lambda a: getattr(sizes, a)
    for axis, where in UNPORTED_AXES.items():
        if get(axis) > 1:
            what = ("tensor-parallel training is not ported; tensor-parallel serving is "
                    "--tp N" if axis == "tensor" else f"{axis} parallelism is not ported")
            raise NotImplementedError(
                f"mesh axis {axis}={get(axis)}: the PyTorch trainer shards over data and fsdp "
                f"only: {what} (the JAX package's {where} has it)")


def make_mesh(config: Optional[MeshConfig] = None, world: Optional[int] = None,
              rank: Optional[int] = None) -> DeviceMesh:
    """The mesh of ``config`` over ``world`` ranks (the process group's by
    default, 1 without one). Sizes and their ``ValueError``s are
    ``MeshConfig.axis_sizes``'s; an unported axis larger than 1 raises
    ``NotImplementedError``. With a process group of that world, the fsdp
    groups are made here, one per data replica, and the replica groups,
    one per fsdp slice (every rank makes every group, in the same
    order)."""
    config = config or MeshConfig()
    check_ported_axes(config)
    grouped = is_distributed()
    if world is None:
        world = dist.get_world_size() if grouped else 1
    if rank is None:
        rank = dist.get_rank() if grouped else 0
    sizes = config.axis_sizes(world)
    check_ported_axes(sizes)  # an unported axis of -1 that took devices
    mesh = DeviceMesh({a: sizes[a] for a in MESH_AXES}, rank)
    if grouped and world == dist.get_world_size() and 1 < sizes["fsdp"] < world:
        per = sizes["fsdp"]
        for d in range(world // per):
            group = dist.new_group(list(range(d * per, (d + 1) * per)))
            if d == mesh.coords["data"]:
                mesh.fsdp_group = group
        for f in range(per):
            group = dist.new_group(list(range(f, world, per)))
            if f == mesh.coords["fsdp"]:
                mesh.replica_group = group
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


def data_parallel_size(mesh: DeviceMesh) -> int:
    """Data-parallel replicas = data x fsdp (the batch is split over both).
    Drives the lr x world-size rule."""
    return mesh.shape["data"] * mesh.shape["fsdp"]


def describe_mesh(mesh: DeviceMesh) -> str:
    parts = [f"{a}={mesh.shape[a]}" for a in MESH_AXES]
    return f"Mesh({', '.join(parts)}) over {mesh.size} devices"
