"""The process mesh of the port: counterpart of micro_diffusion_tpu/parallel/mesh.py.

The JAX package lays its devices out as a (data, fsdp, tensor) ``jax.sharding.Mesh``
and lets XLA insert the collectives. The port runs one process per GPU (``torchrun``)
and lays the ranks out the same way, rank = (data * fsdp_size + fsdp) * tensor_size +
tensor, with one ``torch.distributed`` process group per axis:

    data   - pure data parallelism: gradients are all-reduced over it;
    fsdp   - ZeRO-2 (FSDP ``SHARD_GRAD_OP``): the batch is split over it as well, the
             gradients are reduce-scattered over it and every optimizer-state leaf
             is sharded along it (parallel/sharding.py);
    tensor - expert parallelism: the EC-MoE expert tensors split their expert axis
             over it; its ranks see the same rows.

The rows of the global batch split over data x fsdp (the ``batch`` group), in rank
order: the ``tensor`` ranks of one (data, fsdp) cell hold the same rows.
"""

import dataclasses
import datetime
import os
from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
AXES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS)
BATCH_AXES = (DATA_AXIS, FSDP_AXIS)
DEFAULT_TIMEOUT_S = 600


def init_distributed(device: str = "cuda", timeout: float = DEFAULT_TIMEOUT_S) -> int:
    """Join the process group that ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``):
    NCCL on ``cuda`` (after ``torch.cuda.set_device(LOCAL_RANK)``), gloo on
    ``cpu``. Returns the local rank. Raises when a variable is missing, or on
    ``cuda`` without a card or without NCCL."""
    missing = [v for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if v not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed: {missing} not set; start the processes "
                           "with torchrun (or set the variables it sets)")
    local_rank = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed on 'cuda': no CUDA device")
        if not dist.is_nccl_available():
            raise RuntimeError("init_distributed on 'cuda': this torch has no NCCL")
        torch.cuda.set_device(local_rank)
        backend, device_id = "nccl", torch.device("cuda", local_rank)
    elif kind == "cpu":
        backend, device_id = "gloo", None
    else:
        raise ValueError(f"init_distributed: device {device!r} is not 'cuda' or 'cpu'")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                timeout=datetime.timedelta(seconds=timeout),
                                device_id=device_id)
    return local_rank


class Shard(NamedTuple):
    """Part ``index`` of ``count`` equal parts of a leading axis."""

    index: int
    count: int

    def rows(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"{n} rows do not split into {self.count} equal parts")
        size = n // self.count
        return slice(self.index * size, (self.index + 1) * size)


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data, fsdp, tensor) layout of the world, and the
    process group of each axis (and of ``batch``, data x fsdp, and ``world``) that
    holds it."""

    shape: Dict[str, int]
    rank: int
    groups: Dict[str, object]

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[FSDP_AXIS] * self.shape[TENSOR_AXIS]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (or along ``batch``)."""
        t = self.shape[TENSOR_AXIS]
        f = self.shape[FSDP_AXIS]
        coords = {TENSOR_AXIS: self.rank % t, FSDP_AXIS: (self.rank // t) % f,
                  DATA_AXIS: self.rank // (t * f)}
        coords["batch"] = coords[DATA_AXIS] * f + coords[FSDP_AXIS]
        return coords[axis]

    def axis_size(self, axis: str) -> int:
        if axis == "batch":
            return self.shape[DATA_AXIS] * self.shape[FSDP_AXIS]
        return self.shape[axis]

    def group(self, axis: str):
        return self.groups[axis]

    def __repr__(self) -> str:
        dims = "x".join(str(self.shape[a]) for a in AXES)
        return f"Mesh({dims} (data, fsdp, tensor), rank {self.rank})"


def _axis_groups(data: int, fsdp: int, tensor: int) -> Dict[str, object]:
    """One process group per axis (and per batch cell), made by every rank in the
    same order, as ``new_group`` requires; returns the groups holding this rank."""
    rank = dist.get_rank()
    layout = torch.arange(data * fsdp * tensor).reshape(data, fsdp, tensor)
    lines = {DATA_AXIS: layout.permute(1, 2, 0).reshape(-1, data),
             FSDP_AXIS: layout.permute(0, 2, 1).reshape(-1, fsdp),
             TENSOR_AXIS: layout.reshape(-1, tensor),
             "batch": layout.permute(2, 0, 1).reshape(tensor, -1)}
    mine = {}
    for axis, rows in lines.items():
        for ranks in rows.tolist():
            group = dist.new_group(ranks)
            if rank in ranks:
                mine[axis] = group
    mine["world"] = dist.group.WORLD
    return mine


def make_mesh(data: Optional[int] = None, fsdp: int = 1, tensor: int = 1) -> Mesh:
    """A (data, fsdp, tensor) mesh over the initialised world; ``data=None`` takes
    what fsdp x tensor leaves. Raises when the shape does not equal the world."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call init_distributed() first "
                           "(train.cli does with --multihost or WORLD_SIZE set)")
    world = dist.get_world_size()
    if data is None:
        if world % (fsdp * tensor):
            raise ValueError(f"mesh fsdp {fsdp} x tensor {tensor} does not divide the "
                             f"world of {world} processes")
        data = world // (fsdp * tensor)
    if data * fsdp * tensor != world:
        raise ValueError(f"mesh {data}x{fsdp}x{tensor} (data, fsdp, tensor) does not "
                         f"equal the world of {world} processes")
    shape = {DATA_AXIS: int(data), FSDP_AXIS: int(fsdp), TENSOR_AXIS: int(tensor)}
    return Mesh(shape=shape, rank=dist.get_rank(), groups=_axis_groups(data, fsdp, tensor))


def make_multislice_mesh(dcn_data: int, fsdp: int = 1, tensor: int = 1) -> Mesh:
    """A mesh over ``dcn_data`` nodes: a node plays the part of a TPU slice. torchrun
    numbers the ranks node-major, so fsdp and tensor stay inside a node and only
    the data axis crosses nodes (its all-reduce is the only traffic between them)."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world // max(dcn_data, 1)))
    if world != dcn_data * per_node or per_node % (fsdp * tensor):
        raise ValueError(f"{world} processes do not form {dcn_data} nodes of "
                         f"{per_node} with fsdp {fsdp} x tensor {tensor} inside each")
    return make_mesh(data=world // (fsdp * tensor), fsdp=fsdp, tensor=tensor)


def batch_sharding(mesh: Optional[Mesh]) -> Shard:
    """The part of the global batch's rows this rank holds: split over data x fsdp."""
    if mesh is None:
        return Shard(0, 1)
    return Shard(mesh.index("batch"), mesh.axis_size("batch"))


def replicated_sharding(mesh: Optional[Mesh]) -> Shard:
    """Every rank holds the whole."""
    return Shard(0, 1)
