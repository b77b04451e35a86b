"""Sharding rules and ZeRO-2 for the port: counterpart of
micro_diffusion_tpu/parallel/sharding.py.

The rules are the JAX package's (reference FSDP ``SHARD_GRAD_OP``,
configs/res_256_pretrain.yaml:117-118):

  * parameters stay replicated, except that the 3-D EC-MoE expert tensors ``w1``
    (e, d, f) and ``w2`` (e, f, d) split their expert axis over ``tensor`` when it
    divides (expert parallelism);
  * every optimizer-state leaf splits over ``fsdp`` along its largest divisible
    axis (the first of equal ones), or stays whole.

A spec is a tuple with one entry per dimension: the mesh axis that dimension is
split over, or None (``()``: whole), as ``tuple(PartitionSpec)`` reads in JAX. A
rank holds the slice of each split dimension at its coordinate on that axis.

XLA derives the collectives from these specs; here ``Zero2`` does it by hand, in
flat buckets of at most ``BUCKET_NUMEL`` elements, after a step's microbatches:

  1. the EC-MoE gate gradients, which hold only this rank's experts' share under
     ``tensor``, are summed over ``tensor``;
  2. each state-sharded gradient is reduce-scattered over ``fsdp`` into this rank's
     shard, then all-reduced over ``data``; a whole one is all-reduced over
     data x fsdp; both are divided by data x fsdp (the mean over the batch);
  3. AdamW updates this rank's shard of each parameter (train/optim.py);
  4. the shards are all-gathered over ``fsdp`` back into the full parameters.

The expert tensors' gradients reduce over data x fsdp only: each ``tensor`` rank
owns its experts. The optimizer state of an expert tensor follows its parameter's
``tensor`` split, then the fsdp rule on that local shape.
"""

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, FSDP_AXIS, TENSOR_AXIS, Mesh

# elements per bucket of one collective: 256 MB of fp32, a bound on the extra memory
BUCKET_NUMEL = 1 << 26

Spec = Tuple[Optional[str], ...]


def _sizes(mesh) -> Dict[str, int]:
    return mesh.shape if isinstance(mesh, Mesh) else dict(mesh)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", leaf))


def param_spec(name: str, leaf, mesh) -> Spec:
    """The spec of one parameter (``name`` in torch's dotted or JAX's slashed form;
    ``leaf`` a tensor, an array or a shape; ``mesh`` a Mesh or {axis: size})."""
    shape = _shape(leaf)
    tensor = _sizes(mesh)[TENSOR_AXIS]
    last = name.replace("/", ".").split(".")[-1]
    if tensor > 1 and len(shape) == 3 and last in ("w1", "w2") and shape[0] % tensor == 0:
        return (TENSOR_AXIS, None, None)
    return ()


def param_shardings(params: Dict[str, torch.Tensor], mesh) -> Dict[str, Spec]:
    return {n: param_spec(n, p, mesh) for n, p in params.items()}


def opt_state_spec(leaf, mesh) -> Spec:
    """ZeRO-2: the leaf's largest fsdp-divisible axis (the first of equal ones) is
    split over ``fsdp``; otherwise it stays whole."""
    shape = _shape(leaf)
    fsdp = _sizes(mesh)[FSDP_AXIS]
    if fsdp <= 1 or not shape:
        return ()
    best = None
    for i, s in enumerate(shape):
        if s % fsdp == 0 and (best is None or s > shape[best]):
            best = i
    if best is None:
        return ()
    return tuple(FSDP_AXIS if i == best else None for i in range(len(shape)))


def opt_state_shardings(params: Dict[str, torch.Tensor], mesh) -> Dict[str, Spec]:
    """The state spec of each (rank-local) parameter."""
    return {n: opt_state_spec(p, mesh) for n, p in params.items()}


def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Apply the parameter rules to ``model`` in place: every EC-MoE module whose
    ``w1`` / ``w2`` the rules split over ``tensor`` keeps this rank's experts only
    and runs expert-parallel. Returns ``model``."""
    policy = getattr(model, "remat_policy", "full") if getattr(model, "remat", False) else None
    for name, mod in model.named_modules():
        if not hasattr(mod, "set_expert_parallel"):
            continue
        specs = {param_spec(f"{name}.{w}", getattr(mod, w), mesh) for w in ("w1", "w2")}
        if specs == {(TENSOR_AXIS, None, None)}:
            if policy not in (None, "full"):
                raise ValueError(f"expert parallelism (tensor > 1) runs under remat "
                                 f"policy 'full' or without remat, not {policy!r}")
            mod.set_expert_parallel(mesh.group(TENSOR_AXIS), mesh.index(TENSOR_AXIS),
                                    mesh.axis_size(TENSOR_AXIS))
    return model


def _split_dim(spec: Spec) -> Optional[int]:
    for i, axis in enumerate(spec):
        if axis is not None:
            return i
    return None


def local_slice(full: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a whole tensor under ``spec`` (a view)."""
    dim = _split_dim(spec)
    if dim is None:
        return full
    n = mesh.axis_size(spec[dim])
    size = full.shape[dim] // n
    return full.narrow(dim, mesh.index(spec[dim]) * size, size)


def gather_full(local: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's slice under ``spec`` (a collective over
    the spec's axis: every rank of that group calls it)."""
    dim = _split_dim(spec)
    if dim is None:
        return local
    parts = [torch.empty_like(local, memory_format=torch.contiguous_format)
             for _ in range(mesh.axis_size(spec[dim]))]
    dist.all_gather(parts, local.contiguous(), group=mesh.group(spec[dim]))
    return torch.cat(parts, dim=dim)


# ------------------------------------------------------------ expert parallelism


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group (the input
    is replicated, each rank's use of it covers its own experts). The sum is taken
    in fp32 and rounded to the input's dtype, but each rank's gradient arrives
    already rounded to that dtype (bf16 on the card), so under a low-precision
    input it differs from one process's, which rounds the whole sum once."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = grad.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(total, group=ctx.group)
        return total.to(grad.dtype), None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward (each rank's partial output); identity backward
    (the sum is replicated, so is its gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


# ------------------------------------------------------------ ZeRO-2


class Zero2:
    """ZeRO-2 over a mesh for the parameters of ``dit`` (the module whose
    ``named_parameters`` the train state holds), after ``shard_params``.

    ``state_specs``: each parameter's optimizer-state spec on its local shape;
    ``param_shards()``: this rank's shard of each parameter (views the optimizer
    updates in place); ``reduce_gradients`` and ``gather_params`` are steps 1-2 and
    4 of the module docstring; ``norm_names``: the parameters whose shards this
    rank counts in the global norm, so that the sum over the world counts every
    element once."""

    def __init__(self, dit: torch.nn.Module, mesh: Mesh):
        self.mesh = mesh
        self.params = {n: p for n, p in dit.named_parameters() if p.requires_grad}
        # lists in module order: every rank issues the collectives in one order
        self.tensor_split, self.tensor_partial = [], []
        for name, mod in dit.named_modules():
            if getattr(mod, "expert_parallel", None) is not None:
                self.tensor_split += [f"{name}.w1", f"{name}.w2"]
                self.tensor_partial += [f"{name}.gate.{n}" for n, _ in mod.gate.named_parameters()]
        self.param_specs = {n: (TENSOR_AXIS, None, None) if n in self.tensor_split else ()
                            for n in self.params}
        self.state_specs = opt_state_shardings(self.params, mesh)
        self.split = [n for n in self.params if self.state_specs[n]]
        self.whole = [n for n in self.params if not self.state_specs[n]]
        first = {a: mesh.index(a) == 0 for a in (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS)}
        self.norm_names = [
            n for n in self.params
            if first[DATA_AXIS] and (n in self.tensor_split or first[TENSOR_AXIS])
            and (self.state_specs[n] or first[FSDP_AXIS])]
        self.buckets = self._bucket(self.split)
        self.whole_buckets = self._bucket(self.whole)

    def _bucket(self, names: List[str]) -> List[List[str]]:
        fsdp = self.mesh.axis_size(FSDP_AXIS)
        out, cur, size = [], [], 0
        for n in names:
            numel = self.params[n].numel() // (fsdp if self.state_specs[n] else 1)
            if cur and size + numel > BUCKET_NUMEL:
                out.append(cur)
                cur, size = [], 0
            cur.append(n)
            size += numel
        if cur:
            out.append(cur)
        return out

    # ---------------------------------------------------------------- slices

    def _piece(self, t: torch.Tensor, name: str, j: int) -> torch.Tensor:
        """Part ``j`` of ``t`` under ``name``'s state spec."""
        dim = _split_dim(self.state_specs[name])
        size = t.shape[dim] // self.mesh.axis_size(FSDP_AXIS)
        return t.narrow(dim, j * size, size)

    def shard_of(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's part of a rank-local tensor shaped like parameter ``name``."""
        if not self.state_specs[name]:
            return t
        return self._piece(t, name, self.mesh.index(FSDP_AXIS))

    def param_shards(self) -> Dict[str, torch.Tensor]:
        return {n: self.shard_of(p, n) for n, p in self.params.items()}

    def state_local(self, full: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's optimizer-state slice of a whole (checkpointed) leaf."""
        return self.shard_of(self.param_local(full, name), name)

    def param_local(self, full: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's slice of a whole (checkpointed) parameter or EMA leaf."""
        return local_slice(full, self.param_specs[name], self.mesh)

    def gather_param(self, local: torch.Tensor, name: str) -> torch.Tensor:
        return gather_full(local, self.param_specs[name], self.mesh)

    def gather_state(self, shard: torch.Tensor, name: str) -> torch.Tensor:
        return self.gather_param(gather_full(shard, self.state_specs[name], self.mesh), name)

    # ---------------------------------------------------------------- step

    @torch.no_grad()
    def reduce_gradients(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Steps 1-2: this rank's shard of the mean gradient over the batch, by name.
        ``grads`` (rank-local, fp32, this rank's microbatch mean) is emptied as its
        buckets go, so that no second full gradient is held."""
        mesh = self.mesh
        for n in self.tensor_partial:
            dist.all_reduce(grads[n], group=mesh.group(TENSOR_AXIS))
        scale = 1.0 / mesh.axis_size("batch")
        fsdp = mesh.axis_size(FSDP_AXIS)
        out = {}
        for names in self.buckets:
            shapes = [self._piece(grads[n], n, 0).shape for n in names]
            numels = [s.numel() for s in shapes]
            size = sum(numels)
            packed = torch.empty(fsdp * size, dtype=torch.float32, device=grads[names[0]].device)
            for j in range(fsdp):
                off = j * size
                for n, shape, k in zip(names, shapes, numels):
                    packed[off:off + k].view(shape).copy_(self._piece(grads[n], n, j))
                    off += k
            for n in names:
                del grads[n]
            shard = torch.empty(size, dtype=torch.float32, device=packed.device)
            dist.reduce_scatter_tensor(shard, packed, group=mesh.group(FSDP_AXIS))
            del packed
            dist.all_reduce(shard, group=mesh.group(DATA_AXIS))
            shard.mul_(scale)
            off = 0
            for n, shape, k in zip(names, shapes, numels):
                out[n] = shard[off:off + k].view(shape)
                off += k
        for names in self.whole_buckets:
            flat = torch.cat([grads.pop(n).reshape(-1) for n in names])
            dist.all_reduce(flat, group=mesh.group("batch"))
            flat.mul_(scale)
            off = 0
            for n in names:
                k = self.params[n].numel()
                out[n] = flat[off:off + k].view(self.params[n].shape)
                off += k
        return out

    @torch.no_grad()
    def gather_params(self) -> None:
        """Step 4: every rank's updated shards back into the full parameters."""
        fsdp = self.mesh.axis_size(FSDP_AXIS)
        for names in self.buckets:
            mine = [self.shard_of(self.params[n], n) for n in names]
            numels = [t.numel() for t in mine]
            size = sum(numels)
            send = torch.cat([t.reshape(-1) for t in mine])
            recv = torch.empty(fsdp * size, dtype=send.dtype, device=send.device)
            dist.all_gather_into_tensor(recv, send, group=self.mesh.group(FSDP_AXIS))
            for j in range(fsdp):
                off = j * size
                for n, t, k in zip(names, mine, numels):
                    self._piece(self.params[n], n, j).copy_(recv[off:off + k].view(t.shape))
                    off += k
