"""The process group as the host code sees it: one process unless
``torch.distributed`` has been initialised (``parallel.multihost``).

The group is laid out as a (data x model) grid (``set_mesh``, which
``parallel.mesh.make_mesh`` calls): with ``world = data * model``, rank
``d * model + m`` is model rank ``m`` of data rank ``d``, so consecutive
ranks form a model group and ranks with the same ``m`` a data group. The
accessors below read that layout; without one (or at ``model`` 1) the data
group is the whole group and there is no model group.

The collectives run whenever a group exists, whatever its size (at world 1
they return their input's values); without one they are the identity. The
three tensor-parallel operators (``copy_to_group``, ``reduce_from_group``,
``gather_from_group``) are Megatron-LM's, as autograd functions over a model
group; with ``group`` None they are the identity."""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


# ----------------------------------------------------------------- the grid
@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data x model) layout of the default group. ``data_group`` None is
    the default group itself (``model`` 1); ``model_group`` None means no
    model axis."""

    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: Any = None
    model_group: Any = None
    world_group: Any = None  # the default group the layout was built on


_mesh: Optional[Mesh] = None


def grid(world: int, model: int) -> Tuple[List[List[int]], List[List[int]]]:
    """The ranks of every model group and of every data group of ``world``
    ranks at a model axis of ``model``: rank ``d * model + m`` is model rank
    ``m`` of data rank ``d``. -> (model groups by data rank, data groups by
    model rank)."""
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide {world} rank(s)")
    data = world // model
    return ([[d * model + m for m in range(model)] for d in range(data)],
            [[d * model + m for d in range(data)] for m in range(model)])


def set_mesh(model: int) -> Mesh:
    """Lay the default group out as ``world / model`` data ranks by
    ``model`` model ranks, building every model group and every data group
    (``torch.distributed.new_group``, which every rank calls for every group
    in the same order). The layout stays until the default group is
    destroyed; a call for the same model axis on it returns it (every rank
    takes the same branch). -> the layout."""
    global _mesh
    current = mesh()
    if current.model == model:
        return current
    world, r = world_size(), rank()
    model_groups, data_groups = grid(world, model)
    data_group = model_group = None
    if model > 1:
        for ranks in model_groups:
            g = dist.new_group(ranks)
            if r in ranks:
                model_group = g
        for ranks in data_groups:
            g = dist.new_group(ranks)
            if r in ranks:
                data_group = g
    data = world // model
    _mesh = Mesh(data, model, r // model, r % model, data_group, model_group,
                 dist.group.WORLD if initialized() else None)
    return _mesh


def mesh() -> Mesh:
    """The layout ``set_mesh`` built on the live default group; all data
    (``model`` 1) without one."""
    if _mesh is not None and initialized() and _mesh.world_group is dist.group.WORLD:
        return _mesh
    return Mesh(world_size(), 1, rank(), 0)


def data_rank() -> int:
    return mesh().data_rank


def data_size() -> int:
    return mesh().data


def data_group():
    """The ranks that hold this rank's model shard: the group over which
    rows, losses and gradients are reduced (None: the default group)."""
    return mesh().data_group


def model_rank() -> int:
    return mesh().model_rank


def model_size() -> int:
    return mesh().model


def model_group():
    """The ranks that share this rank's rows, each with its model shard
    (None: no model axis)."""
    return mesh().model_group


def _trivial(group) -> bool:
    return not initialized() or dist.get_world_size(group) == 1


# -------------------------------------------------------------- collectives
def all_gather_list(items: List[Any]) -> List[Any]:
    """Every data rank's ``items`` (picklable, e.g. metric rows), concatenated
    in data-rank order: the ranks of a model group hold the same rows, and
    each row comes once. The list itself in a single process."""
    group = data_group()
    if _trivial(group):
        return items
    parts: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, items, group=group)
    return [x for part in parts for x in part]


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    dtypes = {t.dtype for t in tensors}
    devices = {t.device for t in tensors}
    if len(dtypes) != 1 or len(devices) != 1:
        raise ValueError(f"one dtype and one device expected, got {dtypes} on {devices}")
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def all_reduce_sum(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """SUM over ``group`` (None: the default group) of every tensor of
    ``tensors`` (one dtype, one device), in place, through one contiguous
    buffer: one collective for the whole list. -> the same tensors."""
    tensors = list(tensors)
    if not initialized() or not tensors:
        return tensors
    flat = _flat(tensors)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    _unflat(flat, tensors)
    return tensors


class _AllReduceSum(torch.autograd.Function):
    """SUM over the group whose backward is the SUM of the gradients (each
    rank's input reaches every rank's output, and each rank's loss is its
    own term of the total). The semantics of the deprecated
    ``torch.distributed.nn.functional.all_reduce``."""

    @staticmethod
    def forward(ctx, tensor, group=None):
        ctx.group = group
        out = tensor.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def all_reduce_sum_grad(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """SUM over ``group`` (None: the default group) of ``tensor``,
    differentiable: the gradient flows back to every rank's input (each
    rank's loss a term of the total). The tensor itself without a group."""
    return _AllReduceSum.apply(tensor, group) if initialized() else tensor


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: the identity forward, SUM of the gradients backward. It
    stands where a replicated tensor meets a weight split over the model
    group: each rank's backward holds the part of the input's gradient that
    its shard gives, and the SUM is the whole on every rank."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return tensor

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: SUM forward (of the partial products of a weight split
    along its input), the identity backward. Every rank of the model group
    computes the same loss from the sum, so each rank's gradient of it is
    already the whole; summing it again (as ``_AllReduceSum`` does) would
    scale it by the group's size."""

    @staticmethod
    def forward(ctx, tensor, group):
        out = tensor.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_gather_tensor(tensor: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``tensor`` (one shape) over ``group``, in group-rank
    order, on ``tensor``'s device. gloo gathers CPU tensors only, so under
    gloo a CUDA tensor goes through the host (the copy back to the card
    included); NCCL gathers on the card."""
    staged = tensor.is_cuda and dist.get_backend(group) == "gloo"
    src = (tensor.cpu() if staged else tensor).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(tensor.device) for p in parts] if staged else parts


class _GatherFromGroup(torch.autograd.Function):
    """All-gather along the last axis (a vocabulary split over the model
    group), this rank's slice of the gradient backward. Every rank then
    holds the same bytes of the whole, and computes the same loss from
    them."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group, ctx.width = group, tensor.shape[-1]
        return torch.cat(all_gather_tensor(tensor, group), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        lo = dist.get_rank(ctx.group) * ctx.width
        return grad[..., lo:lo + ctx.width], None


def copy_to_group(tensor: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f over ``group`` (the identity for None)."""
    return tensor if group is None else _CopyToGroup.apply(tensor, group)


def reduce_from_group(tensor: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g over ``group`` (the identity for None)."""
    return tensor if group is None else _ReduceFromGroup.apply(tensor, group)


def gather_from_group(tensor: torch.Tensor, group) -> torch.Tensor:
    """The last axis gathered over ``group`` (the identity for None)."""
    return tensor if group is None else _GatherFromGroup.apply(tensor, group)


def all_reduce_max(value: int, group=None) -> int:
    """The largest of every rank's ``value`` (an int) over ``group`` (None:
    the default group)."""
    if not initialized():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


def broadcast(tensors: Sequence[torch.Tensor], src: int = 0, group=None) -> List[torch.Tensor]:
    """Rank ``src``'s (a default-group rank) values of ``tensors`` (one
    device) on every rank of ``group`` (None: the default group), in place,
    through one contiguous buffer per dtype. -> the same tensors."""
    tensors = list(tensors)
    if not initialized():
        return tensors
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = _flat(same)
        dist.broadcast(flat, src=src, group=group)
        _unflat(flat, same)
    return tensors


def collective_device() -> torch.device:
    """The device of a host value's collective: the rank's card under NCCL,
    which takes CUDA tensors only; the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
