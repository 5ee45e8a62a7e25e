"""The process group as the host code sees it: one process unless
``torch.distributed`` has been initialised (``parallel.multihost``).

The collectives below run whenever a group exists, whatever its size (at
world 1 they return their input's values); without one they are the
identity."""

from __future__ import annotations

from typing import Any, List, Sequence

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


def all_gather_list(items: List[Any]) -> List[Any]:
    """Every rank's ``items`` (picklable), concatenated in rank order; the
    list itself in a single process."""
    if world_size() == 1:
        return items
    parts: List[Any] = [None] * world_size()
    dist.all_gather_object(parts, items)
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


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """SUM over the group of every tensor of ``tensors`` (one dtype, one
    device), in place, through one contiguous buffer: one collective for the
    whole list. -> the same tensors."""
    tensors = list(tensors)
    if not initialized() or not tensors:
        return tensors
    flat = _flat(tensors)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    _unflat(flat, tensors)
    return tensors


class _AllReduceSum(torch.autograd.Function):
    """SUM over the group whose backward is the SUM of the gradients (each
    rank's input reaches every rank's output). The semantics of the
    deprecated ``torch.distributed.nn.functional.all_reduce``."""

    @staticmethod
    def forward(ctx, tensor):
        out = tensor.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM)
        return grad


def all_reduce_sum_grad(tensor: torch.Tensor) -> torch.Tensor:
    """SUM over the group of ``tensor``, differentiable: the gradient flows
    back to every rank's input. The tensor itself without a group."""
    return _AllReduceSum.apply(tensor) if initialized() else tensor


def all_reduce_max(value: int) -> int:
    """The largest of every rank's ``value`` (an int)."""
    if not initialized():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def broadcast(tensors: Sequence[torch.Tensor], src: int = 0) -> List[torch.Tensor]:
    """Rank ``src``'s values of ``tensors`` (one device) on every rank, in
    place, through one contiguous buffer per dtype. -> the same tensors."""
    tensors = list(tensors)
    if not initialized():
        return tensors
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        group = [t for t in tensors if t.dtype == dtype]
        flat = _flat(group)
        dist.broadcast(flat, src=src)
        _unflat(flat, group)
    return tensors


def collective_device() -> torch.device:
    """The device of a host value's collective: the rank's card under NCCL,
    which takes CUDA tensors only; the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
