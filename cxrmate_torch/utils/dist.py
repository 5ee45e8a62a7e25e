"""The process group as the host code sees it: one process unless
``torch.distributed`` has been initialised."""

from __future__ import annotations

from typing import Any, List

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
