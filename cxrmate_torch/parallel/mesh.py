"""The data-parallel layout: the port's counterpart of the data-parallel half
of ``cxrmate_tpu/parallel/mesh.py``.

The JAX package lays a (data x model) mesh over devices; the port runs one
process per card (``torchrun``), so its mesh is the process group itself
(``dist.world_size()`` ranks along ``data``, ``model`` 1), and a task's
``mesh_data``/``mesh_model`` are only checked against it. Every rank holds the whole,
replicated train state and loads the contiguous row stripe
``[r * B / W, (r + 1) * B / W)`` of each global batch of ``B`` rows, which
the train step copies to its device (``train.tf_trainer.batch_to_device``,
the counterpart of JAX's ``place_batch``). The
tensor-parallel rules of the JAX module (its ``model`` axis: vocabulary-,
head- and intermediate-sharded decoder weights) are not ported
(``ROADMAP.md`` queue 1, item 7)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from cxrmate_torch.utils import dist

TP_NOT_PORTED = ("tensor parallelism (mesh_model > 1) is not ported: the port is data-"
                 "parallel over processes only (ROADMAP.md queue 1, item 7: the TP rules)")


def validate_mesh(data: Optional[int] = None, model: int = 1) -> None:
    """Check a task's (data x model) layout against this process group:
    ``data`` unset or equal to the world size; ``model`` 1."""
    if model < 1:
        raise ValueError(f"mesh model axis must be >= 1, got {model}")
    if model > 1:
        raise NotImplementedError(TP_NOT_PORTED)
    world = dist.world_size()
    if data is not None and data != world:
        raise ValueError(
            f"mesh_data={data} but the process group has {world} rank(s): the port runs "
            f"one rank per card, so leave mesh_data unset or set it to {world}")


def local_row_range(global_rows: int) -> Tuple[int, int]:
    """This rank's contiguous ``[start, stop)`` rows of a global batch of
    ``global_rows``: ``[r * B / W, (r + 1) * B / W)``. Loaders materialise
    only this stripe (``data.pipeline.batch_iterator(row_shard=...)``)."""
    world = dist.world_size()
    if global_rows % world:
        raise ValueError(f"a global batch of {global_rows} rows does not split over "
                         f"{world} ranks")
    per = global_rows // world
    r = dist.rank()
    return r * per, (r + 1) * per


def replicate_tree(model: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and floating buffers on every rank, in place (the
    broadcast DDP makes when it wraps a model). Each rank built the same
    state from the same seed or the same shared-file checkpoint; this makes
    the replicas agree bit for bit before the first step. The counterpart of
    JAX's ``host_copy`` is no function: ``torch.save`` copies the state from
    rank 0's device, and each rank validates with its own replica."""
    dist.broadcast([t for t in model.state_dict().values() if t.is_floating_point()])
    return model


def pad_to_multiple(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Pad the leading (batch) axis up to a multiple by repeating the last row
    (``cli.stages.evaluate``: the one-process decode order, cut into whole
    batches that every rank stripes)."""
    b = arr.shape[0]
    pad = (-b) % multiple
    if pad == 0:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)
