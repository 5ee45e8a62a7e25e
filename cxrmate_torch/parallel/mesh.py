"""The (data x model) layout and the tensor-parallel rules: the port's
counterpart of ``cxrmate_tpu/parallel/mesh.py``.

The JAX package lays a (data x model) mesh over devices; the port runs one
process per rank (``torchrun``), so its mesh is the process group itself.
:func:`make_mesh` checks a task's ``mesh_data``/``mesh_model`` against the
group and lays it out (``utils.dist.set_mesh``): with ``world = data *
model``, rank ``d * model + m`` is model rank ``m`` of data rank ``d``.

Data parallelism: every rank of a data group loads the contiguous row
stripe ``[d * B / D, (d + 1) * B / D)`` of each global batch of ``B`` rows
(``local_row_range``, by data rank: the ranks of a model group hold the same
rows), which the train step copies to its device
(``train.tf_trainer.batch_to_device``, the counterpart of JAX's
``place_batch``); losses, gradients and BatchNorm's moments are reduced
over the data group.

Tensor parallelism (``model`` > 1), the rules of the JAX module's
``decoder_param_specs`` in torch's layout (a JAX ``w`` is ``[in, out]``, a
torch ``weight`` ``[out, in]``, so JAX's ``P(None, "model")`` is torch's
dimension 0): the decoder's vocabulary (word embedding, LM head), its
attention by whole heads (q/k/v and their LoRA ``lora_b`` on the output,
the attention output on the input) and its intermediate (``fc1`` on the
output, ``fc2`` on the input) split over the model group; the rest
replicated, the CvT encoder whole (:func:`shard_dim`). As the JAX module's
``_feasible_spec``, a dimension that does not divide ``model`` stays
replicated. One deviation: the port splits attention by whole heads only,
so where ``num_attention_heads % model != 0`` the attention stays
replicated, where JAX (splitting the hidden width) would cut inside a head;
the numbers are the same, only the placement differs. A model is built
whole, filled (a fresh init, a warm start, a checkpoint), then cut to its
shard (:func:`shard_model`)."""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from cxrmate_torch.utils import dist


def validate_mesh(data: Optional[int] = None, model: int = 1) -> None:
    """Check a task's (data x model) layout against this process group:
    ``model`` divides the world size; ``data`` unset or ``world / model``."""
    world = dist.world_size()
    if model < 1:
        raise ValueError(f"mesh model axis must be >= 1, got {model}")
    if world % model:
        raise ValueError(f"mesh_model={model} does not divide the process group's {world} "
                         f"rank(s): launch a multiple of {model} ranks")
    if data is not None and data * model != world:
        raise ValueError(
            f"mesh_data={data} but the process group has {world} rank(s): the port runs "
            f"one rank per card, so leave mesh_data unset or set it to {world // model}")


def make_mesh(data: Optional[int] = None, model: int = 1) -> dist.Mesh:
    """:func:`validate_mesh`, then the layout's groups (every rank calls it,
    in the same order) -> the layout."""
    validate_mesh(data, model)
    return dist.set_mesh(model)


def local_row_range(global_rows: int) -> Tuple[int, int]:
    """This rank's contiguous ``[start, stop)`` rows of a global batch of
    ``global_rows``: ``[d * B / D, (d + 1) * B / D)`` for data rank ``d`` of
    ``D``. Loaders materialise only this stripe
    (``data.pipeline.batch_iterator(row_shard=...)``)."""
    world = dist.data_size()
    if global_rows % world:
        raise ValueError(f"a global batch of {global_rows} rows does not split over "
                         f"{world} data rank(s)")
    per = global_rows // world
    r = dist.data_rank()
    return r * per, (r + 1) * per


def replicate_tree(model: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and floating buffers on every rank, in place (the
    broadcast DDP makes when it wraps a model), before any sharding. Each
    rank built the same state from the same seed or the same shared-file
    checkpoint; this makes the replicas agree bit for bit before the first
    step. The counterpart of JAX's ``host_copy`` is no function:
    ``torch.save`` copies the state from rank 0's device (gathered over its
    model group, ``ckpt.checkpoints``), and each rank validates with its own
    replica."""
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


# ------------------------------------------------------ the tensor-parallel rules
_DEC = r"decoder\.(?:base_model\.model\.)?"  # a LoRA decoder's PEFT names too
_LAYER = _DEC + r"bert\.encoder\.layer\.\d+\."
# (name pattern, what splits, torch dimension)
RULES = (
    (_DEC + r"bert\.embeddings\.word_embeddings\.weight", "vocab", 0),
    # the untied head's weight, its bias (and the bias's export alias)
    (_DEC + r"cls\.predictions\.(?:decoder\.)?(?:weight|bias)", "vocab", 0),
    (_LAYER + r"(?:attention|crossattention)\.self\.(?:query|key|value)"
              r"(?:\.base_layer)?\.(?:weight|bias)", "heads", 0),
    (_LAYER + r"attention\.self\.(?:query|key)\.lora_B\.default\.weight", "heads", 0),
    (_LAYER + r"(?:attention|crossattention)\.output\.dense\.weight", "heads", 1),
    (_LAYER + r"intermediate\.dense\.(?:weight|bias)", "ffn", 0),
    (_LAYER + r"output\.dense\.weight", "ffn", 1),
)
_RULES = tuple((re.compile(p), kind, dim) for p, kind, dim in RULES)


def splits(config, model: int) -> dict:
    """What splits over ``model`` ranks for a ``BertDecoderConfig``:
    ``{"vocab", "heads", "ffn"}`` -> bool (a dimension that does not divide
    stays whole; attention splits by whole heads)."""
    return {"vocab": config.vocab_size % model == 0,
            "heads": config.num_attention_heads % model == 0,
            "ffn": config.intermediate_size % model == 0}


def shard_dim(name: str, config, model: int) -> Optional[int]:
    """The torch dimension along which the tensor ``name`` (a model
    state-dict key: ``decoder.*``, or a released checkpoint's PEFT name) is
    split over ``model`` ranks of a decoder of ``config``; None where it is
    replicated: every key outside :data:`RULES` (LoRA's ``lora_A``, the
    attention-output and ``fc2`` biases, which are added once after the
    reduction, position and token-type embeddings, every LayerNorm, the
    head's transform, the CvT encoder and its BatchNorm statistics), and
    every key of a kind that does not split (:func:`splits`)."""
    if model == 1:
        return None
    for pattern, kind, dim in _RULES:
        if pattern.fullmatch(name):
            return dim if splits(config, model)[kind] else None
    return None


@dataclasses.dataclass(frozen=True)
class Shard:
    """A decoder's place on a model group (``BertLMHeadModel.tp``): model
    rank ``rank`` of ``size``, the group, and what splits."""

    rank: int
    size: int
    group: Any
    vocab: bool
    heads: bool
    ffn: bool


def shard_model(model: nn.Module) -> nn.Module:
    """Cut a whole ``EncoderDecoder``'s decoder to this rank's shard on the
    layout's model group, in place (each split ``Parameter`` replaced by
    its slice, the whole freed), and mark the decoder with its
    :class:`Shard`. The identity without a model axis. -> ``model``."""
    from cxrmate_torch.ckpt.hf import shard_state_dict

    mesh = dist.mesh()
    if mesh.model == 1:
        return model
    cfg = model.config.decoder
    params = dict(model.named_parameters())
    local = shard_state_dict(params, mesh.model_rank, mesh.model, cfg)
    for name, p in params.items():
        if local[name].shape != p.shape:
            owner, leaf = name.rsplit(".", 1)
            setattr(model.get_submodule(owner), leaf,
                    nn.Parameter(local[name].detach().clone(), requires_grad=p.requires_grad))
    model.decoder.tp = Shard(mesh.model_rank, mesh.model, mesh.model_group,
                             **splits(cfg, mesh.model))
    return model


def model_shard(model: nn.Module) -> Optional[Shard]:
    """The :class:`Shard` of an ``EncoderDecoder``'s decoder; None when it
    is whole."""
    return getattr(getattr(model, "decoder", None), "tp", None)
