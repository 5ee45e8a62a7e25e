"""Teacher-forcing training: loss, train step, batch builder and per-step
random generators.

The port of ``cxrmate_tpu/train/tf_trainer.py``. Semantics of the reference
steps:

  * single/multi (single.py:449-475, multi.py:182-210): cross-entropy over
    the logits with ``ignore_index=pad`` on the shift-one labels; token types
    from the SEP rule;
  * gt-prompt (gt_prompt.py:186-249): prompt + report concatenation,
    cumulative position ids, [0, 1, 0, 1] section types split at
    [PMT-SEP]/BOS/SEP, labels left-padded over the prompt.

The entry points are those ``cxrmate_tpu/cli/stages.py:708 fit`` calls:
``optim.mask_for_stage`` -> ``optim.adamw`` -> :func:`create_train_state` ->
:func:`make_train_step` -> :func:`build_tf_batch` -> ``step(state, batch,
train_generator(trial, global_step))``. PyTorch runs eagerly: the step is a
plain function, and it updates the state in place (the JAX step returns a new
one).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from cxrmate_torch.configs import EncoderDecoderConfig
from cxrmate_torch.models import encoder_decoder as ed
from cxrmate_torch.models.cvt import batch_stats
from cxrmate_torch.ops.layers import RowStripe
from cxrmate_torch.train.optim import AdamW, AdamWState, Mask
from cxrmate_torch.utils import dist


@dataclasses.dataclass
class TrainState:
    """``model`` holds the fp32 master parameters and the BatchNorm running
    statistics (the JAX state's ``params`` and ``batch_stats``); ``step``
    counts micro-steps."""

    model: ed.EncoderDecoder
    opt_state: AdamWState
    step: int = 0


def create_train_state(model: ed.EncoderDecoder, tx: AdamW) -> TrainState:
    return TrainState(model=model, opt_state=tx.init(dict(model.named_parameters())))


def cross_entropy_ignore_pad(logits: torch.Tensor, labels: torch.Tensor,
                             pad_id: int, over_group: bool = False) -> torch.Tensor:
    """torch ``F.cross_entropy(..., ignore_index=pad)``: the mean NLL over the
    non-pad labels, from fp32 logits.

    ``over_group``: the rows are this rank's stripe of a batch split over
    the data group, and the mean is the global batch's, as the JAX loss
    over the global array: this rank's NLL sum over the non-pad count of
    every data rank (all-reduced). The data ranks' losses, and their
    gradients, then sum to the global ones
    (:func:`all_reduce_loss_and_grads`). Under tensor parallelism the
    logits are the whole vocabulary's on every rank of a model group
    (``models.bert``), so each computes this loss alike."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    mask = (labels != pad_id).float()
    count = mask.sum()
    if over_group:
        dist.all_reduce_sum([count], dist.data_group())
    return (nll * mask).sum() / count.clamp(min=1.0)


def all_reduce_loss_and_grads(loss: torch.Tensor, grads: Dict[str, torch.Tensor]
                              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The SUM over the data group of a micro-step's loss and of each
    trainable gradient, in place and in one collective, before
    the optimizer accumulates them: every rank then holds the global
    batch's loss and gradients (of its model shard: the data group is the
    ranks that hold the same one), and its AdamW state stays a replica of
    theirs. The identity without a group. AdamW updates each shard
    elementwise and clips no global norm, so nothing is reduced over the
    model group. (``nn.parallel.DistributedDataParallel`` would not do it
    here: its reducer hooks the accumulation into ``.grad``, which
    ``torch.autograd.grad`` through ``functional_call`` never runs.)"""
    dist.all_reduce_sum([loss.view(1)] + list(grads.values()), dist.data_group())
    return loss, grads


def batch_to_device(batch: Dict, device: torch.device, compute_dtype) -> Dict[str, torch.Tensor]:
    """numpy or tensors -> tensors on ``device``: floats (the pixels) in the
    compute dtype, integers as int64."""
    out = {}
    for key, val in batch.items():
        x = val if torch.is_tensor(val) else torch.from_numpy(np.asarray(val))
        x = x.to(compute_dtype or torch.float32) if x.is_floating_point() else x.long()
        out[key] = x.to(device)
    return out


class _Apply(nn.Module):
    """``fn(model, ...)`` as a module's forward, for ``torch.func.functional_call``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn, *args, **kwargs):
        return fn(self.model, *args, **kwargs)


def in_compute_dtype(fn: Callable, model: nn.Module, compute_dtype: Optional[torch.dtype],
                     *args, buffers: bool = False, **kwargs):
    """``fn(model, *args, **kwargs)`` over copies of the model's parameters
    (and, with ``buffers``, of its floating buffers) cast to ``compute_dtype``:
    mixed precision as the JAX steps cast their variables. The fp32 masters
    are left as they are, and each gradient flows back through its cast
    (arriving fp32). ``compute_dtype`` None runs on the masters themselves."""
    if compute_dtype is None:
        return fn(model, *args, **kwargs)
    tensors = dict(model.named_parameters())
    if buffers:
        tensors.update((n, b) for n, b in model.named_buffers() if b.is_floating_point())
    cast = {f"model.{n}": t.to(compute_dtype) for n, t in tensors.items()}
    return torch.func.functional_call(_Apply(model), cast, (fn,) + args, kwargs)


def value_and_grad(model: nn.Module, loss_fn: Callable[[], torch.Tensor],
                   trainable_mask: Optional[Mask] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``loss_fn()`` under autograd -> (the loss, detached; the gradients of
    the trainable parameters by name). Only those require grad, so the
    backward holds nothing for a frozen parameter."""
    params = dict(model.named_parameters())
    names = [n for n in params if trainable_mask is None or trainable_mask[n]]
    for n, p in params.items():
        p.requires_grad_(n in names)
    with torch.enable_grad():
        loss = loss_fn()
        grads = torch.autograd.grad(loss, [params[n] for n in names]) if names else ()
    return loss.detach(), dict(zip(names, grads))


def loss_and_grads(model: ed.EncoderDecoder, batch: Dict,
                   generator: Optional[torch.Generator] = None, *, pad_id: int = 4,
                   compute_dtype: Optional[torch.dtype] = None,
                   trainable_mask: Optional[Mask] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One micro-step's loss and the fp32 gradients of the trainable
    parameters; the encoder's BatchNorm running statistics are updated in
    place (train mode).

    ``compute_dtype`` (e.g. bf16) is mixed precision, as the JAX step's: the
    forward and backward run on the parameters cast to ``compute_dtype``
    (:func:`in_compute_dtype`); the BatchNorm running statistics enter
    rounded to ``compute_dtype`` and are stored back fp32 (the JAX step casts
    them the same way, tf_trainer.py:84 and :108); the loss is computed from
    fp32 logits. ``generator`` None turns dropout and drop-path off
    (BatchNorm still uses the batch's statistics). An
    ``ops.layers.RowStripe`` marks the batch as this rank's stripe of a
    global batch: the draws, BatchNorm's moments and the loss's mean are
    the global batch's (the caller sums the ranks' losses and gradients,
    :func:`all_reduce_loss_and_grads`)."""
    b = batch_to_device(batch, next(model.parameters()).device, compute_dtype)
    kw = dict(decoder_attention_mask=b["decoder_attention_mask"],
              decoder_token_type_ids=b["decoder_token_type_ids"],
              decoder_position_ids=b.get("decoder_position_ids"), train=True,
              generator=generator)
    if compute_dtype is not None:
        with torch.no_grad():
            for buf in batch_stats(model.encoder).values():
                buf.copy_(buf.to(compute_dtype))

    def loss_fn():
        logits, _ = in_compute_dtype(ed.forward, model, compute_dtype, b["pixel_values"],
                                     b["decoder_input_ids"], **kw)
        return cross_entropy_ignore_pad(logits, b["label_ids"], pad_id,
                                        over_group=isinstance(generator, RowStripe))

    return value_and_grad(model, loss_fn, trainable_mask)


def make_train_step(config: EncoderDecoderConfig, tx: AdamW,
                    trainable_mask: Optional[Mask] = None, pad_id: int = 4,
                    compute_dtype: Optional[torch.dtype] = None):
    """The TF train step: ``step(state, batch, generator) -> (state, loss)``,
    :func:`loss_and_grads` then ``tx.update`` (which applies AdamW every
    ``accumulate_steps``-th micro-step), in place on ``state``.

    ``batch``: 'pixel_values', 'decoder_input_ids', 'decoder_attention_mask',
    'decoder_token_type_ids', optional 'decoder_position_ids', 'label_ids'
    (numpy arrays or tensors, as :func:`build_tf_batch` gives them).
    ``trainable_mask`` defaults to the optimizer's. A ``generator`` that is
    an ``ops.layers.RowStripe`` (``train_generator(..., row_range=...)``)
    makes the step the global batch's over the process group."""
    mask = trainable_mask if trainable_mask is not None else tx.trainable_mask

    def train_step(state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, torch.Tensor]:
        if state.model.config != config:
            raise ValueError("the train state's model was built from another config")
        loss, grads = loss_and_grads(state.model, batch, generator, pad_id=pad_id,
                                     compute_dtype=compute_dtype, trainable_mask=mask)
        if isinstance(generator, RowStripe):
            loss, grads = all_reduce_loss_and_grads(loss, grads)
        tx.update(grads, state.opt_state, dict(state.model.named_parameters()))
        state.step += 1
        return state, loss

    return train_step


def train_generator(trial: int, global_step: int, device="cuda",
                    row_range: Optional[Tuple[int, int]] = None):
    """The dropout generator of micro-step ``global_step`` of trial ``trial``:
    the counterpart of ``fold_in(_train_base_rng(trial), global_step)``
    (``cxrmate_tpu/cli/stages.py:678``, :808), so a resumed run draws what the
    uninterrupted run drew. The seed mixes both numbers (numpy's
    ``SeedSequence``); the draws are not the JAX package's.

    ``row_range`` (this rank's stripe ``[lo, hi)`` of a global batch split
    evenly over the data group): an ``ops.layers.RowStripe`` over the
    same generator, whose draws are the global batch's cut to the stripe, so
    every row draws what it draws in one process."""
    seed = int(np.random.SeedSequence([trial, global_step]).generate_state(1, np.uint64)[0])
    gen = torch.Generator(device=device).manual_seed(seed)
    if row_range is None:
        return gen
    lo, hi = row_range
    return RowStripe(gen, lo, hi, (hi - lo) * dist.data_size())


# --------------------------------------------------------------- batch assembly
def build_tf_batch(tokenizer, config: EncoderDecoderConfig, images: np.ndarray,
                   findings: Sequence[str], impression: Sequence[str],
                   previous_findings: Optional[Sequence[Optional[str]]] = None,
                   previous_impression: Optional[Sequence[Optional[str]]] = None,
                   pad_report_to: Optional[int] = None,
                   pad_prompt_to: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Host-side batch assembly of the reference training steps (numpy).
    ``pad_report_to``/``pad_prompt_to`` pad the 'longest' widths up to fixed
    ones."""
    tok = ed.tokenize_report_teacher_forcing(findings, impression, tokenizer,
                                             config.decoder_max_len)
    ids, mask, labels = tok["decoder_input_ids"], tok["decoder_attention_mask"], tok["label_ids"]
    if pad_report_to:
        ids = _pad_np(ids, pad_report_to, tokenizer.pad_token_id)
        mask = _pad_np(mask, pad_report_to, 0)
        labels = _pad_np(labels, pad_report_to, tokenizer.pad_token_id)

    if config.variant != "longitudinal":
        types = ed.token_ids_to_token_type_ids(torch.from_numpy(ids),
                                               [tokenizer.sep_token_id]).numpy()
        return {"pixel_values": images, "decoder_input_ids": ids,
                "decoder_attention_mask": mask, "decoder_token_type_ids": types,
                "label_ids": labels}

    prompt = ed.tokenize_prompt(previous_findings, previous_impression, tokenizer,
                                config.prompt_max_len)
    p_ids, p_mask = prompt["input_ids"], prompt["attention_mask"]
    if pad_prompt_to:
        p_ids = _pad_np(p_ids, pad_prompt_to, tokenizer.pad_token_id)
        p_mask = _pad_np(p_mask, pad_prompt_to, 0)
    full_ids = np.concatenate([p_ids, ids], axis=1)
    full_mask = np.concatenate([p_mask, mask], axis=1)
    pos = np.maximum(np.cumsum(full_mask, axis=1) - 1, 0)
    types = ed.token_ids_to_token_type_ids(
        torch.from_numpy(full_ids),
        [tokenizer.vocab["[PMT-SEP]"], tokenizer.bos_token_id, tokenizer.sep_token_id],
        [0, 1, 0, 1]).numpy()
    # labels left-padded over the prompt (gt_prompt.py:233-238)
    full_labels = np.full(full_ids.shape, tokenizer.pad_token_id, dtype=labels.dtype)
    full_labels[:, p_ids.shape[1]:] = labels
    return {"pixel_values": images, "decoder_input_ids": full_ids,
            "decoder_attention_mask": full_mask, "decoder_token_type_ids": types,
            "decoder_position_ids": pos, "label_ids": full_labels}


def _pad_np(a: np.ndarray, width: int, fill) -> np.ndarray:
    if a.shape[1] >= width:
        return a
    out = np.full((a.shape[0], width), fill, dtype=a.dtype)
    out[:, :a.shape[1]] = a
    return out
