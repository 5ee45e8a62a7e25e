"""Self-critical sequence training (SCST, REINFORCE) with the CXR-BERT reward.

The port of ``cxrmate_tpu/train/scst.py``. One step, as the reference's
``scst/gt_prompt.py``:

  1. the frozen encoder runs once (eval mode, output detached);
  2. one decode loop draws the sampled rollout (top-k 50, top-p 1.0,
     temperature 1.0) and the greedy baseline from the same encoder states
     (``generate.decode.scst_rollout_decode``);
  3. both are scored on the host with the CXR-BERT reward; the advantage is
     sample minus baseline;
  4. one teacher-forced re-forward over the sampled sequences, its logits
     re-warped with the sampling's top-k/top-p, gives
     ``sum_t NLL(sampled_t) * advantage`` (pads ignored, batch mean), whose
     gradient updates the decoder (LoRA included; the encoder is frozen,
     ``optim.mask_for_stage(params, "scst")``).

One deviation from the JAX step: the re-warp keeps each sampled token, which
the JAX step masks (an infinite loss) where bf16 rounding ranks it just
outside the top-k in the re-forward; elsewhere the two are the same.

The entry points are those ``cxrmate_tpu/cli/stages.py:834 fit_scst`` calls:
``make_scst_step`` -> ``SCSTTrainer(config, rollout, grad_step, reward_fn,
split_fn).step(state, pixels, prompt_ids, prompt_mask, findings, impression,
generator, prompt_logits_col)``. Under a process group each rank runs its
stripe ``row_range`` of the global batch (by data rank): its rollout
samples the global batch's draws cut to its rows, the loss is its share of
the global mean, the loss and the gradients are summed over the data group
before the update, and the logged reward and baseline are the global
means. Under tensor parallelism the ranks of a model group hold the same
rows and roll them out alike (the gathered logits are the same bytes on
each), and the CXR-BERT reward is replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from cxrmate_torch.configs import EncoderDecoderConfig
from cxrmate_torch.generate import decode as decode_mod
from cxrmate_torch.generate.decode import GenerationConfig
from cxrmate_torch.generate.logits_process import NEG, apply_temperature, warp_logits
from cxrmate_torch.models import encoder_decoder as ed
from cxrmate_torch.ops.decode_attention import resolve_decode_kernel
from cxrmate_torch.ops.layers import RowStripe
from cxrmate_torch.train.optim import AdamW, Mask, zero_frozen_grads
from cxrmate_torch.train.tf_trainer import (TrainState, all_reduce_loss_and_grads,
                                            in_compute_dtype, value_and_grad)
from cxrmate_torch.utils import dist


def reinforce_loss(warped_logits: torch.Tensor, sampled_ids: torch.Tensor,
                   reward: torch.Tensor, pad_id: int,
                   global_rows: Optional[int] = None) -> torch.Tensor:
    """``sum_t NLL(sampled_t) * reward``, mean over the batch, pads ignored
    (scst/gt_prompt.py:211-246). warped_logits [B, T, V], sampled_ids [B, T],
    reward [B] (the advantage). ``global_rows``: the rows are this rank's
    stripe of a global batch of that many rows, and the mean is the global
    batch's: this rank's sum over ``global_rows``, the ranks' shares
    summing to it."""
    logp = torch.log_softmax(warped_logits.float(), dim=-1)
    nll = -logp.gather(-1, sampled_ids[..., None].long())[..., 0]
    mask = (sampled_ids != pad_id).float()
    per_row = (nll * mask).sum(dim=-1) * reward.float()
    if global_rows is None:
        return per_row.mean()
    return per_row.sum() / global_rows


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def make_scst_step(config: EncoderDecoderConfig, gen_cfg_sample: GenerationConfig,
                   gen_cfg_baseline: GenerationConfig, tx: AdamW,
                   trainable_mask: Optional[Mask] = None, pad_id: int = 4,
                   compute_dtype: Optional[torch.dtype] = None,
                   decode_kernel: Optional[str] = None):
    """-> ``(rollout, grad_step)``.

    ``rollout(model, pixels, prompt_ids, prompt_mask, generator,
    prompt_logits_col=None) -> (sampled, baseline, encoder_hidden,
    encoder_mask)``: no gradients, in ``compute_dtype`` (the model's
    parameters and buffers cast per call; the fp32 masters untouched).

    ``grad_step(state, encoder_hidden, encoder_mask, prompt_len, first_col,
    seq, advantage, global_rows=None) -> (state, loss)``: one teacher-forced
    re-forward of ``seq`` (no dropout) in ``compute_dtype``, the gradients of
    the trainable parameters, then ``tx.update`` of the fp32 masters, in
    place. ``global_rows``: the rows are this rank's stripe of a global
    batch of that many rows; the loss is its share of the global mean, and
    the loss and the gradients are summed over the process group before the
    update.

    ``decode_kernel``: the rollout's decode-attention routing spec, resolved
    here (``None`` reads ``CXRMATE_DECODE_KERNEL``). The rollout is
    exploration, and the gradient re-forwards the sampled sequences on the
    exact path whatever the spec, so ``cross-rowgroup-q8`` is admissible here
    (train/scst.py:77-86)."""
    mask = trainable_mask if trainable_mask is not None else tx.trainable_mask
    decode_kernel = resolve_decode_kernel(decode_kernel)
    cfg = gen_cfg_sample

    def _rollout(model, pixels, prompt_ids, generator, prompt_logits_col):
        enc_hidden, enc_mask = ed.encode_images(model, pixels)  # eval mode: the frozen encoder
        sampled, baseline = decode_mod.scst_rollout_decode(
            model, gen_cfg_sample, gen_cfg_baseline, enc_hidden, enc_mask, prompt_ids, None,
            generator, prompt_logits_col=prompt_logits_col, decode_kernel=decode_kernel)
        return sampled, baseline, enc_hidden, enc_mask

    @torch.no_grad()
    def rollout(model, pixels, prompt_ids, prompt_mask, generator: torch.Generator,
                prompt_logits_col: Optional[int] = None):
        del prompt_mask  # the decoder's mask comes from the mask-token rule
        dev = next(model.parameters()).device
        pixels = _as_tensor(pixels, dev, compute_dtype or torch.float32)
        prompt_ids = _as_tensor(prompt_ids, dev, torch.int32)
        return in_compute_dtype(_rollout, model, compute_dtype, pixels, prompt_ids, generator,
                                prompt_logits_col, buffers=True)

    def _loss(model, enc_hidden, enc_mask, prompt_len, first_col, seq, advantage, global_rows):
        b, t = seq.shape
        if cfg.mask_token_id is not None:
            attn = (seq != cfg.mask_token_id).to(torch.int32)
            pos = ed.cumulative_position_ids(attn)
        else:
            attn = torch.ones(b, t, dtype=torch.int32, device=seq.device)
            pos = torch.arange(t, device=seq.device).expand(b, t)
        types = ed.token_ids_to_token_type_ids(seq, cfg.special_token_ids, cfg.sections())
        logits, _ = ed.forward(model, None, seq, decoder_attention_mask=attn,
                               decoder_token_type_ids=types, decoder_position_ids=pos,
                               encoder_outputs=(enc_hidden, enc_mask))
        # the query that issued generated token seq[:, prompt_len + k] sits at
        # column prompt_len + k - 1 for k >= 1; the first one was issued by the
        # prefill at first_col (the true longest column of a bucket-padded prompt)
        gen = torch.cat([logits[:, first_col:first_col + 1], logits[:, prompt_len:t - 1]], dim=1)
        sampled = seq[:, prompt_len:]
        return reinforce_loss(rewarp(gen.float(), sampled), sampled, advantage, pad_id,
                              global_rows)

    def rewarp(gen, sampled):
        """``warp_logits`` of the re-forward's logits, the sampled token kept.
        It was inside the kept set when it was drawn, and in exact arithmetic
        the re-forward ranks it there too (so this is JAX's loss); in bf16 the
        re-forward can rank a token drawn near the top-k boundary just outside
        it, and the masked logit (finfo.min) gives it an NLL of ~3.4e38, the
        loss inf. There its temperature-scaled logit is kept instead."""
        warped = warp_logits(gen, cfg.temperature, cfg.top_k, cfg.top_p)
        drawn = torch.zeros_like(warped, dtype=torch.bool).scatter_(-1, sampled[..., None], True)
        return torch.where(drawn & (warped == NEG), apply_temperature(gen, cfg.temperature),
                           warped)

    def grad_step(state: TrainState, enc_hidden, enc_mask, prompt_len: int, first_col: int,
                  seq, advantage, global_rows: Optional[int] = None
                  ) -> Tuple[TrainState, torch.Tensor]:
        if state.model.config != config:
            raise ValueError("the train state's model was built from another config")
        model = state.model
        dev = next(model.parameters()).device
        args = (enc_hidden.detach(), enc_mask, int(prompt_len), int(first_col),
                _as_tensor(seq, dev).long(), _as_tensor(advantage, dev, torch.float32),
                global_rows)
        loss, grads = value_and_grad(
            model, lambda: in_compute_dtype(_loss, model, compute_dtype, *args), mask)
        if mask is not None:  # the identity here: a frozen parameter gets no gradient
            grads = zero_frozen_grads(grads, mask)
        if global_rows is not None:
            loss, grads = all_reduce_loss_and_grads(loss, grads)
        tx.update(grads, state.opt_state, dict(model.named_parameters()))
        state.step += 1
        return state, loss

    return rollout, grad_step


@dataclasses.dataclass
class SCSTTrainer:
    """The host side of one SCST step (the reward round trip).

    ``reward_fn(predictions, labels) -> np.ndarray [B]``, e.g.
    ``reward.cxrbert.CXRBERTReward``; ``split_fn(token_ids) -> (prompt,
    findings, impression)`` strings, e.g. a closure over
    ``encoder_decoder.split_and_decode_sections``. ``row_range``: this
    rank's stripe ``[lo, hi)`` of the global batch under a process group
    (``parallel.mesh.local_row_range``); ``step`` then takes the stripe's
    rows and the step's (unstriped) generator."""

    config: EncoderDecoderConfig
    rollout: Callable
    grad_step: Callable
    reward_fn: Callable
    split_fn: Callable
    row_range: Optional[Tuple[int, int]] = None

    def step(self, state: TrainState, pixels, prompt_ids, prompt_mask, findings, impression,
             generator: torch.Generator, prompt_logits_col: Optional[int] = None
             ) -> Tuple[TrainState, Dict[str, float], Tuple]:
        """One step on the device of ``state.model``. ``prompt_logits_col``:
        the true longest column when the prompt is bucket-padded beyond the
        batch's longest row; None for batch-longest padding. -> (state, logs
        ``scst_loss``, ``reward`` (the mean advantage, as in JAX) and
        ``baseline``, the baseline's (findings, impression))."""
        p_len = int(prompt_ids.shape[1])
        first_col = p_len - 1 if prompt_logits_col is None else int(prompt_logits_col)
        global_rows = None
        if self.row_range is not None:
            lo, hi = self.row_range
            if len(findings) != hi - lo:
                raise ValueError(f"{len(findings)} rows for the stripe [{lo}, {hi})")
            global_rows = (hi - lo) * dist.data_size()
            generator = RowStripe(generator, lo, hi, global_rows)
        sampled, baseline, enc_hidden, enc_mask = self.rollout(
            state.model, pixels, prompt_ids, prompt_mask, generator, first_col)
        _, s_f, s_i = self.split_fn(sampled.cpu().numpy())
        _, b_f, b_i = self.split_fn(baseline.cpu().numpy())
        labels = [[f"{f} {i}"] for f, i in zip(findings, impression)]
        r_sample = np.asarray(self.reward_fn([f"{f} {i}" for f, i in zip(s_f, s_i)], labels))
        r_base = np.asarray(self.reward_fn([f"{f} {i}" for f, i in zip(b_f, b_i)], labels))
        advantage = (r_sample - r_base).astype(np.float32)
        state, loss = self.grad_step(state, enc_hidden, enc_mask, p_len, first_col, sampled,
                                     advantage, global_rows)
        # the global batch's means: every data rank's rows in rank (= row) order
        adv_all = np.concatenate(dist.all_gather_list([advantage]))
        base_all = np.concatenate(dist.all_gather_list([r_base]))
        logs = {"scst_loss": float(loss), "reward": float(np.mean(adv_all)),
                "baseline": float(np.mean(base_all))}
        return state, logs, (b_f, b_i)
