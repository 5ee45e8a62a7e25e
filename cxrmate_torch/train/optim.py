"""Optimizer and trainable-parameter masks of teacher-forcing training.

The port of ``cxrmate_tpu/train/optim.py``. The reference trains with
``torch.optim.AdamW(lr)`` (betas (0.9, 0.999), eps 1e-8, weight decay 0.01)
and Lightning's gradient accumulation (``accumulated_mbatch_size`` 32 over
micro-batches of ``mbatch_size``). Freezing rules, by stage:

  * ``single`` / ``multi`` TF: everything trains;
  * ``gt_prompt`` TF: only the decoder's LoRA factors train;
  * ``scst``, ``scst_gt``, ``gen_prompt``: the decoder trains (LoRA included),
    the encoder is frozen.

A mask is ``{parameter name: bool}`` over the port's HF parameter names
(``dict(model.named_parameters())``; the tied LM head is the one
word-embedding entry).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch

Mask = Dict[str, bool]


@dataclasses.dataclass
class AdamWState:
    """``count``: AdamW updates applied; ``mini_step``: micro-steps
    accumulated towards the next one; ``mu``/``nu``: the moments and ``acc``
    the running mean of the micro-gradients, per trainable parameter (fp32,
    on the parameter's device)."""

    count: int
    mini_step: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    acc: Dict[str, torch.Tensor]


class AdamW:
    """``optax.adamw`` under ``optax.masked`` and ``optax.MultiSteps``, as
    ``cxrmate_tpu/train/optim.py:21 adamw`` composes them, on a dict of
    parameters updated in place:

      * every micro-step folds its gradients into a running mean (optax's
        ``acc + (g - acc) / (n + 1)``); every ``accumulate_steps``-th applies
        AdamW to the mean and starts a new one;
      * AdamW: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
        bias-corrected, ``u = mu_hat / (sqrt(nu_hat) + eps) + wd * p``,
        ``p -= lr * u``;
      * a parameter outside ``trainable_mask`` has no state and is never
        touched (no weight decay either), as torch's ``requires_grad=False``
        leaves it.
    """

    def __init__(self, lr: float, weight_decay: float = 0.01, accumulate_steps: int = 1,
                 trainable_mask: Optional[Mask] = None, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        if accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got {accumulate_steps}")
        self.lr, self.weight_decay, self.accumulate_steps = lr, weight_decay, accumulate_steps
        self.trainable_mask = trainable_mask
        self.b1, self.b2, self.eps = b1, b2, eps

    def trains(self, name: str) -> bool:
        return self.trainable_mask is None or bool(self.trainable_mask[name])

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        zeros = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()
                 if self.trains(n)}
        acc = ({n: z.clone() for n, z in zeros.items()} if self.accumulate_steps > 1 else {})
        return AdamWState(0, 0, zeros, {n: z.clone() for n, z in zeros.items()}, acc)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
               params: Mapping[str, torch.Tensor]) -> bool:
        """Take one micro-step's gradients (one per trainable parameter);
        returns True if this micro-step applied an update to ``params``.
        Multi-tensor (``torch._foreach_*``) ops, a few launches for all
        parameters; elementwise, so the same values as one tensor at a time."""
        if set(grads) != set(state.mu):
            raise ValueError("grads must hold exactly the trainable parameters: "
                             f"{sorted(set(grads) ^ set(state.mu))[:4]} differ")
        names = list(state.mu)
        if not names:
            return False
        g = [grads[n].float() for n in names]
        if self.accumulate_steps > 1:
            acc = [state.acc[n] for n in names]
            step = torch._foreach_sub(g, acc)
            torch._foreach_div_(step, state.mini_step + 1)
            torch._foreach_add_(acc, step)
            if state.mini_step < self.accumulate_steps - 1:
                state.mini_step += 1
                return False
            state.mini_step, g = 0, acc
        state.count += 1
        mu, nu = [state.mu[n] for n in names], [state.nu[n] for n in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2))
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** state.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(torch._foreach_div(mu, 1.0 - self.b1 ** state.count), denom)
        p = [params[n] for n in names]
        pf = [x.float() for x in p]  # the fp32 masters themselves; a copy otherwise
        torch._foreach_add_(u, torch._foreach_mul(pf, self.weight_decay))
        torch._foreach_mul_(u, self.lr)
        torch._foreach_sub_(pf, u)
        for x, y in zip(p, pf):
            if x is not y:
                x.copy_(y)
        if self.accumulate_steps > 1:
            torch._foreach_zero_(g)  # the accumulated mean, spent
        return True


def adamw(lr: float, weight_decay: float = 0.01, accumulate_steps: int = 1,
          trainable_mask: Optional[Mask] = None) -> AdamW:
    """AdamW with optional freezing and gradient accumulation (the JAX
    package's signature). Freezing lives in the optimizer: decoupled weight
    decay would move a frozen parameter whose gradient is merely zero."""
    return AdamW(lr, weight_decay, accumulate_steps, trainable_mask)


def mask_all(params: Mapping[str, torch.Tensor]) -> Mask:
    return {n: True for n in params}


def mask_none(params: Mapping[str, torch.Tensor]) -> Mask:
    return {n: False for n in params}


def mask_lora_only(params: Mapping[str, torch.Tensor]) -> Mask:
    """gt-prompt TF: only the LoRA factors (PEFT's ``lora_A``/``lora_B``) train."""
    return {n: (".lora_A." in n or ".lora_B." in n) for n in params}


def mask_decoder_only(params: Mapping[str, torch.Tensor]) -> Mask:
    """SCST: the decoder (LoRA included) trains, the encoder is frozen."""
    return {n: n.startswith("decoder.") for n in params}


def mask_for_stage(params: Mapping[str, torch.Tensor], stage: str) -> Mask:
    if stage in ("single", "multi"):
        return mask_all(params)
    if stage == "gt_prompt":
        return mask_lora_only(params)
    if stage in ("scst", "scst_gt", "gen_prompt"):
        return mask_decoder_only(params)
    raise ValueError(stage)


def zero_frozen_grads(grads: Mapping[str, torch.Tensor], mask: Mask) -> Dict[str, torch.Tensor]:
    """Zero the gradients of frozen parameters."""
    return {n: g if mask[n] else torch.zeros_like(g) for n, g in grads.items()}
