"""Logits warpers for sampled decoding: HF's processor semantics
(temperature -> top-k -> top-p, ``min_tokens_to_keep=1``), the port of
``cxrmate_tpu/generate/logits_process.py``. Filtered logits become
``finfo(float32).min``, as there."""

from __future__ import annotations

import torch

NEG = float(torch.finfo(torch.float32).min)


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    if temperature == 1.0:
        return logits
    return logits / temperature


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits (HF TopKLogitsWarper); logits that tie with
    the k-th are kept too."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG), logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering (HF TopPLogitsWarper, min_tokens_to_keep=1): in
    descending order, keep tokens while the probability mass before them is
    below p; at least the first."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    keep_sorted[..., 0] = True
    num_keep = keep_sorted.sum(dim=-1, keepdim=True)
    thresh = torch.gather(sorted_logits, -1, num_keep - 1)  # the smallest kept logit
    return torch.where(logits < thresh, torch.full_like(logits, NEG), logits)


def warp_logits(logits: torch.Tensor, temperature: float = 1.0, top_k: int = 0,
                top_p: float = 1.0) -> torch.Tensor:
    logits = apply_temperature(logits, temperature)
    logits = apply_top_k(logits, top_k)
    return apply_top_p(logits, top_p)
