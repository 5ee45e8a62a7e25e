"""Seeded random weights of a configuration, made on the device.

One ``torch.randn`` of every parameter's numbers together, drawn from a
``torch.Generator`` on the device in the type the model is served in, then
cut into an HF-layout state dict (``reference.model.state_dict_layout``) and
shaped by kind. Weights (embeddings and LoRA's A too) are N(0, 1/fan_in),
fan_in the product of a weight's dimensions after the first, so that every
layer's output is of the order of its input and each token's logits depend
on its context as a trained model's do (at HF's N(0, 0.02) a 768-wide
decoder's logits hardly move with the cache: a stale cache would pass for a
sound one). Biases N(0, 0.1), so that a bias the program drops shows; norm
scales 1 + N(0, 0.1); BatchNorm running means N(0, 0.1) and variances
1 + |N(0, 0.1)|; LoRA's B N(0, 0.02), so that LoRA is live (a fresh LoRA's B
is zero) and smaller than the product it adds to. Both the program and the
reference are given these same tensors.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.model import state_dict_layout

SCALE = {"bias": 0.1, "norm": 0.1, "mean": 0.1, "var": 0.1, "lora_b": 0.02}


def make_state_dict(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    layout = state_dict_layout(cfg)
    total = sum(_numel(shape) for _, shape, _ in layout)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    sd, off = {}, 0
    with torch.no_grad():
        for key, shape, kind in layout:
            n = _numel(shape)
            t = flat[off:off + n].view(shape)
            off += n
            if kind in ("weight", "lora_a"):
                t.mul_(_numel(shape[1:]) ** -0.5)
            elif kind == "norm":
                t.mul_(SCALE[kind]).add_(1.0)
            elif kind == "var":
                t.abs_().mul_(SCALE[kind]).add_(1.0)
            else:
                t.mul_(SCALE[kind])
            sd[key] = t
    return sd


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
