"""Neural-net primitives and HF-named parameter holders.

The functions mirror ``cxrmate_tpu/ops/layers.py`` op for op, in PyTorch's
layouts: linear weights are ``[out, in]`` and convolutions NCHW with OIHW
kernels, as HF checkpoints store them. Matmuls accumulate in fp32 and cast the
output back to the input dtype; normalisation statistics are fp32.

The ``nn.Module`` holders (:class:`Linear`, :class:`LayerNorm`, ...) only own
parameters under HF's names, so an HF state dict loads with
``load_state_dict``. Their storage is left uninitialised: a model is filled by
``load_state_dict`` or by ``models.api.random_init``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


# ------------------------------------------------------------------ functions
def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias``. fp32 stays fp32; in bf16 cuBLAS accumulates in
    fp32 and adds the bias in its fp32 epilogue before the one rounding."""
    return F.linear(x, weight, bias)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis, output in x's dtype. PyTorch computes the
    statistics and the affine step in fp32 for bf16 input and rounds once."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def batch_norm_infer(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """BatchNorm over NCHW channels with running statistics, in fp32."""
    y = F.batch_norm(x.float(), running_mean.float(), running_var.float(),
                     weight.float(), bias.float(), False, 0.0, eps)
    return y.to(x.dtype)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0, groups: int = 1) -> torch.Tensor:
    """NCHW convolution with an OIHW kernel and symmetric padding."""
    return F.conv2d(x, weight, bias, stride=stride, padding=padding, groups=groups)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as both HF CvT and BERT use."""
    return F.gelu(x)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              additive_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eager-order attention on [B, H, T, Dh]: fp32 scores, x scale, + mask,
    softmax, probs cast to the input dtype, fp32 context, cast back."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if additive_mask is not None:
        scores = scores + additive_mask.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.matmul(probs.float(), v.float())
    return ctx.to(q.dtype)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, D] -> [B, H, T, Dh]"""
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, Dh] -> [B, T, D]"""
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


# -------------------------------------------------------- parameter holders
def _empty(*shape, **kw) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, **kw), requires_grad=False)


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True, **kw):
        super().__init__()
        self.weight = _empty(out_features, in_features, **kw)
        self.bias = _empty(out_features, **kw) if bias else None

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, **kw):
        super().__init__()
        self.eps = eps
        self.weight = _empty(dim, **kw)
        self.bias = _empty(dim, **kw)

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class Conv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, padding: int,
                 groups: int = 1, bias: bool = True, **kw):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = _empty(out_ch, in_ch // groups, kernel, kernel, **kw)
        self.bias = _empty(out_ch, **kw) if bias else None

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding, self.groups)


class BatchNorm2d(nn.Module):
    """Inference-only BatchNorm. HF's ``num_batches_tracked`` counter is not
    held: it plays no part in inference (``ckpt.hf`` drops it on load)."""

    def __init__(self, dim: int, eps: float, **kw):
        super().__init__()
        self.eps = eps
        self.weight = _empty(dim, **kw)
        self.bias = _empty(dim, **kw)
        self.register_buffer("running_mean", torch.empty(dim, **kw))
        self.register_buffer("running_var", torch.empty(dim, **kw))

    def forward(self, x):
        return batch_norm_infer(x, self.weight, self.bias, self.running_mean,
                                self.running_var, self.eps)


class Embedding(nn.Module):
    def __init__(self, num: int, dim: int, **kw):
        super().__init__()
        self.weight = _empty(num, dim, **kw)

    def forward(self, ids):
        return F.embedding(ids, self.weight)
