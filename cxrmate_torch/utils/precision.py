"""Precision policy helpers.

Parity mode keeps fp32 end to end with TF32 off (``parity_mode``). Production
mode casts every float parameter and buffer to bfloat16; layer-norm and
softmax statistics and matmul accumulation stay fp32 inside ``ops/layers.py``
and the kernels."""

from __future__ import annotations

import contextlib

import torch
from torch import nn


def cast_floats(module: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Cast every floating-point parameter and buffer (BatchNorm running
    statistics included) to ``dtype`` in place; integer buffers keep theirs."""
    for t in list(module.parameters()) + list(module.buffers()):
        if t.is_floating_point():
            t.data = t.data.to(dtype)
    return module


@contextlib.contextmanager
def parity_mode():
    """Full-fp32 matmuls and convolutions on the card: TF32 off for cuBLAS and
    cuDNN (cuDNN convolutions default to TF32), restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
