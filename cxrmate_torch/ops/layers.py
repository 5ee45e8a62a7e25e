"""Neural-net primitives and HF-named parameter holders.

The functions mirror ``cxrmate_tpu/ops/layers.py`` op for op, in PyTorch's
layouts: linear weights are ``[out, in]`` and convolutions NCHW with OIHW
kernels, as HF checkpoints store them. Matmuls accumulate in fp32 and cast the
output back to the input dtype; normalisation statistics are fp32.

The ``nn.Module`` holders (:class:`Linear`, :class:`LayerNorm`, ...) only own
parameters under HF's names, so an HF state dict loads with
``load_state_dict``. Their storage is left uninitialised: a model is filled by
``load_state_dict`` or by ``models.api.random_init``. Parameters are created
with ``requires_grad`` off, for serving; a trainer turns it on for the ones it
trains (``train.tf_trainer.loss_and_grads``).

Train-only randomness (:func:`dropout`, LoRA's input dropout, attention-probs
dropout, CvT's drop-path) draws from an explicit ``torch.Generator``; without
one (``None``) each is the identity, as ``rng=None`` is in the JAX package.
A :class:`RowStripe` in its place draws for the global batch and keeps one
rank's rows (data parallelism over processes); a :class:`HeadSlice` draws for
every attention head and keeps one model rank's (tensor parallelism).

With ``over_group`` (which CvT passes where its generator is a
:class:`RowStripe`), :func:`batch_norm_train` takes the moments of the
global batch over the process group (``utils.dist``), as the JAX package's
does over a mesh that spans processes; without it every op stays local.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from cxrmate_torch.utils import dist


@dataclasses.dataclass(frozen=True)
class RowStripe:
    """A generator for rows ``[lo, hi)`` of a global batch of ``rows`` rows
    split over the process group: every draw is taken at the global batch's
    shape from ``generator`` and cut to this stripe's rows, so a row's draws
    do not depend on how the batch is split over ranks (every rank's
    ``generator`` is seeded alike). A tensor of ``k * (hi - lo)`` leading
    rows (CvT folds a study's ``k`` images into the batch axis, study-major)
    keeps rows ``k*lo:k*hi`` of a draw of ``k * rows``. ``generator`` None:
    no draws (dropout and drop-path off), the rows still a stripe whose
    BatchNorm moments and loss are the global batch's."""

    generator: Optional[torch.Generator]
    lo: int
    hi: int
    rows: int


@dataclasses.dataclass(frozen=True)
class HeadSlice:
    """A generator for heads ``[lo, hi)`` (axis 1) of ``heads`` attention
    heads split over a model group: every draw is taken over all the heads
    from ``generator`` (a ``torch.Generator`` or a :class:`RowStripe`) and
    cut to this slice, so a head's draws do not depend on how the heads are
    split over ranks (every rank of the group draws alike)."""

    generator: Union[torch.Generator, RowStripe]
    lo: int
    hi: int
    heads: int


Generator = Union[torch.Generator, RowStripe, HeadSlice]


def drawing(generator: Optional[Generator]) -> bool:
    """Whether ``generator`` draws: a ``torch.Generator``, or a
    :class:`RowStripe` or :class:`HeadSlice` over one."""
    if isinstance(generator, (RowStripe, HeadSlice)):
        return drawing(generator.generator)
    return generator is not None


def draw(generator: Generator, shape: Sequence[int],
         sample: Callable[[Tuple[int, ...], torch.Generator], torch.Tensor]) -> torch.Tensor:
    """``sample(shape, generator)``; for a :class:`RowStripe`, this stripe's
    rows of ``sample(global shape, stripe.generator)``; for a
    :class:`HeadSlice`, its heads of the draw over every head."""
    shape = tuple(shape)
    if isinstance(generator, HeadSlice):
        full = draw(generator.generator, shape[:1] + (generator.heads,) + shape[2:], sample)
        return full[:, generator.lo:generator.hi]
    if not isinstance(generator, RowStripe):
        return sample(shape, generator)
    local = generator.hi - generator.lo
    if shape[0] % local:
        raise ValueError(f"a draw of {shape[0]} rows for a stripe of {local} rows")
    k = shape[0] // local
    full = sample((k * generator.rows,) + shape[1:], generator.generator)
    return full[k * generator.lo:k * generator.hi]


# ------------------------------------------------------------------ functions
def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias``. fp32 stays fp32; in bf16 the product
    accumulates in fp32 and the bias is added in fp32 before the one rounding,
    as ``cxrmate_tpu/ops/layers.py:22`` does. ``F.linear`` does that (addmm)
    for a 2-D or a contiguous input, but runs a non-contiguous one of three or
    more dims (CvT's tokens of a convolution output) through matmul and a
    separate bias add, rounding twice; such an input is made contiguous first,
    the copy matmul would make anyway."""
    if bias is not None and x.dim() > 2 and not x.is_contiguous():
        x = x.contiguous()
    return F.linear(x, weight, bias)


def lora_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                lora_a: Optional[torch.Tensor], lora_b: Optional[torch.Tensor],
                scaling: float, dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None,
                base_input: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """Linear with a LoRA delta (PEFT ``lora.Linear``): ``x W^T + b + scaling
    * (drop(x) A^T) B^T`` with ``lora_a`` [r, in] and ``lora_b`` [out, r] as
    PEFT stores them; the dropout, on the LoRA branch's input only, runs in
    training (a ``generator``). The LoRA branch accumulates in fp32 and is
    rounded to the output dtype before the add, as
    ``cxrmate_tpu/ops/layers.py:29`` does.

    Tensor parallelism (``W``, ``b`` and ``lora_b`` split along the output
    over the model group ``group``, ``lora_a`` replicated):
    ``base_input`` is x through ``utils.dist.copy_to_group`` (the base
    product's input), and the rank-r product ``drop(x) A^T`` goes through
    ``copy_to_group`` before ``lora_b``, so that ``lora_a`` and x receive
    the whole gradient on every rank."""
    y = linear(x if base_input is None else base_input, weight, bias)
    if lora_a is None:
        return y
    xa = dropout(x, dropout_rate, generator)
    rank_r = dist.copy_to_group(F.linear(xa.float(), lora_a.float()), group)
    delta = F.linear(rank_r, lora_b.float())
    return y + (scaling * delta).to(y.dtype)


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


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
                     momentum: float, over_group: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BatchNorm over NCHW channels with the batch's statistics, in fp32 ->
    (y in x's dtype, new running mean, new running var), as
    ``cxrmate_tpu/ops/layers.py:68``: the normalisation uses the biased
    variance, the running update ``(1 - momentum) * old + momentum * batch``
    the unbiased one; the new statistics are fp32 and carry no gradient.

    ``over_group``: x is this rank's stripe of a batch split over the
    data group (``utils.dist.data_group``), and the moments are the global
    batch's: the per-channel sum and count, then the sum of squares about
    the global mean, each summed over the data ranks by an all-reduce that
    carries the gradient back to every rank's rows (the formula of one
    process, in two collectives; the identity without a group). The ranks
    of a model group hold the same rows and the same replicated encoder."""
    xf = x.float()
    n = x.numel() // x.shape[1]
    if over_group:
        group = dist.data_group()
        sums = dist.all_reduce_sum_grad(torch.cat([xf.sum(dim=(0, 2, 3)),
                                                   xf.new_full((1,), float(n))]), group)
        n = sums[-1].detach()  # on the device: no host sync per call
        mean = sums[:-1] / n
        centred = xf - mean[None, :, None, None]
        var = dist.all_reduce_sum_grad(centred.square().sum(dim=(0, 2, 3)), group) / n
        correction = n / (n - 1).clamp(min=1.0)
    else:
        mean = xf.mean(dim=(0, 2, 3))
        centred = xf - mean[None, :, None, None]
        var = centred.square().mean(dim=(0, 2, 3))
        correction = n / max(n - 1, 1)
    with torch.no_grad():
        unbiased = var * correction
        new_mean = (1 - momentum) * running_mean.float() + momentum * mean
        new_var = (1 - momentum) * running_var.float() + momentum * unbiased
    y = centred * torch.rsqrt(var + eps)[None, :, None, None]
    y = y * weight.float()[None, :, None, None] + bias.float()[None, :, None, None]
    return y.to(x.dtype), new_mean, new_var


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0, groups: int = 1) -> torch.Tensor:
    """NCHW convolution with an OIHW kernel and symmetric padding."""
    return F.conv2d(x, weight, bias, stride=stride, padding=padding, groups=groups)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as both HF CvT and BERT use."""
    return F.gelu(x)


def dropout(x: torch.Tensor, rate: float, generator: Optional[Generator]) -> torch.Tensor:
    """Inverted dropout: keep each element with probability ``1 - rate``
    (a uniform fp32 draw below it, the Bernoulli of ``jax.random.bernoulli``)
    and scale the kept ones by ``1 / (1 - rate)`` in x's dtype. The identity
    for ``rate == 0`` or ``generator is None``. The draws are not the JAX
    package's (another generator)."""
    if rate == 0.0 or not drawing(generator):
        return x
    keep = 1.0 - rate
    mask = draw(generator, x.shape,
                lambda shape, g: torch.rand(shape, generator=g, device=x.device)) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              additive_mask: Optional[torch.Tensor] = None, probs_dropout: float = 0.0,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Eager-order attention on [B, H, T, Dh]: fp32 scores, x scale, + mask,
    softmax, probs cast to the input dtype (then, in training, dropped out
    with ``probs_dropout``), fp32 context, cast back."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if additive_mask is not None:
        scores = scores + additive_mask.float()
    probs = dropout(torch.softmax(scores, dim=-1).to(q.dtype), probs_dropout, generator)
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


class LoraLinear(nn.Module):
    """A linear wrapped by PEFT's LoRA, under PEFT's key names:
    ``base_layer.{weight,bias}``, ``lora_A.default.weight`` [r, in] and
    ``lora_B.default.weight`` [out, r]."""

    def __init__(self, in_features: int, out_features: int, r: int, scaling: float,
                 dropout: float = 0.0, **kw):
        super().__init__()
        self.scaling, self.dropout = scaling, dropout
        self.base_layer = Linear(in_features, out_features, **kw)
        self.lora_A = nn.ModuleDict({"default": Linear(in_features, r, bias=False, **kw)})
        self.lora_B = nn.ModuleDict({"default": Linear(r, out_features, bias=False, **kw)})

    def forward(self, x, generator: Optional[torch.Generator] = None,
                base_input: Optional[torch.Tensor] = None, group=None):
        return lora_linear(x, self.base_layer.weight, self.base_layer.bias,
                           self.lora_A["default"].weight, self.lora_B["default"].weight,
                           self.scaling, self.dropout, generator, base_input, group)


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
    """BatchNorm with HF's buffers. ``train=False`` normalises with the
    running statistics; ``train=True`` with the batch's, and then updates the
    running buffers in place (:func:`batch_norm_train`) and adds one to
    ``num_batches_tracked``, as torch's BatchNorm2d does in training (with a
    set momentum the counter is bookkeeping only). ``over_group``: the
    global batch's moments (:func:`batch_norm_train`)."""

    def __init__(self, dim: int, eps: float, momentum: float = 0.1, device=None, dtype=None):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = _empty(dim, device=device, dtype=dtype)
        self.bias = _empty(dim, device=device, dtype=dtype)
        self.register_buffer("running_mean", torch.empty(dim, device=device, dtype=dtype))
        self.register_buffer("running_var", torch.empty(dim, device=device, dtype=dtype))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    def forward(self, x, train: bool = False, over_group: bool = False):
        if not train:
            return batch_norm_infer(x, self.weight, self.bias, self.running_mean,
                                    self.running_var, self.eps)
        y, mean, var = batch_norm_train(x, self.weight, self.bias, self.running_mean,
                                        self.running_var, self.eps, self.momentum,
                                        over_group)
        with torch.no_grad():
            self.running_mean.copy_(mean)
            self.running_var.copy_(var)
            self.num_batches_tracked.add_(1)
        return y


class Embedding(nn.Module):
    def __init__(self, num: int, dim: int, **kw):
        super().__init__()
        self.weight = _empty(num, dim, **kw)

    def forward(self, ids):
        return F.embedding(ids, self.weight)
