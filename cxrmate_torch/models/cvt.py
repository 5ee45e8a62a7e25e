"""CvT (Convolutional vision Transformer) encoder + projection head.

The port of ``cxrmate_tpu/models/cvt.py``: HF ``CvtModel`` behaviour with the
cxrmate projection head, in eval mode (serving) and train mode. Parameters
are held under HF's names (:class:`CvtWithProjectionHead` loads a
``CvtWithProjectionHead`` state dict);
the forward functions are plain functions over those modules. Layout is NCHW
between stages and [B, T, D] tokens inside them, as in HF.

HF quirks kept for checkpoint parity:
  * attention scale is ``embed_dim ** -0.5`` (the stage width, not head_dim);
  * internal LayerNorms use eps 1e-5, the projection head the config eps 1e-12;
  * the cls token exists in the last stage only;
  * the stochastic-depth rate of every layer of stage ``s`` is
    ``linspace(0, rate_s, depth_s)[s]`` (HF indexes the schedule by stage);
  * the second residual connection is taken inside drop-path.
Stage attention goes through ``ops.flash_attention``: ``flash_attention`` in
eval mode, the differentiable ``flash_attention_grad`` in train mode (the CUDA
kernels on the card, their plain versions on the CPU).

Train mode (``train=True``): BatchNorm normalises with the batch's statistics
and updates its running buffers in place; with a ``generator``, dropout and
drop-path draw from it (``None``: both off, as ``rng=None`` in JAX); an
``ops.layers.RowStripe`` draws for the global batch and keeps its rows, and
BatchNorm then takes the global batch's moments over the process group.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from cxrmate_torch.configs import CvtConfig
from cxrmate_torch.ops import flash_attention as fa
from cxrmate_torch.ops.layers import (
    BatchNorm2d,
    Conv2d,
    LayerNorm,
    Linear,
    RowStripe,
    attention,
    draw,
    drawing,
    dropout,
    gelu,
    merge_heads,
    split_heads,
)


# ----------------------------------------------------------------- parameters
class _ConvEmbeddings(nn.Module):
    def __init__(self, config: CvtConfig, s: int, in_ch: int, **kw):
        super().__init__()
        dim = config.embed_dim[s]
        self.projection = Conv2d(in_ch, dim, config.patch_sizes[s], config.patch_stride[s],
                                 config.patch_padding[s], **kw)
        self.normalization = LayerNorm(dim, config.internal_layer_norm_eps, **kw)


class _Embedding(nn.Module):
    def __init__(self, config, s, in_ch, **kw):
        super().__init__()
        self.convolution_embeddings = _ConvEmbeddings(config, s, in_ch, **kw)


class _ConvProjectionInner(nn.Module):
    def __init__(self, dim: int, kernel: int, stride: int, padding: int, eps: float,
                 momentum: float, **kw):
        super().__init__()
        self.convolution = Conv2d(dim, dim, kernel, stride, padding, groups=dim, bias=False, **kw)
        self.normalization = BatchNorm2d(dim, eps, momentum, **kw)


class _ConvProjection(nn.Module):
    def __init__(self, dim, kernel, stride, padding, eps, momentum, **kw):
        super().__init__()
        self.convolution_projection = _ConvProjectionInner(dim, kernel, stride, padding, eps,
                                                           momentum, **kw)


class _SelfAttention(nn.Module):
    def __init__(self, config: CvtConfig, s: int, **kw):
        super().__init__()
        dim, k, eps = config.embed_dim[s], config.kernel_qkv[s], config.batch_norm_eps
        mom = config.batch_norm_momentum
        self.convolution_projection_query = _ConvProjection(
            dim, k, config.stride_q[s], config.padding_q[s], eps, mom, **kw)
        self.convolution_projection_key = _ConvProjection(
            dim, k, config.stride_kv[s], config.padding_kv[s], eps, mom, **kw)
        self.convolution_projection_value = _ConvProjection(
            dim, k, config.stride_kv[s], config.padding_kv[s], eps, mom, **kw)
        bias = config.qkv_bias[s]
        self.projection_query = Linear(dim, dim, bias, **kw)
        self.projection_key = Linear(dim, dim, bias, **kw)
        self.projection_value = Linear(dim, dim, bias, **kw)


class _Dense(nn.Module):
    def __init__(self, fan_in, fan_out, **kw):
        super().__init__()
        self.dense = Linear(fan_in, fan_out, **kw)


class _Attention(nn.Module):
    def __init__(self, config, s, **kw):
        super().__init__()
        dim = config.embed_dim[s]
        self.attention = _SelfAttention(config, s, **kw)
        self.output = _Dense(dim, dim, **kw)


class _Layer(nn.Module):
    def __init__(self, config: CvtConfig, s: int, **kw):
        super().__init__()
        dim = config.embed_dim[s]
        hidden = int(dim * config.mlp_ratio[s])
        eps = config.internal_layer_norm_eps
        self.attention = _Attention(config, s, **kw)
        self.intermediate = _Dense(dim, hidden, **kw)
        self.output = _Dense(hidden, dim, **kw)
        self.layernorm_before = LayerNorm(dim, eps, **kw)
        self.layernorm_after = LayerNorm(dim, eps, **kw)


class _Stage(nn.Module):
    def __init__(self, config: CvtConfig, s: int, in_ch: int, **kw):
        super().__init__()
        self.embedding = _Embedding(config, s, in_ch, **kw)
        self.layers = nn.ModuleList(_Layer(config, s, **kw) for _ in range(config.depth[s]))
        if config.cls_token[s]:
            # requires_grad off for serving, as every holder's (ops.layers._empty)
            self.cls_token = nn.Parameter(
                torch.empty(1, 1, config.embed_dim[-1], **kw), requires_grad=False)


class _Encoder(nn.Module):
    def __init__(self, config: CvtConfig, **kw):
        super().__init__()
        stages, in_ch = [], config.num_channels
        for s in range(config.num_stages):
            stages.append(_Stage(config, s, in_ch, **kw))
            in_ch = config.embed_dim[s]
        self.stages = nn.ModuleList(stages)


class _Cvt(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        self.encoder = _Encoder(config, **kw)


class _ProjectionHead(nn.Module):
    def __init__(self, config: CvtConfig, **kw):
        super().__init__()
        self.layer_norm = LayerNorm(config.embed_dim[-1], config.layer_norm_eps, **kw)
        self.projection = Linear(config.embed_dim[-1], config.projection_size, bias=False, **kw)


class CvtWithProjectionHead(nn.Module):
    """Parameter holder with the key layout of the reference's
    ``CvtWithProjectionHead`` (``cvt.encoder.stages.*``, ``projection_head.*``).
    Storage is uninitialised until a state dict is loaded or the model is
    randomly initialised."""

    def __init__(self, config: CvtConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.config = config
        self.cvt = _Cvt(config, **kw)
        self.projection_head = _ProjectionHead(config, **kw)


# -------------------------------------------------------------------- forward
def _drop_path(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
               ) -> torch.Tensor:
    """Stochastic depth (``cxrmate_tpu/models/cvt.py:117``): each example of
    the batch is kept with probability ``1 - rate`` and scaled by ``1 / (1 -
    rate)``, the draw uniform in x's dtype as in JAX. Identity without a
    generator or at rate 0."""
    if rate == 0.0 or not drawing(generator):
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    u = draw(generator, shape,
             lambda sh, g: torch.rand(sh, generator=g, device=x.device, dtype=x.dtype))
    return x / keep * torch.floor(keep + u)


def _stage_drop_path_rate(config: CvtConfig, s: int) -> float:
    """HF quirk: ``linspace(0, drop_path_rate[s], depth[s])`` indexed by the
    stage number (its last entry if the stage is shallower than its index)."""
    sched = np.linspace(0, config.drop_path_rate[s], config.depth[s])
    return float(sched[s]) if s < config.depth[s] else float(sched[-1])


def _attention_block(attn: _SelfAttention, tokens: torch.Tensor, hw: Tuple[int, int],
                     config: CvtConfig, s: int, train: bool = False,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """CvT self-attention on [B, T(+cls), D] tokens with depthwise-conv + BN
    q/k/v projections. Eval mode: ``flash_attention``. Train mode: BN on the
    batch's statistics, then ``flash_attention_grad`` when the stage has no
    attention dropout (every CvT-21 stage), else the plain attention with
    probs dropout."""
    h, w = hw
    dim, heads = config.embed_dim[s], config.num_heads[s]
    if config.cls_token[s]:
        cls, grid_tokens = tokens[:, :1], tokens[:, 1:]
    else:
        cls, grid_tokens = None, tokens
    b = grid_tokens.shape[0]
    grid = grid_tokens.transpose(1, 2).reshape(b, dim, h, w)

    def project(cp: _ConvProjection) -> torch.Tensor:
        inner = cp.convolution_projection
        y = inner.normalization(inner.convolution(grid), train=train,
                                over_group=isinstance(generator, RowStripe))
        return y.flatten(2).transpose(1, 2)

    k_tok = project(attn.convolution_projection_key)
    q_tok = project(attn.convolution_projection_query)
    v_tok = project(attn.convolution_projection_value)
    if cls is not None:
        q_tok = torch.cat([cls, q_tok], dim=1)
        k_tok = torch.cat([cls, k_tok], dim=1)
        v_tok = torch.cat([cls, v_tok], dim=1)

    q = split_heads(attn.projection_query(q_tok), heads)
    k = split_heads(attn.projection_key(k_tok), heads)
    v = split_heads(attn.projection_value(v_tok), heads)
    if train and config.attention_drop_rate[s] > 0.0:
        return merge_heads(attention(q, k, v, dim ** -0.5,
                                     probs_dropout=config.attention_drop_rate[s],
                                     generator=generator))
    bq, hq, lq, dh = q.shape
    lk = k.shape[2]
    run = fa.flash_attention_grad if train else fa.flash_attention

    def rows(t: torch.Tensor, length: int) -> torch.Tensor:
        # [B, H, L, Dh] (heads split by a transpose) -> contiguous [B*H, L, Dh]:
        # reshape copies for B > 1, but for one image it can return a strided
        # view, which the kernels refuse
        return t.reshape(bq * hq, length, dh).contiguous()

    ctx = run(rows(q, lq), rows(k, lk), rows(v, lk), dim ** -0.5).reshape(bq, hq, lq, dh)
    return merge_heads(ctx)


def cvt_stage(model: CvtWithProjectionHead, s: int, x: torch.Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Stage ``s`` on its NCHW input -> (grid tokens [B, H*W, D], cls token
    [B, 1, D] or None, the grid tokens as the next stage's NCHW input)."""
    config = model.config
    stage = model.cvt.encoder.stages[s]
    emb = stage.embedding.convolution_embeddings
    x = emb.projection(x)
    b, dim, h, w = x.shape
    tokens = emb.normalization(x.flatten(2).transpose(1, 2))
    drop = config.drop_rate[s] if train else 0.0
    tokens = dropout(tokens, drop, generator)
    if config.cls_token[s]:
        cls = stage.cls_token.to(tokens.dtype).expand(b, 1, dim)
        tokens = torch.cat([cls, tokens], dim=1)
    dp_rate = _stage_drop_path_rate(config, s) if train else 0.0
    for layer in stage.layers:
        attn_in = layer.layernorm_before(tokens)
        attn_out = layer.attention.output.dense(
            _attention_block(layer.attention.attention, attn_in, (h, w), config, s, train,
                             generator))
        attn_out = dropout(attn_out, drop, generator)
        tokens = _drop_path(attn_out, dp_rate, generator) + tokens
        y = layer.layernorm_after(tokens)
        y = dropout(layer.output.dense(gelu(layer.intermediate.dense(y))), drop, generator)
        # HF quirk: the residual is added before drop-path is applied
        tokens = _drop_path(y + tokens, dp_rate, generator)
    cls_out = None
    if config.cls_token[s]:
        cls_out, tokens = tokens[:, :1], tokens[:, 1:]
    return tokens, cls_out, tokens.transpose(1, 2).reshape(b, dim, h, w)


def cvt_forward(model: CvtWithProjectionHead, pixel_values: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the CvT trunk on NCHW ``pixel_values`` [B, C, H, W] -> (grid
    tokens [B, H*W, D_last], cls token [B, 1, D_last] or None). In train mode
    the BatchNorm running buffers are updated in place (``batch_stats``
    reads them)."""
    x = pixel_values
    for s in range(model.config.num_stages):
        tokens, cls_out, x = cvt_stage(model, s, x, train, generator)
    return tokens, cls_out


def cvt_encode(model: CvtWithProjectionHead, pixel_values: torch.Tensor, train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Full encoder: CvT trunk + projection head -> [B, H*W, projection_size]
    (the cls token is unused, as in the reference)."""
    tokens, _ = cvt_forward(model, pixel_values, train, generator)
    head = model.projection_head
    return head.projection(head.layer_norm(tokens))


def batch_stats(model: CvtWithProjectionHead) -> dict:
    """The BatchNorm running statistics {state-dict name: tensor}, the
    counterpart of the JAX package's ``batch_stats`` tree."""
    return {name: buf for name, buf in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))}
