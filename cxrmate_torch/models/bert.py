"""BERT LM-head decoder with cross-attention, inference, cache-aware.

The port of ``cxrmate_tpu/models/bert.py``: HF ``BertLMHeadModel`` behaviour
(``is_decoder=True, add_cross_attention=True``, eager attention) with a
static-shape KV cache, and optionally LoRA on the self-attention query/key
(the longitudinal checkpoints). :class:`BertLMHeadModel` holds the parameters
under HF's (and PEFT's) names; the functions below run them.

  * ``bert_prefill`` writes positions ``[0, P)`` of the self cache and computes
    the cross K/V once; its attention is plain PyTorch, as the JAX package
    keeps prefill outside Pallas (``decode_attention.py:16-17``).
  * ``bert_step`` runs one token at column ``index``; its self- and
    cross-attention go through the kernels of ``ops.decode_attention`` that
    the ``decode_kernel`` routing spec names (CUDA kernels on the card).
    Beam search shares one cross cache per study: with a cross batch of B/K,
    the K beams fold into the kernel's M rows.
  * ``quantize_cross_cache`` turns the cross K/V into int8 once per decode
    call for the ``cross-rowgroup-q8`` spec.
  * the cache is updated in place (the JAX package returns new arrays).

Numerics follow HF eager order; additive masks are ``(1 - m) * finfo.min``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cxrmate_torch.configs import BertDecoderConfig, LoraConfig
from cxrmate_torch.ops import decode_attention as da
from cxrmate_torch.ops.layers import (
    Embedding,
    LayerNorm,
    Linear,
    LoraLinear,
    attention,
    gelu,
    merge_heads,
    split_heads,
)

NEG = float(torch.finfo(torch.float32).min)


# ----------------------------------------------------------------- parameters
class _Embeddings(nn.Module):
    def __init__(self, c: BertDecoderConfig, **kw):
        super().__init__()
        self.word_embeddings = Embedding(c.vocab_size, c.hidden_size, **kw)
        self.position_embeddings = Embedding(c.max_position_embeddings, c.hidden_size, **kw)
        self.token_type_embeddings = Embedding(c.type_vocab_size, c.hidden_size, **kw)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)


class _QKV(nn.Module):
    def __init__(self, d: int, kv_in: int, lora: Optional[LoraConfig] = None, **kw):
        super().__init__()
        if lora is None:
            self.query = Linear(d, d, **kw)
            self.key = Linear(kv_in, d, **kw)
        else:
            self.query = LoraLinear(d, d, lora.r, lora.scaling, **kw)
            self.key = LoraLinear(kv_in, d, lora.r, lora.scaling, **kw)
        self.value = Linear(kv_in, d, **kw)


class _Output(nn.Module):
    def __init__(self, fan_in: int, d: int, eps: float, **kw):
        super().__init__()
        self.dense = Linear(fan_in, d, **kw)
        self.LayerNorm = LayerNorm(d, eps, **kw)


class _Attention(nn.Module):
    def __init__(self, d: int, kv_in: int, eps: float, lora: Optional[LoraConfig] = None, **kw):
        super().__init__()
        self.self = _QKV(d, kv_in, lora, **kw)
        self.output = _Output(d, d, eps, **kw)


class _Intermediate(nn.Module):
    def __init__(self, d: int, ff: int, **kw):
        super().__init__()
        self.dense = Linear(d, ff, **kw)


class _Layer(nn.Module):
    def __init__(self, c: BertDecoderConfig, lora: Optional[LoraConfig] = None, **kw):
        super().__init__()
        d, eps = c.hidden_size, c.layer_norm_eps
        self.attention = _Attention(d, d, eps, lora, **kw)
        self.crossattention = _Attention(d, c.cross_attention_hidden_size, eps, **kw)
        self.intermediate = _Intermediate(d, c.intermediate_size, **kw)
        self.output = _Output(c.intermediate_size, d, eps, **kw)


class _Encoder(nn.Module):
    def __init__(self, c: BertDecoderConfig, lora: Optional[LoraConfig] = None, **kw):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(c, lora, **kw) for _ in range(c.num_hidden_layers))


class _Bert(nn.Module):
    def __init__(self, c, lora=None, **kw):
        super().__init__()
        self.embeddings = _Embeddings(c, **kw)
        self.encoder = _Encoder(c, lora, **kw)


class _Transform(nn.Module):
    def __init__(self, d: int, **kw):
        super().__init__()
        self.dense = Linear(d, d, **kw)
        # HF BertPredictionHeadTransform: config eps, 1e-12 in every cxrmate decoder
        self.LayerNorm = LayerNorm(d, 1e-12, **kw)


class _Predictions(nn.Module):
    def __init__(self, c: BertDecoderConfig, **kw):
        super().__init__()
        self.transform = _Transform(c.hidden_size, **kw)
        self.bias = nn.Parameter(torch.empty(c.vocab_size, **kw), requires_grad=False)
        if not c.tie_word_embeddings:
            self.decoder = Linear(c.hidden_size, c.vocab_size, bias=False, **kw)


class _Cls(nn.Module):
    def __init__(self, c, **kw):
        super().__init__()
        self.predictions = _Predictions(c, **kw)


class BertLMHeadModel(nn.Module):
    """Parameter holder with HF ``BertLMHeadModel``'s key layout (``bert.*``,
    ``cls.predictions.*``). With ``tie_word_embeddings`` the LM projection is
    the word-embedding matrix and ``cls.predictions.decoder`` is not held.
    With ``lora`` the self-attention query and key are ``LoraLinear``s."""

    def __init__(self, config: BertDecoderConfig, lora: Optional[LoraConfig] = None,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.config = config
        self.bert = _Bert(config, lora, **kw)
        self.cls = _Cls(config, **kw)


# -------------------------------------------------------------------- forward
def bert_embed(model: BertLMHeadModel, input_ids, token_type_ids, position_ids,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    e = model.bert.embeddings
    x = e.word_embeddings(input_ids)
    if dtype is not None:
        x = x.to(dtype)
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    x = x + e.token_type_embeddings(token_type_ids).to(x.dtype)
    x = x + e.position_embeddings(position_ids).to(x.dtype)
    return e.LayerNorm(x)


def bert_lm_head(model: BertLMHeadModel, hidden: torch.Tensor) -> torch.Tensor:
    p = model.cls.predictions
    h = p.transform.LayerNorm(gelu(p.transform.dense(hidden)))
    if hasattr(p, "decoder"):
        w = p.decoder.weight
    else:  # tied projection: the word-embedding matrix
        w = model.bert.embeddings.word_embeddings.weight
    return F.linear(h, w, p.bias)


def causal_additive_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, L] padding mask -> [B, 1, L, L] additive causal + padding mask."""
    b, l = attention_mask.shape
    causal = torch.tril(torch.ones(l, l, device=attention_mask.device))
    combined = causal[None] * attention_mask[:, None, :].float()
    return ((1.0 - combined) * NEG)[:, None]


def padding_additive_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, K] key padding mask -> [B, 1, 1, K] additive mask."""
    return ((1.0 - attention_mask.float()) * NEG)[:, None, None, :]


def _sublayer(att: _Attention, hidden, kv_hidden, mask, heads: int, scale: float):
    """Full-sequence attention sublayer (plain attention) + residual LN."""
    qkv = att.self
    ctx = attention(split_heads(qkv.query(hidden), heads),
                    split_heads(qkv.key(kv_hidden), heads),
                    split_heads(qkv.value(kv_hidden), heads), scale, mask)
    return att.output.LayerNorm(att.output.dense(merge_heads(ctx)) + hidden)


def _mlp(layer: _Layer, hidden):
    y = layer.output.dense(gelu(layer.intermediate.dense(hidden)))
    return layer.output.LayerNorm(y + hidden)


def bert_forward(model: BertLMHeadModel, input_ids, attention_mask=None, token_type_ids=None,
                 position_ids=None, encoder_hidden_states=None,
                 encoder_attention_mask=None) -> torch.Tensor:
    """Full-sequence (teacher-forcing) forward -> logits [B, L, V]."""
    c = model.config
    b, l = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones(b, l, dtype=torch.int32, device=input_ids.device)
    if position_ids is None:
        position_ids = torch.arange(l, device=input_ids.device).expand(b, l)
    self_mask = causal_additive_mask(attention_mask)
    cross_mask = None
    if encoder_hidden_states is not None and encoder_attention_mask is not None:
        cross_mask = padding_additive_mask(encoder_attention_mask)
    hidden = bert_embed(model, input_ids, token_type_ids, position_ids,
                        dtype=None if encoder_hidden_states is None else encoder_hidden_states.dtype)
    heads, scale = c.num_attention_heads, 1.0 / math.sqrt(c.head_dim)
    for layer in model.bert.encoder.layer:
        hidden = _sublayer(layer.attention, hidden, hidden, self_mask, heads, scale)
        if encoder_hidden_states is not None:
            hidden = _sublayer(layer.crossattention, hidden, encoder_hidden_states,
                               cross_mask, heads, scale)
        hidden = _mlp(layer, hidden)
    return bert_lm_head(model, hidden)


# -------------------------------------------------------------- cached decode
@dataclasses.dataclass
class DecodeCache:
    """Per-layer K/V caches: self [B, H, T, Dh] (T = prompt + new tokens) and
    cross [B, H, S, Dh] (computed once at prefill; zero-width after
    ``quantize_cross_cache``). Updated in place."""

    self_k: List[torch.Tensor]
    self_v: List[torch.Tensor]
    cross_k: List[torch.Tensor]
    cross_v: List[torch.Tensor]


def init_cache(config: BertDecoderConfig, batch: int, max_len: int, enc_len: int,
               dtype=torch.float32, device="cpu") -> DecodeCache:
    l, h, dh = config.num_hidden_layers, config.num_attention_heads, config.head_dim

    def zeros(t):
        return [torch.zeros(batch, h, t, dh, dtype=dtype, device=device) for _ in range(l)]

    return DecodeCache(zeros(max_len), zeros(max_len), zeros(enc_len), zeros(enc_len))


CrossQ8 = List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]


def quantize_cross_cache(cache: DecodeCache) -> Tuple[DecodeCache, CrossQ8]:
    """Int8-quantise the cross K/V (computed at prefill, the same at every
    step) for the ``cross-rowgroup-q8`` decode.

    Returns ``(cache, cross_q8)``: ``cross_q8`` holds per layer ``(kq int8,
    kscale f32 [B, H, 1, S], vq int8, vscale f32)`` from
    ``ops.decode_attention.quantize_kv_rowwise``; the cache's own cross
    tensors become zero-width placeholders [B, H, 0, Dh] (batch and dtype
    kept for ``bert_step``) one layer at a time, so that the card never holds
    more than one layer's K/V in both forms. Quantised numerics: serving
    only."""
    cross_q8 = []
    for i in range(len(cache.cross_k)):
        ck, cv = cache.cross_k[i], cache.cross_v[i]
        cross_q8.append(da.quantize_kv_rowwise(ck) + da.quantize_kv_rowwise(cv))
        # a copy, not a view: a view would keep the full-width storage alive
        cache.cross_k[i] = ck[:, :, :0].clone()
        cache.cross_v[i] = cv[:, :, :0].clone()
    return cache, cross_q8


def maybe_quantize_cross_cache(cache: DecodeCache, decode_kernel: str
                               ) -> Tuple[DecodeCache, Optional[CrossQ8]]:
    """``quantize_cross_cache`` iff the resolved spec is
    ``cross-rowgroup-q8[:G]``, else ``(cache, None)``: the one place the
    decode loops ask. ``bert_step`` checks the pairing again."""
    if da.is_q8(decode_kernel):
        return quantize_cross_cache(cache)
    return cache, None


def bert_prefill(model: BertLMHeadModel, cache: DecodeCache, input_ids, attention_mask,
                 token_type_ids, position_ids, encoder_hidden_states, encoder_attention_mask):
    """Process the prompt (positions [0, P)) and fill the cache.

    Returns (logits [B, P, V], cache)."""
    c = model.config
    p_len = input_ids.shape[1]
    heads, scale = c.num_attention_heads, 1.0 / math.sqrt(c.head_dim)
    self_mask = causal_additive_mask(attention_mask)
    cross_mask = padding_additive_mask(encoder_attention_mask)
    hidden = bert_embed(model, input_ids, token_type_ids, position_ids,
                        dtype=encoder_hidden_states.dtype)
    for i, layer in enumerate(model.bert.encoder.layer):
        sa = layer.attention
        qh = split_heads(sa.self.query(hidden), heads)
        kh = split_heads(sa.self.key(hidden), heads)
        vh = split_heads(sa.self.value(hidden), heads)
        cache.self_k[i][:, :, :p_len] = kh
        cache.self_v[i][:, :, :p_len] = vh
        ctx = attention(qh, kh, vh, scale, self_mask)
        hidden = sa.output.LayerNorm(sa.output.dense(merge_heads(ctx)) + hidden)

        ca = layer.crossattention
        ck = split_heads(ca.self.key(encoder_hidden_states), heads)
        cv = split_heads(ca.self.value(encoder_hidden_states), heads)
        cache.cross_k[i].copy_(ck)
        cache.cross_v[i].copy_(cv)
        cq = split_heads(ca.self.query(hidden), heads)
        cctx = attention(cq, ck, cv, scale, cross_mask)
        hidden = ca.output.LayerNorm(ca.output.dense(merge_heads(cctx)) + hidden)
        hidden = _mlp(layer, hidden)
    return bert_lm_head(model, hidden), cache


def bert_step(model: BertLMHeadModel, cache: DecodeCache, input_id, token_type_id,
              position_id, index: int, key_mask, encoder_attention_mask, *,
              deferred_write: bool = False, decode_kernel: Optional[str] = None,
              cross_q8: Optional[CrossQ8] = None):
    """One decode step for the token at cache column ``index``.

    Args:
      input_id/token_type_id/position_id: [B] current-token ids.
      index: the self-cache column of this token (== tokens so far).
      key_mask: [B, T] 1 for attendable cache columns.
      encoder_attention_mask: [B_cross, S]; B_cross = B / K when the K beams
        of a study share its cross cache.
      deferred_write: do not write this step's K/V into the cache. Attention
        reads ``where(col == index, new, cache)`` instead (same values as the
        written cache), and the new columns are returned for the caller's
        beam reorder to write.
      decode_kernel: decode-attention routing spec
        (``ops.decode_attention.resolve_decode_kernel``; ``None`` reads
        ``CXRMATE_DECODE_KERNEL``). The decode loops resolve it once per call.
      cross_q8: ``quantize_cross_cache``'s per-layer tuples: required with,
        and only valid with, the ``cross-rowgroup-q8`` spec; the cache's own
        cross tensors are then zero-width placeholders.
    Returns (logits [B, V], cache), or (logits, (new_k, new_v)) with per-layer
    [B, H, Dh] lists under ``deferred_write``.
    """
    c = model.config
    heads, dh = c.num_attention_heads, c.head_dim
    dtype = cache.cross_k[0].dtype
    decode_kernel = da.resolve_decode_kernel(decode_kernel)
    if da.is_q8(decode_kernel) != (cross_q8 is not None):
        raise ValueError(
            "cross-rowgroup-q8 requires the caller to pass quantize_cross_cache's "
            "cross_q8 tuples (and cross_q8 is only valid with that spec); got "
            f"decode_kernel={decode_kernel!r}, cross_q8={'set' if cross_q8 else 'None'}")
    hidden = bert_embed(model, input_id[:, None], token_type_id[:, None], position_id[:, None],
                        dtype=dtype)
    self_mask2d = ((1.0 - key_mask.float()) * NEG).contiguous()
    cross_mask2d = ((1.0 - encoder_attention_mask.float()) * NEG).contiguous()
    bsz = hidden.shape[0]
    groups = cache.cross_k[0].shape[0]
    beams = bsz // groups
    scale = 1.0 / math.sqrt(dh)
    is_new = None
    if deferred_write:
        t_cols = torch.arange(cache.self_k[0].shape[2], device=hidden.device)
        is_new = (t_cols == index)[None, None, :, None]
    pend_k, pend_v = [], []

    def attn(qh, kh, vh, mask2d, is_cross: bool):
        # the wrappers are looked up at call time, on the module
        if da.uses_vpu(decode_kernel, is_cross):
            return da.decode_attention_vpu(qh, kh, vh, mask2d, scale)
        return da.decode_attention(qh, kh, vh, mask2d, scale)

    def cross_attn(cqh, i: int):
        if cross_q8 is not None:  # int8 operands; the cache's cross entries are placeholders
            kq, ks, vq, vs = cross_q8[i]
            return da.decode_attention_q8(cqh, kq, ks, vq, vs, cross_mask2d, scale)
        return attn(cqh, cache.cross_k[i], cache.cross_v[i], cross_mask2d, True)

    for i, layer in enumerate(model.bert.encoder.layer):
        sa = layer.attention
        qh = split_heads(sa.self.query(hidden), heads).contiguous()  # [B, H, 1, Dh]
        kh = split_heads(sa.self.key(hidden), heads).to(dtype)
        vh = split_heads(sa.self.value(hidden), heads).to(dtype)
        if deferred_write:
            k_read = torch.where(is_new, kh, cache.self_k[i])
            v_read = torch.where(is_new, vh, cache.self_v[i])
            pend_k.append(kh[:, :, 0].contiguous())
            pend_v.append(vh[:, :, 0].contiguous())
        else:
            cache.self_k[i][:, :, index] = kh[:, :, 0]
            cache.self_v[i][:, :, index] = vh[:, :, 0]
            k_read, v_read = cache.self_k[i], cache.self_v[i]
        ctx = attn(qh, k_read, v_read, self_mask2d, False)
        hidden = sa.output.LayerNorm(sa.output.dense(merge_heads(ctx)) + hidden)

        ca = layer.crossattention
        cq = ca.self.query(hidden)  # [B, 1, D]
        # fold a study's beams into the query rows over its shared cross cache
        cqh = cq.reshape(groups, beams, heads, dh).transpose(1, 2).contiguous()
        gctx = cross_attn(cqh, i)
        cctx = gctx.transpose(1, 2).reshape(bsz, 1, heads * dh)
        hidden = ca.output.LayerNorm(ca.output.dense(cctx) + hidden)
        hidden = _mlp(layer, hidden)
    logits = bert_lm_head(model, hidden)[:, 0]
    if deferred_write:
        return logits, (pend_k, pend_v)
    return logits, cache

