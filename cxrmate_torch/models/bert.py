"""BERT LM-head decoder with cross-attention, cache-aware.

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
  * ``bert_step(use_fused=True)`` runs each layer through the four kernels of
    ``ops.fused_decode`` instead (greedy and sampled decoding without LoRA).
  * the cache is updated in place (the JAX package returns new arrays).
  * ``bert_forward(train=True, generator=...)`` is the teacher-forcing
    forward of training: hidden dropout after the embeddings and after each
    sublayer's output projection, attention-probs dropout, and LoRA's input
    dropout, all drawn from the generator. The tied LM head reads the one
    word-embedding ``Parameter``, so its gradient sums both uses.

Under tensor parallelism (``parallel.mesh.shard_model``) the decoder holds
its model rank's shard (``BertLMHeadModel.tp``, a ``parallel.mesh.Shard``)
and runs Megatron-LM's layout with the operators of ``utils.dist``: the
replicated hidden state goes through ``copy_to_group`` (identity forward,
SUM backward) before q/k/v, before ``fc1``, and so does the encoder state
before cross k/v, LoRA's rank-r product before ``lora_b`` and the head's
transform before the vocabulary projection; the attention output and
``fc2`` are computed on this rank's input columns and summed by
``reduce_from_group`` (SUM forward, identity backward) in fp32 before
their bias, rounded once; the word embedding looks up this rank's
vocabulary rows (zero elsewhere) and sums; the LM head's logits are
gathered along the vocabulary (``gather_from_group``), so greedy, beam and
sampled choices see the one-process logits, the same bytes on every rank
of the group. Attention runs on this rank's heads (the caches hold them);
its probs dropout is drawn at the one-process shape and cut to them
(``ops.layers.HeadSlice``), and every other draw is full width, the same
on every rank of the group. Without a ``tp`` every operator is the
identity and the code is the one-process path.

Numerics follow HF eager order; additive masks are ``(1 - m) * finfo.min``.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cxrmate_torch.configs import BertDecoderConfig, LoraConfig
from cxrmate_torch.ops import decode_attention as da
from cxrmate_torch.ops import fused_decode
from cxrmate_torch.ops.layers import (
    Embedding,
    HeadSlice,
    LayerNorm,
    Linear,
    LoraLinear,
    attention,
    drawing,
    dropout,
    gelu,
    merge_heads,
    split_heads,
)
from cxrmate_torch.utils import dist, tracing

NEG = float(torch.finfo(torch.float32).min)
FUSED_TP = ("the fused decode step (use_fused=True) does not run under tensor parallelism: "
            "ops.fused_decode.prepare_fused_params and its kernels take a whole layer, and a "
            "model rank holds a shard of it; decode with use_fused=False")


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
            self.query = LoraLinear(d, d, lora.r, lora.scaling, lora.dropout, **kw)
            self.key = LoraLinear(kv_in, d, lora.r, lora.scaling, lora.dropout, **kw)
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
        if c.add_cross_attention:  # the decoder's; a plain encoder (CXR-BERT) has none
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
        # requires_grad off for serving, as every holder's (ops.layers._empty)
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
    With ``lora`` the self-attention query and key are ``LoraLinear``s.
    ``tp``: the decoder's ``parallel.mesh.Shard`` once
    ``parallel.mesh.shard_model`` has cut it to a model rank's shard; None
    for a whole decoder."""

    def __init__(self, config: BertDecoderConfig, lora: Optional[LoraConfig] = None,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.config = config
        self.lora = lora
        self.tp = None
        self.bert = _Bert(config, lora, **kw)
        self.cls = _Cls(config, **kw)


# -------------------------------------------------------------------- forward
def _group(model, kind: str):
    """The model group where ``kind`` ("vocab", "heads", "ffn") of ``model``
    is split over it; None (every operator the identity) otherwise."""
    tp = getattr(model, "tp", None)
    return tp.group if tp is not None and getattr(tp, kind) else None


def local_heads(model) -> int:
    """The attention heads this rank runs (and its caches hold)."""
    tp, heads = getattr(model, "tp", None), model.config.num_attention_heads
    return heads // tp.size if tp is not None and tp.heads else heads


def _out_proj(dense: Linear, x: torch.Tensor, group) -> torch.Tensor:
    """An output projection (attention out, ``fc2``). Split along its input
    over ``group``: this rank's partial product in fp32, summed over the
    group, then the bias, rounded once to x's dtype (the one rounding of
    ``ops.layers.linear``)."""
    if group is None:
        return dense(x)
    y = dist.reduce_from_group(F.linear(x.float(), dense.weight.float()), group)
    return (y + dense.bias.float()).to(x.dtype)


def _word_embeddings(model, ids: torch.Tensor) -> torch.Tensor:
    w = model.bert.embeddings.word_embeddings.weight
    group = _group(model, "vocab")
    if group is None:
        return F.embedding(ids, w)
    # this rank's vocabulary rows; the others are zero here and summed in
    local = ids - model.tp.rank * w.shape[0]
    inside = ((local >= 0) & (local < w.shape[0]))[..., None]
    x = F.embedding(torch.where(inside[..., 0], local, 0), w)
    return dist.reduce_from_group(torch.where(inside, x, 0.0), group)


def bert_embed(model: BertLMHeadModel, input_ids, token_type_ids, position_ids,
               dtype: Optional[torch.dtype] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    e = model.bert.embeddings
    x = _word_embeddings(model, input_ids)
    if dtype is not None:
        x = x.to(dtype)
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    x = x + e.token_type_embeddings(token_type_ids).to(x.dtype)
    x = x + e.position_embeddings(position_ids).to(x.dtype)
    return dropout(e.LayerNorm(x), model.config.hidden_dropout_prob, generator)


def bert_lm_head(model: BertLMHeadModel, hidden: torch.Tensor) -> torch.Tensor:
    p = model.cls.predictions
    h = p.transform.LayerNorm(gelu(p.transform.dense(hidden)))
    if hasattr(p, "decoder"):
        w = p.decoder.weight
    else:  # tied projection: the word-embedding matrix
        w = model.bert.embeddings.word_embeddings.weight
    group = _group(model, "vocab")
    return dist.gather_from_group(F.linear(dist.copy_to_group(h, group), w, p.bias), group)


def causal_additive_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, L] padding mask -> [B, 1, L, L] additive causal + padding mask."""
    b, l = attention_mask.shape
    causal = torch.tril(torch.ones(l, l, device=attention_mask.device))
    combined = causal[None] * attention_mask[:, None, :].float()
    return ((1.0 - combined) * NEG)[:, None]


def padding_additive_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, K] key padding mask -> [B, 1, 1, K] additive mask."""
    return ((1.0 - attention_mask.float()) * NEG)[:, None, None, :]


def _project(lin, x, x_copied, generator, group):
    """A q/k/v projection of ``x_copied`` (``x`` through ``copy_to_group``);
    a LoRA one draws its input dropout of ``x`` first (its rank-r product
    copied to ``group``)."""
    if isinstance(lin, LoraLinear):
        return lin(x, generator, base_input=x_copied, group=group)
    return lin(x_copied)


def _sublayer(att: _Attention, hidden, kv_hidden, mask, c: BertDecoderConfig,
              generator: Optional[torch.Generator] = None, tp=None):
    """Full-sequence attention sublayer (plain attention) + residual LN. With
    a generator (training), in the JAX package's order: LoRA dropout of q
    then k, probs dropout, output dropout. ``tp``: the decoder's shard
    (heads split over its group when ``tp.heads``)."""
    qkv, heads, group, probs_gen = att.self, c.num_attention_heads, None, generator
    if tp is not None and tp.heads:
        heads, group = heads // tp.size, tp.group
        if drawing(generator):
            probs_gen = HeadSlice(generator, tp.rank * heads, (tp.rank + 1) * heads,
                                  c.num_attention_heads)
    x = dist.copy_to_group(hidden, group)
    kv = x if kv_hidden is hidden else dist.copy_to_group(kv_hidden, group)
    q = _project(qkv.query, hidden, x, generator, group)
    k = _project(qkv.key, kv_hidden, kv, generator, group)
    ctx = attention(split_heads(q, heads), split_heads(k, heads),
                    split_heads(qkv.value(kv), heads), 1.0 / math.sqrt(c.head_dim), mask,
                    c.attention_probs_dropout_prob, probs_gen)
    out = dropout(_out_proj(att.output.dense, merge_heads(ctx), group), c.hidden_dropout_prob,
                  generator)
    return att.output.LayerNorm(out + hidden)


def _mlp(layer: _Layer, hidden, rate: float = 0.0,
         generator: Optional[torch.Generator] = None, tp=None):
    """The MLP + residual LN; ``tp``: the intermediate split over its group
    when ``tp.ffn``."""
    group = tp.group if tp is not None and tp.ffn else None
    h = gelu(layer.intermediate.dense(dist.copy_to_group(hidden, group)))
    y = dropout(_out_proj(layer.output.dense, h, group), rate, generator)
    return layer.output.LayerNorm(y + hidden)


def bert_forward(model: BertLMHeadModel, input_ids, attention_mask=None, token_type_ids=None,
                 position_ids=None, encoder_hidden_states=None,
                 encoder_attention_mask=None, train: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Full-sequence (teacher-forcing) forward -> logits [B, L, V]. Dropout
    runs only with ``train`` and a ``generator``."""
    c = model.config
    gen = generator if train else None
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
                        dtype=None if encoder_hidden_states is None else encoder_hidden_states.dtype,
                        generator=gen)
    tp = model.tp
    for layer in model.bert.encoder.layer:
        hidden = _sublayer(layer.attention, hidden, hidden, self_mask, c, gen, tp)
        if encoder_hidden_states is not None:
            hidden = _sublayer(layer.crossattention, hidden, encoder_hidden_states,
                               cross_mask, c, gen, tp)
        hidden = _mlp(layer, hidden, c.hidden_dropout_prob, gen, tp)
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
               dtype=torch.float32, device="cpu", heads: Optional[int] = None) -> DecodeCache:
    """Zero caches of ``heads`` heads (``local_heads`` of a sharded decoder;
    all of ``config``'s by default)."""
    l, dh = config.num_hidden_layers, config.head_dim
    h = heads or config.num_attention_heads

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

    Returns (logits [B, P, V], cache). Under a model group (no gradients
    here, so no ``copy_to_group``) on this rank's heads, the logits
    gathered."""
    c = model.config
    p_len = input_ids.shape[1]
    heads, scale = local_heads(model), 1.0 / math.sqrt(c.head_dim)
    tp = model.tp
    att_group = _group(model, "heads")
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
        hidden = sa.output.LayerNorm(_out_proj(sa.output.dense, merge_heads(ctx), att_group)
                                     + hidden)

        ca = layer.crossattention
        ck = split_heads(ca.self.key(encoder_hidden_states), heads)
        cv = split_heads(ca.self.value(encoder_hidden_states), heads)
        cache.cross_k[i].copy_(ck)
        cache.cross_v[i].copy_(cv)
        cq = split_heads(ca.self.query(hidden), heads)
        cctx = attention(cq, ck, cv, scale, cross_mask)
        hidden = ca.output.LayerNorm(_out_proj(ca.output.dense, merge_heads(cctx), att_group)
                                     + hidden)
        hidden = _mlp(layer, hidden, tp=tp)
    return bert_lm_head(model, hidden), cache


def bert_step(model: BertLMHeadModel, cache: DecodeCache, input_id, token_type_id,
              position_id, index: int, key_mask, encoder_attention_mask, *,
              use_fused: bool = False, fused_prepared: Optional[List[dict]] = None,
              deferred_write: bool = False, decode_kernel: Optional[str] = None,
              cross_q8: Optional[CrossQ8] = None):
    """One decode step for the token at cache column ``index``.

    Args:
      input_id/token_type_id/position_id: [B] current-token ids.
      index: the self-cache column of this token (== tokens so far).
      key_mask: [B, T] 1 for attendable cache columns.
      encoder_attention_mask: [B_cross, S]; B_cross = B / K when the K beams
        of a study share its cross cache.
      use_fused: run each layer through the four kernels of
        ``ops.fused_decode.fused_layer_step_v2`` (the plain versions on CPU
        tensors). A model with LoRA or ``deferred_write`` takes the unfused
        path below all the same; a set ``decode_kernel`` is ignored on the
        fused path with a ``RuntimeWarning``.
      fused_prepared: ``ops.fused_decode.prepare_fused_params``'s list, built
        once per decode call; built per step here if missing.
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
    [B, H, Dh] lists under ``deferred_write``. Under a model group (no
    gradients here, so no ``copy_to_group``) H is this rank's heads and the
    logits are gathered; the fused path raises there.
    """
    c = model.config
    heads, dh = local_heads(model), c.head_dim
    tp = model.tp
    att_group = _group(model, "heads")
    dtype = cache.cross_k[0].dtype
    decode_kernel = da.resolve_decode_kernel(decode_kernel)
    if use_fused and tp is not None:
        raise NotImplementedError(FUSED_TP)
    if use_fused and model.lora is None and not deferred_write:
        if decode_kernel:
            warnings.warn(
                "CXRMATE_DECODE_KERNEL=%r is ignored on the fused decode path "
                "(use_fused=True routes whole layers through ops/fused_decode.py, "
                "which has no per-module attention routing): unset one of the two "
                "knobs" % decode_kernel,
                RuntimeWarning,
            )
        with tracing.span("embed"):
            hidden = bert_embed(model, input_id[:, None], token_type_id[:, None],
                                position_id[:, None], dtype=dtype)
            h = hidden[:, 0].contiguous()
            key_mask32 = key_mask.to(torch.int32).contiguous()
            cross_mask32 = encoder_attention_mask.to(torch.int32).contiguous()
        for i, layer in enumerate(model.bert.encoder.layer):
            with tracing.span("layer"):
                h = fused_decode.fused_layer_step_v2(
                    h, layer, cache.self_k[i], cache.self_v[i], cache.cross_k[i],
                    cache.cross_v[i], index, key_mask32, cross_mask32, eps=c.layer_norm_eps,
                    prepared=fused_prepared[i] if fused_prepared is not None else None)
        with tracing.span("lm_head"):
            return bert_lm_head(model, h[:, None, :])[:, 0], cache
    if da.is_q8(decode_kernel) != (cross_q8 is not None):
        raise ValueError(
            "cross-rowgroup-q8 requires the caller to pass quantize_cross_cache's "
            "cross_q8 tuples (and cross_q8 is only valid with that spec); got "
            f"decode_kernel={decode_kernel!r}, cross_q8={'set' if cross_q8 else 'None'}")
    with tracing.span("embed"):  # the token's embedding, the masks and positions
        hidden = bert_embed(model, input_id[:, None], token_type_id[:, None],
                            position_id[:, None], dtype=dtype)
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
        with tracing.span("layer"):
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
            hidden = sa.output.LayerNorm(_out_proj(sa.output.dense, merge_heads(ctx), att_group)
                                         + hidden)

            ca = layer.crossattention
            cq = ca.self.query(hidden)  # [B, 1, D]
            # fold a study's beams into the query rows over its shared cross cache
            cqh = cq.reshape(groups, beams, heads, dh).transpose(1, 2).contiguous()
            gctx = cross_attn(cqh, i)
            cctx = gctx.transpose(1, 2).reshape(bsz, 1, heads * dh)
            hidden = ca.output.LayerNorm(_out_proj(ca.output.dense, cctx, att_group) + hidden)
            hidden = _mlp(layer, hidden, tp=tp)
    with tracing.span("lm_head"):
        logits = bert_lm_head(model, hidden)[:, 0]
    if deferred_write:
        return logits, (pend_k, pend_v)
    return logits, cache

