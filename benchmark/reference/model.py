"""The plain reference of CXRMate: CvT-21 with its projection head and the
BERT decoder with cross-attention (LoRA on the self-attention query and key
for the longitudinal model), written out in plain PyTorch over an HF-layout
state dict.

It imports nothing of the program. It follows HF ``CvtModel`` and
``BertLMHeadModel`` (eager attention) as the released checkpoints use them:

  * CvT's attention scale is the stage width ``embed_dim ** -0.5``; its inner
    LayerNorms use eps ``internal_layer_norm_eps``, the projection head the
    config's ``layer_norm_eps``; the cls token exists in the last stage only;
    the q/k/v projections are a depthwise convolution and BatchNorm with its
    running statistics (eval mode) before a linear layer.
  * An image slot is padding iff its pixel [0, 0, 0] is exactly 0; padding
    slots are masked out of cross-attention.
  * The decoder's additive masks use finfo(float32).min; LoRA adds
    ``scaling * (x A^T) B^T`` to the base projection.

``Precision`` decides what every matrix product and convolution computes in:
``"fp32"`` is the reference (TF32 must be off, ``fp32_mode``); ``"fp8"``
rounds both operands of each product to float8 e4m3 with one scale a tensor
and multiplies in fp32, the control that a lower precision than the
configuration's bf16 has to fail.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

NEG = float(torch.finfo(torch.float32).min)
PEFT_PREFIX = "decoder.base_model.model."
E4M3_MAX = 448.0


@contextlib.contextmanager
def fp32_mode():
    """Plain fp32 products on the card: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (its largest magnitude to 448)."""
    amax = x.abs().max().float().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


class Precision:
    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def _ops(self, *xs):
        if self.name == "fp8":
            return [None if x is None else _round_fp8(x) for x in xs]
        return [None if x is None else x.float() for x in xs]

    def linear(self, x, w, b=None):
        x, w = self._ops(x, w)
        y = x @ w.t()
        return y if b is None else y + b.float()

    def conv(self, x, w, b=None, stride=1, padding=0, groups=1):
        x, w = self._ops(x, w)
        return F.conv2d(x, w, None if b is None else b.float(), stride=stride, padding=padding,
                        groups=groups)

    def matmul(self, a, b):
        a, b = self._ops(a, b)
        return a @ b


def _ln(x, sd, key, eps):
    return F.layer_norm(x, (x.shape[-1],), sd[key + ".weight"].float(),
                        sd[key + ".bias"].float(), eps)


def _attend(p: Precision, q, k, v, scale, additive_mask=None):
    """[B, H, Lq, Dh] x [B, H, Lk, Dh] -> [B, H, Lq, Dh]."""
    scores = p.matmul(q, k.transpose(-1, -2)) * scale
    if additive_mask is not None:
        scores = scores + additive_mask
    return p.matmul(torch.softmax(scores, dim=-1), v)


def _heads(x, n):
    b, t, d = x.shape
    return x.reshape(b, t, n, d // n).transpose(1, 2)


def _merge(x):
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


# ------------------------------------------------------------------ the layout
def tokens_per_image(enc: dict, image_size: int) -> int:
    side = image_size
    for k, s, pad in zip(enc["patch_sizes"], enc["patch_stride"], enc["patch_padding"]):
        side = (side + 2 * pad - k) // s + 1
    return side * side


def decoder_prefix(cfg: dict) -> str:
    return PEFT_PREFIX if cfg.get("lora") else "decoder."


def state_dict_layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every tensor of an HF-layout checkpoint of ``cfg`` as (key, shape,
    kind), kind one of ``weight``, ``bias``, ``norm`` (a norm's scale),
    ``mean``/``var`` (BatchNorm's running statistics), ``lora_a``, ``lora_b``.
    The LM head is tied to the word embeddings (no projection key)."""
    enc, dec = cfg["encoder"], cfg["decoder"]
    out = []

    def lin(key, n_in, n_out, bias=True):
        out.append((key + ".weight", (n_out, n_in), "weight"))
        if bias:
            out.append((key + ".bias", (n_out,), "bias"))

    def ln(key, d):
        out.append((key + ".weight", (d,), "norm"))
        out.append((key + ".bias", (d,), "bias"))

    in_ch = enc["num_channels"]
    for s, dim in enumerate(enc["embed_dim"]):
        st = f"encoder.cvt.encoder.stages.{s}"
        emb = f"{st}.embedding.convolution_embeddings"
        k = enc["patch_sizes"][s]
        out.append((f"{emb}.projection.weight", (dim, in_ch, k, k), "weight"))
        out.append((f"{emb}.projection.bias", (dim,), "bias"))
        ln(f"{emb}.normalization", dim)
        if enc["cls_token"][s]:
            out.append((f"{st}.cls_token", (1, 1, dim), "weight"))
        hidden = int(dim * enc["mlp_ratio"][s])
        kq = enc["kernel_qkv"][s]
        for layer in range(enc["depth"][s]):
            ly = f"{st}.layers.{layer}"
            at = f"{ly}.attention.attention"
            for name in ("query", "key", "value"):
                cp = f"{at}.convolution_projection_{name}.convolution_projection"
                out.append((f"{cp}.convolution.weight", (dim, 1, kq, kq), "weight"))
                ln(f"{cp}.normalization", dim)
                out.append((f"{cp}.normalization.running_mean", (dim,), "mean"))
                out.append((f"{cp}.normalization.running_var", (dim,), "var"))
                lin(f"{at}.projection_{name}", dim, dim, enc["qkv_bias"][s])
            lin(f"{ly}.attention.output.dense", dim, dim)
            lin(f"{ly}.intermediate.dense", dim, hidden)
            lin(f"{ly}.output.dense", hidden, dim)
            ln(f"{ly}.layernorm_before", dim)
            ln(f"{ly}.layernorm_after", dim)
        in_ch = dim
    ln("encoder.projection_head.layer_norm", enc["embed_dim"][-1])
    lin("encoder.projection_head.projection", enc["embed_dim"][-1], enc["projection_size"],
        bias=False)

    dp, d, lora = decoder_prefix(cfg), dec["hidden_size"], cfg.get("lora")
    out.append((f"{dp}bert.embeddings.word_embeddings.weight", (dec["vocab_size"], d), "weight"))
    out.append((f"{dp}bert.embeddings.position_embeddings.weight",
                (dec["max_position_embeddings"], d), "weight"))
    out.append((f"{dp}bert.embeddings.token_type_embeddings.weight",
                (dec["type_vocab_size"], d), "weight"))
    ln(f"{dp}bert.embeddings.LayerNorm", d)
    for layer in range(dec["num_hidden_layers"]):
        ly = f"{dp}bert.encoder.layer.{layer}"
        for name in ("query", "key"):
            if lora:
                lin(f"{ly}.attention.self.{name}.base_layer", d, d)
                out.append((f"{ly}.attention.self.{name}.lora_A.default.weight",
                            (lora["r"], d), "lora_a"))
                out.append((f"{ly}.attention.self.{name}.lora_B.default.weight",
                            (d, lora["r"]), "lora_b"))
            else:
                lin(f"{ly}.attention.self.{name}", d, d)
        lin(f"{ly}.attention.self.value", d, d)
        lin(f"{ly}.attention.output.dense", d, d)
        ln(f"{ly}.attention.output.LayerNorm", d)
        e = enc["projection_size"]
        lin(f"{ly}.crossattention.self.query", d, d)
        lin(f"{ly}.crossattention.self.key", e, d)
        lin(f"{ly}.crossattention.self.value", e, d)
        lin(f"{ly}.crossattention.output.dense", d, d)
        ln(f"{ly}.crossattention.output.LayerNorm", d)
        lin(f"{ly}.intermediate.dense", d, dec["intermediate_size"])
        lin(f"{ly}.output.dense", dec["intermediate_size"], d)
        ln(f"{ly}.output.LayerNorm", d)
    lin(f"{dp}cls.predictions.transform.dense", d, d)
    ln(f"{dp}cls.predictions.transform.LayerNorm", d)
    out.append((f"{dp}cls.predictions.bias", (dec["vocab_size"],), "bias"))
    return out


# -------------------------------------------------------------------- encoder
def _batch_norm(y, sd, cp, enc):
    """Eval mode: the running statistics."""
    return F.batch_norm(y, sd[f"{cp}.normalization.running_mean"].float(),
                        sd[f"{cp}.normalization.running_var"].float(),
                        sd[f"{cp}.normalization.weight"].float(),
                        sd[f"{cp}.normalization.bias"].float(), False, 0.0, enc["batch_norm_eps"])


def _cvt_attention(p, sd, at, x_tokens, hw, enc, s):
    h, w = hw
    dim, heads = enc["embed_dim"][s], enc["num_heads"][s]
    has_cls = enc["cls_token"][s]
    cls, grid_tokens = (x_tokens[:, :1], x_tokens[:, 1:]) if has_cls else (None, x_tokens)
    b = grid_tokens.shape[0]
    grid = grid_tokens.transpose(1, 2).reshape(b, dim, h, w)
    kq = enc["kernel_qkv"][s]

    def project(name, stride, padding):
        cp = f"{at}.convolution_projection_{name}.convolution_projection"
        y = p.conv(grid, sd[f"{cp}.convolution.weight"], None, stride, padding, groups=dim)
        return _batch_norm(y, sd, cp, enc).flatten(2).transpose(1, 2)

    del kq
    q_tok = project("query", enc["stride_q"][s], enc["padding_q"][s])
    k_tok = project("key", enc["stride_kv"][s], enc["padding_kv"][s])
    v_tok = project("value", enc["stride_kv"][s], enc["padding_kv"][s])
    if cls is not None:
        q_tok, k_tok, v_tok = (torch.cat([cls, t], dim=1) for t in (q_tok, k_tok, v_tok))

    def proj(name, t):
        key = f"{at}.projection_{name}"
        return p.linear(t, sd[key + ".weight"], sd.get(key + ".bias"))

    q, k, v = (_heads(proj(n, t), heads)
               for n, t in (("query", q_tok), ("key", k_tok), ("value", v_tok)))
    return _merge(_attend(p, q, k, v, dim ** -0.5))


def encode_images(sd: Dict[str, torch.Tensor], cfg: dict, pixels: torch.Tensor,
                  precision: str = "fp32", chunk: int = 8) -> torch.Tensor:
    """[N, 3, H, W] images -> [N, T_img, projection_size] in fp32, ``chunk``
    images at a time."""
    p, enc = Precision(precision), cfg["encoder"]
    eps = enc["internal_layer_norm_eps"]
    outs = []
    for i in range(0, pixels.shape[0], chunk):
        x = pixels[i:i + chunk].float()
        for s, dim in enumerate(enc["embed_dim"]):
            st = f"encoder.cvt.encoder.stages.{s}"
            emb = f"{st}.embedding.convolution_embeddings"
            x = p.conv(x, sd[f"{emb}.projection.weight"], sd[f"{emb}.projection.bias"],
                       enc["patch_stride"][s], enc["patch_padding"][s])
            b, _, h, w = x.shape
            tokens = _ln(x.flatten(2).transpose(1, 2), sd, f"{emb}.normalization", eps)
            if enc["cls_token"][s]:
                tokens = torch.cat([sd[f"{st}.cls_token"].float().expand(b, 1, dim), tokens], 1)
            for layer in range(enc["depth"][s]):
                ly = f"{st}.layers.{layer}"
                a = _cvt_attention(p, sd, f"{ly}.attention.attention",
                                   _ln(tokens, sd, f"{ly}.layernorm_before", eps), (h, w), enc, s)
                a = p.linear(a, sd[f"{ly}.attention.output.dense.weight"],
                             sd[f"{ly}.attention.output.dense.bias"])
                tokens = tokens + a
                y = _ln(tokens, sd, f"{ly}.layernorm_after", eps)
                y = F.gelu(p.linear(y, sd[f"{ly}.intermediate.dense.weight"],
                                    sd[f"{ly}.intermediate.dense.bias"]))
                y = p.linear(y, sd[f"{ly}.output.dense.weight"], sd[f"{ly}.output.dense.bias"])
                tokens = tokens + y
            if enc["cls_token"][s]:
                tokens = tokens[:, 1:]
            x = tokens.transpose(1, 2).reshape(b, dim, h, w)
        head = _ln(tokens, sd, "encoder.projection_head.layer_norm", enc["layer_norm_eps"])
        outs.append(p.linear(head, sd["encoder.projection_head.projection.weight"]))
    return torch.cat(outs)


def encode_studies(sd, cfg, pixel_values: torch.Tensor, precision: str = "fp32"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, N, 3, H, W] studies -> (hidden [B, N*T, P], mask [B, N*T] int)."""
    b, n = pixel_values.shape[:2]
    hidden = encode_images(sd, cfg, pixel_values.reshape((b * n,) + pixel_values.shape[2:]),
                           precision)
    t = hidden.shape[1]
    mask = (pixel_values[:, :, 0, 0, 0] != 0).to(torch.int32).repeat_interleave(t, dim=1)
    return hidden.reshape(b, n * t, -1), mask


# -------------------------------------------------------------------- decoder
def token_types(ids: torch.Tensor, specials: Sequence[int], sections: Sequence[int]
                ) -> torch.Tensor:
    """Type id of each column: ``sections[j + 1]`` for the last special j (in
    list order) present in the columns before it, ``sections[0]`` if none."""
    out = torch.full(ids.shape, sections[0], dtype=torch.long, device=ids.device)
    for j, sid in enumerate(specials):
        seen_before = torch.cumsum((ids == sid).long(), dim=1) - (ids == sid).long() > 0
        out = torch.where(seen_before, torch.full_like(out, sections[j + 1]), out)
    return out


def decoder_logits(sd, cfg, ids: torch.Tensor, attention_mask: torch.Tensor,
                   type_ids: torch.Tensor, position_ids: torch.Tensor,
                   enc_hidden: torch.Tensor, enc_mask: torch.Tensor,
                   precision: str = "fp32") -> torch.Tensor:
    """Teacher-forced decoder forward over whole sequences -> logits [B, L, V]
    in fp32. ``attention_mask`` [B, L] marks the keys that may be attended
    (besides causality); ``enc_mask`` [B, S] the real encoder tokens."""
    p, dec = Precision(precision), cfg["decoder"]
    dp, eps, d = decoder_prefix(cfg), dec["layer_norm_eps"], dec["hidden_size"]
    heads = dec["num_attention_heads"]
    scale = 1.0 / math.sqrt(d // heads)
    lora = cfg.get("lora")
    b, l = ids.shape
    causal = torch.tril(torch.ones(l, l, device=ids.device))
    self_mask = ((1.0 - causal[None] * attention_mask[:, None, :].float()) * NEG)[:, None]
    cross_mask = ((1.0 - enc_mask.float()) * NEG)[:, None, None, :]
    e = f"{dp}bert.embeddings"
    x = (sd[f"{e}.word_embeddings.weight"].float()[ids]
         + sd[f"{e}.token_type_embeddings.weight"].float()[type_ids]
         + sd[f"{e}.position_embeddings.weight"].float()[position_ids])
    x = _ln(x, sd, f"{e}.LayerNorm", eps)

    def lin(key, t):
        return p.linear(t, sd[key + ".weight"], sd.get(key + ".bias"))

    def qk(key, t):
        if not lora:
            return lin(key, t)
        base = lin(key + ".base_layer", t)
        a = p.linear(t, sd[key + ".lora_A.default.weight"])
        return base + (lora["alpha"] / lora["r"]) * p.linear(a, sd[key + ".lora_B.default.weight"])

    for layer in range(dec["num_hidden_layers"]):
        ly = f"{dp}bert.encoder.layer.{layer}"
        sa = f"{ly}.attention"
        ctx = _attend(p, _heads(qk(f"{sa}.self.query", x), heads),
                      _heads(qk(f"{sa}.self.key", x), heads),
                      _heads(lin(f"{sa}.self.value", x), heads), scale, self_mask)
        x = _ln(lin(f"{sa}.output.dense", _merge(ctx)) + x, sd,
                f"{sa}.output.LayerNorm", eps)
        ca = f"{ly}.crossattention"
        ctx = _attend(p, _heads(lin(f"{ca}.self.query", x), heads),
                      _heads(lin(f"{ca}.self.key", enc_hidden), heads),
                      _heads(lin(f"{ca}.self.value", enc_hidden), heads), scale, cross_mask)
        x = _ln(lin(f"{ca}.output.dense", _merge(ctx)) + x, sd,
                f"{ca}.output.LayerNorm", eps)
        y = F.gelu(lin(f"{ly}.intermediate.dense", x))
        x = _ln(lin(f"{ly}.output.dense", y) + x, sd, f"{ly}.output.LayerNorm", eps)
    h = F.gelu(lin(f"{dp}cls.predictions.transform.dense", x))
    h = _ln(h, sd, f"{dp}cls.predictions.transform.LayerNorm", 1e-12)
    return p.linear(h, sd[f"{e}.word_embeddings.weight"], sd[f"{dp}cls.predictions.bias"])


def sequence_inputs(ids: torch.Tensor, cfg: dict, tok: dict
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(attention mask, type ids, position ids) of whole served sequences
    under the model's rules: the longitudinal model masks its mask token
    (the pad) and counts positions over the unmasked columns, with sections
    (0, 1, 0, 1) after [PMT-SEP], [BOS] and [SEP]; the others attend to every
    column, count positions from 0 and switch section after [SEP]."""
    if cfg["variant"] == "longitudinal":
        mask = (ids != tok["pad"]).long()
        pos = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
        types = token_types(ids, (tok["pmt_sep"], tok["bos"], tok["sep"]), (0, 1, 0, 1))
    else:
        mask = torch.ones_like(ids)
        pos = torch.arange(ids.shape[1], device=ids.device).expand_as(ids)
        types = token_types(ids, (tok["sep"],), (0, 1))
    return mask, types, pos


def served_logits(sd, cfg, tok: dict, seqs: torch.Tensor, p_len: int, first_col: int,
                  enc_hidden: torch.Tensor, enc_mask: torch.Tensor,
                  precision: str = "fp32") -> torch.Tensor:
    """The logits from which each served token [B, L - p_len] was chosen:
    the first from column ``first_col`` of the prompt, each later one from
    the column before it."""
    mask, types, pos = sequence_inputs(seqs, cfg, tok)
    logits = decoder_logits(sd, cfg, seqs, mask, types, pos, enc_hidden, enc_mask, precision)
    cols = torch.arange(p_len - 1, seqs.shape[1] - 1, device=seqs.device)
    cols[0] = first_col
    return logits[:, cols]
