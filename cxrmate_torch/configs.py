"""Model configurations of the PyTorch port.

The port's own copy of the dataclasses it needs (field names and defaults as in
HF ``CvtConfig`` / ``BertConfig``, so HF checkpoints map 1:1). Frozen and
hashable, like the JAX package's configs, so a config can key a cache.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CvtConfig:
    """CvT (Convolutional vision Transformer) encoder config.

    Defaults are CvT-13; :func:`cvt21_384` builds the CvT-21 of every cxrmate
    checkpoint.
    """

    num_channels: int = 3
    patch_sizes: Tuple[int, ...] = (7, 3, 3)
    patch_stride: Tuple[int, ...] = (4, 2, 2)
    patch_padding: Tuple[int, ...] = (2, 1, 1)
    embed_dim: Tuple[int, ...] = (64, 192, 384)
    num_heads: Tuple[int, ...] = (1, 3, 6)
    depth: Tuple[int, ...] = (1, 2, 10)
    mlp_ratio: Tuple[float, ...] = (4.0, 4.0, 4.0)
    attention_drop_rate: Tuple[float, ...] = (0.0, 0.0, 0.0)
    drop_rate: Tuple[float, ...] = (0.0, 0.0, 0.0)
    drop_path_rate: Tuple[float, ...] = (0.0, 0.0, 0.1)
    qkv_bias: Tuple[bool, ...] = (True, True, True)
    cls_token: Tuple[bool, ...] = (False, False, True)
    qkv_projection_method: Tuple[str, ...] = ("dw_bn", "dw_bn", "dw_bn")
    kernel_qkv: Tuple[int, ...] = (3, 3, 3)
    padding_kv: Tuple[int, ...] = (1, 1, 1)
    stride_kv: Tuple[int, ...] = (2, 2, 2)
    padding_q: Tuple[int, ...] = (1, 1, 1)
    stride_q: Tuple[int, ...] = (1, 1, 1)
    # HF CvT builds its internal LayerNorms with the torch default eps (1e-5);
    # the config-level eps (1e-12) is only read by the projection head.
    layer_norm_eps: float = 1e-12
    internal_layer_norm_eps: float = 1e-5
    batch_norm_eps: float = 1e-5
    batch_norm_momentum: float = 0.1
    # Projection head: LayerNorm + bias-free Linear to the decoder width.
    projection_size: int = 768

    @property
    def num_stages(self) -> int:
        return len(self.depth)


def cvt21_384(projection_size: int = 768) -> CvtConfig:
    """CvT-21 @ 384px, the encoder of every cxrmate checkpoint."""
    return CvtConfig(depth=(1, 4, 16), projection_size=projection_size)


@dataclasses.dataclass(frozen=True)
class BertDecoderConfig:
    """BERT LM-head decoder config (HF ``BertConfig`` semantics, with
    ``is_decoder=True, add_cross_attention=True``)."""

    vocab_size: int = 30000
    hidden_size: int = 768
    num_hidden_layers: int = 6
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 4
    add_cross_attention: bool = True
    cross_attention_hidden_size: int = 768  # encoder projection size
    # HF default: the LM projection shares the word-embedding matrix
    tie_word_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """LoRA on the decoder's self-attention query/key, as in the longitudinal
    checkpoints (reference modelling_longitudinal.py:163-170). ``dropout`` is
    train-only."""

    r: int = 8
    alpha: float = 32.0
    dropout: float = 0.1

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


@dataclasses.dataclass(frozen=True)
class EncoderDecoderConfig:
    """One config for all three variants: ``'single'`` (one image, no encoder
    mask), ``'multi'`` (a per-study stack of up to ``max_images_per_study``
    images, all-zero slots masked out of cross-attention) and
    ``'longitudinal'`` (multi + the previous report as a prompt + a LoRA
    decoder)."""

    encoder: CvtConfig = dataclasses.field(default_factory=cvt21_384)
    decoder: BertDecoderConfig = dataclasses.field(default_factory=BertDecoderConfig)
    variant: str = "multi"
    lora: Optional[LoraConfig] = None
    image_size: int = 384
    max_images_per_study: int = 5
    decoder_max_len: int = 256
    prompt_max_len: int = 256

    def __post_init__(self):
        if self.variant not in ("single", "multi", "longitudinal"):
            raise ValueError(f"unknown variant {self.variant!r}")

    @property
    def tokens_per_image(self) -> int:
        side = self.image_size
        enc = self.encoder
        for k, s, p in zip(enc.patch_sizes, enc.patch_stride, enc.patch_padding):
            side = (side + 2 * p - k) // s + 1
        return side * side


def single_tf_config(vocab_size: int = 30000) -> EncoderDecoderConfig:
    """``aehrc/cxrmate-single-tf``: one image per example, no LoRA, no prompt."""
    return EncoderDecoderConfig(
        decoder=BertDecoderConfig(vocab_size=vocab_size), variant="single"
    )


def multi_tf_config(vocab_size: int = 30000) -> EncoderDecoderConfig:
    """``aehrc/cxrmate-multi-tf``: CvT-21@384 + BERT 6x768, no LoRA, no prompt."""
    return EncoderDecoderConfig(
        decoder=BertDecoderConfig(vocab_size=vocab_size), variant="multi"
    )


def longitudinal_config(vocab_size: int = 30000) -> EncoderDecoderConfig:
    """``aehrc/cxrmate``: multi + previous-report prompt + LoRA r=8 on q/k."""
    return EncoderDecoderConfig(
        decoder=BertDecoderConfig(vocab_size=vocab_size),
        variant="longitudinal",
        lora=LoraConfig(),
    )


def preset(variant: str, vocab_size: int = 30000) -> EncoderDecoderConfig:
    """The full-width config of a variant name."""
    presets = {"single": single_tf_config, "multi": multi_tf_config,
               "longitudinal": longitudinal_config}
    if variant not in presets:
        raise ValueError(f"unknown variant {variant!r}")
    return presets[variant](vocab_size)
