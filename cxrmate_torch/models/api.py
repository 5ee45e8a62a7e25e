"""High-level inference API of the port.

    model = CXRMate.from_hf_checkpoint("/path/to/cxrmate-multi-tf", variant="multi")
    findings, impression = model.generate_report(images, num_beams=4)

Runs on the card (``device="cuda"``) unless the caller passes
``device="cpu"``. The port of ``cxrmate_tpu/models/api.py`` for the ``multi``
variant; ``single`` and ``longitudinal`` are later slices.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from cxrmate_torch import configs as model_configs
from cxrmate_torch.ckpt import hf
from cxrmate_torch.generate.beam import beam_search
from cxrmate_torch.generate.decode import GenerationConfig, check_supported, generate
from cxrmate_torch.models import encoder_decoder as ed
from cxrmate_torch.tokenizer import ByteLevelBPETokenizer
from cxrmate_torch.utils.device import resolve_device
from cxrmate_torch.utils.precision import cast_floats

_NOT_PORTED = {
    "single": "the single-image variant is not ported yet (ROADMAP.md queue 1, item 9)",
    "longitudinal": "the longitudinal variant is not ported yet (ROADMAP.md queue 1, item 9)",
}


def _check_variant(variant: str) -> None:
    if variant in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[variant])
    if variant != "multi":
        raise ValueError(f"unknown variant {variant!r}")


def config_from_hf_dir(path: str, variant: str, vocab_size: int) -> model_configs.EncoderDecoderConfig:
    """Model config from a checkpoint directory's ``config.json``
    (VisionEncoderDecoderConfig layout: nested encoder/decoder dicts), with the
    cxrmate presets for missing fields."""
    _check_variant(variant)
    config = model_configs.multi_tf_config(vocab_size)
    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        return config
    with open(cfg_path) as f:
        hf_cfg = json.load(f)
    enc, dec = hf_cfg.get("encoder", {}), hf_cfg.get("decoder", {})

    def tup(v, default):
        return tuple(v) if v is not None else default

    e = config.encoder
    encoder = dataclasses.replace(
        e,
        num_channels=enc.get("num_channels", e.num_channels),
        patch_sizes=tup(enc.get("patch_sizes"), e.patch_sizes),
        patch_stride=tup(enc.get("patch_stride"), e.patch_stride),
        patch_padding=tup(enc.get("patch_padding"), e.patch_padding),
        embed_dim=tup(enc.get("embed_dim"), e.embed_dim),
        num_heads=tup(enc.get("num_heads"), e.num_heads),
        depth=tup(enc.get("depth"), e.depth),
        mlp_ratio=tup(enc.get("mlp_ratio"), e.mlp_ratio),
        qkv_bias=tup(enc.get("qkv_bias"), e.qkv_bias),
        cls_token=tup(enc.get("cls_token"), e.cls_token),
        kernel_qkv=tup(enc.get("kernel_qkv"), e.kernel_qkv),
        padding_kv=tup(enc.get("padding_kv"), e.padding_kv),
        stride_kv=tup(enc.get("stride_kv"), e.stride_kv),
        padding_q=tup(enc.get("padding_q"), e.padding_q),
        stride_q=tup(enc.get("stride_q"), e.stride_q),
        drop_path_rate=tup(enc.get("drop_path_rate"), e.drop_path_rate),
        layer_norm_eps=enc.get("layer_norm_eps", e.layer_norm_eps),
        projection_size=enc.get("projection_size", e.projection_size),
    )
    d = config.decoder
    decoder = dataclasses.replace(
        d,
        vocab_size=dec.get("vocab_size", vocab_size),
        hidden_size=dec.get("hidden_size", d.hidden_size),
        num_hidden_layers=dec.get("num_hidden_layers", d.num_hidden_layers),
        num_attention_heads=dec.get("num_attention_heads", d.num_attention_heads),
        intermediate_size=dec.get("intermediate_size", d.intermediate_size),
        max_position_embeddings=dec.get("max_position_embeddings", d.max_position_embeddings),
        type_vocab_size=dec.get("type_vocab_size", d.type_vocab_size),
        layer_norm_eps=dec.get("layer_norm_eps", d.layer_norm_eps),
        pad_token_id=dec.get("pad_token_id", d.pad_token_id),
        cross_attention_hidden_size=enc.get("projection_size", d.cross_attention_hidden_size),
    )
    return dataclasses.replace(config, encoder=encoder, decoder=decoder)


def _fill_random(model: ed.EncoderDecoder, gen: torch.Generator) -> None:
    """The JAX package's initialisation scheme, drawn from ``gen``: weights
    N(0, 0.02), biases 0, norm scales 1, BatchNorm statistics (0, 1), and the
    pad row of the word embeddings zeroed."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            is_norm = any(n in name for n in ("LayerNorm", "layer_norm", "normalization"))
            if is_norm:
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * 0.02)
        for name, buf in model.named_buffers():
            buf.fill_(1.0 if name.endswith("running_var") else 0.0)
        pad = model.config.decoder.pad_token_id
        model.decoder.bert.embeddings.word_embeddings.weight[pad] = 0.0


@dataclasses.dataclass
class CXRMate:
    config: model_configs.EncoderDecoderConfig
    model: ed.EncoderDecoder
    tokenizer: ByteLevelBPETokenizer
    device: torch.device

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_hf_checkpoint(cls, path: str, variant: str = "multi", dtype=torch.float32,
                           device="cuda") -> "CXRMate":
        """Load an HF checkpoint directory (weights + ``tokenizer.json`` +
        ``config.json``) onto ``device`` in ``dtype``."""
        _check_variant(variant)
        dev = resolve_device(device)
        tokenizer = ByteLevelBPETokenizer.from_file(path)
        sd = hf.load_hf_pretrained_dir(path)
        config = config_from_hf_dir(path, variant, len(tokenizer))
        config = dataclasses.replace(config, decoder=dataclasses.replace(
            config.decoder, tie_word_embeddings=hf.head_is_tied(sd)))
        model = ed.EncoderDecoder(config, device="cpu", dtype=torch.float32)
        hf.load_model_state(model, sd)
        model = cast_floats(model.to(dev), dtype)
        return cls(config, model, tokenizer, dev)

    @classmethod
    def random_init(cls, tokenizer: ByteLevelBPETokenizer, variant: str = "multi",
                    dtype=torch.float32, seed: int = 0, device="cuda",
                    config: Optional[model_configs.EncoderDecoderConfig] = None) -> "CXRMate":
        """A model with seeded random weights (a ``torch.Generator`` on
        ``device``): the full-width ``multi`` config unless ``config`` is given."""
        _check_variant(variant)
        dev = resolve_device(device)
        config = config or model_configs.multi_tf_config(len(tokenizer))
        model = ed.EncoderDecoder(config, device=dev, dtype=torch.float32)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        _fill_random(model, gen)
        return cls(config, cast_floats(model, dtype), tokenizer, dev)

    # -------------------------------------------------------------- inference
    @property
    def dtype(self) -> torch.dtype:
        return next(self.model.parameters()).dtype

    def _gen_cfg(self, num_beams: int, max_new: Optional[int], do_sample: bool) -> GenerationConfig:
        tok = self.tokenizer
        return GenerationConfig(
            max_new_tokens=max_new or self.config.decoder_max_len - 1,
            bos_token_id=tok.bos_token_id, eos_token_id=tok.eos_token_id,
            pad_token_id=tok.pad_token_id,
            special_token_ids=(tok.sep_token_id,), num_beams=num_beams, do_sample=do_sample,
        )

    @torch.no_grad()
    def encode(self, pixel_values) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixel_values [B, N, 3, H, W] (numpy or tensor), zero-filled image
        slots for studies with fewer than N images -> (hidden, mask)."""
        px = (pixel_values if torch.is_tensor(pixel_values)
              else torch.from_numpy(np.asarray(pixel_values)))
        return ed.encode_images(self.model, px.to(self.device, self.dtype))

    @torch.no_grad()
    def generate_report(self, pixel_values, num_beams: int = 4,
                        max_new_tokens: Optional[int] = None,
                        do_sample: bool = False) -> Tuple[List[str], List[str]]:
        """-> (findings, impression) strings per study."""
        gen_cfg = self._gen_cfg(num_beams, max_new_tokens, do_sample)
        check_supported(gen_cfg)
        tok = self.tokenizer
        enc_hidden, enc_mask = self.encode(pixel_values)
        b = enc_hidden.shape[0]
        prompt_ids = torch.full((b, 1), tok.bos_token_id, dtype=torch.int32, device=self.device)
        prompt_mask = torch.ones(b, 1, dtype=torch.int32, device=self.device)
        if num_beams > 1:
            seqs, _ = beam_search(self.model, gen_cfg, enc_hidden, enc_mask, prompt_ids, prompt_mask)
        else:
            seqs = generate(self.model, gen_cfg, enc_hidden, enc_mask, prompt_ids, prompt_mask)
        findings, impression = ed.split_and_decode_sections(
            seqs.cpu().numpy(), [tok.sep_token_id, tok.eos_token_id], tok)
        return list(findings), list(impression)
