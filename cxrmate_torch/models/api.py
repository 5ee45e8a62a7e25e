"""High-level inference API of the port.

    model = CXRMate.from_hf_checkpoint("/path/to/aehrc-cxrmate", variant="longitudinal")
    findings, impression = model.generate_report(images, prev_findings, prev_impression,
                                                 num_beams=4)

Runs on the card (``device="cuda"``) unless the caller passes
``device="cpu"``. The port of ``cxrmate_tpu/models/api.py`` for the three
variants ``single``, ``multi`` and ``longitudinal``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from cxrmate_torch import configs as model_configs
from cxrmate_torch.ckpt import hf
from cxrmate_torch.generate.beam import beam_search
from cxrmate_torch.generate.decode import GenerationConfig, generate
from cxrmate_torch.models import encoder_decoder as ed
from cxrmate_torch.tokenizer import ByteLevelBPETokenizer
from cxrmate_torch.utils.device import resolve_device
from cxrmate_torch.utils.precision import cast_floats

def config_from_hf_dir(path: str, variant: str, vocab_size: int) -> model_configs.EncoderDecoderConfig:
    """Model config from a checkpoint directory's ``config.json``
    (VisionEncoderDecoderConfig layout: nested encoder/decoder dicts), with the
    cxrmate presets for missing fields."""
    config = model_configs.preset(variant, vocab_size)
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
    N(0, 0.02), biases 0, norm scales 1, BatchNorm statistics (0, 1), the pad
    row of the word embeddings zeroed, LoRA A N(0, 1/sqrt(d)) and LoRA B 0
    (a fresh LoRA is inert until trained or loaded)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            is_norm = any(n in name for n in ("LayerNorm", "layer_norm", "normalization"))
            if is_norm:
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias" or ".lora_B." in name:
                p.zero_()
            elif ".lora_A." in name:
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device)
                        * p.shape[1] ** -0.5)
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
    def from_hf_checkpoint(cls, path: str, variant: str = "longitudinal", dtype=torch.float32,
                           device="cuda") -> "CXRMate":
        """Load an HF checkpoint directory (weights + ``tokenizer.json`` +
        ``config.json``) onto ``device`` in ``dtype``. A checkpoint without
        LoRA factors loads without LoRA, whatever the variant's preset; the
        factors' rank is the checkpoint's and the scaling (alpha / r) the
        preset's, as in the JAX package."""
        dev = resolve_device(device)
        tokenizer = ByteLevelBPETokenizer.from_file(path)
        sd = hf.load_hf_pretrained_dir(path)
        config = config_from_hf_dir(path, variant, len(tokenizer))
        rank, lora = hf.lora_rank(sd), None
        if rank is not None and config.lora is not None:
            lora = dataclasses.replace(config.lora, r=rank, alpha=config.lora.scaling * rank)
        config = dataclasses.replace(
            config, lora=lora,
            decoder=dataclasses.replace(config.decoder,
                                        tie_word_embeddings=hf.head_is_tied(sd)))
        model = ed.EncoderDecoder(config, device="cpu", dtype=torch.float32)
        hf.load_model_state(model, sd)
        model = cast_floats(model.to(dev), dtype)
        return cls(config, model, tokenizer, dev)

    @classmethod
    def random_init(cls, tokenizer: ByteLevelBPETokenizer, variant: str = "multi",
                    dtype=torch.float32, seed: int = 0, device="cuda",
                    config: Optional[model_configs.EncoderDecoderConfig] = None) -> "CXRMate":
        """A model with seeded random weights (a ``torch.Generator`` on
        ``device``): the variant's full-width config unless ``config`` is given."""
        dev = resolve_device(device)
        config = config or model_configs.preset(variant, len(tokenizer))
        model = ed.EncoderDecoder(config, device=dev, dtype=torch.float32)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        _fill_random(model, gen)
        return cls(config, cast_floats(model, dtype), tokenizer, dev)

    # -------------------------------------------------------------- inference
    @property
    def dtype(self) -> torch.dtype:
        return next(self.model.parameters()).dtype

    def _gen_cfg(self, num_beams: int, max_new: Optional[int], do_sample: bool = False,
                 top_k: int = 0, top_p: float = 1.0, temperature: float = 1.0
                 ) -> GenerationConfig:
        tok = self.tokenizer
        common = dict(
            max_new_tokens=max_new or self.config.decoder_max_len - 1,
            bos_token_id=tok.bos_token_id, eos_token_id=tok.eos_token_id,
            pad_token_id=tok.pad_token_id, num_beams=num_beams, do_sample=do_sample,
            top_k=top_k, top_p=top_p, temperature=temperature)
        if self.config.variant == "longitudinal":
            return GenerationConfig(
                mask_token_id=tok.pad_token_id,
                special_token_ids=(tok.vocab["[PMT-SEP]"], tok.bos_token_id, tok.sep_token_id),
                token_type_sections=(0, 1, 0, 1), **common)
        return GenerationConfig(special_token_ids=(tok.sep_token_id,), **common)

    @torch.no_grad()
    def encode(self, pixel_values) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixel_values [B, 3, H, W] (single) or [B, N, 3, H, W]
        (multi/longitudinal; numpy or tensor), zero-filled image slots for
        studies with fewer than N images -> (hidden, mask)."""
        px = (pixel_values if torch.is_tensor(pixel_values)
              else torch.from_numpy(np.asarray(pixel_values)))
        return ed.encode_images(self.model, px.to(self.device, self.dtype))

    @torch.no_grad()
    def generate_report(self, pixel_values,
                        previous_findings: Optional[Sequence[Optional[str]]] = None,
                        previous_impression: Optional[Sequence[Optional[str]]] = None,
                        num_beams: int = 4, max_new_tokens: Optional[int] = None,
                        generator: Optional[torch.Generator] = None, do_sample: bool = False,
                        top_k: int = 0, top_p: float = 1.0, temperature: float = 1.0,
                        decode_kernel: Optional[str] = None) -> Tuple[List[str], List[str]]:
        """-> (findings, impression) strings per study. The longitudinal
        variant takes the previous report's sections (``None`` for a study
        without one). ``generator`` feeds ``do_sample`` (greedy only);
        ``decode_kernel`` is the decode-attention routing spec
        (``ops.decode_attention.resolve_decode_kernel``)."""
        tok = self.tokenizer
        enc_hidden, enc_mask = self.encode(pixel_values)
        b = enc_hidden.shape[0]
        if self.config.variant == "longitudinal":
            if previous_findings is None or previous_impression is None:
                raise ValueError("the longitudinal variant needs previous_findings and "
                                 "previous_impression (None entries for studies without)")
            prompt = ed.tokenize_prompt(previous_findings, previous_impression, tok,
                                        self.config.prompt_max_len, add_bos_token_id=True)
            true_width = prompt["input_ids"].shape[1]
            ids_b, mask_b = ed.bucket_prompt(prompt["input_ids"], prompt["attention_mask"],
                                             tok.pad_token_id, bucket=32,
                                             max_len=self.config.prompt_max_len)
            prompt_ids = torch.from_numpy(ids_b.astype(np.int32)).to(self.device)
            prompt_mask = torch.from_numpy(mask_b.astype(np.int32)).to(self.device)
            prompt_logits_col = true_width - 1
            split_specials = [tok.bos_token_id, tok.sep_token_id, tok.eos_token_id]
        else:
            prompt_ids = torch.full((b, 1), tok.bos_token_id, dtype=torch.int32,
                                    device=self.device)
            prompt_mask = torch.ones(b, 1, dtype=torch.int32, device=self.device)
            prompt_logits_col = None
            split_specials = [tok.sep_token_id, tok.eos_token_id]

        gen_cfg = self._gen_cfg(num_beams, max_new_tokens, do_sample, top_k, top_p, temperature)
        if num_beams > 1:
            seqs, _ = beam_search(self.model, gen_cfg, enc_hidden, enc_mask, prompt_ids,
                                  prompt_mask, prompt_logits_col=prompt_logits_col,
                                  decode_kernel=decode_kernel)
        else:
            seqs = generate(self.model, gen_cfg, enc_hidden, enc_mask, prompt_ids, prompt_mask,
                            generator, prompt_logits_col=prompt_logits_col,
                            decode_kernel=decode_kernel)
        sections = ed.split_and_decode_sections(seqs.cpu().numpy(), split_specials, tok)
        findings, impression = sections[-2:]  # longitudinal: the prompt section comes first
        return list(findings), list(impression)

    def tokenize_report_teacher_forcing(self, findings, impression, max_len=None):
        return ed.tokenize_report_teacher_forcing(
            findings, impression, self.tokenizer, max_len or self.config.decoder_max_len)

    def tokenize_prompt(self, previous_findings, previous_impression, max_len=None,
                        add_bos_token_id=False):
        return ed.tokenize_prompt(previous_findings, previous_impression, self.tokenizer,
                                  max_len or self.config.prompt_max_len, add_bos_token_id)

    def split_and_decode_sections(self, token_ids, special_token_ids):
        return ed.split_and_decode_sections(token_ids, special_token_ids, self.tokenizer)
