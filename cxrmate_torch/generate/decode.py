"""Greedy and sampled decoding with a static KV cache.

The port of ``cxrmate_tpu/generate/decode.py`` (``generate`` :176/:222), with
the semantics of HF ``generate`` as the reference models drive it:

  * single/multi: the decoder attention mask is all ones (also over post-EOS
    padding), position ids are absolute, token types switch sections after
    the first occurrence of each special token.
  * longitudinal (``mask_token_id`` set): the attention mask is
    ``ids != mask_token_id`` (prompt padding and post-EOS pads are masked),
    position ids are ``relu(cumsum(mask) - 1)``, sections are ``[0, 1, 0, 1]``.

Sequences are pad-filled after EOS to the static width ``P + max_new_tokens``.
A Python loop replaces ``lax.while_loop``; it stops when every row has
finished or the width is reached. The self cache has one static width
``P + max_new_tokens`` (the JAX package's segmented growth is bit-exact either
way and is not ported). ``use_fused`` sends the steps through the fused
decoder-layer kernels (:188, :264-271, :298-299). Sampling draws with an explicit ``torch.Generator``;
its draws are not the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cxrmate_torch.generate.logits_process import warp_logits
from cxrmate_torch.models import bert as bert_mod
from cxrmate_torch.models import encoder_decoder as ed
from cxrmate_torch.ops.decode_attention import resolve_decode_kernel
from cxrmate_torch.ops.fused_decode import prepare_fused_params


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 4
    # longitudinal mask-token semantics; None -> all-ones attention (single/multi)
    mask_token_id: Optional[int] = None
    special_token_ids: Tuple[int, ...] = (3,)  # section boundaries for token types
    token_type_sections: Optional[Tuple[int, ...]] = None
    num_beams: int = 1
    do_sample: bool = False
    top_k: int = 0
    top_p: float = 1.0
    temperature: float = 1.0
    length_penalty: float = 1.0
    early_stopping: bool = False

    def sections(self) -> Tuple[int, ...]:
        if self.token_type_sections is not None:
            return tuple(self.token_type_sections)[: len(self.special_token_ids) + 1]
        return tuple(range(len(self.special_token_ids) + 1))


def _specials_present(seq_prefix: torch.Tensor, gen_cfg: GenerationConfig) -> torch.Tensor:
    """[B, L] prefix -> [B, n_specials] presence flags."""
    return torch.stack([(seq_prefix == s).any(dim=1) for s in gen_cfg.special_token_ids], dim=1)


def _type_from_present(present: torch.Tensor, gen_cfg: GenerationConfig) -> torch.Tensor:
    """Type id of the next token: iterate the specials in order, the last one
    present wins (modelling_single.py:294-318)."""
    sections = gen_cfg.sections()
    out = torch.full((present.shape[0],), sections[0], dtype=torch.int32, device=present.device)
    for i in range(len(gen_cfg.special_token_ids)):
        out = torch.where(present[:, i], torch.full_like(out, sections[i + 1]), out)
    return out


def prefill(model: ed.EncoderDecoder, gen_cfg: GenerationConfig, encoder_hidden, encoder_mask,
            prompt_ids, t_total: int):
    """Prompt-side ids, a cache of width ``t_total`` and the prefill pass.
    Returns (prefill logits [B, P, V], cache, prompt attention mask [B, P])."""
    dcfg = model.config.decoder
    b, p_len = prompt_ids.shape
    dev = prompt_ids.device
    prompt_types = ed.token_ids_to_token_type_ids(
        prompt_ids, gen_cfg.special_token_ids, gen_cfg.sections())
    if gen_cfg.mask_token_id is not None:
        attn_prompt = (prompt_ids != gen_cfg.mask_token_id).to(torch.int32)
        prompt_pos = ed.cumulative_position_ids(attn_prompt)
    else:
        attn_prompt = torch.ones(b, p_len, dtype=torch.int32, device=dev)
        prompt_pos = torch.arange(p_len, device=dev).expand(b, p_len)
    cache = bert_mod.init_cache(dcfg, b, t_total, encoder_hidden.shape[1],
                                dtype=encoder_hidden.dtype, device=dev)
    logits, cache = bert_mod.bert_prefill(model.decoder, cache, prompt_ids, attn_prompt,
                                          prompt_types, prompt_pos, encoder_hidden, encoder_mask)
    return logits, cache, attn_prompt


@torch.no_grad()
def generate(model: ed.EncoderDecoder, gen_cfg: GenerationConfig, encoder_hidden: torch.Tensor,
             encoder_mask: torch.Tensor, prompt_ids: torch.Tensor, prompt_mask: torch.Tensor,
             generator: Optional[torch.Generator] = None, *,
             use_fused: bool = False, prompt_logits_col: Optional[int] = None,
             decode_kernel: Optional[str] = None) -> torch.Tensor:
    """Greedy or sampled decoding (``num_beams == 1``).

    Args:
      encoder_hidden/encoder_mask: from ``encoder_decoder.encode_images``.
      prompt_ids/prompt_mask: [B, P]; for single/multi a [B, 1] BOS column.
        The decoder's own mask comes from ``gen_cfg`` (all ones, or
        ``prompt_ids != mask_token_id``), as in the JAX package.
      generator: the ``torch.Generator`` (on the model's device) that
        ``gen_cfg.do_sample`` draws from; required when sampling.
      use_fused: run every decode step's layers through the fused
        decoder-layer kernels (``ops.fused_decode``), greedy or sampled. A
        model with LoRA takes the unfused path all the same; ``decode_kernel``
        is ignored on the fused path (``bert_step`` warns) and no int8 cross
        cache is made.
      prompt_logits_col: column of the prefill logits that gives the first
        token; the last prompt column by default. When the prompt is
        bucket-padded beyond the batch's longest row, pass the true longest
        width - 1: the result then equals the unpadded batch's.
      decode_kernel: decode-attention routing spec, resolved here, once per
        call (``ops.decode_attention.resolve_decode_kernel``; ``None`` reads
        ``CXRMATE_DECODE_KERNEL``).
    Returns sequences [B, P + max_new_tokens].
    """
    if gen_cfg.num_beams != 1:
        raise ValueError("generate is greedy; use generate.beam.beam_search for num_beams > 1")
    if gen_cfg.do_sample and generator is None:
        raise ValueError("do_sample needs a torch.Generator on the model's device")
    del prompt_mask
    decode_kernel = resolve_decode_kernel(decode_kernel)
    masked_pads = gen_cfg.mask_token_id is not None
    b, p_len = prompt_ids.shape
    max_new = gen_cfg.max_new_tokens
    t_total = p_len + max_new
    dev = prompt_ids.device
    fused = use_fused and model.config.lora is None
    # the fused kernels' per-layer operands, built once, never per step
    fused_prepared = (prepare_fused_params(model.decoder, model.config.decoder.num_attention_heads)
                      if fused else None)
    prefill_logits, cache, attn_prompt = prefill(model, gen_cfg, encoder_hidden, encoder_mask,
                                                 prompt_ids, t_total)
    if fused:
        cross_q8 = None  # the fused path ignores decode_kernel (bert_step warns)
    else:  # int8 serving decode: quantise the cross cache once, after prefill
        cache, cross_q8 = bert_mod.maybe_quantize_cross_cache(cache, decode_kernel)

    seq = torch.full((b, t_total), gen_cfg.pad_token_id, dtype=prompt_ids.dtype, device=dev)
    seq[:, :p_len] = prompt_ids
    key_mask = torch.zeros(b, t_total, dtype=torch.int32, device=dev)
    key_mask[:, :p_len] = attn_prompt
    # specials seen in seq[:, :cur-1]: the current query token is not folded
    # in yet (HF drops the last column in token_ids_to_token_type_ids_past)
    present = _specials_present(prompt_ids, gen_cfg)
    real_count = attn_prompt.sum(dim=1)

    def select_token(logits):
        logits = logits.float()
        if gen_cfg.do_sample:
            warped = warp_logits(logits, gen_cfg.temperature, gen_cfg.top_k, gen_cfg.top_p)
            probs = torch.softmax(warped, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0].to(seq.dtype)
        return torch.argmax(logits, dim=-1).to(seq.dtype)

    def new_key_mask(tok):
        if masked_pads:
            return (tok != gen_cfg.mask_token_id).to(torch.int32)
        return torch.ones(b, dtype=torch.int32, device=dev)

    first_col = p_len - 1 if prompt_logits_col is None else prompt_logits_col
    tok = select_token(prefill_logits[:, first_col])
    finished = tok == gen_cfg.eos_token_id
    seq[:, p_len] = tok
    nm = new_key_mask(tok)
    key_mask[:, p_len] = nm
    real_count = real_count + nm
    specials = torch.tensor(gen_cfg.special_token_ids, device=dev)

    cur = p_len + 1  # tokens so far
    while cur < t_total and not bool(finished.all()):
        i = cur - 1  # query index = the last appended token
        present = present | (seq[:, i - 1, None] == specials[None, :])
        ttype = _type_from_present(present, gen_cfg)
        if masked_pads:
            pos = torch.clamp(real_count - 1, min=0)
        else:
            pos = torch.full((b,), i, dtype=torch.long, device=dev)
        logits, cache = bert_mod.bert_step(
            model.decoder, cache, seq[:, i], ttype, pos, i, key_mask, encoder_mask,
            use_fused=use_fused, fused_prepared=fused_prepared,
            decode_kernel=decode_kernel, cross_q8=cross_q8)
        tok = select_token(logits)
        tok = torch.where(finished, torch.full_like(tok, gen_cfg.pad_token_id), tok)
        finished = finished | (tok == gen_cfg.eos_token_id)
        seq[:, cur] = tok
        nm = new_key_mask(tok)
        key_mask[:, cur] = nm
        real_count = real_count + nm
        cur += 1
    return seq
