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

``scst_rollout_decode`` (:412/:446) runs SCST's sampled rollout and its greedy
baseline in one loop, the baseline rows folded into the batch; it shares
``generate``'s loop (``_decode``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from cxrmate_torch.generate.logits_process import warp_logits
from cxrmate_torch.models import bert as bert_mod
from cxrmate_torch.models import encoder_decoder as ed
from cxrmate_torch.ops.decode_attention import resolve_decode_kernel
from cxrmate_torch.ops.fused_decode import prepare_fused_params
from cxrmate_torch.ops.layers import draw
from cxrmate_torch.utils import tracing


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
            prompt_ids, t_total: int, prompt_types: Optional[torch.Tensor] = None):
    """Prompt-side ids, a cache of width ``t_total`` and the prefill pass.
    ``prompt_types`` defaults to ``gen_cfg``'s section rule over the prompt.
    Returns (prefill logits [B, P, V], cache, prompt attention mask [B, P])."""
    dcfg = model.config.decoder
    b, p_len = prompt_ids.shape
    dev = prompt_ids.device
    with tracing.span("prefill"):
        if prompt_types is None:
            prompt_types = ed.token_ids_to_token_type_ids(
                prompt_ids, gen_cfg.special_token_ids, gen_cfg.sections())
        if gen_cfg.mask_token_id is not None:
            attn_prompt = (prompt_ids != gen_cfg.mask_token_id).to(torch.int32)
            prompt_pos = ed.cumulative_position_ids(attn_prompt)
        else:
            attn_prompt = torch.ones(b, p_len, dtype=torch.int32, device=dev)
            prompt_pos = torch.arange(p_len, device=dev).expand(b, p_len)
        cache = bert_mod.init_cache(dcfg, b, t_total, encoder_hidden.shape[1],
                                    dtype=encoder_hidden.dtype, device=dev,
                                    heads=bert_mod.local_heads(model.decoder))
        logits, cache = bert_mod.bert_prefill(model.decoder, cache, prompt_ids, attn_prompt,
                                              prompt_types, prompt_pos, encoder_hidden,
                                              encoder_mask)
    return logits, cache, attn_prompt


Select = Callable[[torch.Tensor], Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _decode(model: ed.EncoderDecoder, cfgs: Tuple[GenerationConfig, ...],
            encoder_hidden: torch.Tensor, encoder_mask: torch.Tensor, prompt_ids: torch.Tensor,
            max_new: int, select: Select, *, use_fused: bool = False,
            prompt_logits_col: Optional[int] = None, decode_kernel: str = "",
            return_scores: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The decode loop of :func:`generate` and :func:`scst_rollout_decode`.

    The rows split into ``len(cfgs)`` equal blocks; block j takes its token
    types from ``cfgs[j]``'s specials and sections (over the prompt, and as
    tokens are decoded), the ids and the mask-token rule from ``cfgs[0]``.
    ``select(logits [B, V]) -> (tokens [B], the step's scores [B, V] or None)``
    picks each step's tokens. Returns (sequences [B, P + max_new], scores
    [B, max_new, V] fp32 with ``return_scores``, else None)."""
    cfg = cfgs[0]
    masked_pads = cfg.mask_token_id is not None
    b, p_len = prompt_ids.shape
    t_total = p_len + max_new
    dev = prompt_ids.device
    n = b // len(cfgs)
    rows = [slice(j * n, (j + 1) * n) for j in range(len(cfgs))]
    prompt_types = torch.cat([ed.token_ids_to_token_type_ids(
        prompt_ids[r], c.special_token_ids, c.sections()) for r, c in zip(rows, cfgs)])
    if use_fused and model.decoder.tp is not None:
        raise NotImplementedError(bert_mod.FUSED_TP)
    fused = use_fused and model.config.lora is None
    # the fused kernels' per-layer operands, built once, never per step
    fused_prepared = (prepare_fused_params(model.decoder, model.config.decoder.num_attention_heads)
                      if fused else None)
    prefill_logits, cache, attn_prompt = prefill(model, cfg, encoder_hidden, encoder_mask,
                                                 prompt_ids, t_total, prompt_types)
    if fused:
        cross_q8 = None  # the fused path ignores decode_kernel (bert_step warns)
    else:  # int8 serving decode: quantise the cross cache once, after prefill
        cache, cross_q8 = bert_mod.maybe_quantize_cross_cache(cache, decode_kernel)

    seq = torch.full((b, t_total), cfg.pad_token_id, dtype=prompt_ids.dtype, device=dev)
    seq[:, :p_len] = prompt_ids
    key_mask = torch.zeros(b, t_total, dtype=torch.int32, device=dev)
    key_mask[:, :p_len] = attn_prompt
    # specials seen in seq[:, :cur-1]: the current query token is not folded
    # in yet (HF drops the last column in token_ids_to_token_type_ids_past)
    present = [_specials_present(prompt_ids[r], c) for r, c in zip(rows, cfgs)]
    tracing.count("host_read", len(cfgs))  # torch.tensor of a list: a blocking copy each
    specials = [torch.tensor(c.special_token_ids, device=dev) for c in cfgs]
    real_count = attn_prompt.sum(dim=1)
    scores = (torch.zeros(b, max_new, model.config.decoder.vocab_size, device=dev)
              if return_scores else None)

    def new_key_mask(tok):
        if masked_pads:
            return (tok != cfg.mask_token_id).to(torch.int32)
        return torch.ones(b, dtype=torch.int32, device=dev)

    def put(tok, step_scores, cur):
        nonlocal real_count
        seq[:, cur] = tok
        nm = new_key_mask(tok)
        key_mask[:, cur] = nm
        real_count = real_count + nm
        if return_scores:
            scores[:, cur - p_len] = step_scores

    def stop() -> bool:
        """The loop's one host read a step, the stop test and the draws'
        validity. It closes a step: it waits for the step's tokens. The
        first, after the prefill's token, stands outside any step."""
        with tracing.span("stop_check"):
            tracing.count("host_read")
            done, bad = torch.stack([finished.all(), invalid.any()]).tolist()
        if bad:
            raise FloatingPointError(
                "sampling met probabilities that are not finite (a NaN or inf logit); "
                "torch.multinomial refuses such a distribution")
        return done or cur >= t_total

    first_col = p_len - 1 if prompt_logits_col is None else prompt_logits_col
    with tracing.span("select"):
        tok, step_scores = select(prefill_logits[:, first_col])
        tok = tok.to(seq.dtype)
        invalid = tok < 0  # a sampled row whose probabilities were not finite (_draw)
        finished = tok == cfg.eos_token_id
        put(tok, step_scores, p_len)

    cur = p_len + 1  # tokens so far
    stopped = stop()
    while not stopped:
        with tracing.span("decode_step"):
            tracing.count("decode_steps")
            i = cur - 1  # query index = the last appended token
            present = [p | (seq[r, i - 1, None] == s[None, :])
                       for p, r, s in zip(present, rows, specials)]
            types = [_type_from_present(p, c) for p, c in zip(present, cfgs)]
            ttype = types[0] if len(types) == 1 else torch.cat(types)
            if masked_pads:
                pos = torch.clamp(real_count - 1, min=0)
            else:
                pos = torch.full((b,), i, dtype=torch.long, device=dev)
            with tracing.span("bert_step"):
                logits, cache = bert_mod.bert_step(
                    model.decoder, cache, seq[:, i], ttype, pos, i, key_mask, encoder_mask,
                    use_fused=use_fused, fused_prepared=fused_prepared,
                    decode_kernel=decode_kernel, cross_q8=cross_q8)
            with tracing.span("select"):
                tok, step_scores = select(logits)
                tok = tok.to(seq.dtype)
                invalid = invalid | (tok < 0)
                tok = torch.where(finished, torch.full_like(tok, cfg.pad_token_id), tok)
                finished = finished | (tok == cfg.eos_token_id)
                put(tok, step_scores, cur)
            cur += 1
            stopped = stop()
    return seq, scores


def _draw(warped: torch.Tensor, generator) -> torch.Tensor:
    """One token per row from softmax(warped): ``torch.multinomial(p, 1,
    generator=g)`` written out as PyTorch's one-sample path computes it
    (``aten/src/ATen/native/Distributions.cpp``): exponentials q of p's shape,
    then the argmax of p / q. So an ``ops.layers.RowStripe`` can draw q for
    the global batch and keep its rows; with a ``torch.Generator`` the
    tokens are ``multinomial``'s, bit for bit. Where ``multinomial`` raises
    (a row's probabilities not finite: a NaN or inf logit) the row's token is
    -1, which :func:`_decode` refuses at its next host read; no sync here."""
    p = torch.softmax(warped, dim=-1)
    q = draw(generator, p.shape, lambda shape, g: torch.empty(
        shape, dtype=p.dtype, device=p.device).exponential_(generator=g))
    return torch.where(torch.isfinite(p).all(dim=-1), torch.argmax(p / q, dim=-1), -1)


@torch.no_grad()
def generate(model: ed.EncoderDecoder, gen_cfg: GenerationConfig, encoder_hidden: torch.Tensor,
             encoder_mask: torch.Tensor, prompt_ids: torch.Tensor, prompt_mask: torch.Tensor,
             generator: Optional[torch.Generator] = None, *,
             max_new_tokens_pad: Optional[int] = None, return_scores: bool = False,
             use_fused: bool = False, prompt_logits_col: Optional[int] = None,
             decode_kernel: Optional[str] = None):
    """Greedy or sampled decoding (``num_beams == 1``).

    Args:
      encoder_hidden/encoder_mask: from ``encoder_decoder.encode_images``.
      prompt_ids/prompt_mask: [B, P]; for single/multi a [B, 1] BOS column.
        The decoder's own mask comes from ``gen_cfg`` (all ones, or
        ``prompt_ids != mask_token_id``), as in the JAX package.
      generator: the ``torch.Generator`` (on the model's device) that
        ``gen_cfg.do_sample`` draws from; required when sampling.
      max_new_tokens_pad: decode this many new tokens instead of
        ``gen_cfg.max_new_tokens`` (the sequences' width), as in JAX.
      return_scores: also return each step's scores [B, max_new, V] in fp32:
        the warped logits when sampling, the logits otherwise (what SCST's
        sample path keeps); columns after the loop stopped stay 0.
      use_fused: run every decode step's layers through the fused
        decoder-layer kernels (``ops.fused_decode``), greedy or sampled. A
        model with LoRA takes the unfused path all the same; ``decode_kernel``
        is ignored on the fused path (``bert_step`` warns) and no int8 cross
        cache is made. A decoder cut to a model rank's shard raises
        ``NotImplementedError`` (the fused kernels take a whole layer).
      prompt_logits_col: column of the prefill logits that gives the first
        token; the last prompt column by default. When the prompt is
        bucket-padded beyond the batch's longest row, pass the true longest
        width - 1: the result then equals the unpadded batch's.
      decode_kernel: decode-attention routing spec, resolved here, once per
        call (``ops.decode_attention.resolve_decode_kernel``; ``None`` reads
        ``CXRMATE_DECODE_KERNEL``).
    Returns sequences [B, P + max_new] (and the scores with ``return_scores``).
    """
    if gen_cfg.num_beams != 1:
        raise ValueError("generate is greedy; use generate.beam.beam_search for num_beams > 1")
    if gen_cfg.do_sample and generator is None:
        raise ValueError("do_sample needs a torch.Generator on the model's device")
    del prompt_mask

    def select(logits):
        logits = logits.float()
        if gen_cfg.do_sample:
            warped = warp_logits(logits, gen_cfg.temperature, gen_cfg.top_k, gen_cfg.top_p)
            return _draw(warped, generator), warped
        return torch.argmax(logits, dim=-1), logits

    max_new = gen_cfg.max_new_tokens if max_new_tokens_pad is None else max_new_tokens_pad
    seq, scores = _decode(model, (gen_cfg,), encoder_hidden, encoder_mask, prompt_ids, max_new,
                          select, use_fused=use_fused, prompt_logits_col=prompt_logits_col,
                          decode_kernel=resolve_decode_kernel(decode_kernel),
                          return_scores=return_scores)
    return (seq, scores) if return_scores else seq


@torch.no_grad()
def scst_rollout_decode(model: ed.EncoderDecoder, cfg_sample: GenerationConfig,
                        cfg_base: GenerationConfig, encoder_hidden: torch.Tensor,
                        encoder_mask: torch.Tensor, prompt_ids: torch.Tensor,
                        prompt_mask: torch.Tensor, generator: torch.Generator, *,
                        prompt_logits_col: Optional[int] = None,
                        decode_kernel: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SCST's rollout: the sampled sequences and the greedy baselines in one
    decode loop, the baseline rows [B, 2B) folded into the batch behind the
    sampled rows [0, B), over one cross cache of 2B rows.

    The prompt goes in twice; each half takes its token types from its own
    config (the reference samples with specials ``(BOS, SEP)`` and decodes
    the baseline with ``(PMT-SEP, BOS, SEP)``). Both configs use the
    mask-token rule with the same pad/BOS/EOS/mask ids and the same
    ``max_new_tokens``. The sample half draws from ``generator`` over its rows
    only, in :func:`generate`'s order: given equal logits it gives what
    ``generate(do_sample=True)`` gives, and the greedy half what greedy
    ``generate`` gives. ``prompt_logits_col`` and ``decode_kernel`` as in
    :func:`generate` (``cross-rowgroup-q8`` quantises the doubled cross cache
    once). Returns (sampled [B, P + max_new], baseline [B, P + max_new])."""
    if not (cfg_sample.do_sample and not cfg_base.do_sample):
        raise ValueError("cfg_sample must sample and cfg_base must be greedy")
    if cfg_sample.mask_token_id is None or cfg_sample.mask_token_id != cfg_base.mask_token_id:
        raise ValueError("both configs need the same mask_token_id (the SCST configuration)")
    for f in ("bos_token_id", "eos_token_id", "pad_token_id", "max_new_tokens"):
        if getattr(cfg_sample, f) != getattr(cfg_base, f):
            raise ValueError(f"cfg_sample and cfg_base differ in {f}")
    del prompt_mask
    b = prompt_ids.shape[0]

    def select(logits):
        warped = warp_logits(logits[:b].float(), cfg_sample.temperature, cfg_sample.top_k,
                             cfg_sample.top_p)
        greedy = torch.argmax(logits[b:].float(), dim=-1)
        return torch.cat([_draw(warped, generator), greedy]), None

    seq, _ = _decode(model, (cfg_sample, cfg_base), torch.cat([encoder_hidden, encoder_hidden]),
                     torch.cat([encoder_mask, encoder_mask]), torch.cat([prompt_ids, prompt_ids]),
                     cfg_sample.max_new_tokens, select, prompt_logits_col=prompt_logits_col,
                     decode_kernel=resolve_decode_kernel(decode_kernel))
    return seq[:b], seq[b:]
