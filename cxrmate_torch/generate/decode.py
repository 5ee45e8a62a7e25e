"""Greedy decoding with a static KV cache.

The port of ``cxrmate_tpu/generate/decode.py`` (``generate`` :176/:222) for the
single/multi semantics of HF ``generate`` as the reference drives it: the
decoder attention mask is all ones (also over post-EOS padding), position ids
are absolute, token types switch sections after the first occurrence of each
special token, and sequences are pad-filled after EOS to the static width
``P + max_new_tokens``. A Python loop replaces ``lax.while_loop``; it stops
when every row has finished or the width is reached. The self cache has one
static width ``P + max_new_tokens`` (the JAX package's segmented growth is
bit-exact either way and is not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cxrmate_torch.models import bert as bert_mod
from cxrmate_torch.models import encoder_decoder as ed


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 4
    special_token_ids: Tuple[int, ...] = (3,)  # section boundaries for token types
    num_beams: int = 1
    do_sample: bool = False
    length_penalty: float = 1.0
    early_stopping: bool = False

    def sections(self) -> Tuple[int, ...]:
        return tuple(range(len(self.special_token_ids) + 1))


def check_supported(gen_cfg: GenerationConfig) -> None:
    """Reject the decoding options this slice of the port does not run yet."""
    if gen_cfg.do_sample:
        raise NotImplementedError("sampling is not ported yet (ROADMAP.md queue 1, item 10)")


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
    Returns (prefill logits [B, P, V], cache)."""
    dcfg = model.config.decoder
    b, p_len = prompt_ids.shape
    dev = prompt_ids.device
    prompt_types = ed.token_ids_to_token_type_ids(
        prompt_ids, gen_cfg.special_token_ids, gen_cfg.sections())
    attn_prompt = torch.ones(b, p_len, dtype=torch.int32, device=dev)
    prompt_pos = torch.arange(p_len, device=dev).expand(b, p_len)
    cache = bert_mod.init_cache(dcfg, b, t_total, encoder_hidden.shape[1],
                                dtype=encoder_hidden.dtype, device=dev)
    return bert_mod.bert_prefill(model.decoder, cache, prompt_ids, attn_prompt, prompt_types,
                                 prompt_pos, encoder_hidden, encoder_mask)


@torch.no_grad()
def generate(model: ed.EncoderDecoder, gen_cfg: GenerationConfig, encoder_hidden: torch.Tensor,
             encoder_mask: torch.Tensor, prompt_ids: torch.Tensor,
             prompt_mask: torch.Tensor) -> torch.Tensor:
    """Greedy decoding (``num_beams == 1``).

    Args:
      encoder_hidden/encoder_mask: from ``encoder_decoder.encode_images``.
      prompt_ids/prompt_mask: [B, P]; for single/multi a [B, 1] BOS column.
        The first new token comes from the last prompt column.
    Returns sequences [B, P + max_new_tokens].
    """
    check_supported(gen_cfg)
    if gen_cfg.num_beams != 1:
        raise ValueError("generate is greedy; use generate.beam.beam_search for num_beams > 1")
    del prompt_mask  # single/multi: the decoder mask is all ones (HF default)
    b, p_len = prompt_ids.shape
    max_new = gen_cfg.max_new_tokens
    t_total = p_len + max_new
    dev = prompt_ids.device
    prefill_logits, cache = prefill(model, gen_cfg, encoder_hidden, encoder_mask, prompt_ids,
                                    t_total)

    seq = torch.full((b, t_total), gen_cfg.pad_token_id, dtype=prompt_ids.dtype, device=dev)
    seq[:, :p_len] = prompt_ids
    key_mask = torch.zeros(b, t_total, dtype=torch.int32, device=dev)
    key_mask[:, :p_len] = 1
    # specials seen in seq[:, :cur-1]: the current query token is not folded
    # in yet (HF drops the last column in token_ids_to_token_type_ids_past)
    present = _specials_present(prompt_ids, gen_cfg)

    tok = torch.argmax(prefill_logits[:, -1].float(), dim=-1).to(seq.dtype)
    finished = tok == gen_cfg.eos_token_id
    seq[:, p_len] = tok
    key_mask[:, p_len] = 1
    specials = torch.tensor(gen_cfg.special_token_ids, device=dev)

    cur = p_len + 1  # tokens so far
    while cur < t_total and not bool(finished.all()):
        i = cur - 1  # query index = the last appended token
        present = present | (seq[:, i - 1, None] == specials[None, :])
        ttype = _type_from_present(present, gen_cfg)
        pos = torch.full((b,), i, dtype=torch.long, device=dev)
        logits, cache = bert_mod.bert_step(
            model.decoder, cache, seq[:, i], ttype, pos, i, key_mask, encoder_mask)
        tok = torch.argmax(logits.float(), dim=-1).to(seq.dtype)
        tok = torch.where(finished, torch.full_like(tok, gen_cfg.pad_token_id), tok)
        finished = finished | (tok == gen_cfg.eos_token_id)
        seq[:, cur] = tok
        key_mask[:, cur] = 1
        cur += 1
    return seq
