"""Beam search with a static KV cache.

The port of ``cxrmate_tpu/generate/beam.py:55/:90`` (HF ``_beam_search``
semantics, transformers 4.57): 2K candidates per step, finalisation restricted
to the top-K candidates, the length penalty applied at finalisation, the
early-stop heuristic, pad-filled static sequence buffers.

Each study is prefilled once; its self cache is tiled over the K beams while
the cross cache stays per study (``bert_step`` folds the beams into the decode
kernel's query rows). The cache write follows the JAX package's ``'pallas'``
write mode (beam.py:279-298): ``bert_step(deferred_write=True)``, then one
in-place reorder + column write per layer (``ops.beam_reorder``).

Top-k is a stable descending sort: ``jax.lax.top_k`` puts the lower index
first on ties, and the NEG-filled finished slots tie exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cxrmate_torch.generate.decode import GenerationConfig, _type_from_present, prefill
from cxrmate_torch.models import bert as bert_mod
from cxrmate_torch.models import encoder_decoder as ed
from cxrmate_torch.ops import beam_reorder as br
from cxrmate_torch.ops.decode_attention import resolve_decode_kernel

NEG = -1.0e9


def _gather_beams(tensor: torch.Tensor, beam_indices: torch.Tensor) -> torch.Tensor:
    """[B, K_src, ...] gathered along dim 1 by [B, K_out] indices."""
    idx = beam_indices.long()
    idx = idx.reshape(idx.shape + (1,) * (tensor.dim() - 2))
    return torch.gather(tensor, 1, idx.expand(*beam_indices.shape, *tensor.shape[2:]))


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, the lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def beam_search(model: ed.EncoderDecoder, gen_cfg: GenerationConfig,
                encoder_hidden: torch.Tensor, encoder_mask: torch.Tensor,
                prompt_ids: torch.Tensor, prompt_mask: torch.Tensor,
                prompt_logits_col: Optional[int] = None,
                decode_kernel: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-search decode -> (sequences [B, P + max_new], scores [B]): the best
    finished hypothesis per study (HF ``num_return_sequences=1``).
    ``prompt_logits_col`` and ``decode_kernel`` as in ``decode.generate``; the
    decoder's mask comes from ``gen_cfg`` (``mask_token_id``)."""
    del prompt_mask
    decode_kernel = resolve_decode_kernel(decode_kernel)
    masked_pads = gen_cfg.mask_token_id is not None
    k = gen_cfg.num_beams
    b, p_len = prompt_ids.shape
    dev = prompt_ids.device
    t_total = p_len + gen_cfg.max_new_tokens
    keep = 2 * k  # beams to keep with one EOS token
    vocab = model.config.decoder.vocab_size
    penalty = gen_cfg.length_penalty
    early_stopping = gen_cfg.early_stopping

    prefill_logits, cache, _ = prefill(model, gen_cfg, encoder_hidden, encoder_mask, prompt_ids,
                                       t_total)
    # tile the self cache to B*K rows (beam-major within each study); the
    # cross cache and encoder mask stay per study
    cache.self_k = [x.repeat_interleave(k, dim=0) for x in cache.self_k]
    cache.self_v = [x.repeat_interleave(k, dim=0) for x in cache.self_v]
    # int8 serving decode: quantise the per-study cross cache once
    cache, cross_q8 = bert_mod.maybe_quantize_cross_cache(cache, decode_kernel)

    seq = torch.full((b, k, t_total), gen_cfg.pad_token_id, dtype=prompt_ids.dtype, device=dev)
    seq[:, :, :p_len] = prompt_ids[:, None, :]
    running_scores = torch.full((b, k), NEG, device=dev)
    running_scores[:, 0] = 0.0
    fin_seq = seq.clone()
    fin_scores = torch.full((b, k), NEG, device=dev)
    is_fin = torch.zeros(b, k, dtype=torch.bool, device=dev)
    early_unsat = torch.ones(b, 1, dtype=torch.bool, device=dev)
    top_k_mask = torch.arange(keep, device=dev) < k  # only top-K candidates may finalise
    cols = torch.arange(t_total, device=dev)
    specials = torch.tensor(gen_cfg.special_token_ids, device=dev)
    zero_kv = None

    def select_and_update(log_probs_flat, cur: int, pending=None, write_idx: int = -1):
        """One beam step given per-beam next-token log-probs [B*K, V]; the
        new token lands at column ``cur``. Returns all_hit (a device bool)."""
        nonlocal seq, running_scores, fin_seq, fin_scores, is_fin, early_unsat, zero_kv
        log_probs = log_probs_flat.reshape(b, k, vocab) + running_scores[:, :, None]
        topk_log_probs, topk_idx = top_k(log_probs.reshape(b, k * vocab), keep)
        beam_idx = topk_idx // vocab
        tok = (topk_idx % vocab).to(seq.dtype)
        topk_seq = _gather_beams(seq, beam_idx)
        topk_seq[:, :, cur] = tok

        # stopping criteria per candidate: EOS or max length reached
        hits = (tok == gen_cfg.eos_token_id) | (cur + 1 >= t_total)

        # finalisation (HF _update_finished_beams)
        lp_scores = topk_log_probs / float((cur + 1 - p_len) ** penalty)
        can_finalise = hits & top_k_mask[None, :]
        lp_scores = lp_scores + torch.where(can_finalise, 0.0, NEG)
        lp_scores = lp_scores + torch.where(early_unsat, 0.0, NEG)
        if early_stopping:
            # HF: once a study's beams are all finished, no further additions
            beams_full = is_fin.all(dim=-1, keepdim=True)
            lp_scores = lp_scores + torch.where(beams_full, NEG, 0.0)
        merged_seq = torch.cat([fin_seq, topk_seq], dim=1)
        merged_scores = torch.cat([fin_scores, lp_scores], dim=1)
        merged_fin = torch.cat([is_fin, can_finalise], dim=1)
        best = top_k(merged_scores, k)[1]
        fin_seq = _gather_beams(merged_seq, best)
        fin_scores = _gather_beams(merged_scores, best)
        is_fin = _gather_beams(merged_fin, best)

        # next running beams (finished candidates demoted)
        running_log_probs = topk_log_probs + hits.float() * NEG
        nxt = top_k(running_log_probs, k)[1]
        seq = _gather_beams(topk_seq, nxt)
        running_scores = _gather_beams(running_log_probs, nxt)
        sel_local = _gather_beams(beam_idx, nxt).reshape(b * k).to(torch.int32).contiguous()

        # in-place reorder of the self cache by source beam + this step's column
        for li in range(len(cache.self_k)):
            if pending is None:
                if zero_kv is None:
                    zero_kv = torch.zeros_like(cache.self_k[li][:, :, 0])
                nk = nv = zero_kv
            else:
                nk, nv = pending[0][li], pending[1][li]
            br.beam_reorder_write(cache.self_k[li], cache.self_v[li], nk, nv, sel_local,
                                  write_idx, k)

        # early-stop heuristic (HF _check_early_stop_heuristic): the current
        # generated length stands in for the best hypothetical length
        best_possible = running_scores[:, :1] / float((cur + 1 - p_len) ** penalty)
        worst_fin = torch.where(is_fin, fin_scores.min(dim=1, keepdim=True).values,
                                torch.full_like(fin_scores, NEG))
        early_unsat = early_unsat & (best_possible > worst_fin).any(dim=-1, keepdim=True)
        all_hit = hits.all()
        if early_stopping:
            all_hit = all_hit | is_fin.all()
        return all_hit

    # first step from the prefill logits
    first_col = p_len - 1 if prompt_logits_col is None else prompt_logits_col
    lp0 = torch.log_softmax(prefill_logits[:, first_col].float(), dim=-1)
    all_hit = select_and_update(lp0.repeat_interleave(k, dim=0), p_len)
    cur = p_len + 1
    while cur < t_total and bool(early_unsat.any() & ~all_hit):
        seq_flat = seq.reshape(b * k, t_total)
        i = cur - 1
        before = cols[None, :] < i
        present = ((seq_flat[:, :, None] == specials) & before[:, :, None]).any(dim=1)
        ttype = _type_from_present(present, gen_cfg)
        upto = cols <= i
        if masked_pads:
            key_mask = ((seq_flat != gen_cfg.mask_token_id) & upto).to(torch.int32)
            pos = torch.clamp(key_mask.sum(dim=1) - 1, min=0)
        else:
            key_mask = upto.to(torch.int32).expand(b * k, t_total)
            pos = torch.full((b * k,), i, dtype=torch.long, device=dev)
        logits, pending = bert_mod.bert_step(
            model.decoder, cache, seq_flat[:, i], ttype, pos, i, key_mask, encoder_mask,
            deferred_write=True, decode_kernel=decode_kernel, cross_q8=cross_q8)
        lp = torch.log_softmax(logits.float(), dim=-1)
        all_hit = select_and_update(lp, cur, pending, write_idx=i)
        cur += 1
    return fin_seq[:, 0, :], fin_scores[:, 0]
