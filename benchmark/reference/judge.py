"""The comparison that decides a served cell's ``correct``.

For a sample of the studies that the window served, the plain reference
(``reference.model``) encodes their images and runs the decoder over the
prompt that it makes again (``reference.prompt``) with the served tokens
after it, and these numbers are read:

  ``token_gap``    the widest gap by which a served token's reference logit
                   lies below the reference's k-th best logit at its
                   position (0 where it is not below): k = 1 for greedy
                   tokens; for beam search k = 2 * beams, since a beam step
                   keeps the 2K best (beam, token) pairs and so each kept
                   token is among its own beam's 2K best.
  ``score_gap``    beam search only: the largest difference between the
                   program's score of a returned sequence and the
                   reference's (the mean log-probability of its new tokens,
                   EOS included, under length penalty 1).
  ``encoder_err``  the largest relative distance (Frobenius, over the real
                   image tokens) between the program's encoder output for a
                   study and the reference's.
  ``prompt_err``   the prompt columns of the whole judged batch as served
                   against the reference's (``reference.prompt``, made again
                   from the studies' previous reports): the count of ids
                   that differ, every column counted where the widths do.
  ``logit_err``    greedy only: the same of the logits that the program's
                   decode steps gave the study (each step's scores, kept by
                   the harness), against the reference's at those positions.

Tokens after a row's first EOS are padding that no logit chose; they are
not judged.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.reference.model import encode_studies, fp32_mode, served_logits


def new_token_counts(new_tokens: torch.Tensor, eos: int) -> torch.Tensor:
    """[B, G] served tokens -> tokens up to and including each row's first EOS."""
    g = new_tokens.shape[1]
    hit = new_tokens == eos
    first = torch.where(hit.any(dim=1), hit.int().argmax(dim=1), torch.full_like(hit[:, 0], g - 1,
                                                                                  dtype=torch.long))
    return first + 1


def reference_outputs(sd, cfg, tok: dict, pixels, seqs, p_len: int, first_col: int,
                      precision: str = "fp32") -> dict:
    """The reference's encoder output and the logits behind every served
    token, in ``precision``."""
    with fp32_mode(), torch.no_grad():
        hidden, mask = encode_studies(sd, cfg, pixels, precision)
        logits = served_logits(sd, cfg, tok, seqs, p_len, first_col, hidden, mask, precision)
    return {"hidden": hidden, "mask": mask, "logits": logits}


def sequence_scores(logits: torch.Tensor, tokens: torch.Tensor, counts: torch.Tensor
                    ) -> torch.Tensor:
    """Mean log-probability of each row's first ``counts`` tokens."""
    lp = torch.log_softmax(logits, dim=-1).gather(-1, tokens[..., None].long())[..., 0]
    keep = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < counts[:, None]
    return (lp * keep).sum(dim=1) / counts


def token_gap(ref_logits: torch.Tensor, tokens: torch.Tensor, counts: torch.Tensor,
              k: int) -> float:
    kth = torch.topk(ref_logits, k, dim=-1).values[..., -1]
    got = ref_logits.gather(-1, tokens[..., None].long())[..., 0]
    keep = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < counts[:, None]
    return float(torch.clamp((kth - got) * keep, min=0.0).max())


def encoder_err(ref_hidden: torch.Tensor, mask: torch.Tensor, hidden: torch.Tensor) -> float:
    m = mask[..., None].float()
    diff = ((hidden.float() - ref_hidden) * m).flatten(1).norm(dim=1)
    return float((diff / (ref_hidden * m).flatten(1).norm(dim=1)).max())


def logit_err(ref_logits: torch.Tensor, counts: torch.Tensor, logits: torch.Tensor) -> float:
    """Relative distance of the decode steps' logits [B, S, V], which chose
    the served tokens 1..S, from the reference's, up to each row's EOS."""
    want = ref_logits[:, 1:1 + logits.shape[1]]
    keep = (torch.arange(1, 1 + logits.shape[1], device=counts.device)[None, :]
            < counts[:, None])[..., None].float()
    diff = ((logits.float() - want) * keep).flatten(1).norm(dim=1)
    return float((diff / (want * keep).flatten(1).norm(dim=1)).max())


def prompt_err(want: torch.Tensor, served: torch.Tensor) -> float:
    if want.shape != served.shape:
        return float(max(want.numel(), served.numel()))
    return float((want != served.to(want.device)).sum())


def numbers(ref: dict, tokens: torch.Tensor, eos: int, beams: int,
            hidden: Optional[torch.Tensor] = None, scores: Optional[torch.Tensor] = None,
            logits: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """The compared numbers of one side (the program's outputs, or a
    control's) against the reference's outputs ``ref``."""
    counts = new_token_counts(tokens, eos)
    out = {"token_gap": token_gap(ref["logits"], tokens, counts, 1 if beams == 1 else 2 * beams)}
    if beams > 1 and scores is not None:
        want = sequence_scores(ref["logits"], tokens, counts)
        out["score_gap"] = float((scores.float() - want).abs().max())
    if hidden is not None:
        out["encoder_err"] = encoder_err(ref["hidden"], ref["mask"], hidden)
    if logits is not None:
        out["logit_err"] = logit_err(ref["logits"], counts, logits)
    return out


def control_numbers(ref: dict, low: dict, tokens: torch.Tensor, eos: int, beams: int
                    ) -> Dict[str, float]:
    """The numbers of the reference computed in a lower precision (``low``)
    put in the program's place, on the same prompts and served tokens: the
    token the lower precision puts first at each position, the lower
    precision's score of each served sequence, its encoder output."""
    counts = new_token_counts(tokens, eos)
    k = 1 if beams == 1 else 2 * beams
    out = {"token_gap": token_gap(ref["logits"], low["logits"].argmax(dim=-1), counts, k)}
    if beams > 1:
        out["score_gap"] = float((sequence_scores(low["logits"], tokens, counts)
                                  - sequence_scores(ref["logits"], tokens, counts)).abs().max())
    else:
        out["logit_err"] = logit_err(ref["logits"], counts, low["logits"][:, 1:])
    out["encoder_err"] = encoder_err(ref["hidden"], ref["mask"], low["hidden"])
    return out
