"""CXRMate encoder-decoder. ``multi`` and ``longitudinal``: a study's image
stack is encoded by CvT, projected, and concatenated along the token axis;
all-zero image slots are padding and masked out of cross-attention.
``single``: one image per example, no encoder mask. ``longitudinal`` adds the
previous report as a decoder prompt.

The port of ``cxrmate_tpu/models/encoder_decoder.py``'s serving helpers
(``encode_images`` :40, ``token_ids_to_token_type_ids`` :145 and ``_past``
:173, ``tokenize_report_teacher_forcing`` :196, ``tokenize_prompt`` :213,
``split_and_decode_sections`` :241, ``bucket_prompt`` :264,
``cumulative_position_ids`` :284).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from cxrmate_torch.configs import EncoderDecoderConfig
from cxrmate_torch.models.bert import BertLMHeadModel
from cxrmate_torch.models.cvt import CvtWithProjectionHead, cvt_encode


class EncoderDecoder(nn.Module):
    """Parameter holder with the key layout of the released checkpoints
    (``encoder.*`` = CvtWithProjectionHead, ``decoder.*`` = BertLMHeadModel)."""

    def __init__(self, config: EncoderDecoderConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.encoder = CvtWithProjectionHead(config.encoder, device=device, dtype=dtype)
        self.decoder = BertLMHeadModel(config.decoder, config.lora, device=device, dtype=dtype)


def encode_images(model: EncoderDecoder, pixel_values: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, N, 3, H, W] pixel values -> (encoder_hidden [B, N*T_img, P],
    encoder_mask [B, N*T_img] int32). The N images are folded into the batch
    for CvT; an image is padding iff its pixel [0, 0, 0] is exactly 0
    (reference modelling_multi.py:80). ``single``: [B, 3, H, W], or slot 0 of
    a 5-D batch (its other slots are padding), and a mask of all ones."""
    if model.config.variant == "single":
        if pixel_values.dim() == 5:
            pixel_values = pixel_values[:, 0]
        hidden = cvt_encode(model.encoder, pixel_values)
        return hidden, torch.ones(hidden.shape[:2], dtype=torch.int32, device=hidden.device)
    b, n = pixel_values.shape[:2]
    flat = pixel_values.reshape((b * n,) + tuple(pixel_values.shape[2:]))
    hidden = cvt_encode(model.encoder, flat)
    tokens_per = hidden.shape[1]
    hidden = hidden.reshape(b, n * tokens_per, hidden.shape[-1])
    img_mask = (pixel_values[:, :, 0, 0, 0] != 0.0).to(torch.int32)
    mask = img_mask.repeat_interleave(tokens_per, dim=1)
    return hidden, mask


def token_ids_to_token_type_ids(token_ids: torch.Tensor, special_token_ids: Sequence[int],
                                token_type_id_sections: Optional[Sequence[int]] = None
                                ) -> torch.Tensor:
    """For each special token (in order), positions strictly after its first
    occurrence take the next section's type id (modelling_single.py:251-292);
    a boundary at column 0, or an absent token, is ignored."""
    sections = (list(token_type_id_sections) if token_type_id_sections is not None
                else list(range(len(special_token_ids) + 1)))
    b, l = token_ids.shape
    cols = torch.arange(l, device=token_ids.device)
    out = torch.full((b, l), sections[0], dtype=torch.int32, device=token_ids.device)
    for i, sid in enumerate(special_token_ids):
        first = torch.argmax((token_ids == sid).to(torch.int32), dim=1)  # 0 when absent
        exists = (first != 0) & (first + 1 < l)
        after = cols[None, :] > first[:, None]
        out = torch.where(exists[:, None] & after,
                          torch.tensor(sections[i + 1], dtype=torch.int32, device=out.device), out)
    return out


def token_ids_to_token_type_ids_past(token_ids: torch.Tensor, special_token_ids: Sequence[int],
                                     token_type_id_sections: Optional[Sequence[int]] = None
                                     ) -> torch.Tensor:
    """Type id of the *next* token given everything decoded so far
    (modelling_single.py:294-318): the last column, the current token that is
    not embedded yet, is left out; the last special present wins."""
    sections = (list(token_type_id_sections) if token_type_id_sections is not None
                else list(range(len(special_token_ids) + 1)))
    past = token_ids[:, :-1]
    out = torch.full((token_ids.shape[0],), sections[0], dtype=torch.int32,
                     device=token_ids.device)
    for i, sid in enumerate(special_token_ids):
        exists = (past == sid).any(dim=1)
        out = torch.where(exists, torch.full_like(out, sections[i + 1]), out)
    return out


def tokenize_report_teacher_forcing(findings: Sequence[str], impression: Sequence[str],
                                    tokenizer, max_len: int) -> Dict[str, np.ndarray]:
    """[BOS]findings[SEP]impression[EOS] -> shifted decoder inputs and labels
    (modelling_single.py:320-365)."""
    reports = [f"{tokenizer.bos_token}{f}{tokenizer.sep_token}{i}{tokenizer.eos_token}"
               for f, i in zip(findings, impression)]
    tok = tokenizer(reports, padding="longest", truncation=True, max_length=max_len + 1)
    return {
        "label_ids": tok["input_ids"][:, 1:].copy(),
        "decoder_input_ids": tok["input_ids"][:, :-1],
        "decoder_attention_mask": tok["attention_mask"][:, 1:],
    }


def tokenize_prompt(previous_findings: Sequence[Optional[str]],
                    previous_impression: Sequence[Optional[str]], tokenizer, max_len: int,
                    add_bos_token_id: bool = False) -> Dict[str, np.ndarray]:
    """[PMT]prev_f[PMT-SEP]prev_i([BOS]) with the [NPF]/[NPI] placeholders for
    a missing section (modelling_longitudinal.py:459-513)."""
    previous_findings = ["[NPF]" if not f else f for f in previous_findings]
    previous_impression = ["[NPI]" if not i else i for i in previous_impression]
    bos = tokenizer.bos_token if add_bos_token_id else ""
    texts = [f"[PMT]{f}[PMT-SEP]{i}{bos}"
             for f, i in zip(previous_findings, previous_impression)]
    tok = tokenizer(texts, padding="longest", truncation=True, max_length=max_len)
    input_ids, attention_mask = tok["input_ids"], tok["attention_mask"]
    if input_ids.shape[1] == max_len:
        # BOS goes into the last slot of every row that fills the width: the
        # reference does this whether or not add_bos_token_id is set
        # (modelling_longitudinal.py:503-509)
        last_real = attention_mask[:, -1] == 1
        input_ids[last_real, -1] = tokenizer.bos_token_id
    return {"input_ids": input_ids, "attention_mask": attention_mask}


def bucket_prompt(input_ids: np.ndarray, attention_mask: np.ndarray, pad_id: int,
                  bucket: int = 32, max_len: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad a tokenised prompt to the next multiple of ``bucket`` (at most
    ``max_len``), so that few distinct widths reach the decoder. The padding
    changes nothing under the longitudinal mask-token attention: pad columns
    are masked, and the first token is read at the true width
    (``prompt_logits_col``)."""
    width = input_ids.shape[1]
    target = -(-width // bucket) * bucket
    if max_len is not None:
        target = min(max(target, width), max_len) if width <= max_len else width
    if target <= width:
        return input_ids, attention_mask
    pad = target - width
    input_ids = np.pad(input_ids, ((0, 0), (0, pad)), constant_values=pad_id)
    attention_mask = np.pad(attention_mask, ((0, 0), (0, pad)), constant_values=0)
    return input_ids, attention_mask


def cumulative_position_ids(attention_mask: torch.Tensor) -> torch.Tensor:
    """relu(cumsum(mask) - 1): the longitudinal position rule
    (modelling_longitudinal.py:275-277)."""
    return torch.clamp(torch.cumsum(attention_mask.to(torch.int32), dim=1) - 1, min=0)


def split_and_decode_sections(token_ids, special_token_ids: Sequence[int], tokenizer
                              ) -> Tuple[List[str], ...]:
    """Split each row at the first occurrence of each boundary special token
    and decode (modelling_single.py:367-411)."""
    token_ids = np.asarray(token_ids)
    _, seq_len = token_ids.shape
    sections: List[List[str]] = [[] for _ in special_token_ids]
    for row in token_ids:
        prev_col = 0
        for j, k in enumerate(special_token_ids):
            if prev_col >= seq_len:
                sections[j].append("")
                continue
            hits = np.flatnonzero(row == k)
            col = int(hits[0]) if hits.size else 0
            if col == 0:  # not found
                col = seq_len
            sections[j].append(tokenizer.decode(row[prev_col:col], skip_special_tokens=True))
            prev_col = col
    return tuple(sections)
