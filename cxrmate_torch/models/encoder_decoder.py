"""CXRMate encoder-decoder, ``multi`` variant: a study's image stack is
encoded by CvT, projected, and concatenated along the token axis; all-zero
image slots are padding and masked out of cross-attention.

The port of ``cxrmate_tpu/models/encoder_decoder.py``'s serving helpers
(``encode_images`` :40, ``token_ids_to_token_type_ids`` :145,
``split_and_decode_sections`` :241). The prompt helpers of the longitudinal
variant are not ported yet (ROADMAP.md queue 1, item 9).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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
        self.decoder = BertLMHeadModel(config.decoder, device=device, dtype=dtype)


def encode_images(model: EncoderDecoder, pixel_values: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, N, 3, H, W] pixel values -> (encoder_hidden [B, N*T_img, P],
    encoder_mask [B, N*T_img] int32). The N images are folded into the batch
    for CvT; an image is padding iff its pixel [0, 0, 0] is exactly 0
    (reference modelling_multi.py:80)."""
    if model.config.variant != "multi":
        raise NotImplementedError(
            f"variant {model.config.variant!r} is not ported yet (ROADMAP.md queue 1, item 9)")
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
