"""Plain (bidirectional) BERT encoder: the backbone of the CXR-BERT reward, the
CheXbert labeler and BERTScore.

The port of ``cxrmate_tpu/models/bert_encoder.py``. :class:`BertEncoderModel`
holds HF ``BertModel``'s parameters under HF's names (``bert.embeddings.*``,
``bert.encoder.layer.N.attention/intermediate/output``, optionally
``bert.pooler.dense``), so an HF state dict loads with ``load_state_dict``
(after :func:`bert_encoder_state`). The forward reuses the decoder's layers
(``models.bert``: ``bert_embed``, ``_sublayer``, ``_mlp``) with a
bidirectional padding mask, no cross-attention, no LoRA and no dropout.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from cxrmate_torch.configs import BertDecoderConfig
from cxrmate_torch.models.bert import _Bert, _mlp, _sublayer, bert_embed, padding_additive_mask
from cxrmate_torch.ops.layers import Linear, linear

# HF BertModel buffers that some state dicts carry; not parameters
_HF_BUFFERS = ("embeddings.position_ids", "embeddings.token_type_ids")


class _Pooler(nn.Module):
    def __init__(self, d: int, **kw):
        super().__init__()
        self.dense = Linear(d, d, **kw)


class BertEncoderModel(nn.Module):
    """HF ``BertModel``'s parameters under the ``bert.`` prefix, the pooler
    only with ``add_pooling_layer``. ``config.add_cross_attention`` must be
    False: a plain encoder's layers hold no cross-attention."""

    def __init__(self, config: BertDecoderConfig, add_pooling_layer: bool = False,
                 device=None, dtype=None):
        super().__init__()
        if config.add_cross_attention:
            raise ValueError("a plain BERT encoder has no cross-attention: "
                             "build its config with add_cross_attention=False")
        kw = {"device": device, "dtype": dtype}
        self.config = config
        self.bert = _Bert(config, **kw)
        if add_pooling_layer:
            self.bert.pooler = _Pooler(config.hidden_size, **kw)


def bert_encoder_state(sd: Mapping, prefix: str = "bert.") -> Dict[str, torch.Tensor]:
    """The ``prefix`` entries of an HF state dict as tensors, without HF's
    ``position_ids``/``token_type_ids`` buffers, under the ``bert.`` names of
    :class:`BertEncoderModel`."""
    out = {}
    for k, v in sd.items():
        if k.startswith(prefix) and not k[len(prefix):].startswith(_HF_BUFFERS):
            out["bert." + k[len(prefix):]] = torch.as_tensor(v)
    return out


def bert_encoder_forward(model: BertEncoderModel, input_ids: torch.Tensor,
                         attention_mask: Optional[torch.Tensor] = None,
                         token_type_ids: Optional[torch.Tensor] = None,
                         position_ids: Optional[torch.Tensor] = None,
                         num_layers: Optional[int] = None) -> torch.Tensor:
    """-> last hidden state [B, L, D] (inference: no dropout); with
    ``num_layers``, the hidden state after that many layers (BERTScore's cut,
    ``cxrmate_tpu/eval/bertscore.py:23 bert_hidden_states``)."""
    c = model.config
    b, l = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones(b, l, dtype=torch.int32, device=input_ids.device)
    if position_ids is None:
        position_ids = torch.arange(l, device=input_ids.device).expand(b, l)
    mask = padding_additive_mask(attention_mask)  # [B, 1, 1, L]: bidirectional
    hidden = bert_embed(model, input_ids, token_type_ids, position_ids)
    for layer in list(model.bert.encoder.layer)[:num_layers]:
        hidden = _sublayer(layer.attention, hidden, hidden, mask, c)
        hidden = _mlp(layer, hidden)
    return hidden


def cls_embedding(hidden: torch.Tensor) -> torch.Tensor:
    return hidden[:, 0, :]


def pooler(model: BertEncoderModel, hidden: torch.Tensor) -> torch.Tensor:
    """HF ``BertPooler``: tanh(dense(CLS))."""
    dense = model.bert.pooler.dense
    return torch.tanh(linear(cls_embedding(hidden), dense.weight, dense.bias))
