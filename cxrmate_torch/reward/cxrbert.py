"""CXR-BERT cosine-similarity reward of SCST.

The port of ``cxrmate_tpu/reward/cxrbert.py``: predictions and labels are
embedded by ``microsoft/BiomedVLP-CXR-BERT-specialized`` (a BERT encoder whose
[CLS] hidden state goes through a projection head) and each prediction
scores the cosine similarity of the two projected embeddings. The text goes
through the WordPiece tokenizer on the host; the two BERT forwards and the
cosine run on the model's device, in fp32 (the JAX package never casts the
reward's parameters).

    sd = ckpt.hf.load_hf_pretrained_dir(path)
    model = load_cxrbert(sd, cxrbert_config_from_state_dict(sd, config_json), device="cuda")
    reward = CXRBERTReward(model, WordPieceTokenizer.from_file(path + "/vocab.txt"))
    reward(["no acute process ."], [["heart size is normal ."]])  # -> np.ndarray [1]
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from cxrmate_torch.configs import BertDecoderConfig
from cxrmate_torch.models.bert_encoder import (
    BertEncoderModel,
    bert_encoder_forward,
    bert_encoder_state,
    cls_embedding,
)
from cxrmate_torch.ops.layers import Linear
from cxrmate_torch.utils.device import resolve_device


class CXRBERT(BertEncoderModel):
    """The reward model: :class:`BertEncoderModel` (``bert.*``) and a linear
    ``cls_projection_head`` of width ``projection_size`` on the [CLS] state."""

    def __init__(self, config: BertDecoderConfig, projection_size: int,
                 projection_bias: bool = False, add_pooling_layer: bool = False,
                 device=None, dtype=None):
        super().__init__(config, add_pooling_layer, device=device, dtype=dtype)
        self.cls_projection_head = Linear(config.hidden_size, projection_size,
                                          bias=projection_bias, device=device, dtype=dtype)


def projected_cls(model: CXRBERT, input_ids: torch.Tensor,
                  attention_mask: torch.Tensor) -> torch.Tensor:
    hidden = bert_encoder_forward(model, input_ids, attention_mask)
    return model.cls_projection_head(cls_embedding(hidden))


def cosine_reward(model: CXRBERT, pred_ids, pred_mask, label_ids, label_mask) -> torch.Tensor:
    """Cosine similarity of the projected prediction and label embeddings,
    in fp32 with torch's eps of 1e-8 on each norm -> [B]."""
    a = projected_cls(model, pred_ids, pred_mask).float()
    b = projected_cls(model, label_ids, label_mask).float()
    na = torch.linalg.vector_norm(a, dim=-1).clamp(min=1e-8)
    nb = torch.linalg.vector_norm(b, dim=-1).clamp(min=1e-8)
    return (a * b).sum(dim=-1) / (na * nb)


class CXRBERTReward:
    """``(predictions, labels) -> np.ndarray [B]``, as
    ``cxrmate_tpu/reward/cxrbert.py:44 CXRBERTReward``; ``labels`` holds one
    list per prediction, whose first string is the reference.

    The tokenizer pads a batch to its longest row; ``length_bucket`` then
    zero-pads it to the next multiple (at most ``max_position_embeddings``),
    as the JAX package does to bound its compiled shapes. That is exact: the
    padded keys carry mask 0, so every softmax and the [CLS] state are
    unchanged. 0 turns it off."""

    def __init__(self, model: CXRBERT, tokenizer, length_bucket: int = 32):
        self.model = model
        self.tokenizer = tokenizer
        self.length_bucket = length_bucket

    def _tokenize(self, texts: Sequence[str], max_len: int):
        out = self.tokenizer(list(texts), padding="longest", truncation=True,
                             max_length=max_len)
        ids = np.asarray(out["input_ids"], np.int32)
        mask = np.asarray(out["attention_mask"], np.int32)
        if self.length_bucket:
            target = min(-(-ids.shape[1] // self.length_bucket) * self.length_bucket, max_len)
            pad = target - ids.shape[1]
            if pad > 0:
                ids = np.pad(ids, ((0, 0), (0, pad)),
                             constant_values=getattr(self.tokenizer, "pad_token_id", 0))
                mask = np.pad(mask, ((0, 0), (0, pad)))
        dev = next(self.model.parameters()).device
        return (torch.from_numpy(ids).long().to(dev), torch.from_numpy(mask).to(dev))

    @torch.no_grad()
    def __call__(self, predictions: Sequence[str],
                 labels: Sequence[Sequence[str]]) -> np.ndarray:
        if not all(isinstance(p, str) for p in predictions):
            raise TypeError("predictions must be strings")
        max_len = self.model.config.max_position_embeddings
        pred = self._tokenize(predictions, max_len)
        lab = self._tokenize([l[0] for l in labels], max_len)
        return cosine_reward(self.model, *pred, *lab).cpu().numpy()


def _projection_key(sd: Mapping) -> str:
    key = next((k for k in sd if k.endswith("projection_head.weight")
                or k == "cls_projection_head.weight"), None)
    if key is None:
        raise KeyError("no projection head (a key ending in projection_head.weight) in the "
                       "state dict")
    return key


def cxrbert_config_from_state_dict(sd: Mapping, hf_config: Optional[Mapping] = None
                                   ) -> BertDecoderConfig:
    """The encoder's config from the state dict's shapes, as
    ``cxrmate_tpu/cli/stages.py:1150-1170`` infers it: layers counted from the
    keys; the head count (which no shape holds) from ``hf_config`` (the
    checkpoint's parsed ``config.json``) when given, else ``hidden // 64``."""
    word = sd["bert.embeddings.word_embeddings.weight"]
    hidden = int(word.shape[1])
    heads = (hf_config or {}).get("num_attention_heads")
    return BertDecoderConfig(
        vocab_size=int(word.shape[0]), hidden_size=hidden,
        num_hidden_layers=1 + max(int(k.split(".")[3]) for k in sd
                                  if k.startswith("bert.encoder.layer.")),
        num_attention_heads=heads or max(1, hidden // 64),
        intermediate_size=int(sd["bert.encoder.layer.0.intermediate.dense.weight"].shape[0]),
        max_position_embeddings=int(sd["bert.embeddings.position_embeddings.weight"].shape[0]),
        type_vocab_size=int(sd["bert.embeddings.token_type_embeddings.weight"].shape[0]),
        pad_token_id=0, add_cross_attention=False)


def load_cxrbert(sd: Mapping, config: Optional[BertDecoderConfig] = None,
                 device="cuda") -> CXRBERT:
    """A CXR-BERT-style HF state dict (``bert.*``, a projection head under a key
    ending in ``projection_head.weight`` or named ``cls_projection_head.weight``,
    its bias if present; an LM head is ignored) -> :class:`CXRBERT` in fp32 on
    ``device`` (the counterpart of ``convert_cxrbert`` :97). ``config``
    defaults to :func:`cxrbert_config_from_state_dict`."""
    dev = resolve_device(device)
    config = config or cxrbert_config_from_state_dict(sd)
    proj = _projection_key(sd)
    bias = proj[: -len("weight")] + "bias"
    state = bert_encoder_state(sd)
    state["cls_projection_head.weight"] = torch.as_tensor(sd[proj])
    if bias in sd:
        state["cls_projection_head.bias"] = torch.as_tensor(sd[bias])
    model = CXRBERT(config, int(state["cls_projection_head.weight"].shape[0]),
                    projection_bias=bias in sd,
                    add_pooling_layer="bert.pooler.dense.weight" in state,
                    device="cpu", dtype=torch.float32)
    model.load_state_dict({k: v.float() for k, v in state.items()}, strict=True)
    return model.to(dev)
