"""CheXbert labeler and the classification metrics over its labels.

The port of ``cxrmate_tpu/eval/chexbert.py``, itself a port of the
reference's ``tools/chexbert.py`` (a BERT-base encoder, 13 four-class heads
and one two-class head on the [CLS] state, the Stanford checkpoint's names)
and ``tools/metrics/chexbert.py`` (14-pathology example, macro and micro
accuracy, precision, recall and F1, ``f1_macro`` among them: the reference's
checkpoint-selection metric). The reports go through the WordPiece tokenizer
on the host; the forward runs on the model's device in fp32, as the JAX
package never casts it, and is plain PyTorch (the JAX package runs it
outside Pallas).

    model = load_chexbert(ckpt.hf.load_hf_pretrained_dir(path), device="cuda")
    tok = tokenizer.WordPieceTokenizer.from_file(path + "/vocab.txt")
    chexbert_predict(model, tok, ["no acute process ."])  # -> [1, 14] class ids
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from cxrmate_torch.configs import BertDecoderConfig
from cxrmate_torch.models.bert_encoder import (
    BertEncoderModel,
    bert_encoder_forward,
    bert_encoder_state,
    cls_embedding,
)
from cxrmate_torch.ops.layers import Linear
from cxrmate_torch.utils.device import resolve_device

PATHOLOGIES = [
    "enlarged_cardiomediastinum", "cardiomegaly", "lung_opacity", "lung_lesion",
    "edema", "consolidation", "pneumonia", "atelectasis", "pneumothorax",
    "pleural_effusion", "pleural_other", "fracture", "support_devices", "no_finding",
]
# classes per head: {blank, positive, negative, uncertain}; no_finding {blank, positive}
HEAD_CLASSES = (4,) * 13 + (2,)

BERT_BASE = BertDecoderConfig(
    vocab_size=30522, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
    intermediate_size=3072, max_position_embeddings=512, type_vocab_size=2,
    pad_token_id=0, add_cross_attention=False,
)


def normalize_report(text: str) -> str:
    """tools/chexbert.py:53-58 (literal-string replaces, as in the reference)."""
    text = text.strip()
    text = text.replace("\n", " ")
    text = text.replace("\\s+", " ")
    text = text.replace("\\s+(?=[\\.,])", "")
    return text.strip()


class CheXbert(BertEncoderModel):
    """:class:`BertEncoderModel` (``bert.*``) and ``linear_heads.{0..13}`` on
    the [CLS] state, under the Stanford checkpoint's names (less its
    ``module.`` prefix)."""

    def __init__(self, config: BertDecoderConfig = BERT_BASE, add_pooling_layer: bool = False,
                 device=None, dtype=None):
        super().__init__(config, add_pooling_layer, device=device, dtype=dtype)
        self.linear_heads = nn.ModuleList(
            Linear(config.hidden_size, n, device=device, dtype=dtype) for n in HEAD_CLASSES)


def chexbert_logits(model: CheXbert, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor) -> List[torch.Tensor]:
    """-> the 14 heads' logits, [B, 4] x 13 and [B, 2]."""
    cls = cls_embedding(bert_encoder_forward(model, input_ids, attention_mask))
    return [head(cls) for head in model.linear_heads]


@torch.no_grad()
def chexbert_predict(model: CheXbert, tokenizer, reports: Sequence[str],
                     max_length: int = 512) -> np.ndarray:
    """-> [B, 14] int32 class ids (argmax per head, the first on a tie), as
    tools/chexbert.py:60-81."""
    reports = [normalize_report(r) for r in reports]
    tok = tokenizer(list(reports), padding="longest", truncation=True, max_length=max_length)
    dev = next(model.parameters()).device
    logits = chexbert_logits(model, torch.from_numpy(tok["input_ids"]).long().to(dev),
                             torch.from_numpy(tok["attention_mask"]).to(dev))
    return np.stack([l.argmax(dim=-1).cpu().numpy().astype(np.int32) for l in logits], axis=1)


def load_chexbert(sd: Mapping, config: Optional[BertDecoderConfig] = None,
                  device="cuda") -> CheXbert:
    """The Stanford CheXbert state dict (``module.bert.*`` and
    ``module.linear_heads.*``, or the same without ``module.``; tensors or
    numpy arrays) -> :class:`CheXbert` in fp32 on ``device``: the
    counterpart of ``convert_chexbert`` :63. A key that is neither BERT's nor
    a head's (HF's ``position_ids``/``token_type_ids`` buffers aside) is
    refused. ``config`` defaults to :data:`BERT_BASE`."""
    dev = resolve_device(device)
    config = config or BERT_BASE
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    stray = [k for k in sd if not k.startswith(("bert.", "linear_heads."))]
    if stray:
        raise KeyError(f"keys that are not CheXbert's: {stray[:8]}")
    state = bert_encoder_state(sd)
    state.update((k, torch.as_tensor(v)) for k, v in sd.items() if k.startswith("linear_heads."))
    model = CheXbert(config, add_pooling_layer="bert.pooler.dense.weight" in state,
                     device="cpu", dtype=torch.float32)
    model.load_state_dict({k: v.float() for k, v in state.items()}, strict=True)
    return model.to(dev)


# ------------------------------------------------------------ classification metrics
def chexbert_scores(y_hat: np.ndarray, y: np.ndarray) -> Dict[str, float]:
    """tp/tn/fp/fn -> example/macro/micro accuracy/precision/recall/F1
    (tools/metrics/chexbert.py:201-292). Class semantics: prediction classes are
    {blank:0, positive:1, negative:2, uncertain:3}; the metric binarises on
    class == 1 (positive)."""
    tp = ((y_hat == 1) & (y == 1)).astype(np.float64)
    tn = ((y_hat != 1) & (y != 1)).astype(np.float64)
    fp = ((y_hat == 1) & (y != 1)).astype(np.float64)
    fn = ((y_hat != 1) & (y == 1)).astype(np.float64)

    eps = 1e-11  # avoid 0/0 like the torch implementation's masking

    def safe_div(a, b):
        return np.where(b > 0, a / np.maximum(b, eps), 0.0)

    scores: Dict[str, float] = {}
    # example-based: mean over examples of per-example scores across the 14 classes
    ex_p = safe_div(tp.sum(1), (tp + fp).sum(1))
    ex_r = safe_div(tp.sum(1), (tp + fn).sum(1))
    ex_f1 = safe_div(2 * ex_p * ex_r, ex_p + ex_r)
    ex_acc = safe_div((tp + tn).sum(1), (tp + tn + fp + fn).sum(1))
    scores["accuracy_example"] = float(ex_acc.mean())
    scores["precision_example"] = float(ex_p.mean())
    scores["recall_example"] = float(ex_r.mean())
    scores["f1_example"] = float(ex_f1.mean())

    # class-based (macro): per-class over all examples, then mean
    cl_tp, cl_tn, cl_fp, cl_fn = tp.sum(0), tn.sum(0), fp.sum(0), fn.sum(0)
    cl_p = safe_div(cl_tp, cl_tp + cl_fp)
    cl_r = safe_div(cl_tp, cl_tp + cl_fn)
    cl_f1 = safe_div(2 * cl_p * cl_r, cl_p + cl_r)
    cl_acc = safe_div(cl_tp + cl_tn, cl_tp + cl_tn + cl_fp + cl_fn)
    for name, val in zip(PATHOLOGIES, cl_f1):
        scores[f"f1_{name}"] = float(val)
    scores["accuracy_macro"] = float(cl_acc.mean())
    scores["precision_macro"] = float(cl_p.mean())
    scores["recall_macro"] = float(cl_r.mean())
    scores["f1_macro"] = float(cl_f1.mean())

    # micro: pooled
    scores["accuracy_micro"] = float(safe_div(tp.sum() + tn.sum(), tp.sum() + tn.sum() + fp.sum() + fn.sum()))
    scores["precision_micro"] = float(safe_div(tp.sum(), tp.sum() + fp.sum()))
    scores["recall_micro"] = float(safe_div(tp.sum(), tp.sum() + fn.sum()))
    scores["f1_micro"] = float(
        safe_div(2 * scores["precision_micro"] * scores["recall_micro"],
                 scores["precision_micro"] + scores["recall_micro"])
    )
    scores["num_study_ids"] = float(len(y_hat))
    return scores
