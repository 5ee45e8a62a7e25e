"""BERTScore.

The port of ``cxrmate_tpu/eval/bertscore.py``, itself a port of the
reference's ``BERTScoreRoBERTaLarge`` (its ``tools/metrics/bertscore.py``:
roberta-large's hidden states after layer 17, F1/precision/recall). The
scoring is the published one, greedy token matching on L2-normalised hidden
states; the encoder is :class:`~cxrmate_torch.models.bert_encoder.BertEncoderModel`
with RoBERTa's weights renamed (``convert_roberta``) and RoBERTa's positions.
The text is tokenised on the host; the forward and the matching run on the
model's device in fp32 (the JAX package never casts them) as plain PyTorch,
as the JAX package keeps them outside Pallas. ``rescale_with_baseline`` takes
the (P, R, F) triple from bert-score's baseline file when one is given.

    sd = ckpt.hf.load_hf_pretrained_dir(path)  # roberta-large
    model = load_roberta(sd, num_attention_heads=16, device="cuda")
    scorer = BERTScorer(model, RobertaBPETokenizer.from_dir(path), num_layers=17,
                        roberta_positions=True,
                        baseline=load_rescale_baseline(tsv, 17))
    scorer.score(["no acute process ."], ["heart size normal ."])  # {"f1": ...}
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from cxrmate_torch.configs import BertDecoderConfig
from cxrmate_torch.eval import metrics as _metrics
from cxrmate_torch.models.bert_encoder import (
    BertEncoderModel,
    bert_encoder_forward,
    bert_encoder_state,
)
from cxrmate_torch.tokenizer.bpe import ByteLevelBPETokenizer
from cxrmate_torch.utils.device import resolve_device


def roberta_position_ids(attention_mask: torch.Tensor, padding_idx: int = 1) -> torch.Tensor:
    """RoBERTa's position scheme: padding_idx + cumsum(mask) on real tokens."""
    m = attention_mask.long()
    return torch.cumsum(m, dim=1) * m + padding_idx


def _greedy_match_f1(cand: torch.Tensor, cand_mask: torch.Tensor, ref: torch.Tensor,
                     ref_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BERTScore P/R/F1 from hidden states [B, L, D] and float match masks
    [B, L] (the caller masks the special tokens out), in fp32: each token's
    best cosine, a masked token at -1e9 on the other side."""
    def norm(x):
        x = x.float()
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)

    c, r = norm(cand), norm(ref)
    sim = torch.einsum("bid,bjd->bij", c, r)
    neg = -1e9
    sim = sim + (1 - cand_mask[:, :, None]) * neg + (1 - ref_mask[:, None, :]) * neg
    p = (sim.max(dim=2).values * cand_mask).sum(1) / cand_mask.sum(1).clamp(min=1)
    rr = (sim.max(dim=1).values * ref_mask).sum(1) / ref_mask.sum(1).clamp(min=1)
    f1 = 2 * p * rr / (p + rr).clamp(min=1e-12)
    return p, rr, f1


class BERTScorer:
    """(predictions, references) -> dict of per-item P/R/F1 arrays.

    tokenizer: WordPiece/BPE tokenizer with the batch call (specials
    included; they are masked out of matching, as bert-score does)."""

    def __init__(self, model: BertEncoderModel, tokenizer, num_layers: int = 17,
                 roberta_positions: bool = False,
                 baseline: Optional[Tuple[float, float, float]] = None,
                 max_length: int = 512):
        self.model = model
        self.tokenizer = tokenizer
        self.num_layers = num_layers
        self.roberta_positions = roberta_positions
        self.baseline = baseline
        self.max_length = max_length

    @property
    def config(self) -> BertDecoderConfig:
        return self.model.config

    def _embed(self, texts: Sequence[str]):
        tok = self.tokenizer(list(texts), padding="longest", truncation=True,
                             max_length=self.max_length)
        dev = next(self.model.parameters()).device
        ids = torch.from_numpy(np.asarray(tok["input_ids"])).long().to(dev)
        mask = torch.from_numpy(np.asarray(tok["attention_mask"])).to(dev)
        pos = roberta_position_ids(mask) if self.roberta_positions else None
        # the hidden states after num_layers (bert_hidden_states in the JAX package)
        hidden = bert_encoder_forward(self.model, ids, mask, position_ids=pos,
                                      num_layers=self.num_layers)
        # exclude [CLS]/[SEP]-style specials from matching (first + last real token)
        idx = torch.arange(mask.shape[1], device=dev)[None, :]
        last_real = mask.sum(dim=1) - 1
        match_mask = mask.float() * (idx != 0) * (idx != last_real[:, None])
        return hidden, match_mask

    @torch.no_grad()
    def score(self, predictions: Sequence[str], references: Sequence[str]
              ) -> Dict[str, np.ndarray]:
        cand, cand_mask = self._embed(predictions)
        ref, ref_mask = self._embed(references)
        width = max(cand.shape[1], ref.shape[1])

        def pad(x, m):
            extra = width - x.shape[1]
            return (torch.nn.functional.pad(x, (0, 0, 0, extra)),
                    torch.nn.functional.pad(m, (0, extra)))

        p, r, f1 = (t.cpu().numpy() for t in _greedy_match_f1(*pad(cand, cand_mask),
                                                               *pad(ref, ref_mask)))
        if self.baseline is not None:
            bp, br, bf = self.baseline
            p, r, f1 = (p - bp) / (1 - bp), (r - br) / (1 - br), (f1 - bf) / (1 - bf)
        return {"precision": p, "recall": r, "f1": f1}


class RobertaBPETokenizer:
    """RoBERTa tokenisation conventions over the port's byte-level BPE.

    Loads an HF ``roberta-large``-style checkpoint dir (``vocab.json`` +
    ``merges.txt``, or a ``tokenizer.json``) and reproduces what bert-score's
    ``sent_encode`` does with the HF tokenizer (the reference's
    ``tools/metrics/bertscore.py`` uses the bert-score package, whose roberta
    path is ``tokenizer.encode(sent, add_special_tokens=True,
    truncation=True)``): ``<s> + BPE(text) + </s>`` with the content truncated
    to fit ``max_length``."""

    def __init__(self, vocab: Dict[str, int], merges):
        specials = [t for t in ("<s>", "</s>", "<pad>", "<unk>", "<mask>") if t in vocab]
        self._bpe = ByteLevelBPETokenizer(
            vocab, merges, special_tokens=("<unk>",) if "<unk>" in vocab else (),
            additional_special_tokens=[t for t in specials if t != "<unk>"],
            unk_token="<unk>",
        )
        self.bos_token_id = vocab["<s>"]
        self.eos_token_id = vocab["</s>"]
        self.pad_token_id = vocab["<pad>"]

    @classmethod
    def from_dir(cls, path: str) -> "RobertaBPETokenizer":
        vocab_json = os.path.join(path, "vocab.json")
        if os.path.exists(vocab_json):
            with open(vocab_json) as f:
                vocab = json.load(f)
            merges = []
            with open(os.path.join(path, "merges.txt")) as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line or line.startswith("#version"):
                        continue
                    merges.append(tuple(line.split(" ", 1)))
            return cls(vocab, merges)
        with open(os.path.join(path, "tokenizer.json")) as f:
            data = json.load(f)
        model = data["model"]
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        vocab = dict(model["vocab"])
        for t in data.get("added_tokens", []):
            vocab.setdefault(t["content"], t["id"])
        return cls(vocab, merges)

    def __call__(self, texts: Sequence[str], padding: str = "longest",
                 truncation: bool = False, max_length: Optional[int] = None):
        encoded = []
        for t in texts:
            ids = self._bpe.encode(t)
            if truncation and max_length is not None:
                ids = ids[: max_length - 2]
            encoded.append([self.bos_token_id] + ids + [self.eos_token_id])
        width = max((len(e) for e in encoded), default=0)
        n = len(encoded)
        input_ids = np.full((n, width), self.pad_token_id, np.int32)
        attention_mask = np.zeros((n, width), np.int32)
        for r, e in enumerate(encoded):
            input_ids[r, : len(e)] = e
            attention_mask[r, : len(e)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}


def convert_roberta(sd: Mapping, num_attention_heads: Optional[int] = None
                    ) -> Tuple[Dict[str, torch.Tensor], BertDecoderConfig]:
    """An HF RoBERTa encoder state dict (``roberta.*`` keys, e.g.
    roberta-large as bert-score downloads it) -> (the ``bert.*`` state dict of
    :class:`BertEncoderModel`, its config derived from the shapes, with
    ``pad_token_id`` 1). RoBERTa differs from BERT only in naming (remapped
    here) and the position scheme (:func:`roberta_position_ids`).

    ``layer_norm_eps`` stays at the config's 1e-12, as the JAX package's
    ``convert_roberta`` leaves it (HF RoBERTa uses 1e-5).
    ``num_attention_heads`` is not recoverable from shapes and changes the
    attention partitioning: pass it from the checkpoint's config.json; the
    fallback assumes RoBERTa's 64-dim heads."""
    sd = {k.replace("roberta.", "bert.", 1): v for k, v in sd.items()}
    word = sd["bert.embeddings.word_embeddings.weight"]
    hidden = int(word.shape[1])
    config = BertDecoderConfig(
        vocab_size=int(word.shape[0]), hidden_size=hidden,
        num_hidden_layers=1 + max(int(k.split(".")[3]) for k in sd
                                  if k.startswith("bert.encoder.layer.")),
        num_attention_heads=num_attention_heads or max(1, hidden // 64),
        intermediate_size=int(sd["bert.encoder.layer.0.intermediate.dense.weight"].shape[0]),
        max_position_embeddings=int(sd["bert.embeddings.position_embeddings.weight"].shape[0]),
        type_vocab_size=int(sd["bert.embeddings.token_type_embeddings.weight"].shape[0]),
        pad_token_id=1, add_cross_attention=False,
    )
    return bert_encoder_state(sd), config


def load_roberta(sd: Mapping, num_attention_heads: Optional[int] = None,
                 device="cuda") -> BertEncoderModel:
    """:func:`convert_roberta`, loaded strictly into a
    :class:`BertEncoderModel` in fp32 on ``device`` (a pooler when the state
    dict has one; an LM head is ignored)."""
    dev = resolve_device(device)
    state, config = convert_roberta(sd, num_attention_heads)
    model = BertEncoderModel(config, add_pooling_layer="bert.pooler.dense.weight" in state,
                             device="cpu", dtype=torch.float32)
    model.load_state_dict({k: v.float() for k, v in state.items()}, strict=True)
    return model.to(dev)


def load_rescale_baseline(path: str, num_layers: int) -> Optional[Tuple[float, float, float]]:
    """Parse a bert-score rescale-baseline file (CSV ``LAYER,P,R,F``, one row per
    layer: the package's ``rescale_baseline/en/roberta-large.tsv``) and return
    the (P, R, F) triple for ``num_layers``."""
    with open(path) as f:
        reader = csv.reader(f)
        header = next(reader)
        cols = {c.strip().upper(): i for i, c in enumerate(header)}
        for row in reader:
            if not row:
                continue
            if int(float(row[cols.get("LAYER", 0)])) == num_layers:
                return (
                    float(row[cols.get("P", 1)]),
                    float(row[cols.get("R", 2)]),
                    float(row[cols.get("F", 3)]),
                )
    return None


class BERTScoreMetric(_metrics._Accumulator):
    """Accumulating metric mirroring tools/metrics/bertscore.py: dedup by id,
    per-item CSV dump, mean f1/precision/recall."""

    def __init__(self, split, exp_dir, accumulate_over_dicoms, scorer: BERTScorer,
                 mbatch_size: int = 16):
        super().__init__(split, exp_dir, "bertscore", accumulate_over_dicoms)
        self.scorer = scorer
        self.mbatch_size = mbatch_size

    def update(self, predictions, labels, study_ids, dicom_ids=None):
        self._add(predictions, [l[0] if isinstance(l, list) else l for l in labels],
                  study_ids, dicom_ids)

    def compute(self, epoch=0) -> Dict[str, float]:
        rows = self._deduped()
        outs = {"precision": [], "recall": [], "f1": []}
        preds, labels = [r["prediction"] for r in rows], [r["label"] for r in rows]
        for s in range(0, len(rows), self.mbatch_size):
            out = self.scorer.score(preds[s : s + self.mbatch_size], labels[s : s + self.mbatch_size])
            for k in outs:
                outs[k].append(out[k])
        # raw and rescaled BERTScore live on very different scales (the
        # reference always rescales, tools/metrics/bertscore.py:93): without a
        # baseline every emitted key and column carries a suffix, so that no
        # consumer compares `..._bertscore_f1` across runs with and without it
        suffix = "" if self.scorer.baseline is not None else "_unrescaled"
        table = _metrics._columns(rows, drop=("prediction", "label"))
        for k in outs:
            table[k + suffix] = list(np.concatenate(outs[k])) if outs[k] else []
        self._save(table, epoch)
        return {k + suffix: float(np.mean(np.concatenate(v))) for k, v in outs.items() if v}
