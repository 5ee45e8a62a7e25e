"""Metric accumulators and report loggers.

The port of ``cxrmate_tpu/eval/metrics.py``, which mirrors the reference's
torchmetrics classes (its ``tools/metrics/``): accumulate (prediction, label,
ids) rows per step, gather them across processes at ``compute`` time, keep
the first row of each id (oversampled examples count once), score, write the
per-item scores to a timestamped CSV (rank 0), and average DICOM -> study ->
mean.

Without pandas: the tables are columns of plain lists, written with ``csv``
in the columns and row order that the JAX package's ``DataFrame.to_csv``
writes, and the means reduce as pandas reduces, so every score is equal to
the JAX package's: a column's mean is numpy's (pairwise) sum in the column's
dtype over the count (pandas' ``nanmean``), and a study's mean over its
DICOMs a compensated (Kahan) sum over the count, in the groups' sorted order
(``groupby(...).mean()``).

The cross-process gather is ``torch.distributed.all_gather_object`` of the
row lists when a process group is initialised (the reference's, coco.py:
119-121), and nothing otherwise.
"""

from __future__ import annotations

import csv
import math
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import numpy as np

from cxrmate_torch.eval import nlg
from cxrmate_torch.eval.ptb import ptb_tokenize
from cxrmate_torch.utils import dist

Columns = Dict[str, list]


def _first_per_key(rows: List[dict], key: str) -> List[dict]:
    """``drop_duplicates(subset=[key])``: the first row of each key value."""
    seen, out = set(), []
    for r in rows:
        if r[key] not in seen:
            seen.add(r[key])
            out.append(r)
    return out


def _columns(rows: List[dict], drop: Sequence[str] = ()) -> Columns:
    """The rows as columns, in the order of the rows' keys, less ``drop``."""
    names = [k for k in (rows[0] if rows else {}) if k not in drop]
    return {k: [r[k] for r in rows] for k in names}


def _mean(values) -> float:
    """pandas' ``Series.mean``: numpy's sum in the values' float dtype over
    the count in the same dtype."""
    a = np.asarray(values)
    if a.dtype.kind != "f":
        a = a.astype(np.float64)
    return float(a.sum(dtype=a.dtype) / a.dtype.type(a.size)) if a.size else math.nan


def _group_mean(table: Columns, key: str) -> Columns:
    """``groupby(key, as_index=False).mean()``: one row per key value, sorted
    by it; each other column's mean over the group by a Kahan sum in the
    column's float dtype, as pandas' ``group_mean`` adds."""
    groups: Dict = {}
    for i, k in enumerate(table[key]):
        groups.setdefault(k, []).append(i)
    keys = sorted(groups)
    out: Columns = {key: keys}
    for name, col in table.items():
        if name == key:
            continue
        a = np.asarray(col)
        if a.dtype.kind != "f":
            a = a.astype(np.float64)
        kind = a.dtype.type
        means = []
        for k in keys:
            total, comp = kind(0), kind(0)
            for i in groups[k]:
                y = a[i] - comp
                t = total + y
                comp = (t - total) - y
                if comp != comp:  # an infinite value: pandas resets the compensation
                    comp = kind(0)
                total = t
            means.append(total / kind(len(groups[k])))
        out[name] = np.asarray(means, dtype=a.dtype)
    return out


def _cell(v):
    """A value as ``DataFrame.to_csv`` writes it: NaN and None empty, numpy
    scalars and floats by their shortest repr, the rest by ``str``."""
    if v is None or (isinstance(v, (float, np.floating)) and v != v):
        return ""
    return v if isinstance(v, str) else str(v)


class _Accumulator:
    def __init__(self, split: str, exp_dir: str, subdir: str, accumulate_over_dicoms: bool):
        self.split = split
        self.accumulate_over_dicoms = accumulate_over_dicoms
        self.save_dir = os.path.join(exp_dir, subdir)
        Path(self.save_dir).mkdir(parents=True, exist_ok=True)
        self.rows: List[dict] = []

    def reset(self):
        self.rows = []

    def _key(self) -> str:
        return "dicom_id" if self.accumulate_over_dicoms else "study_id"

    def _add(self, predictions, labels, study_ids, dicom_ids):
        if self.accumulate_over_dicoms:
            for p, l, s, d in zip(predictions, labels, study_ids, dicom_ids):
                self.rows.append({"prediction": p, "label": l, "study_id": s, "dicom_id": d})
        else:
            for p, l, s in zip(predictions, labels, study_ids):
                self.rows.append({"prediction": p, "label": l, "study_id": s})

    def _deduped(self) -> List[dict]:
        return _first_per_key(dist.all_gather_list(self.rows), self._key())

    def _save(self, table: Columns, epoch) -> None:
        """``to_csv(index=False)`` of the table, on rank 0 only."""
        if dist.rank() != 0:
            return
        path = os.path.join(
            self.save_dir,
            f"{self.split}_epoch-{epoch}_{time.strftime('%d-%m-%Y_%H-%M-%S')}.csv")
        names = list(table)
        with open(path, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(names)
            for row in zip(*(table[n] for n in names)):
                w.writerow([_cell(v) for v in row])


class COCONLGMetrics(_Accumulator):
    """BLEU-1..4 + ROUGE-L + CIDEr (+ METEOR) with PTB tokenisation, per-study
    CSV dump and DICOM -> study mean aggregation (tools/metrics/coco.py)."""

    def __init__(self, split, exp_dir, accumulate_over_dicoms, metrics=("bleu", "cider", "rouge"),
                 use_tokenizer: bool = True, meteor_synonyms=None, meteor_paraphrases=None,
                 meteor_function_words=None):
        super().__init__(split, exp_dir, "nlg_scores", accumulate_over_dicoms)
        self.metrics = [m.lower() for m in metrics]
        self.use_tokenizer = use_tokenizer
        # the optional METEOR synonym module (eval/meteor.py:default_synonyms),
        # paraphrase table (load_paraphrase_table) and verbatim function-word
        # list (load_function_words)
        self.meteor_synonyms = meteor_synonyms
        self.meteor_paraphrases = meteor_paraphrases
        self.meteor_function_words = meteor_function_words

    def update(self, predictions: Sequence[str], labels: Sequence[Sequence[str]],
               study_ids, dicom_ids=None):
        assert all(isinstance(p, str) for p in predictions)
        assert all(isinstance(l, list) for l in labels)
        self._add(predictions, labels, study_ids, dicom_ids)

    def compute(self, epoch=0) -> Dict[str, float]:
        rows = dist.all_gather_list(self.rows)
        key = self._key()
        # the last row of an id gives its texts; the first its place
        preds, labels = {}, {}
        for r in rows:
            idx = r[key]
            idx = int(idx) if isinstance(idx, np.integer) else idx
            preds[idx] = [{"caption": " ".join(str(r["prediction"]).split())}]
            labels[idx] = [{"caption": " ".join(str(m).split())} for m in r["label"]]
        if self.use_tokenizer:
            preds = ptb_tokenize(preds)
            labels = ptb_tokenize(labels)
        else:
            preds = {k: [d["caption"] for d in v] for k, v in preds.items()}
            labels = {k: [d["caption"] for d in v] for k, v in labels.items()}

        kept = _first_per_key(rows, key)
        ids = ["dicom_id", "study_id"] if self.accumulate_over_dicoms else ["study_id"]
        table: Columns = {c: [r[c] for r in kept] for c in ids}
        ids_in_order = [int(i) if isinstance(i, np.integer) else i for i in table[key]]
        preds = {i: preds[i] for i in ids_in_order}
        labels = {i: labels[i] for i in ids_in_order}

        def nunique(col):
            return float(len({v for v in col if v is not None}))

        scores: Dict[str, float] = {"num_study_ids": nunique(table["study_id"])}
        if self.accumulate_over_dicoms:
            scores["num_dicom_ids"] = nunique(table["dicom_id"])
        if "bleu" in self.metrics:
            _, per_item = nlg.bleu(labels, preds)
            for n in range(4):
                table[f"bleu_{n + 1}"] = per_item[n]
        if "meteor" in self.metrics:
            from cxrmate_torch.eval.meteor import meteor

            _, per = meteor(labels, preds, synonyms=self.meteor_synonyms,
                            paraphrases=self.meteor_paraphrases,
                            function_words=self.meteor_function_words)
            table["meteor"] = per
        if "spice" in self.metrics:
            from cxrmate_torch.eval.spice import spice

            _, per = spice(labels, preds)
            table["spice"] = per
        if "rouge" in self.metrics:
            _, per = nlg.rouge_l(labels, preds)
            table["rouge"] = per
        if "cider" in self.metrics:
            _, per = nlg.cider(labels, preds)
            table["cider"] = per
        self._save(table, epoch)
        if self.accumulate_over_dicoms:
            table = _group_mean({k: v for k, v in table.items() if k != "dicom_id"}, "study_id")
        return {**scores, **{k: _mean(v) for k, v in table.items() if k != "study_id"}}


class CheXbertMetrics(_Accumulator):
    """14-pathology classification metrics via the CheXbert labeler
    (tools/metrics/chexbert.py)."""

    def __init__(self, split, exp_dir, accumulate_over_dicoms, predict_fn: Callable,
                 mbatch_size: int = 16):
        super().__init__(split, exp_dir, "chexbert_outputs", accumulate_over_dicoms)
        self.predict_fn = predict_fn  # reports -> [B, 14] class ids
        self.mbatch_size = mbatch_size

    def update(self, predictions, labels, study_ids, dicom_ids=None):
        self._add(predictions, [l[0] if isinstance(l, list) else l for l in labels],
                  study_ids, dicom_ids)

    def compute(self, epoch=0) -> Dict[str, float]:
        from cxrmate_torch.eval.chexbert import PATHOLOGIES, chexbert_scores

        rows = self._deduped()
        texts_p, texts_l = [r["prediction"] for r in rows], [r["label"] for r in rows]
        preds, labels = [], []
        for start in range(0, len(rows), self.mbatch_size):
            preds.append(self.predict_fn(texts_p[start : start + self.mbatch_size]))
            labels.append(self.predict_fn(texts_l[start : start + self.mbatch_size]))
        y_hat = np.concatenate(preds, 0)
        y = np.concatenate(labels, 0)
        table = _columns(rows, drop=("prediction", "label"))
        for i, name in enumerate(PATHOLOGIES):
            table[f"pred_{name}"] = list(y_hat[:, i])
            table[f"label_{name}"] = list(y[:, i])
        self._save(table, epoch)
        return chexbert_scores(y_hat, y)


class CXRBERTMetric(_Accumulator):
    """CXR-BERT cosine-similarity metric (tools/metrics/cxr_bert.py);
    ``reward_fn`` is e.g. ``reward.cxrbert.CXRBERTReward``."""

    def __init__(self, split, exp_dir, accumulate_over_dicoms, reward_fn: Callable,
                 mbatch_size: int = 16):
        super().__init__(split, exp_dir, "cxr_bert", accumulate_over_dicoms)
        self.reward_fn = reward_fn
        self.mbatch_size = mbatch_size

    def update(self, predictions, labels, study_ids, dicom_ids=None):
        self._add(predictions, labels, study_ids, dicom_ids)

    def compute(self, epoch=0) -> Dict[str, float]:
        rows = self._deduped()
        preds, labels = [r["prediction"] for r in rows], [r["label"] for r in rows]
        sims = [self.reward_fn(preds[s : s + self.mbatch_size], labels[s : s + self.mbatch_size])
                for s in range(0, len(rows), self.mbatch_size)]
        table = _columns(rows, drop=("prediction", "label"))
        table["cxr_bert_similarity"] = list(np.concatenate(sims, 0))
        self._save(table, epoch)
        if self.accumulate_over_dicoms:
            table = _group_mean({k: v for k, v in table.items() if k != "dicom_id"}, "study_id")
        return {"similarity": _mean(table["cxr_bert_similarity"])}


class ReportLogger(_Accumulator):
    """Generated findings/impression -> timestamped CSV
    (tools/metrics/report_logger.py)."""

    def __init__(self, split, exp_dir, track_dicom_id: bool):
        super().__init__(split, exp_dir, "generated_reports", track_dicom_id)

    def update(self, findings, impression, study_ids, dicom_ids=None):
        if self.accumulate_over_dicoms:
            for f, i, s, d in zip(findings, impression, study_ids, dicom_ids):
                self.rows.append({"findings": f, "impression": i, "study_id": s, "dicom_id": d})
        else:
            for f, i, s in zip(findings, impression, study_ids):
                self.rows.append({"findings": f, "impression": i, "study_id": s})

    def compute(self, epoch=0):
        self._save(_columns(self._deduped()), epoch)


class ReportTokenIdentifiersLogger(_Accumulator):
    """Raw generated token ids -> CSV (tools/metrics/report_ids_logger.py)."""

    def __init__(self, split, exp_dir, track_dicom_id: bool):
        super().__init__(split, exp_dir, "generated_report_ids", track_dicom_id)

    def update(self, report_ids: np.ndarray, study_ids, dicom_ids=None):
        ids_list = [list(map(int, row)) for row in np.asarray(report_ids)]
        if self.accumulate_over_dicoms:
            for ids, s, d in zip(ids_list, study_ids, dicom_ids):
                self.rows.append({"report_ids": ids, "study_id": s, "dicom_id": d})
        else:
            for ids, s in zip(ids_list, study_ids):
                self.rows.append({"report_ids": ids, "study_id": s})

    def compute(self, epoch=0):
        self._save(_columns(self._deduped()), epoch)
