"""Datasets: per-DICOM, per-study, and longitudinal previous-report views.

The port's copy of ``cxrmate_tpu/data/datasets.py`` on the port's column
table (``data/table.py``) instead of pandas: plain-Python indexable objects
returning numpy batches, consumed by ``pipeline.batch_iterator``. The
longitudinal view keeps the reference's subject-history lookup (the
chronological previous study by StudyDate/StudyTime), the three excluded
ambiguous subjects, and the generated-report history of gen-prompt training
and testing; the lane packers draw as the JAX package's do."""

from __future__ import annotations

import itertools
import math
import random
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import numpy as np

from cxrmate_torch.data import table as tb
from cxrmate_torch.data.index import mimic_cxr_image_path

# Subjects with two studies at identical times; these and all later studies are
# dropped (data/prompt.py:33-61).
_AMBIGUOUS = [(15964158, 21800331), (10661934, 21490809), (16973455, 21440406)]


def _present(v):
    """A cell as the JAX datasets hand it on: None where it is missing."""
    return None if (v is None or (isinstance(v, float) and math.isnan(v))) else v


def _subject_lists(df: tb.Table) -> List[List]:
    """Per-subject chronological study lists (``df`` is already sorted
    subject/date/time), longest first: the shared input of both lane packers."""
    sub = df.drop_duplicates(["study_id"])
    lists = tb.group_lists(sub["subject_id"], sub["study_id"])
    lists.sort(key=len, reverse=True)
    return lists


def _greedy_pack(subject_lists: List[List], lanes: int):
    """Greedy longest-first bin packing of subject study-lists onto ``lanes``
    lanes -> (buckets: per-lane lists of subject lists, totals)."""
    buckets: List[List[List]] = [[] for _ in range(lanes)]
    totals = [0] * lanes
    for lst in subject_lists:
        idx = int(np.argmin(totals))
        buckets[idx].append(lst)
        totals[idx] += len(lst)
    return buckets, totals


class DicomDataset:
    """Per-DICOM examples (single variant)."""

    def __init__(self, df: tb.Table, dataset_dir: str, load_image: Callable):
        self.df = df
        self.dataset_dir = dataset_dir
        self.load_image = load_image
        self.examples = tb.unique(self.df["dicom_id"])

    def __len__(self):
        return len(self.examples)

    def image_paths(self) -> List[str]:
        """Every image file this dataset can load, deduplicated: the
        decoded-image cache warmer's work list (data/image.py:CacheWarmer)."""
        sub = self.df.drop_duplicates("dicom_id")
        return [
            mimic_cxr_image_path(self.dataset_dir, s, st, d)
            for s, st, d in zip(sub["subject_id"], sub["study_id"], sub["dicom_id"])
        ]

    def _item(self, rows: tb.Table, images: np.ndarray) -> Dict:
        r = rows.row(0)
        return {
            "images": images,
            "findings": _present(r["findings"]),
            "impression": _present(r["impression"]),
            "dicom_ids": r["dicom_id"],
            "study_ids": r["study_id"],
        }

    def __getitem__(self, index) -> Dict:
        rows = self.df[self.df["dicom_id"] == self.examples[index]]
        r = rows.row(0)
        image = self.load_image(
            mimic_cxr_image_path(self.dataset_dir, r["subject_id"], r["study_id"], r["dicom_id"])
        )
        return self._item(rows, image[None])  # [1, 3, H, W]


class StudyDataset(DicomDataset):
    """Per-study examples: stacked image arrays [N, 3, H, W] (multi variant)."""

    def __init__(self, df, dataset_dir, load_image):
        super().__init__(df, dataset_dir, load_image)
        self.examples = tb.unique(self.df["study_id"])

    def __getitem__(self, index) -> Dict:
        rows = self.df[self.df["study_id"] == self.examples[index]]
        images = np.stack(
            [
                self.load_image(
                    mimic_cxr_image_path(self.dataset_dir, row["subject_id"], row["study_id"],
                                         row["dicom_id"])
                )
                for row in rows.rows()
            ],
            axis=0,
        )
        return self._item(rows, images)

    def image_counts(self) -> np.ndarray:
        """DICOMs per study, aligned with ``examples``: the eval loader's
        sort key for image-slot-homogeneous batches."""
        vc = tb.value_counts(self.df["study_id"])
        return np.asarray([int(vc[s]) for s in self.examples])


class PreviousReportDataset(StudyDataset):
    """Study examples with the previous report of the same subject as prompt
    (data/prompt.py:12-140)."""

    def __init__(
        self,
        df: tb.Table,
        history: tb.Table,
        dataset_dir: str,
        load_image: Callable,
        use_generated: bool = False,
        scst_generated: bool = False,
        mbatch_size: Optional[int] = None,
        world_size: int = 1,
    ):
        super().__init__(df, dataset_dir, load_image)
        self.history = history
        self.use_generated = use_generated
        self.scst_generated = scst_generated
        self.mbatch_size = mbatch_size
        self.world_size = world_size

        for subject, date in _AMBIGUOUS:
            sub = self.df[self.df["subject_id"] == subject].sort_values(["StudyDate", "StudyTime"])
            excluded = sub[sub["StudyDate"] >= date]["study_id"].tolist()
            self.df = self.df[~tb.isin(self.df["study_id"], excluded)]

        self.df = self.df.sort_values(["subject_id", "StudyDate", "StudyTime"])
        self.examples = tb.unique(self.df["study_id"])

        if self.use_generated:
            self.history = self.history.copy()
            self.reset_generated()
            self.allocate_subjects_to_rank(shuffle_subjects=False)
        if self.scst_generated:
            self.allocate_subjects_to_rank(seed=0)

    def record_generated(self, study_id, findings: str, impression: str) -> None:
        """Write generated sections into the history so later studies of the same
        subject are prompted with them (gen_prompt.py:137-139)."""
        sel = self.history["study_id"] == study_id
        self.history.set_where(sel, "generated_findings", findings)
        self.history.set_where(sel, "generated_impression", impression)

    def reset_generated(self) -> None:
        for col in ("generated_findings", "generated_impression"):
            self.history[col] = tb._objects([math.nan] * len(self.history))

    def export_generated(self) -> Dict:
        """Snapshot of the generated-prompt history (study_id -> [findings,
        impression]), persisted next to mid-epoch SCST checkpoints."""
        sel = ~tb.isna(self.history["generated_findings"])
        sub = self.history[sel][["study_id", "generated_findings", "generated_impression"]]
        sub = sub.drop_duplicates("study_id")
        return {
            str(int(s)): [f, i]
            for s, f, i in zip(sub["study_id"].tolist(), sub["generated_findings"],
                               sub["generated_impression"])
        }

    def import_generated(self, mapping: Dict) -> None:
        for sid, (f, i) in mapping.items():
            self.record_generated(int(sid), f, i)

    def __getitem__(self, index) -> Dict:
        out = StudyDataset.__getitem__(self, index)
        example = self.df[self.df["study_id"] == self.examples[index]].row(0)
        subject_id = example["subject_id"]
        study_date = example["StudyDate"]
        study_time = example["StudyTime"]

        sub = self.history[self.history["subject_id"] == subject_id].sort_values(
            ["StudyDate", "StudyTime"]
        )
        sub = sub[sub["StudyDate"] <= study_date]
        sub = sub[(sub["StudyTime"] <= study_time) | (sub["StudyDate"] != study_date)]
        considered = list(OrderedDict.fromkeys(sub["study_id"].tolist()))[-2:]

        out["previous_findings"] = None
        out["previous_impression"] = None
        if len(considered) == 2 and (self.df["study_id"] == considered[0]).any():
            prev = sub[sub["study_id"] == considered[0]].row(0)
            if self.use_generated:
                pf, pi = prev["generated_findings"], prev["generated_impression"]
                assert pf == pf and pi == pi, f"generated prompt missing for study {considered[0]}"
                out["previous_findings"], out["previous_impression"] = pf, pi
            else:
                out["previous_findings"] = _present(prev["findings"])
                out["previous_impression"] = _present(prev["impression"])
        return out

    def allocate_eval_lanes(self, lanes: int) -> None:
        """Re-pack subjects onto ``lanes`` lanes for evaluation decode packing:
        greedy longest-first, each short lane padded to the longest lane's
        width by repeating its final study (a duplicate decodes after its
        original in the same lane, so its prompt is already written back;
        the metric layer dedups by study_id)."""
        assert self.use_generated and not self.scst_generated
        subject_lists = _subject_lists(self.df)
        if not subject_lists:  # empty split: no lanes, evaluate emits no rows
            self.examples = []
            return
        lanes = max(1, min(lanes, len(subject_lists)))
        buckets, totals = _greedy_pack(subject_lists, lanes)
        width = max(totals)
        lanes_flat = [[s for subj in b for s in subj] for b in buckets]
        lanes_flat = [b + [b[-1]] * (width - len(b)) for b in lanes_flat]
        self.examples = [s for group in zip(*lanes_flat) for s in group]
        self.mbatch_size = lanes
        assert len(set(self.examples)) == len(tb.unique(self.df["study_id"]))

    def allocate_subjects_to_rank(self, seed: Optional[int] = None, shuffle_subjects: bool = True):
        """Greedy longest-first bin-packing of subjects onto world_size x mbatch
        lanes, oversampled to divisibility and interleaved so one subject's studies
        recur every mbatch*world steps (data/prompt.py:142-213). Shuffles with
        the global ``random`` module, as the JAX package does."""
        assert self.use_generated
        if shuffle_subjects:
            assert self.scst_generated
        lanes = self.world_size * self.mbatch_size

        subject_lists = _subject_lists(self.df)
        buckets, totals = _greedy_pack(subject_lists, lanes)

        def flat_count():
            return len([s for lane in buckets for subj in lane for s in subj])

        while flat_count() % lanes != 0:
            buckets[int(np.argmin(totals))].append(subject_lists[-1])

        if shuffle_subjects:
            random.seed(seed)
            lanes_flat = [list(itertools.chain(*random.sample(lane, k=len(lane)))) for lane in buckets]
        else:
            lanes_flat = [list(itertools.chain(*lane)) for lane in buckets]

        self.examples = [s for group in zip(*lanes_flat) for s in group]
        assert len(set(self.examples)) == len(tb.unique(self.df["study_id"]))
