"""MIMIC-CXR-JPG dataset index: CSV merge and split filtering.

The port's copy of ``cxrmate_tpu/data/index.py`` on the port's own column
table (``data/table.py``) instead of pandas: the same rows, and a merged CSV
with the same bytes (``tests/test_torch_data.py``)."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

from cxrmate_torch.data import table as tb


def mimic_cxr_image_path(image_dir: str, subject_id, study_id, dicom_id, ext: str = "jpg") -> str:
    """`p<first-2>/p<subject>/s<study>/<dicom>.<ext>` (tools/utils.py:6-9)."""
    return os.path.join(
        image_dir, "p" + str(subject_id)[:2], "p" + str(subject_id),
        "s" + str(study_id), str(dicom_id) + "." + ext,
    )


def mimic_cxr_text_path(image_dir: str, subject_id, study_id, ext: str = "txt") -> str:
    return os.path.join(
        image_dir, "p" + str(subject_id)[:2], "p" + str(subject_id),
        "s" + str(study_id) + "." + ext,
    )


def _find_csv(base: str) -> str:
    for suffix in (".csv", ".csv.gz"):
        if os.path.exists(base + suffix):
            return base + suffix
    raise FileNotFoundError(f"neither {base}.csv nor .csv.gz exists")


def build_merged_index(dataset_dir: str, merged_csv_path: Optional[str] = None) -> tb.Table:
    """Create (or load) the merged splits ⋈ sectioned-reports ⋈ metadata table."""
    if merged_csv_path is None:
        merged_csv_path = os.path.join(dataset_dir, "mimic_cxr_merged", "splits_reports_metadata.csv")
    if os.path.isfile(merged_csv_path):
        return tb.read_csv(merged_csv_path)

    root = os.path.join(dataset_dir, "physionet.org", "files", "mimic-cxr-jpg", "2.0.0")
    splits = tb.read_csv(_find_csv(os.path.join(root, "mimic-cxr-2.0.0-split")))
    reports_path = os.path.join(dataset_dir, "mimic_cxr_sections", "mimic_cxr_sectioned.csv")
    assert os.path.isfile(reports_path), (
        f"{reports_path} missing; create it with the MIT-LCP mimic-cxr sectioning tool"
    )
    reports = tb.read_csv(reports_path)
    metadata = tb.read_csv(_find_csv(os.path.join(root, "mimic-cxr-2.0.0-metadata")))

    for col in ("findings", "impression"):
        values = reports[col]
        for pattern in (r"\n", r"\t", r"\s{2,}"):
            values = tb.regex_replace(values, pattern, " ")
        reports[col] = values
    reports = reports.rename({"study": "study_id"})
    reports["study_id"] = [int(s[1:]) for s in reports["study_id"]]
    df = tb.merge(splits, reports, on="study_id")
    df = tb.merge(df, metadata, on=["dicom_id", "study_id", "subject_id"])
    Path(os.path.dirname(merged_csv_path)).mkdir(parents=True, exist_ok=True)
    df.to_csv(merged_csv_path)
    return df


def filter_split(df: tb.Table, split: str, max_images_per_study: int = 5) -> tb.Table:
    """Drop rows without findings/impression, drop oversize studies, select split
    (single.py:326-374)."""
    df = df.dropna(subset=["findings", "impression"])
    counts = tb.value_counts(df["study_id"])
    df = df[np.array([counts[s] <= max_images_per_study for s in df["study_id"].tolist()], bool)]
    return df[df["split"] == split]
