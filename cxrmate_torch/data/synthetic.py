"""Synthetic MIMIC-CXR-shaped dataset builder (smoke tests and dry runs).

The port's copy of ``cxrmate_tpu/data/synthetic.py:29
build_synthetic_dataset``: the same on-disk layout (the reference's
`prepare_data` output: the merged CSV at
mimic_cxr_merged/splits_reports_metadata.csv, JPEGs under
physionet.org/files/mimic-cxr-jpg/2.0.0/files/pXX/p<subj>/s<study>/), the same
rows and tokenizer. The CSV is written by the port's table, the JPEGs by the
port's encoder (libjpeg's defaults, as PIL's ``save``), the random pixels
drawn from ``np.random.RandomState(seed)`` in the JAX builder's order."""

from __future__ import annotations

import os

import numpy as np

from cxrmate_torch.data import native
from cxrmate_torch.data.table import Table

FINDINGS = [
    "the heart size is normal and the lungs are clear",
    "there is a small left pleural effusion",
    "stable cardiomegaly with no focal consolidation",
    "no acute cardiopulmonary process is seen",
]
IMPRESSION = [
    "no acute disease",
    "small left effusion",
    "stable appearance",
    "normal study",
]


def build_synthetic_dataset(
    root: str,
    n_train: int = 16,
    n_val: int = 2,
    n_test: int = 2,
    studies_per_subject: int = 1,
    image_hw=(48, 40),
    seed: int = 0,
) -> dict:
    """Write a synthetic dataset + tokenizer under ``root``; returns the paths
    dict {'dataset_dir', 'ckpt_zoo_dir', 'tokenizer_dir'}."""
    from cxrmate_torch.tokenizer import train_bpe

    dataset_dir = os.path.join(root, "datasets")
    files_dir = os.path.join(dataset_dir, "physionet.org", "files", "mimic-cxr-jpg", "2.0.0")
    rng = np.random.RandomState(seed)
    rows = []
    total = n_train + n_val + n_test
    for i in range(total):
        study = 1000 + i
        subject = 100 + i // max(1, studies_per_subject)
        dicom = f"dcm{i}"
        img_dir = os.path.join(
            files_dir, "files", f"p{str(subject)[:2]}", f"p{subject}", f"s{study}"
        )
        os.makedirs(img_dir, exist_ok=True)
        arr = rng.randint(0, 255, size=image_hw, dtype=np.uint8)
        native.save_jpeg(os.path.join(img_dir, f"{dicom}.jpg"), arr)
        split = "train" if i < n_train else ("validate" if i < n_train + n_val else "test")
        rows.append(
            dict(
                dicom_id=dicom, study_id=study, subject_id=subject, split=split,
                findings=FINDINGS[i % 4], impression=IMPRESSION[i % 4],
                StudyDate=20200101 + i, StudyTime=120000.0 + i,
            )
        )
    merged = os.path.join(dataset_dir, "mimic_cxr_merged")
    os.makedirs(merged, exist_ok=True)
    Table.from_rows(rows).to_csv(os.path.join(merged, "splits_reports_metadata.csv"))

    ckpt_zoo_dir = os.path.join(root, "checkpoints")
    tok_dir = os.path.join(ckpt_zoo_dir, "mimic-cxr-tokenizers", "bpe_prompt")
    os.makedirs(tok_dir, exist_ok=True)
    tok = train_bpe(
        FINDINGS + IMPRESSION, vocab_size=300,
        additional_special_tokens=["[NPF]", "[NPI]", "[PMT]", "[PMT-SEP]"],
    )
    tok.save(tok_dir + os.sep)
    return {"dataset_dir": dataset_dir, "ckpt_zoo_dir": ckpt_zoo_dir, "tokenizer_dir": tok_dir}
