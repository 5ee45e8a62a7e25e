"""Synthetic MIMIC-CXR-shaped dataset and reward-model builders (smoke tests
and dry runs).

The port's copy of ``cxrmate_tpu/data/synthetic.py:29
build_synthetic_dataset``: the same on-disk layout (the reference's
`prepare_data` output: the merged CSV at
mimic_cxr_merged/splits_reports_metadata.csv, JPEGs under
physionet.org/files/mimic-cxr-jpg/2.0.0/files/pXX/p<subj>/s<study>/), the same
rows and tokenizer. The CSV is written by the port's table, the JPEGs by the
port's encoder (libjpeg's defaults, as PIL's ``save``), the random pixels
drawn from ``np.random.RandomState(seed)`` in the JAX builder's order.
``build_synthetic_cxrbert`` is the counterpart of ``:91`` there, without
``transformers``."""

from __future__ import annotations

import json
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


# a WordPiece vocab covering the synthetic report vocabulary (plus the BERT
# specials the tokenizer requires) for the tiny CXR-BERT reward checkpoint
_CXRBERT_VOCAB = (
    "[PAD] [UNK] [CLS] [SEP] [MASK] the heart size is normal and lungs are clear "
    "there a small left pleural effusion stable card ##iome ##gal ##y with no focal "
    "consolidation acute cardiopulmonary process seen disease appearance study , ."
).split()


def build_synthetic_cxrbert(ckpt_zoo_dir: str, seed: int = 7) -> str:
    """Write a tiny random-weight CXR-BERT reward checkpoint into the zoo at
    the path ``cli.stages.build_cxrbert_reward`` loads
    (``microsoft/BiomedVLP-CXR-BERT-specialized``): ``pytorch_model.bin``
    (HF ``bert.*`` names from ``models.bert_encoder.BertEncoderModel`` at the
    JAX builder's widths: hidden 24, 2 layers of 2 heads, intermediate 48, 64
    positions; plus ``cls_projection_head.weight`` [16, 24]), ``config.json``
    (the head count, which no shape holds) and ``vocab.txt``. From a
    ``torch.Generator`` seeded with ``seed``: embeddings N(0, 1), the other
    weights and biases N(0, 0.2), norm scales 1 and shifts 0. Wider than
    BERT's N(0, 0.02) init, with which every text's [CLS] state, and so the
    reward, would be nearly the same. Not the JAX builder's numbers.
    Returns the checkpoint dir."""
    import torch

    from cxrmate_torch.configs import BertDecoderConfig
    from cxrmate_torch.models.bert_encoder import BertEncoderModel

    path = os.path.join(ckpt_zoo_dir, "microsoft", "BiomedVLP-CXR-BERT-specialized")
    os.makedirs(path, exist_ok=True)
    cfg = dict(vocab_size=len(_CXRBERT_VOCAB), hidden_size=24, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=48, max_position_embeddings=64,
               type_vocab_size=2, pad_token_id=0)
    model = BertEncoderModel(BertDecoderConfig(add_cross_attention=False, **cfg),
                             device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in model.state_dict().items():
        if "LayerNorm" in name:
            sd[name] = torch.ones_like(p) if name.endswith("weight") else torch.zeros_like(p)
        else:
            std = 1.0 if "embeddings" in name else 0.2
            sd[name] = torch.randn(p.shape, generator=gen) * std
    sd["cls_projection_head.weight"] = torch.randn(16, 24, generator=gen) * 0.2
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "bert", "hidden_act": "gelu", "layer_norm_eps": 1e-12,
                   **cfg}, f, indent=1)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(_CXRBERT_VOCAB) + "\n")
    return path
