"""The port's data pipeline (cxrmate_torch/data: table, index, datasets,
pipeline, synthetic; tokenizer/bpe.py train_bpe) against the JAX package's
cxrmate_tpu/data and tokenizer/train.py: the same rows, CSV bytes, examples,
items, prompts, lane allocations, batches and tokenizer files.

pandas and PIL are imported inside the tests that compare with the JAX
package, so the file imports on a machine without them."""

from __future__ import annotations

import filecmp
import glob
import gzip
import io
import math
import os
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from cxrmate_torch.data import datasets as td
from cxrmate_torch.data import index as tx
from cxrmate_torch.data import pipeline as tp
from cxrmate_torch.data import table as tb

torch.set_num_threads(2)


def _cell(v):
    """A cell for comparison: NaN and None alike, numpy scalars as Python."""
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return None
    return v.item() if isinstance(v, np.generic) else v


def assert_same_rows(table: tb.Table, df) -> None:
    """The port's table holds pandas' frame: columns, order, values, kinds."""
    assert table.columns == list(df.columns)
    assert len(table) == len(df)
    for c in table.columns:
        got, want = table[c], df[c].to_numpy()
        assert got.dtype.kind == ("O" if want.dtype.kind in "OUT" or str(df[c].dtype) == "str"
                                  else want.dtype.kind), (c, got.dtype, df[c].dtype)
        assert [_cell(v) for v in got] == [_cell(v) for v in want], c


def _same_item(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        if k == "images":
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert _cell(a[k]) == _cell(b[k]), k


# ---------------------------------------------------------------------- table
_TRICKY = (
    'a,b,c,d,e,f\n'
    '1,2.5,"x, y",,120000.0,NA\n'
    '2,,"line\nbreak",3,213014.531,None\n'
    '3,1e-05,"say ""hi""",4,1e16,plain\n'
    '\n'
    '4,7,n/a,5,0.1,"  spaced  "\n'
)


def test_read_csv_types_and_to_csv_bytes_match_pandas(tmp_path):
    pd = pytest.importorskip("pandas")
    src = tmp_path / "t.csv"
    src.write_text(_TRICKY)
    gz = tmp_path / "t.csv.gz"
    with gzip.open(gz, "wt", newline="") as f:
        f.write(_TRICKY)
    for path in (src, gz):
        got, want = tb.read_csv(str(path)), pd.read_csv(path)
        assert_same_rows(got, want)
        got.to_csv(str(tmp_path / "port.csv"))
        want.to_csv(tmp_path / "pandas.csv", index=False)
        assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()


def test_table_operations_match_pandas():
    pd = pytest.importorskip("pandas")
    rows = [dict(k=[3, 1, 2, 1, 3, 2][i], j=[5, 5, 6, 5, 4, 6][i], t=[1.5, np.nan, 0.5, 1.5, 2.0, 0.5][i],
                 s=["a", "b", None, "d", "e", "f"][i]) for i in range(6)]
    df = pd.DataFrame(rows)
    t = tb.Table.from_rows(rows)
    assert_same_rows(t, df)
    assert_same_rows(t.sort_values(["k", "t"]), df.sort_values(["k", "t"]).reset_index(drop=True))
    assert_same_rows(t.sort_values(["t", "j"]), df.sort_values(["t", "j"]).reset_index(drop=True))
    assert_same_rows(t.drop_duplicates("k"), df.drop_duplicates("k").reset_index(drop=True))
    assert_same_rows(t.dropna(["s", "t"]), df.dropna(subset=["s", "t"], how="any").reset_index(drop=True))
    assert_same_rows(t[tb.isin(t["k"], [1, 3])], df[df.k.isin([1, 3])].reset_index(drop=True))
    assert tb.value_counts(t["k"]) == df.k.value_counts().to_dict()
    assert tb.group_lists(t["k"], t["j"]) == df.groupby("k")["j"].apply(list).tolist()
    right = pd.DataFrame(dict(k=[2, 3, 1, 3], j=[6, 5, 5, 4], r=["p", "q", "r", "s"]))
    for on in ("k", ["k", "j"]):
        got = tb.merge(t, tb.Table.from_rows(right.to_dict("records")), on=on)
        assert_same_rows(got, pd.merge(df, right, on=on))


# ---------------------------------------------------------------------- index
def _raw_mimic(root) -> None:
    """Split (gzipped), sectioned-report and metadata CSVs of MIMIC-CXR-JPG's
    layout, with newlines, tabs, runs of spaces and missing sections."""
    pd = pytest.importorskip("pandas")
    base = os.path.join(root, "physionet.org", "files", "mimic-cxr-jpg", "2.0.0")
    os.makedirs(base)
    os.makedirs(os.path.join(root, "mimic_cxr_sections"))
    studies = [(50000001, 10000001), (50000002, 10000001), (50000003, 10000002),
               (50000004, 10000003), (50000005, 10000003), (50000006, 10000004)]
    split_rows, meta_rows = [], []
    for n, (st, su) in enumerate(studies):
        for d in range(1 + n % 3):
            dicom = f"d{st}-{d}"
            split_rows.append(dict(dicom_id=dicom, study_id=st, subject_id=su,
                                   split=["train", "validate", "test"][n % 3]))
            meta_rows.append(dict(dicom_id=dicom, subject_id=su, study_id=st, ViewPosition="PA",
                                  Rows=3056, Columns=2544, StudyDate=21500101 + n,
                                  StudyTime=[120000.0, 93015.531, 120000.0][n % 3]))
    meta_rows.append(dict(dicom_id="orphan", subject_id=1, study_id=2, ViewPosition="AP", Rows=1,
                          Columns=1, StudyDate=1, StudyTime=np.nan))
    split_rows.reverse()
    pd.DataFrame(split_rows).to_csv(os.path.join(base, "mimic-cxr-2.0.0-split.csv.gz"), index=False)
    pd.DataFrame(meta_rows).to_csv(os.path.join(base, "mimic-cxr-2.0.0-metadata.csv"), index=False)
    findings = ["the heart\nis normal", "lungs\tclear  and   dry", None, "a  b\n\nc", "ok", "x"]
    impression = ["no acute", None, "stable\t\tview", "fine", "  lead", "y  "]
    pd.DataFrame(dict(study=[f"s{st}" for st, _ in studies], impression=impression,
                      findings=findings, last_paragraph=["z"] * 6)).to_csv(
        os.path.join(root, "mimic_cxr_sections", "mimic_cxr_sectioned.csv"), index=False)


def test_build_merged_index_and_filter_split_match_jax(tmp_path):
    pd = pytest.importorskip("pandas")
    from cxrmate_tpu.data import index as jx

    _raw_mimic(tmp_path / "jax")
    _raw_mimic(tmp_path / "port")
    want = jx.build_merged_index(str(tmp_path / "jax"))
    got = tx.build_merged_index(str(tmp_path / "port"))
    merged = os.path.join("mimic_cxr_merged", "splits_reports_metadata.csv")
    assert (tmp_path / "port" / merged).read_bytes() == (tmp_path / "jax" / merged).read_bytes()
    assert_same_rows(got, want)
    # the load branch reads the merged CSV back
    again = tx.build_merged_index(str(tmp_path / "port"))
    assert_same_rows(again, jx.build_merged_index(str(tmp_path / "jax")))
    for split in ("train", "validate", "test"):
        for limit in (5, 1):
            assert_same_rows(tx.filter_split(again, split, limit),
                             jx.filter_split(pd.read_csv(tmp_path / "jax" / merged), split, limit)
                             .reset_index(drop=True))
    assert tx.mimic_cxr_image_path("/d", 10000001, 50000001, "x") == \
        jx.mimic_cxr_image_path("/d", 10000001, 50000001, "x")
    assert tx.mimic_cxr_text_path("/d", 10000001, 50000001) == \
        jx.mimic_cxr_text_path("/d", 10000001, 50000001)


# ------------------------------------------------------------------- datasets
def _fake_image(path: str) -> np.ndarray:
    return np.full((3, 4, 4), zlib.crc32(path.encode()) % 251, np.float32)


def _hand_index(tmp_path) -> str:
    """Multi-image studies, missing sections, StudyDate/StudyTime ties, an
    ambiguous subject (_AMBIGUOUS) and subjects of 1 to 4 studies."""
    pd = pytest.importorskip("pandas")
    rows = []
    spec = [  # subject, study, images, date, time, findings, impression, split
        (10000001, 51, 2, 21500101, 80000.0, "f51", "i51", "test"),
        (10000001, 52, 1, 21500105, 90000.0, None, "i52", "test"),
        (10000001, 53, 3, 21500105, 90000.0, "f53", "i53", "test"),   # a tie with 52
        (10000001, 54, 1, 21500110, 70000.0, "f54", "i54", "test"),
        (10000002, 61, 1, 21500101, 120000.0, "f61", None, "test"),
        (10000002, 62, 2, 21500101, 110000.0, "f62", "i62", "test"),  # earlier the same day
        (10000003, 71, 1, 21500101, 120000.0, "f71", "i71", "test"),
        (10000004, 81, 4, 21500101, 120000.0, "f81", "i81", "train"),
        (10000004, 82, 1, 21500201, 120000.0, "f82", "i82", "test"),
        (15964158, 91, 1, 21800330, 120000.0, "f91", "i91", "test"),  # ambiguous subject
        (15964158, 92, 1, 21800331, 120000.0, "f92", "i92", "test"),
        (15964158, 93, 1, 21800401, 120000.0, "f93", "i93", "test"),
        (10000005, 95, 2, 21500101, 120000.0, "f95", "i95", "test"),
        (10000005, 96, 1, 21500102, 120000.0, "f96", "i96", "test"),
    ]
    for su, st, n, date, tm, f, i, split in spec:
        for d in range(n):
            rows.append(dict(dicom_id=f"d{st}-{d}", study_id=st, subject_id=su, split=split,
                             findings=f, impression=i, StudyDate=date, StudyTime=tm))
    path = str(tmp_path / "index.csv")
    pd.DataFrame(rows).to_csv(path, index=False)
    return path


def _both(path, split="test"):
    import pandas as pd

    from cxrmate_tpu.data import index as jx

    full_j, full_t = pd.read_csv(path), tb.read_csv(path)
    return (jx.filter_split(full_j, split), full_j), (tx.filter_split(full_t, split), full_t)


def _jax_synthetic(tmp_path):
    pytest.importorskip("PIL")
    from cxrmate_tpu.data.synthetic import build_synthetic_dataset

    paths = build_synthetic_dataset(str(tmp_path / "syn"), n_train=6, n_val=2, n_test=4,
                                    studies_per_subject=2, image_hw=(50, 42))
    return paths["dataset_dir"], os.path.join(paths["dataset_dir"], "mimic_cxr_merged",
                                              "splits_reports_metadata.csv")


@pytest.mark.parametrize("source", ["hand", "synthetic"])
def test_datasets_match_jax(tmp_path, source):
    pytest.importorskip("pandas")
    from cxrmate_tpu.data import datasets as jd

    if source == "hand":
        image_dir, path = "/data", _hand_index(tmp_path)
        load_j = load_t = _fake_image
    else:
        from cxrmate_torch.data import image as ti
        from cxrmate_tpu.data import image as ji

        image_dir, path = _jax_synthetic(tmp_path)
        image_dir = os.path.join(image_dir, "physionet.org", "files", "mimic-cxr-jpg", "2.0.0", "files")
        load_j, load_t = ji.make_eval_loader_transform(32), ti.make_eval_loader_transform(32)
    (dj, hj), (dt, ht) = _both(path, "test" if source == "hand" else "train")
    pairs = [(jd.DicomDataset(dj, image_dir, load_j), td.DicomDataset(dt, image_dir, load_t)),
             (jd.StudyDataset(dj, image_dir, load_j), td.StudyDataset(dt, image_dir, load_t)),
             (jd.PreviousReportDataset(dj, hj, image_dir, load_j),
              td.PreviousReportDataset(dt, ht, image_dir, load_t))]
    for j, t in pairs:
        assert t.examples == j.examples and len(t) == len(j)
        assert t.image_paths() == j.image_paths()
        for i in range(len(j)):
            _same_item(t[i], j[i])
    assert list(pairs[1][1].image_counts()) == list(pairs[1][0].image_counts())
    if source == "hand":
        assert 92 not in pairs[2][1].examples and 93 not in pairs[2][1].examples
        prompts = [pairs[2][1][i]["previous_findings"] for i in range(len(pairs[2][1]))]
        assert any(p is not None for p in prompts) and None in prompts


@pytest.mark.parametrize("lanes", [1, 2, 3, 7])
def test_allocate_eval_lanes_matches_jax(tmp_path, lanes):
    pytest.importorskip("pandas")
    from cxrmate_tpu.data import datasets as jd

    (dj, hj), (dt, ht) = _both(_hand_index(tmp_path))
    j = jd.PreviousReportDataset(dj, hj, "/d", _fake_image, use_generated=True, mbatch_size=1)
    t = td.PreviousReportDataset(dt, ht, "/d", _fake_image, use_generated=True, mbatch_size=1)
    assert t.examples == j.examples
    j.allocate_eval_lanes(lanes)
    t.allocate_eval_lanes(lanes)
    assert t.examples == j.examples and t.mbatch_size == j.mbatch_size


@pytest.mark.parametrize("seed", [0, 1])
def test_allocate_subjects_to_rank_matches_jax(tmp_path, seed):
    """scst_generated: the subjects shuffled with the global random module."""
    pytest.importorskip("pandas")
    from cxrmate_tpu.data import datasets as jd

    (dj, hj), (dt, ht) = _both(_hand_index(tmp_path))
    for mbatch, world in ((1, 1), (1, 2), (3, 1), (1, 3)):  # lanes of equal length
        kw = dict(use_generated=True, scst_generated=True, mbatch_size=mbatch, world_size=world)
        j = jd.PreviousReportDataset(dj, hj, "/d", _fake_image, **kw)
        t = td.PreviousReportDataset(dt, ht, "/d", _fake_image, **kw)
        assert t.examples == j.examples
        j.allocate_subjects_to_rank(seed=seed)
        t.allocate_subjects_to_rank(seed=seed)
        assert t.examples == j.examples


def test_generated_prompts_record_export_import_match_jax(tmp_path):
    pytest.importorskip("pandas")
    from cxrmate_tpu.data import datasets as jd

    (dj, hj), (dt, ht) = _both(_hand_index(tmp_path))
    j = jd.PreviousReportDataset(dj, hj, "/d", _fake_image, use_generated=True, mbatch_size=2)
    t = td.PreviousReportDataset(dt, ht, "/d", _fake_image, use_generated=True, mbatch_size=2)
    assert t.export_generated() == j.export_generated() == {}
    for sid in j.examples:
        for ds in (j, t):
            ds.record_generated(sid, f"gen findings {sid}", f"gen impression {sid}")
    exported = t.export_generated()
    assert exported == j.export_generated() and len(exported) == len(set(j.examples))
    for i in range(len(j)):
        _same_item(t[i], j[i])
    t.reset_generated()
    assert t.export_generated() == {}
    t.import_generated(exported)
    assert t.export_generated() == exported
    for i in range(len(j)):
        _same_item(t[i], j[i])


# ------------------------------------------------------------------- pipeline
class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"images": np.full((1 + i % 3, 2, 2), i, np.float32), "idx": i}


@pytest.mark.parametrize("mode", [
    dict(), dict(shuffle=True, seed=7), dict(shuffle=True, seed=7, drop_last=True),
    dict(sort_key=[(i * 7) % 4 for i in range(13)]), dict(rank=1, world_size=3),
    dict(shuffle=True, seed=3, rank=0, world_size=2, skip_batches=1),
    dict(row_shard=(1, 3)), dict(order=[5, 3, 11, 0, 2]), dict(max_images=4, num_workers=3),
    dict(sort_key=[i % 3 for i in range(13)], rank=1, world_size=2, skip_batches=1),
])
def test_batch_iterator_matches_jax(mode):
    from cxrmate_tpu.data import pipeline as jp

    got = list(tp.batch_iterator(_Items(13), 3, **mode))
    want = list(jp.batch_iterator(_Items(13), 3, **mode))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a["idx"] == b["idx"]
        assert a["images"].shape == b["images"].shape
        np.testing.assert_array_equal(a["images"], b["images"])


def test_prefetcher_lifecycle():
    """Abandoned iteration releases the producer and runs the inner
    generator's finally; worker errors reach the consumer; a slow consumer
    gets every batch in order (the sentinel never displaces one)."""
    closed = threading.Event()

    def gen():
        try:
            for i in range(100):
                yield i
        finally:
            closed.set()

    pf = tp.Prefetcher(gen(), depth=2)
    for _ in pf:
        break
    pf.close()
    deadline = time.time() + 5
    while pf.thread.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    assert not pf.thread.is_alive()
    assert closed.wait(1)

    def dies():
        yield 1
        raise RuntimeError("loader died")

    with pytest.raises(RuntimeError, match="loader died"):
        list(tp.Prefetcher(dies()))

    pf = tp.Prefetcher(iter(range(12)))
    time.sleep(0.3)
    got = []
    for item in pf:
        time.sleep(0.02)
        got.append(item)
    assert got == list(range(12))


# ------------------------------------------------------------ tokenizer, synthetic
def test_train_bpe_matches_jax():
    pytest.importorskip("regex")
    from cxrmate_torch.tokenizer import train_bpe
    from cxrmate_tpu.tokenizer.train import train_bpe as jax_train_bpe

    from cxrmate_torch.data.synthetic import FINDINGS, IMPRESSION

    corpus = FINDINGS + IMPRESSION + [
        "there is mild cardiomegaly, unchanged since 2019; no pneumothorax.",
        "Lines and tubes: ET tube 4.5 cm above the carina. Ünicode café x-ray",
    ] * 3
    for vocab, extra in ((300, ["[NPF]", "[NPI]", "[PMT]", "[PMT-SEP]"]), (420, [])):
        got = train_bpe(corpus, vocab_size=vocab, additional_special_tokens=extra)
        want = jax_train_bpe(corpus, vocab_size=vocab, additional_special_tokens=extra)
        assert got.vocab == want.vocab
        assert [tuple(m) for m in got.merges] == [tuple(m) for m in want.merges]


def test_build_synthetic_dataset_matches_jax(tmp_path):
    """The CSV and tokenizer files byte-identical; every JPEG decodes in PIL
    to the port decoder's pixels (and here equals PIL's own file)."""
    pytest.importorskip("PIL")
    from PIL import Image

    from cxrmate_torch.data import native
    from cxrmate_torch.data.synthetic import build_synthetic_dataset
    from cxrmate_tpu.data.synthetic import build_synthetic_dataset as jax_build

    kw = dict(n_train=4, n_val=1, n_test=2, studies_per_subject=2, image_hw=(37, 53), seed=3)
    got = build_synthetic_dataset(str(tmp_path / "port"), **kw)
    want = jax_build(str(tmp_path / "jax"), **kw)
    rel = os.path.join("mimic_cxr_merged", "splits_reports_metadata.csv")
    assert filecmp.cmp(os.path.join(got["dataset_dir"], rel), os.path.join(want["dataset_dir"], rel),
                       shallow=False)
    assert filecmp.cmp(os.path.join(got["tokenizer_dir"], "tokenizer.json"),
                       os.path.join(want["tokenizer_dir"], "tokenizer.json"), shallow=False)
    jpgs = sorted(glob.glob(os.path.join(got["dataset_dir"], "**", "*.jpg"), recursive=True))
    assert len(jpgs) == 7
    for p in jpgs:
        data = open(p, "rb").read()
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), native.decode(data))
        assert data == open(p.replace(str(tmp_path / "port"), str(tmp_path / "jax")), "rb").read()
