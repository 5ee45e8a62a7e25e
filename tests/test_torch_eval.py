"""The port's host-side report scoring against the JAX package's: PTB
tokenisation, the Snowball stemmer, BLEU, ROUGE-L, CIDEr, METEOR, SPICE's
gate, the CheXbert classification scores and the metric accumulators.

These are copies, so every score must be equal (``==``), not close: the
scorers on fixed and on seeded random report strings (the golden NLG
fixtures among them); METEOR with the vendored synonym table, a paraphrase
table, a function-word file and a stand-in for nltk's WordNet; and each
accumulator's ``compute()`` dict and CSV (parsed; the file names carry a time
stamp), per study and per DICOM (the study means), with duplicated ids. The
accumulators' models are stand-ins here (deterministic functions of the
text); ``tests/test_torch_scoring.py`` holds the models.
"""

import csv
import json
import os
import random
import sys
import types

import numpy as np
import pytest

from cxrmate_torch.eval import chexbert as tchex
from cxrmate_torch.eval import meteor as tmet
from cxrmate_torch.eval import metrics as tmetrics
from cxrmate_torch.eval import nlg as tnlg
from cxrmate_torch.eval import ptb as tptb
from cxrmate_torch.eval import spice as tspice
from cxrmate_torch.eval import stem as tstem
from cxrmate_torch.eval.bertscore import BERTScoreMetric as TBERTScoreMetric

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = (
    "the heart size is normal and lungs are clear no acute cardiopulmonary process "
    "small left pleural effusion stable cardiomegaly with focal consolidation seen "
    "right lower lobe opacity may reflect atelectasis or pneumonia interval improvement "
    "in pulmonary edema mediastinal contours unremarkable degenerative changes of spine "
    "there has been worsening bibasilar airspace disease since prior exam unchanged "
    "fluid infiltrate collapse swelling progression persists remained effusions opacities"
).split()
PUNCT = [".", ",", "..", "...", ";", ":", "(", ")", "'s", "n't", "-", "--", "?", "\"", "''"]


def reports(seed: int, n: int, lo: int = 0, hi: int = 30):
    """``n`` seeded random report strings of lo..hi words, with punctuation,
    capitals, abbreviations and the odd empty report."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        words = []
        for _ in range(rng.randint(lo, hi)):
            w = rng.choice(WORDS)
            if rng.random() < 0.1:
                w = w.capitalize()
            words.append(w)
            if rng.random() < 0.15:
                words.append(rng.choice(PUNCT + ["e.g.", "etc.", "Dr.", "u.s."]))
        out.append(" ".join(words))
    return out


def corpus(seed: int, n: int = 24):
    """{id: [refs]}, {id: [hyp]} of PTB-tokenised strings; one id has two
    references, one an empty hypothesis."""
    refs = [" ".join(tptb.ptb_tokenize_line(r)) for r in reports(seed, n + 1, lo=1)]
    hyps = [" ".join(tptb.ptb_tokenize_line(r)) for r in reports(seed + 1, n)]
    gts = {i: [refs[i]] for i in range(n)}
    gts[0].append(refs[n])
    hyps[1] = ""
    return gts, {i: [hyps[i]] for i in range(n)}


# ---------------------------------------------------------------- tokenise, stem
def test_ptb_tokenize_equals_jax():
    from cxrmate_tpu.eval import ptb as jptb

    lines = reports(0, 60) + [
        'He said "no acute process." (Stable.)', "edema.. etc.. u.s. e.g. a.m.",
        "cannot gonna wanna -- see [prior] {left}", "It's the patient's 5th exam; isn't it?",
        "", "...", "Dr. Smith's 3.5 cm nodule, unchanged."]
    for line in lines:
        assert tptb.ptb_tokenize_line(line) == jptb.ptb_tokenize_line(line), line
        assert tptb.ptb_tokenize_line(line, False) == jptb.ptb_tokenize_line(line, False), line
    caps = {i: [{"caption": line}] for i, line in enumerate(lines)}
    assert tptb.ptb_tokenize(caps) == jptb.ptb_tokenize(caps)


def test_stem_equals_jax_over_a_word_list():
    from cxrmate_tpu.eval import stem as jstem

    with open(os.path.join(REPO, "cxrmate_torch", "eval", "data", "synonyms_en.txt")) as f:
        table = [w.strip() for line in f if not line.startswith("#")
                 for w in line.split(",") if w.strip()]
    words = sorted(set(table + WORDS + [
        "skies", "dying", "generously", "communism", "arsenal", "yelling", "sayings", "agreed",
        "feed", "hopping", "hoped", "cries", "ties", "caresses", "ponies", "'s", "y", "ya",
        "controllability", "rationalization", "hopefulness", "formativeness", "adoption",
        "effusions", "opacities", "'apostrophe's'"]))
    assert len(words) > 500
    for w in words:
        assert tstem.stem(w) == jstem.stem(w), w


# ------------------------------------------------------------- BLEU, ROUGE, CIDEr
def test_golden_nlg_fixtures_equal_jax():
    from cxrmate_tpu.eval import nlg as jnlg

    with open(os.path.join(REPO, "tests", "golden", "nlg_fixtures.json")) as f:
        cases = json.load(f)["cases"]
    assert cases
    for case in cases:
        gts = {k: list(v) for k, v in case["gts"].items()}
        res = {k: list(v) for k, v in case["res"].items()}
        metric = {"bleu": "bleu", "bleu_corpus": "bleu", "cider": "cider",
                  "rouge": "rouge_l"}[case["metric"]]
        assert getattr(tnlg, metric)(gts, res) == getattr(jnlg, metric)(gts, res), case["note"]


@pytest.mark.parametrize("seed", [1, 2])
def test_bleu_rouge_cider_equal_jax(seed):
    from cxrmate_tpu.eval import nlg as jnlg

    gts, res = corpus(seed)
    assert tnlg.bleu(gts, res) == jnlg.bleu(gts, res)
    assert tnlg.rouge_l(gts, res) == jnlg.rouge_l(gts, res)
    assert tnlg.cider(gts, res) == jnlg.cider(gts, res)


# ------------------------------------------------------------------------ METEOR
class _FakeLemma:
    def __init__(self, n):
        self._n = n

    def name(self):
        return self._n


class _FakeSynset:
    def __init__(self, names):
        self._lemmas = [_FakeLemma(n) for n in names]

    def lemmas(self):
        return self._lemmas


class _FakeWordnet:
    """Enough of nltk.corpus.wordnet for ``wordnet_synonyms`` (as
    tests/test_meteor.py:218); without ``groups`` a corpus that is not
    installed."""

    def __init__(self, groups=None):
        self._by_word = None if groups is None else {}
        for g in groups or ():
            for w in g:
                self._by_word.setdefault(w, set()).update(g)

    def synsets(self, w):
        if self._by_word is None:
            raise LookupError("wordnet")
        return [_FakeSynset(sorted(self._by_word[w]))] if w in self._by_word else []


def fake_nltk(monkeypatch, wordnet: _FakeWordnet) -> None:
    """``from nltk.corpus import wordnet`` gives ``wordnet`` (nltk itself is
    never imported)."""
    corpus = types.ModuleType("nltk.corpus")
    corpus.wordnet = wordnet
    nltk = types.ModuleType("nltk")
    nltk.corpus = corpus
    monkeypatch.setitem(sys.modules, "nltk", nltk)
    monkeypatch.setitem(sys.modules, "nltk.corpus", corpus)


def _meteor_modules(tmp_path, monkeypatch):
    """(name, port kwargs, JAX kwargs) of each METEOR configuration."""
    from cxrmate_tpu.eval import meteor as jmet

    para = tmp_path / "paraphrase.txt"
    para.write_text("pleural effusion ||| fluid\n0.5 ||| lower lobe ||| base\n"
                    "no acute ||| unremarkable ||| 0.25\nheart size ||| cardiac silhouette\n")
    fw = tmp_path / "function.words"
    fw.write_text("# the jar's list\nthe\nis\nand\nno\nof\nin\n")
    groups = [{"normal", "unremarkable"}, {"effusion", "fluid"}, {"stable", "unchanged"},
              {"opacity", "infiltrate"}, {"atelectasis", "collapse"}, {"edema", "swelling"}]
    fake_nltk(monkeypatch, _FakeWordnet(groups))
    t_wn, j_wn = tmet.wordnet_synonyms(warn=False), jmet.wordnet_synonyms(warn=False)
    assert t_wn is not None and j_wn is not None
    return [
        ("none", {}, {}),
        ("vendored", {"synonyms": tmet.load_synonym_table()},
         {"synonyms": jmet.load_synonym_table()}),
        ("paraphrase+function-words",
         {"synonyms": tmet.load_synonym_table(),
          "paraphrases": tmet.load_paraphrase_table(str(para)),
          "function_words": tmet.load_function_words(str(fw))},
         {"synonyms": jmet.load_synonym_table(),
          "paraphrases": jmet.load_paraphrase_table(str(para)),
          "function_words": jmet.load_function_words(str(fw))}),
        ("wordnet", {"synonyms": t_wn}, {"synonyms": j_wn}),
        ("original", {"synonyms": t_wn, "alpha": 0.9, "beta": 3.0, "gamma": 0.5, "delta": 0.5,
                      "weights": (1, 1, 1)},
         {"synonyms": j_wn, "alpha": 0.9, "beta": 3.0, "gamma": 0.5, "delta": 0.5,
          "weights": (1, 1, 1)}),
    ]


def test_meteor_equals_jax(tmp_path, monkeypatch):
    from cxrmate_tpu.eval import meteor as jmet

    gts, res = corpus(3, n=16)
    gts[2] = ["the heart size is normal with small left pleural effusion"]
    res[2] = ["cardiac silhouette normal , small left fluid unchanged"]
    gts[3] = []  # no reference: scores 0
    for name, tkw, jkw in _meteor_modules(tmp_path, monkeypatch):
        assert tmet.meteor(gts, res, **tkw) == jmet.meteor(gts, res, **jkw), name
    assert len(tmet.load_synonym_table()) == len(jmet.load_synonym_table())


@pytest.mark.parametrize("installed", [False, True])
def test_default_synonyms_picks_what_jax_picks(monkeypatch, installed):
    """Without the WordNet corpus (as on a machine without nltk's data) the
    vendored table, with it WordNet: the same choice and answers as JAX."""
    from cxrmate_tpu.eval import meteor as jmet

    fake_nltk(monkeypatch, _FakeWordnet([{"normal", "unremarkable"}] if installed else None))
    monkeypatch.setattr(tmet, "_DEFAULT_SYNONYMS", None)
    monkeypatch.setattr(jmet, "_DEFAULT_SYNONYMS", None)
    t, j = tmet.default_synonyms(), jmet.default_synonyms()
    assert type(t).__name__ == type(j).__name__ == ("function" if installed else "SynonymTable")
    pairs = [(a, b) for a in WORDS[:40] for b in WORDS[:40]]
    assert [t(a, b) for a, b in pairs] == [j(a, b) for a, b in pairs]


def test_spice_gate_agrees_with_jax(tmp_path, monkeypatch):
    from cxrmate_tpu.eval import spice as jspice

    monkeypatch.delenv("CXRMATE_SPICE_JAR", raising=False)
    assert tspice.spice_available() == jspice.spice_available() is False
    jar = tmp_path / "spice-1.0.jar"
    jar.write_bytes(b"")
    monkeypatch.setenv("CXRMATE_SPICE_JAR", str(jar))
    assert tspice.spice_available() == jspice.spice_available()
    monkeypatch.setenv("CXRMATE_SPICE_JAR", str(tmp_path / "absent.jar"))
    with pytest.raises(RuntimeError):
        tspice.spice({1: ["a"]}, {1: ["a"]})


# ------------------------------------------------------------------ CheXbert scores
def test_chexbert_scores_equal_jax():
    from cxrmate_tpu.eval import chexbert as jchex

    rs = np.random.RandomState(4)
    y_hat = rs.randint(0, 4, (40, 14)).astype(np.int32)
    y = rs.randint(0, 4, (40, 14)).astype(np.int32)
    y_hat[:5] = 2  # rows with no positive at all, in the prediction and the label
    y[3:8] = 0
    y_hat[10] = y[10]
    assert tchex.chexbert_scores(y_hat, y) == jchex.chexbert_scores(y_hat, y)
    none = np.zeros((3, 14), np.int32)
    assert tchex.chexbert_scores(none, none) == jchex.chexbert_scores(none, none)


# ---------------------------------------------------------------- accumulators
def _text_hash(text: str) -> int:
    return sum((i + 1) * ord(c) for i, c in enumerate(text)) % 9973


def fake_predict(texts):
    """A CheXbert stand-in: class ids from the text."""
    return np.stack([np.random.RandomState(_text_hash(t)).randint(0, 4, 14)
                     for t in texts]).astype(np.int32)


def fake_reward(preds, labels):
    """A CXR-BERT stand-in: float32 similarities from the texts."""
    return np.asarray([(_text_hash(p) * 7 + _text_hash(l[0])) % 1000 / 997.0
                       for p, l in zip(preds, labels)], np.float32)


class FakeScorer:
    """A BERTScorer stand-in: float32 P/R/F1 from the texts, rescaled with the
    baseline as the scorer rescales."""

    def __init__(self, baseline):
        self.baseline = baseline

    def score(self, preds, refs):
        out = {k: np.asarray([(_text_hash(p) * (i + 3) + _text_hash(r)) % 1000 / 1009.0
                              for p, r in zip(preds, refs)], np.float32)
               for i, k in enumerate(("precision", "recall", "f1"))}
        if self.baseline is not None:
            for k, b in zip(("precision", "recall", "f1"), self.baseline):
                out[k] = (out[k] - b) / (1 - b)
        return out


def read_csv(directory):
    files = sorted(os.listdir(directory))
    assert len(files) == 1, files
    with open(os.path.join(directory, files[0]), newline="") as f:
        return files[0], list(csv.reader(f))


def feed(acc, kind, batches, dicoms):
    for preds, labels, sids, dids in batches:
        kw = {"dicom_ids": dids} if dicoms else {}
        if kind == "ids":
            acc.update(np.asarray([[_text_hash(p) % 50, len(p)] for p in preds]), sids, **kw)
        elif kind == "report":
            acc.update(preds, [l[0] for l in labels], sids, **kw)
        else:
            acc.update(preds, labels, sids, **kw)


def batches(seed: int, dicoms: bool):
    """Three update batches of 6 rows; ids repeat (an oversampled study is
    fed twice), per DICOM several DICOMs share a study."""
    preds, labels = reports(seed, 18), reports(seed + 50, 18, lo=1)
    rs = np.random.RandomState(seed)
    sids = [int(s) for s in rs.randint(100, 108, 18)]
    dids = [f"d{sid}-{rs.randint(0, 2)}" for sid in sids]
    sids[7], dids[7] = sids[2], dids[2]  # a repeated row
    out = []
    for i in range(0, 18, 6):
        out.append((preds[i:i + 6], [[l] for l in labels[i:i + 6]], sids[i:i + 6],
                    dids[i:i + 6] if dicoms else None))
    return out


def accumulators(split, exp_dir, dicoms, jax: bool):
    if jax:
        from cxrmate_tpu.eval import metrics as m
        from cxrmate_tpu.eval.bertscore import BERTScoreMetric
        from cxrmate_tpu.eval.meteor import load_synonym_table
    else:
        m, BERTScoreMetric, load_synonym_table = tmetrics, TBERTScoreMetric, tmet.load_synonym_table
    return {
        "nlg_scores": ("nlg", m.COCONLGMetrics(
            split, exp_dir, dicoms, metrics=("bleu", "cider", "rouge", "meteor"),
            meteor_synonyms=load_synonym_table())),
        "chexbert_outputs": ("nlg", m.CheXbertMetrics(split, exp_dir, dicoms, fake_predict, 4)),
        "cxr_bert": ("nlg", m.CXRBERTMetric(split, exp_dir, dicoms, fake_reward, 5)),
        "bertscore": ("nlg", BERTScoreMetric(split, exp_dir, dicoms,
                                             FakeScorer((0.8, 0.75, 0.7)), 4)),
        "bertscore_raw": ("nlg", BERTScoreMetric(split, os.path.join(exp_dir, "raw"), dicoms,
                                                 FakeScorer(None), 16)),
        "generated_reports": ("report", m.ReportLogger(split, exp_dir, dicoms)),
        "generated_report_ids": ("ids", m.ReportTokenIdentifiersLogger(split, exp_dir, dicoms)),
    }


@pytest.mark.parametrize("dicoms", [False, True])
def test_accumulators_equal_jax(tmp_path, dicoms):
    """Each accumulator fed as cli/stages.py:evaluate feeds it (labels as
    one-item lists): compute()'s dict and the CSV's header and rows equal."""
    data = batches(11 + dicoms, dicoms)
    results = {}
    for jax in (False, True):
        exp_dir = str(tmp_path / ("jax" if jax else "port"))
        accs = accumulators("test_findings", exp_dir, dicoms, jax)
        out = {}
        for name, (kind, acc) in accs.items():
            feed(acc, kind, data, dicoms)
            out[name] = acc.compute(epoch=3)
            sub = "bertscore" if name == "bertscore_raw" else name
            folder = os.path.join(exp_dir, "raw", sub) if name == "bertscore_raw" else \
                os.path.join(exp_dir, sub)
            fname, rows = read_csv(folder)
            assert fname.startswith("test_findings_epoch-3_") and fname.endswith(".csv")
            out[name + ".csv"] = rows
        results[jax] = out
    port, ref = results[False], results[True]
    assert set(port) == set(ref)
    for name in port:
        assert port[name] == ref[name], name
    assert port["nlg_scores"]["num_study_ids"] < 18
    assert "f1_unrescaled" in port["bertscore_raw"] and "f1" in port["bertscore"]
    if dicoms:
        assert port["nlg_scores"]["num_dicom_ids"] > port["nlg_scores"]["num_study_ids"]


def test_group_mean_and_mean_reduce_as_pandas():
    """The study means (Kahan sums in the column's dtype, sorted by study)
    and the column means (numpy's pairwise sum) equal pandas', float64 and
    float32, over groups large enough for the summation order to show."""
    import pandas as pd

    rs = np.random.RandomState(5)
    n = 400
    keys = [int(k) for k in rs.randint(0, 9, n)]
    for dtype in (np.float64, np.float32):
        vals = (rs.rand(n) * 10.0 ** rs.uniform(-3, 2, n)).astype(dtype)
        got = tmetrics._group_mean({"study_id": keys, "x": list(vals)}, "study_id")
        want = pd.DataFrame({"study_id": keys, "x": vals}).groupby(
            "study_id", as_index=False).mean()
        assert got["study_id"] == list(want["study_id"])
        assert got["x"].dtype == want["x"].dtype
        np.testing.assert_array_equal(got["x"], want["x"].to_numpy())
        assert tmetrics._mean(got["x"]) == float(want["x"].mean())
        assert tmetrics._mean(list(vals)) == float(pd.Series(vals).mean())
