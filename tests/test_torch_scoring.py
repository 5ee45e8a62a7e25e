"""The port's model-based report scorers against the JAX package's, fp32 on
the CPU: the CheXbert labeler, BERTScore (BERT and RoBERTa positions, with and
without the baseline rescale), RoBERTa's BPE tokenisation, ``convert_roberta``
and ``load_rescale_baseline``, and the CXR-BERT metric over the SCST reward;
and on a card the scorers against themselves on the CPU.

Weights are random HF-layout state dicts made from numpy seeds at tiny widths
(hidden 24, 3 layers, 2 heads, intermediate 48): the JAX package converts
them (``convert_chexbert``, ``convert_bert_decoder``, ``convert_roberta``),
the port loads them (``load_chexbert``, ``load_roberta``). The WordPiece
vocabulary is a short word list; RoBERTa's is the repository tokenizer's with
``<s> <pad> </s> <unk>`` in front and ``<mask>`` behind.

Tolerances: token ids and class ids equal; logits, P/R/F1 and similarities
within 1e-5 (fp32; the reductions run in another order).

This file imports neither JAX nor ``tests.*`` at module level, so that its
CUDA tests run on the card's machine as they are:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_scoring.py -m cuda
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from cxrmate_torch.eval import bertscore as tbs
from cxrmate_torch.eval import chexbert as tchex
from cxrmate_torch.tokenizer import WordPieceTokenizer
from cxrmate_torch.utils.precision import parity_mode

torch.set_num_threads(2)  # the full suite runs six xdist workers on eight cores
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER = os.path.join(REPO, "artifacts", "tokenizer", "bpe_prompt", "tokenizer.json")
TOL = dict(rtol=1e-5, atol=1e-5)
HIDDEN, LAYERS, HEADS, INTER = 24, 3, 2, 48
WORDS = (
    "[PAD] [UNK] [CLS] [SEP] [MASK] the heart is normal no acute lungs are clear "
    "pleural effusion seen stable un ##change ##d card ##iome ##gal ##y small "
    "left right lower lobe a b c , . pneumonia edema without evidence of size "
    "mild moderate opacity base bases atelectasis ##s ##es"
).split()
PREDS = ["The heart is normal.", "Stable small left pleural effusion, no edema.",
         "cardiomegaly without evidence of pneumonia", "", "xyzzy unknown words here",
         " ".join(["mild bibasilar atelectasis"] * 30)]
REFS = ["heart size normal , no acute process", "small effusion", "no pneumonia",
        "lungs are clear", "", "moderate right lower lobe opacity"]


def bert_state_dict(seed: int, vocab: int, prefix: str = "bert.", positions: int = 64,
                    types: int = 2):
    """A random HF ``BertModel`` state dict (numpy) under ``prefix``, with a
    pooler and HF's ``position_ids`` buffer."""
    rs = np.random.RandomState(seed)

    def w(*shape, scale=0.2):
        return (rs.randn(*shape) * scale).astype(np.float32)

    def lin(key, fan_out, fan_in):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = w(fan_out, fan_in), w(fan_out, scale=0.05)

    def ln(key):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = 1.0 + w(HIDDEN, scale=0.05), w(HIDDEN, scale=0.05)

    p = prefix
    sd = {f"{p}embeddings.word_embeddings.weight": w(vocab, HIDDEN),
          f"{p}embeddings.position_embeddings.weight": w(positions, HIDDEN),
          f"{p}embeddings.token_type_embeddings.weight": w(types, HIDDEN),
          f"{p}embeddings.position_ids": np.arange(positions, dtype=np.int64)[None]}
    ln(f"{p}embeddings.LayerNorm")
    for layer in range(LAYERS):
        q = f"{p}encoder.layer.{layer}"
        for name in ("query", "key", "value"):
            lin(f"{q}.attention.self.{name}", HIDDEN, HIDDEN)
        lin(f"{q}.attention.output.dense", HIDDEN, HIDDEN)
        ln(f"{q}.attention.output.LayerNorm")
        lin(f"{q}.intermediate.dense", INTER, HIDDEN)
        lin(f"{q}.output.dense", HIDDEN, INTER)
        ln(f"{q}.output.LayerNorm")
    lin(f"{p}pooler.dense", HIDDEN, HIDDEN)
    return sd


def chexbert_state_dict(seed: int = 3):
    """The Stanford checkpoint's layout: ``module.bert.*`` and
    ``module.linear_heads.{0..13}``."""
    sd = {f"module.{k}": v for k, v in bert_state_dict(seed, len(WORDS)).items()}
    rs = np.random.RandomState(seed + 1)
    for i, n in enumerate(tchex.HEAD_CLASSES):
        sd[f"module.linear_heads.{i}.weight"] = (rs.randn(n, HIDDEN) * 0.5).astype(np.float32)
        sd[f"module.linear_heads.{i}.bias"] = (rs.randn(n) * 0.1).astype(np.float32)
    return sd


def tiny_chexbert_config():
    return dataclasses.replace(tchex.BERT_BASE, vocab_size=len(WORDS), hidden_size=HIDDEN,
                               num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                               intermediate_size=INTER, max_position_embeddings=64)


def roberta_files(directory) -> dict:
    """vocab.json and merges.txt of a RoBERTa vocabulary over the repository
    tokenizer's: <s> <pad> </s> <unk>, its tokens, <mask>."""
    with open(TOKENIZER) as f:
        data = json.load(f)
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for tok, _ in sorted(data["model"]["vocab"].items(), key=lambda kv: kv[1]):
        vocab.setdefault(tok, len(vocab))
    vocab["<mask>"] = len(vocab)
    merges = [m if isinstance(m, str) else " ".join(m) for m in data["model"]["merges"]]
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(directory, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return vocab


def roberta_state_dict(seed: int, vocab: int, max_length: int = 64):
    """A random HF RoBERTa encoder (``roberta.*``, one token type, positions
    to max_length + 2) with an LM head, which the scorer ignores."""
    sd = bert_state_dict(seed, vocab, "roberta.", positions=max_length + 2, types=1)
    rs = np.random.RandomState(seed + 1)
    sd["lm_head.dense.weight"] = rs.randn(HIDDEN, HIDDEN).astype(np.float32)
    sd["lm_head.bias"] = rs.randn(vocab).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def wp_vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("wp") / "vocab.txt"
    path.write_text("\n".join(WORDS) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def roberta_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("roberta"))
    return d, roberta_files(d)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _jax_bert(sd, vocab, positions=64, types=2, pad=0):
    from cxrmate_tpu.ckpt.hf_convert import convert_bert_decoder
    from cxrmate_tpu.configs import BertDecoderConfig
    from cxrmate_tpu.reward.cxrbert import _fake_lm_head

    cfg = BertDecoderConfig(vocab_size=vocab, hidden_size=HIDDEN, num_hidden_layers=LAYERS,
                            num_attention_heads=HEADS, intermediate_size=INTER,
                            max_position_embeddings=positions, type_vocab_size=types,
                            pad_token_id=pad, add_cross_attention=False)
    params = convert_bert_decoder({**sd, **_fake_lm_head(sd, cfg)}, cfg)
    params.pop("lm_head", None)
    return params, cfg


def _port_bert(sd, device="cpu"):
    """The plain encoder over a ``bert.*`` state dict, fp32."""
    from cxrmate_torch.models.bert_encoder import BertEncoderModel, bert_encoder_state
    from cxrmate_torch.reward.cxrbert import cxrbert_config_from_state_dict

    cfg = cxrbert_config_from_state_dict(sd, {"num_attention_heads": HEADS})
    model = BertEncoderModel(cfg, add_pooling_layer=True, device="cpu", dtype=torch.float32)
    model.load_state_dict({k: v.float() for k, v in bert_encoder_state(sd).items()}, strict=True)
    return model.to(device)


# ------------------------------------------------------------------ CheXbert
def test_chexbert_logits_and_labels_match_jax(wp_vocab):
    import jax.numpy as jnp

    from cxrmate_tpu.configs import BertDecoderConfig
    from cxrmate_tpu.eval import chexbert as jchex
    from cxrmate_tpu.tokenizer.wordpiece import WordPieceTokenizer as JWordPiece

    sd = chexbert_state_dict()
    jcfg = BertDecoderConfig(vocab_size=len(WORDS), hidden_size=HIDDEN, num_hidden_layers=LAYERS,
                             num_attention_heads=HEADS, intermediate_size=INTER,
                             max_position_embeddings=64, type_vocab_size=2, pad_token_id=0,
                             add_cross_attention=False)
    params = jchex.convert_chexbert(sd, jcfg)
    tcfg = tiny_chexbert_config()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    model = tchex.load_chexbert(sd, tcfg, device="cpu")
    assert isinstance(model.linear_heads[13], torch.nn.Module)
    assert [h.weight.shape[0] for h in model.linear_heads] == [4] * 13 + [2]
    tok = WordPieceTokenizer.from_file(wp_vocab)
    enc = tok([tchex.normalize_report(r) for r in PREDS], padding="longest", truncation=True,
              max_length=64)
    want = jchex.chexbert_logits(params, jcfg, jnp.asarray(enc["input_ids"]),
                                 jnp.asarray(enc["attention_mask"]))
    with torch.no_grad():
        got = tchex.chexbert_logits(model, torch.from_numpy(enc["input_ids"]).long(),
                                    torch.from_numpy(enc["attention_mask"]))
    assert len(got) == 14
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    ids = tchex.chexbert_predict(model, tok, PREDS + REFS, max_length=64)
    want_ids = jchex.chexbert_predict(params, jcfg, JWordPiece.from_file(wp_vocab), PREDS + REFS,
                                      max_length=64)
    assert ids.dtype == want_ids.dtype and ids.shape == (12, 14)
    np.testing.assert_array_equal(ids, want_ids)
    assert len(np.unique(ids)) > 1


def test_load_chexbert_takes_both_prefixes_and_refuses_stray_keys():
    sd, cfg = chexbert_state_dict(), tiny_chexbert_config()
    bare = {k[len("module."):]: v for k, v in sd.items()}
    a, b = tchex.load_chexbert(sd, cfg, device="cpu"), tchex.load_chexbert(bare, cfg, device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    with pytest.raises(KeyError):
        tchex.load_chexbert({**sd, "module.classifier.weight": np.zeros(3, np.float32)}, cfg,
                            device="cpu")


# ------------------------------------------------------------------ BERTScore
@pytest.mark.parametrize("positions", ["bert", "roberta"])
@pytest.mark.parametrize("rescaled", [False, True])
def test_bertscore_matches_jax(wp_vocab, roberta_dir, tmp_path, monkeypatch, positions,
                               rescaled):
    import jax

    from cxrmate_tpu.eval import bertscore as jbs
    from cxrmate_tpu.tokenizer.wordpiece import WordPieceTokenizer as JWordPiece

    # one compiled program per shape instead of op-by-op dispatch (same math)
    monkeypatch.setattr(jbs, "bert_hidden_states", jax.jit(
        jbs.bert_hidden_states, static_argnames=("config", "num_layers")))

    baseline_file = tmp_path / "roberta-large.tsv"
    baseline_file.write_text("LAYER,P,R,F\n1,0.81,0.8,0.805\n2,0.83,0.82,0.825\n")
    baseline = tbs.load_rescale_baseline(str(baseline_file), 2) if rescaled else None
    if rescaled:
        assert baseline == jbs.load_rescale_baseline(str(baseline_file), 2) == (0.83, 0.82, 0.825)
    if positions == "bert":
        sd = bert_state_dict(9, len(WORDS))
        params, jcfg = _jax_bert(sd, len(WORDS))
        model = _port_bert(sd)
        jtok, ttok = JWordPiece.from_file(wp_vocab), WordPieceTokenizer.from_file(wp_vocab)
    else:
        d, vocab = roberta_dir
        sd = roberta_state_dict(10, len(vocab))
        params, jcfg = jbs.convert_roberta(sd, num_attention_heads=HEADS)
        model = tbs.load_roberta(sd, num_attention_heads=HEADS, device="cpu")
        jtok, ttok = jbs.RobertaBPETokenizer.from_dir(d), tbs.RobertaBPETokenizer.from_dir(d)
    kw = dict(num_layers=2, roberta_positions=positions == "roberta", baseline=baseline,
              max_length=64)
    want = jbs.BERTScorer(params, jcfg, jtok, **kw).score(PREDS, REFS)
    got = tbs.BERTScorer(model, ttok, **kw).score(PREDS, REFS)
    for k in ("precision", "recall", "f1"):
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    assert got["f1"].std() > 0.01  # the pairs score apart


def test_roberta_tokenizer_ids_match_jax(roberta_dir, tmp_path):
    """From vocab.json + merges.txt and from a tokenizer.json; truncation
    keeps <s> and </s>."""
    from cxrmate_tpu.eval import bertscore as jbs

    d, vocab = roberta_dir
    tok_dir = tmp_path / "tokjson"
    tok_dir.mkdir()
    merges = open(os.path.join(d, "merges.txt")).read().splitlines()[1:]
    added = [{"id": vocab[t], "content": t, "special": True}
             for t in ("<s>", "<pad>", "</s>", "<unk>", "<mask>")]
    model_vocab = {t: i for t, i in vocab.items() if t not in ("<s>", "<pad>", "</s>", "<mask>")}
    (tok_dir / "tokenizer.json").write_text(json.dumps(
        {"added_tokens": added, "model": {"type": "BPE", "vocab": model_vocab, "merges": merges}}))
    texts = PREDS + REFS + ["Café naïve ✓ 3.5cm <s> </s>", "a\tb\n\nc"]
    for path in (d, str(tok_dir)):
        t, j = tbs.RobertaBPETokenizer.from_dir(path), jbs.RobertaBPETokenizer.from_dir(path)
        for kw in ({}, {"truncation": True, "max_length": 8}):
            got, want = t(texts, **kw), j(texts, **kw)
            for k in ("input_ids", "attention_mask"):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=(path, kw, k))
        assert (t.bos_token_id, t.eos_token_id, t.pad_token_id) == (0, 2, 1)


def test_convert_roberta_config_matches_jax(roberta_dir):
    from cxrmate_tpu.eval import bertscore as jbs

    _, vocab = roberta_dir
    sd = roberta_state_dict(10, len(vocab))
    for heads in (None, HEADS):
        state, cfg = tbs.convert_roberta(sd, heads)
        _, jcfg = jbs.convert_roberta(sd, heads)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.pad_token_id == 1 and cfg.layer_norm_eps == 1e-12 and cfg.type_vocab_size == 1
    assert all(k.startswith("bert.") for k in state) and "bert.pooler.dense.weight" in state
    model = tbs.load_roberta(sd, HEADS, device="cpu")
    np.testing.assert_array_equal(
        model.bert.encoder.layer[2].output.dense.weight.detach().numpy(),
        sd["roberta.encoder.layer.2.output.dense.weight"])


# ------------------------------------------------------------------ CXR-BERT metric
def test_cxrbert_metric_matches_jax(tmp_path):
    """CXRBERTMetric over the SCST reward (the port's CXRBERTReward, JAX's
    on the other side), per study, duplicated ids dropped: the similarity's
    mean and the CSV's ids equal, its values within 1e-5."""
    import csv

    from cxrmate_tpu.eval import metrics as jmetrics
    from cxrmate_tpu.reward.cxrbert import CXRBERTReward as JReward
    from cxrmate_tpu.tokenizer.wordpiece import WordPieceTokenizer as JWordPiece
    from cxrmate_torch.eval import metrics as tmetrics
    from cxrmate_torch.reward.cxrbert import CXRBERTReward
    from tests.test_torch_reward import cxrbert_state_dict, jax_cxrbert, port_cxrbert, write_vocab

    sd = cxrbert_state_dict()
    vocab = write_vocab(tmp_path)
    jparams, jcfg = jax_cxrbert(sd)
    rewards = {"port": CXRBERTReward(port_cxrbert(sd), WordPieceTokenizer.from_file(vocab)),
               "jax": JReward(jparams, jcfg, JWordPiece.from_file(vocab))}
    preds = PREDS + PREDS[:2]
    labels = [[r] for r in REFS + REFS[:2]]
    studies = [1, 2, 3, 4, 5, 6, 2, 7]
    out = {}
    for name, cls in (("port", tmetrics.CXRBERTMetric), ("jax", jmetrics.CXRBERTMetric)):
        metric = cls("test_findings", str(tmp_path / name), False, rewards[name], 3)
        metric.update(preds[:4], labels[:4], studies[:4])
        metric.update(preds[4:], labels[4:], studies[4:])
        scores = metric.compute(epoch=1)
        folder = tmp_path / name / "cxr_bert"
        (path,) = list(folder.iterdir())
        with open(path, newline="") as f:
            out[name] = scores, list(csv.reader(f))
    (ts, trows), (js, jrows) = out["port"], out["jax"]
    assert list(ts) == list(js) == ["similarity"]
    np.testing.assert_allclose(ts["similarity"], js["similarity"], **TOL)
    assert trows[0] == jrows[0] == ["study_id", "cxr_bert_similarity"]
    assert [r[0] for r in trows] == [r[0] for r in jrows] and len(trows) == 8
    np.testing.assert_allclose([float(r[1]) for r in trows[1:]],
                               [float(r[1]) for r in jrows[1:]], **TOL)


# ------------------------------------------------------------------ on the card
@pytest.mark.cuda
def test_chexbert_on_card_matches_cpu(cuda_device, wp_vocab):
    sd, cfg = chexbert_state_dict(), tiny_chexbert_config()
    tok = WordPieceTokenizer.from_file(wp_vocab)
    enc = tok(PREDS + REFS, padding="longest", truncation=True, max_length=64)
    outs = []
    for device in ("cpu", "cuda"):
        model = tchex.load_chexbert(sd, cfg, device=device)
        with parity_mode(), torch.no_grad():
            ids = torch.from_numpy(enc["input_ids"]).long().to(device)
            logits = tchex.chexbert_logits(model, ids,
                                           torch.from_numpy(enc["attention_mask"]).to(device))
        outs.append(([l.cpu() for l in logits],
                     tchex.chexbert_predict(model, tok, PREDS + REFS, max_length=64)))
    (cpu, cpu_ids), (card, card_ids) = outs
    for a, b in zip(card, cpu):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    np.testing.assert_array_equal(card_ids, cpu_ids)


@pytest.mark.cuda
def test_bertscore_on_card_matches_cpu(cuda_device, roberta_dir):
    d, vocab = roberta_dir
    sd = roberta_state_dict(10, len(vocab))
    tok = tbs.RobertaBPETokenizer.from_dir(d)
    outs = []
    for device in ("cpu", "cuda"):
        model = tbs.load_roberta(sd, HEADS, device=device)
        scorer = tbs.BERTScorer(model, tok, num_layers=2, roberta_positions=True,
                                baseline=(0.83, 0.82, 0.825), max_length=64)
        with parity_mode():
            outs.append(scorer.score(PREDS, REFS))
    for k in ("precision", "recall", "f1"):
        np.testing.assert_allclose(outs[1][k], outs[0][k], err_msg=k, **TOL)
