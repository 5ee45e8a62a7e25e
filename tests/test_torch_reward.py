"""The CXR-BERT reward of the port against the JAX package, fp32 on the CPU:
the WordPiece tokenizer, the plain BERT encoder (hidden states and pooler),
and the reward (tokenise, two BERT forwards, projected-CLS cosine).

One random HF-layout state dict, made from a numpy seed at the widths of
``cxrmate_tpu/data/synthetic.py:91 build_synthetic_cxrbert`` (hidden 24, 2
layers, 2 heads, intermediate 48, 64 positions, projection 16, its 45-word
vocabulary), goes through ``convert_cxrbert`` on the JAX side and
``load_cxrbert`` on the port's. It carries a pooler, an LM head and HF's
``position_ids`` buffer, which the reward ignores.

Tolerances: token ids equal; hidden states, pooler output and rewards within
1e-5 (fp32); the reward with ``length_bucket`` 0 and 32 within 1e-6 (padded
keys are masked out of every softmax: only the reduction order moves).
"""

import numpy as np
import pytest
import torch

from cxrmate_torch.models import bert_encoder as tbe
from cxrmate_torch.reward import cxrbert as trw
from cxrmate_torch.tokenizer import WordPieceTokenizer

torch.set_num_threads(2)  # the full suite runs six xdist workers on eight cores
TOL = dict(rtol=1e-5, atol=1e-5)
HIDDEN, LAYERS, HEADS, INTER, POSITIONS, PROJ = 24, 2, 2, 48, 64, 16
DIGITS = [str(d) for d in range(10)] + [f"##{d}" for d in range(10)]


def vocab_words():
    """The synthetic CXR-BERT vocabulary, then digits and their ``##``
    continuations (for the SCST tests' id strings)."""
    from cxrmate_tpu.data.synthetic import _CXRBERT_VOCAB

    return list(_CXRBERT_VOCAB) + DIGITS


def cxrbert_state_dict(seed: int = 7, vocab: int = None, extras: bool = True):
    """A random CXR-BERT state dict in HF layout (numpy). ``extras``: a pooler,
    an LM head and the ``position_ids`` buffer besides."""
    vocab = vocab or len(vocab_words())
    rs = np.random.RandomState(seed)

    def w(*shape, scale=0.2):
        return (rs.randn(*shape) * scale).astype(np.float32)

    def lin(key, fan_out, fan_in):
        sd[f"{key}.weight"] = w(fan_out, fan_in)
        sd[f"{key}.bias"] = w(fan_out, scale=0.05)

    def ln(key):
        sd[f"{key}.weight"] = 1.0 + w(HIDDEN, scale=0.05)
        sd[f"{key}.bias"] = w(HIDDEN, scale=0.05)

    sd = {"bert.embeddings.word_embeddings.weight": w(vocab, HIDDEN),
          "bert.embeddings.position_embeddings.weight": w(POSITIONS, HIDDEN),
          "bert.embeddings.token_type_embeddings.weight": w(2, HIDDEN)}
    ln("bert.embeddings.LayerNorm")
    for layer in range(LAYERS):
        p = f"bert.encoder.layer.{layer}"
        for name in ("query", "key", "value"):
            lin(f"{p}.attention.self.{name}", HIDDEN, HIDDEN)
        lin(f"{p}.attention.output.dense", HIDDEN, HIDDEN)
        ln(f"{p}.attention.output.LayerNorm")
        lin(f"{p}.intermediate.dense", INTER, HIDDEN)
        lin(f"{p}.output.dense", HIDDEN, INTER)
        ln(f"{p}.output.LayerNorm")
    sd["cls_projection_head.weight"] = w(PROJ, HIDDEN)
    if extras:
        sd["bert.embeddings.position_ids"] = np.arange(POSITIONS, dtype=np.int64)[None]
        lin("bert.pooler.dense", HIDDEN, HIDDEN)
        lin("cls.predictions.transform.dense", HIDDEN, HIDDEN)
        ln("cls.predictions.transform.LayerNorm")
        sd["cls.predictions.decoder.weight"] = w(vocab, HIDDEN)
        sd["cls.predictions.bias"] = w(vocab)
        sd["cls.predictions.decoder.bias"] = sd["cls.predictions.bias"]
    return sd


def write_vocab(path) -> str:
    path = str(path / "vocab.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab_words()) + "\n")
    return path


def jax_cxrbert(sd):
    """(JAX params, JAX config) through ``convert_cxrbert``, with the pooler."""
    import jax.numpy as jnp

    from cxrmate_tpu.configs import BertDecoderConfig
    from cxrmate_tpu.reward.cxrbert import convert_cxrbert

    cfg = BertDecoderConfig(vocab_size=len(vocab_words()), hidden_size=HIDDEN,
                            num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                            intermediate_size=INTER, max_position_embeddings=POSITIONS,
                            type_vocab_size=2, pad_token_id=0, add_cross_attention=False)
    params = convert_cxrbert(sd, cfg)
    params["bert"]["pooler"] = {"w": jnp.asarray(sd["bert.pooler.dense.weight"].T),
                                "b": jnp.asarray(sd["bert.pooler.dense.bias"])}
    return params, cfg


def port_cxrbert(sd, device="cpu"):
    config = trw.cxrbert_config_from_state_dict(sd, {"num_attention_heads": HEADS})
    return trw.load_cxrbert(sd, config, device=device)


@pytest.fixture(scope="module")
def models():
    sd = cxrbert_state_dict()
    return sd, jax_cxrbert(sd), port_cxrbert(sd)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return write_vocab(tmp_path_factory.mktemp("cxrbert"))


# ------------------------------------------------------------------ WordPiece
TEXTS = [
    "The heart size is normal and the lungs are clear.",
    "Cárdiomégaly, stable; no focal consolidation!",   # accents, punctuation
    "pneumothorax   is  absent\tthere\n",                # unknown word, whitespace
    "cardiomegaly cardiomegal cardio",                   # ## pieces, unknown remainders
    "ＴＨＥ 心 heart\x00\x07 size",                       # full-width, CJK, controls
    "",
    "12 345 6789",
    " ".join(["the heart size is normal"] * 20),         # longer than max_length
]


@pytest.mark.parametrize("max_length", [8, 64])
def test_wordpiece_equals_jax(vocab, max_length):
    from cxrmate_tpu.tokenizer.wordpiece import WordPieceTokenizer as JaxWordPiece

    ours, theirs = WordPieceTokenizer.from_file(vocab), JaxWordPiece.from_file(vocab)
    assert ours.pad_token_id == theirs.pad_token_id == 0
    for text in TEXTS:
        assert ours.tokenize(text) == theirs.tokenize(text), text
        assert ours.encode(text) == theirs.encode(text), text
        assert ours.encode(text, add_special_tokens=False) == theirs.encode(text, False), text
    got = ours(TEXTS, padding="longest", truncation=True, max_length=max_length)
    want = theirs(TEXTS, padding="longest", truncation=True, max_length=max_length)
    for key in ("input_ids", "attention_mask", "token_type_ids"):
        assert got[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    sep = ours.vocab["[SEP]"]
    long_row = got["input_ids"][-1]
    assert len(long_row) == max_length and long_row[-1] == sep  # the final [SEP] is kept
    assert ours.tokenize("cardiomegaly") == ["card", "##iome", "##gal", "##y"]
    assert ours.tokenize("Cárdiomégaly") == ["card", "##iome", "##gal", "##y"]
    assert ours.tokenize("pneumothorax") == ["[UNK]"]


# -------------------------------------------------------------- BERT encoder
def test_bert_encoder_hidden_states_and_pooler_equal_jax(models):
    import jax
    import jax.numpy as jnp

    from cxrmate_tpu.models.bert_encoder import bert_encoder_forward, pooler

    sd, (params, cfg), model = models
    rs = np.random.RandomState(3)
    ids = rs.randint(5, len(vocab_words()), (3, 11)).astype(np.int32)
    mask = np.ones((3, 11), np.int32)
    mask[1, 7:] = 0
    mask[2, 2:] = 0

    @jax.jit
    def ref(p, i, m):
        hidden = bert_encoder_forward(p, cfg, i, m)
        return hidden, pooler(p, hidden)

    want_h, want_p = ref(params["bert"], jnp.asarray(ids), jnp.asarray(mask))
    got_h = tbe.bert_encoder_forward(model, torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(tbe.pooler(model, got_h).numpy(), np.asarray(want_p), **TOL)
    np.testing.assert_array_equal(tbe.cls_embedding(got_h).numpy(), got_h[:, 0].numpy())


def test_bert_encoder_holds_hf_names_and_no_cross_attention():
    sd = cxrbert_state_dict(extras=False)
    config = trw.cxrbert_config_from_state_dict(sd)
    assert config.num_attention_heads == 1  # no config.json: hidden // 64, at least 1
    assert (config.num_hidden_layers, config.intermediate_size,
            config.max_position_embeddings) == (LAYERS, INTER, POSITIONS)
    model = tbe.BertEncoderModel(config, add_pooling_layer=True)
    names = set(model.state_dict())
    assert {"bert.embeddings.word_embeddings.weight", "bert.pooler.dense.weight",
            "bert.encoder.layer.1.attention.self.query.weight",
            "bert.encoder.layer.1.output.LayerNorm.bias"} <= names
    assert not any("crossattention" in n for n in names)
    assert set(tbe.bert_encoder_state(sd)) | {"bert.pooler.dense.weight",
                                              "bert.pooler.dense.bias"} == names
    with pytest.raises(ValueError, match="cross-attention"):
        tbe.BertEncoderModel(trw.BertDecoderConfig(add_cross_attention=True))


def test_load_cxrbert_takes_a_projection_bias_and_refuses_stray_keys():
    sd = cxrbert_state_dict(extras=False)
    sd["model.projection_head.weight"] = sd.pop("cls_projection_head.weight")
    sd["model.projection_head.bias"] = np.full(PROJ, 0.5, np.float32)
    model = trw.load_cxrbert(sd, device="cpu")
    assert not hasattr(model.bert, "pooler")
    ids = torch.tensor([[2, 5, 6, 3]])
    with_bias = trw.projected_cls(model, ids, torch.ones_like(ids))
    hidden = tbe.bert_encoder_forward(model, ids, torch.ones_like(ids))
    plain = hidden[:, 0] @ torch.from_numpy(sd["model.projection_head.weight"]).T
    np.testing.assert_allclose(with_bias.numpy(), plain.numpy() + 0.5, **TOL)
    sd["bert.encoder.layer.0.crossattention.self.query.weight"] = np.zeros((HIDDEN, HIDDEN))
    with pytest.raises(RuntimeError, match="Unexpected"):
        trw.load_cxrbert(sd, device="cpu")


# ------------------------------------------------------------------- reward
PREDICTIONS = [
    "the heart size is normal .",
    "",                                                   # an empty prediction
    "stable small left pleural effusion , no focal consolidation .",
    " ".join(["there is a small left pleural effusion"] * 12),  # truncated at 64
]
LABELS = [["the heart size is normal and the lungs are clear ."],
          ["no acute cardiopulmonary process ."],
          ["small left pleural effusion ."],
          ["cardiomegaly with no focal consolidation ."]]


def test_reward_equals_jax(models, vocab):
    from cxrmate_tpu.reward.cxrbert import CXRBERTReward as JaxReward
    from cxrmate_tpu.tokenizer.wordpiece import WordPieceTokenizer as JaxWordPiece

    _, (params, cfg), model = models
    want = JaxReward(params, cfg, JaxWordPiece.from_file(vocab))(PREDICTIONS, LABELS)
    reward = trw.CXRBERTReward(model, WordPieceTokenizer.from_file(vocab))
    got = reward(PREDICTIONS, LABELS)
    assert got.shape == (len(PREDICTIONS),) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    ids, mask = reward._tokenize(PREDICTIONS, POSITIONS)
    assert ids.shape == (4, POSITIONS) and int(mask[3].sum()) == POSITIONS  # truncated
    assert int(mask[1].sum()) == 2  # [CLS] [SEP]
    np.testing.assert_allclose(reward(LABELS[0], [LABELS[0]]), [1.0], rtol=0, atol=1e-6)


def test_reward_length_bucket_is_exact(models, vocab):
    _, _, model = models
    tok = WordPieceTokenizer.from_file(vocab)
    short = PREDICTIONS[:3]
    exact = trw.CXRBERTReward(model, tok, length_bucket=0)
    bucketed = trw.CXRBERTReward(model, tok)
    assert bucketed.length_bucket == 32
    assert exact._tokenize(short, POSITIONS)[0].shape[1] == 12
    assert bucketed._tokenize(short, POSITIONS)[0].shape[1] == 32
    np.testing.assert_allclose(bucketed(short, LABELS[:3]), exact(short, LABELS[:3]),
                               rtol=0, atol=1e-6)
