"""Sampled decoding of the port: the logits warpers against the JAX package's
(values and keep-masks, exact on shared fp32 inputs), and the sampling loop's
own properties. Torch's draws are not JAX's PRNG's, so draws are never
compared: sampled tokens must stay inside the kept set, and one seed must give
one sequence."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxrmate_tpu.generate import logits_process as jlp
from cxrmate_torch.generate import logits_process as tlp
from cxrmate_torch.generate.decode import GenerationConfig, generate
from tests.test_torch_harness import BOS, EOS, PAD, SEP, VOCAB, t, torch_model

CASES = [
    dict(temperature=1.0, top_k=0, top_p=1.0),
    dict(temperature=0.7, top_k=0, top_p=1.0),
    dict(temperature=1.0, top_k=5, top_p=1.0),
    dict(temperature=1.0, top_k=0, top_p=0.9),
    dict(temperature=1.3, top_k=8, top_p=0.6),
    dict(temperature=1.0, top_k=1, top_p=0.01),   # min_tokens_to_keep = 1
    dict(temperature=1.0, top_k=VOCAB + 3, top_p=1.0),  # k past the vocabulary: no-op
]


def _logits():
    """Random rows, a row with ties across the top-k boundary, a one-hot-like
    row and a flat row."""
    rs = np.random.RandomState(41)
    x = (rs.randn(6, VOCAB) * 3).astype(np.float32)
    x[1] = np.minimum(x[1], 3.0)
    x[1, :12] = 4.0   # twelve equal maxima: ties at the k-th value are kept
    x[2, 7] = 60.0    # one token holds all the mass
    x[3] = 0.25       # flat
    return x


@pytest.mark.parametrize("case", CASES, ids=lambda c: "T{temperature}-k{top_k}-p{top_p}".format(**c))
def test_warp_logits_equals_jax(case):
    x = _logits()
    want = np.asarray(jlp.warp_logits(jnp.asarray(x), **case))
    got = tlp.warp_logits(t(x), **case).numpy()
    np.testing.assert_array_equal(got == tlp.NEG, want == jlp.NEG)  # keep-masks
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert tlp.NEG == jlp.NEG
    assert (got != tlp.NEG).any(axis=-1).all()  # at least one token survives per row
    if case["top_k"] == 5:
        assert (got[1] != tlp.NEG).sum() == 12  # the ties stay
        assert ((got[[0, 4, 5]] != tlp.NEG).sum(axis=-1) == 5).all()


@pytest.fixture(scope="module")
def setup():
    model = torch_model()
    rs = np.random.RandomState(42)
    enc = (rs.randn(3, 32, 32) * 30).astype(np.float32)
    return model, t(enc), torch.ones(3, 32, dtype=torch.int32), torch.full((3, 1), BOS,
                                                                           dtype=torch.int32)


def _cfg(**kw):
    return GenerationConfig(max_new_tokens=8, bos_token_id=BOS, eos_token_id=EOS,
                            pad_token_id=PAD, special_token_ids=(SEP,), **kw)


def test_sampling_is_seeded_and_needs_a_generator(setup):
    model, enc, enc_mask, prompt = setup
    cfg = _cfg(do_sample=True, top_k=20, top_p=0.95, temperature=1.5)
    runs = [generate(model, cfg, enc, enc_mask, prompt, None,
                     torch.Generator().manual_seed(seed)) for seed in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert runs[0].shape == (3, 9) and ((runs[0] >= 0) & (runs[0] < VOCAB)).all()
    with pytest.raises(ValueError, match="Generator"):
        generate(model, cfg, enc, enc_mask, prompt, None)


def test_top_k_one_sampling_is_greedy(setup):
    """With one token kept, any draw is the argmax: the sampled path must
    reproduce greedy decoding."""
    model, enc, enc_mask, prompt = setup
    greedy = generate(model, _cfg(), enc, enc_mask, prompt, None)
    sampled = generate(model, _cfg(do_sample=True, top_k=1), enc, enc_mask, prompt, None,
                       torch.Generator().manual_seed(0))
    assert torch.equal(greedy, sampled)


def test_sampled_tokens_stay_inside_top_k(setup, monkeypatch):
    """Every sampled token is one of the k highest logits of its step."""
    from cxrmate_torch.generate import decode as dec

    model, enc, enc_mask, prompt = setup
    kept = []
    real = dec.warp_logits

    def recording(logits, *a):
        out = real(logits, *a)
        kept.append(out != tlp.NEG)
        return out

    monkeypatch.setattr(dec, "warp_logits", recording)
    seq = generate(model, _cfg(do_sample=True, top_k=3, temperature=2.0), enc, enc_mask, prompt,
                   None, torch.Generator().manual_seed(7))
    assert len(kept) >= 2
    for step, mask in enumerate(kept):
        assert (mask.sum(-1) == 3).all()
        tok = seq[:, 1 + step].long()
        finished_before = (seq[:, 1:1 + step] == EOS).any(dim=1)
        inside = mask.gather(1, tok[:, None])[:, 0]
        assert (inside | finished_before).all()
