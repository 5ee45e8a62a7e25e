"""Greedy and beam-4 decoding of the port against the JAX package on the tiny
multi model (fp32, CPU): token ids identical, beam scores allclose. A boosted
EOS logit makes rows finish at different steps, so the EOS bookkeeping, the
finished-beam finalisation and the early stop are exercised too."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxrmate_tpu.generate import GenerationConfig as JGen
from cxrmate_tpu.generate import generate as jax_generate
from cxrmate_tpu.generate.beam import beam_search as jax_beam_search
from cxrmate_torch.generate.beam import beam_search, top_k
from cxrmate_torch.generate.decode import GenerationConfig, generate
from tests.test_torch_harness import BOS, EOS, PAD, SEP, jax_config, jax_variables, t, torch_model

B, S, MAX_NEW = 3, 32, 12


@pytest.fixture(scope="module", params=[0.0, 0.3], ids=["plain", "eos-boost"])
def setup(request):
    """JAX variables and the port's model with the EOS logit bias raised by
    ``boost`` in both, plus encoder states with a padded image slot."""
    boost = request.param
    variables = copy.deepcopy(jax_variables())
    variables["params"]["decoder"]["lm_head"]["decoder"]["b"][EOS] += boost
    model = torch_model()
    with torch.no_grad():
        model.decoder.cls.predictions.bias[EOS] += boost
    rs = np.random.RandomState(21)
    # large encoder states, so that the studies decode differently
    enc = (rs.randn(B, S, 32) * 30).astype(np.float32)
    enc_mask = np.ones((B, S), np.int32)
    enc_mask[2, S // 2:] = 0
    prompt = np.full((B, 1), BOS, np.int32)
    return variables, model, enc, enc_mask, prompt


def _cfgs(beams, **extra):
    kw = dict(max_new_tokens=MAX_NEW, bos_token_id=BOS, eos_token_id=EOS, pad_token_id=PAD,
              special_token_ids=(SEP,), num_beams=beams, **extra)
    return JGen(**kw), GenerationConfig(**kw)


def test_greedy_ids_identical(setup):
    variables, model, enc, enc_mask, prompt = setup
    jcfg, tcfg = _cfgs(1)
    want = jax_generate(variables, jax_config(), jcfg, jnp.asarray(enc), jnp.asarray(enc_mask),
                        jnp.asarray(prompt), jnp.ones_like(prompt))
    got = generate(model, tcfg, t(enc), t(enc_mask), t(prompt), torch.ones(B, 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("extra", [{}, {"length_penalty": 0.8, "early_stopping": True}],
                         ids=["hf-defaults", "penalty-early-stop"])
def test_beam4_ids_identical_scores_close(setup, extra):
    variables, model, enc, enc_mask, prompt = setup
    jcfg, tcfg = _cfgs(4, **extra)
    want_seq, want_scores = jax_beam_search(
        variables, jax_config(), jcfg, jnp.asarray(enc), jnp.asarray(enc_mask),
        jnp.asarray(prompt), jnp.ones_like(prompt))
    got_seq, got_scores = beam_search(model, tcfg, t(enc), t(enc_mask), t(prompt),
                                      torch.ones(B, 1))
    np.testing.assert_array_equal(got_seq.numpy(), np.asarray(want_seq))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores), rtol=1e-5, atol=1e-5)


def test_top_k_breaks_ties_like_jax():
    """Equal values come out lower index first, as jax.lax.top_k orders them —
    NEG-filled finished slots tie exactly in beam search."""
    x = np.array([[-1e9, 0.5, -1e9, 0.5, 0.25, -1e9, 0.5, -1e9],
                  [-1e9, -1e9, -1e9, -1e9, -1e9, -1e9, -1e9, -1e9],
                  [3.0, 1.0, 3.0, 1.0, 3.0, 2.0, 2.0, 1.0]], np.float32)
    for k in (1, 3, 4, 8):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = top_k(t(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
