"""BERT decoder of the port against the JAX package, fp32 on the CPU:
teacher-forced logits, prefill logits and cache, and a sequence of decode
steps with a written cache, a deferred cache write, and beams folded over a
shared cross cache (cross batch = B / 4)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxrmate_tpu.models import bert as jb
from cxrmate_torch.models import bert as tb
from tests.test_torch_harness import TOL, VOCAB, jax_config, jax_variables, t, torch_model

B, S, P, STEPS = 2, 32, 3, 4
T_LEN = P + STEPS


@pytest.fixture(scope="module")
def setup():
    rs = np.random.RandomState(11)
    enc = rs.randn(B, S, 32).astype(np.float32)
    enc_mask = np.ones((B, S), np.int32)
    enc_mask[1, S // 2:] = 0  # the second study's second image slot is padding
    return {
        "params": jax_variables()["params"]["decoder"],
        "model": torch_model().decoder,
        "enc": enc, "enc_mask": enc_mask,
        "ids": rs.randint(5, VOCAB, (B, 7)).astype(np.int32),
        "types": rs.randint(0, 2, (B, 7)).astype(np.int32),
    }


def test_teacher_forced_logits(setup):
    s = setup
    mask = np.ones((B, 7), np.int32)
    mask[1, 5:] = 0
    want = jax.jit(lambda p, *a: jb.bert_forward(p, jax_config().decoder, *a))(
        s["params"], s["ids"], mask, s["types"], None, s["enc"], s["enc_mask"])
    got = tb.bert_forward(s["model"], t(s["ids"]), t(mask), t(s["types"]), None,
                          t(s["enc"]), t(s["enc_mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@functools.lru_cache(maxsize=None)
def _jax_prefill_fn():
    dcfg = jax_config().decoder
    return jax.jit(lambda p, c, *a: jb.bert_prefill(p, dcfg, c, *a))


def _jax_prefill(params, ids, types, enc, enc_mask):
    cache = jb.init_cache(jax_config().decoder, ids.shape[0], T_LEN, enc.shape[1])
    pos = jnp.broadcast_to(jnp.arange(P), (ids.shape[0], P))
    return _jax_prefill_fn()(params, cache, ids, jnp.ones_like(ids), types, pos, enc, enc_mask)


def _torch_prefill(model, ids, types, enc, enc_mask):
    cache = tb.init_cache(model.config, ids.shape[0], T_LEN, enc.shape[1])
    pos = torch.arange(P).expand(ids.shape[0], P)
    return tb.bert_prefill(model, cache, t(ids), torch.ones(ids.shape, dtype=torch.int32),
                           t(types), pos, t(enc), t(enc_mask))


def test_prefill_logits_and_cache(setup):
    s = setup
    ids, types = s["ids"][:, :P], s["types"][:, :P]
    want_logits, want_cache = _jax_prefill(s["params"], ids, types, s["enc"], s["enc_mask"])
    got_logits, got_cache = _torch_prefill(s["model"], ids, types, s["enc"], s["enc_mask"])
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), **TOL)
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        for got, want in zip(getattr(got_cache, name), getattr(want_cache, name)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@functools.lru_cache(maxsize=None)
def _jax_step(deferred):
    dcfg = jax_config().decoder
    return jax.jit(lambda p, c, *a: jb.bert_step(p, dcfg, c, *a, deferred_write=deferred,
                                                  decode_kernel=""))


@pytest.mark.parametrize("deferred,beams", [(False, 1), (True, 1), (True, 4)],
                         ids=["written", "deferred", "beams-folded"])
def test_step_sequence(setup, deferred, beams):
    s = setup
    rows = B * beams
    rs = np.random.RandomState(12 + beams)
    ids, types = s["ids"][:, :P], s["types"][:, :P]
    _, jcache = _jax_prefill(s["params"], ids, types, s["enc"], s["enc_mask"])
    _, tcache = _torch_prefill(s["model"], ids, types, s["enc"], s["enc_mask"])
    if beams > 1:  # tile the self cache over the beams; the cross cache stays per study
        jcache = jb.DecodeCache(tuple(jnp.repeat(x, beams, 0) for x in jcache.self_k),
                                tuple(jnp.repeat(x, beams, 0) for x in jcache.self_v),
                                jcache.cross_k, jcache.cross_v)
        tcache.self_k = [x.repeat_interleave(beams, 0) for x in tcache.self_k]
        tcache.self_v = [x.repeat_interleave(beams, 0) for x in tcache.self_v]
    step = _jax_step(deferred)
    for n in range(STEPS):
        idx = P + n
        tok = rs.randint(5, VOCAB, rows).astype(np.int32)
        ttype = rs.randint(0, 2, rows).astype(np.int32)
        pos = np.full(rows, idx, np.int32)
        key_mask = np.broadcast_to(np.arange(T_LEN) <= idx, (rows, T_LEN)).astype(np.int32)
        want, jout = step(s["params"], jcache, tok, ttype, pos, jnp.int32(idx), key_mask,
                          s["enc_mask"])
        got, tout = tb.bert_step(s["model"], tcache, t(tok), t(ttype), t(pos), idx,
                                 t(key_mask), t(s["enc_mask"]), deferred_write=deferred)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        if deferred:  # the caller writes the returned column
            for i in range(len(tcache.self_k)):
                np.testing.assert_allclose(tout[0][i].numpy(), np.asarray(jout[0][i]), **TOL)
                tcache.self_k[i][:, :, idx] = tout[0][i]
                tcache.self_v[i][:, :, idx] = tout[1][i]
            jcache = jb.DecodeCache(
                tuple(c.at[:, :, idx].set(k) for c, k in zip(jcache.self_k, jout[0])),
                tuple(c.at[:, :, idx].set(v) for c, v in zip(jcache.self_v, jout[1])),
                jcache.cross_k, jcache.cross_v)
        else:
            jcache = jout
    for got, want in zip(tcache.self_k + tcache.self_v, jcache.self_k + jcache.self_v):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_untied_lm_head(setup):
    """A checkpoint whose LM projection differs from the word embeddings
    loads into an untied head (``cls.predictions.decoder``) and gives JAX's
    logits (``bert_lm_head`` with ``decoder.w``)."""
    import dataclasses

    from cxrmate_tpu.ckpt.hf_convert import export_encoder_decoder
    from cxrmate_torch.ckpt.hf import head_is_tied, load_model_state
    from cxrmate_torch.models.encoder_decoder import EncoderDecoder
    from tests.test_torch_harness import torch_config

    rs = np.random.RandomState(13)
    variables = jax.tree_util.tree_map(np.array, jax_variables())
    variables["params"]["decoder"]["lm_head"]["decoder"]["w"] = (
        rs.randn(32, VOCAB) * 0.02).astype(np.float32)
    cfg = jax_config()
    sd = export_encoder_decoder(variables, cfg.encoder, cfg.decoder)
    assert not head_is_tied(sd)
    tcfg = torch_config()
    tcfg = dataclasses.replace(tcfg, decoder=dataclasses.replace(tcfg.decoder,
                                                                 tie_word_embeddings=False))
    model = EncoderDecoder(tcfg, device="cpu")
    load_model_state(model, sd)
    hidden = rs.randn(B, 5, 32).astype(np.float32)
    want = jax.jit(jb.bert_lm_head)(variables["params"]["decoder"], hidden)
    got = tb.bert_lm_head(model.decoder, t(hidden))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
