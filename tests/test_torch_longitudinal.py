"""The longitudinal (prompted, LoRA) and single-image paths of the port against
the JAX package, fp32 on the CPU, tiny model (hidden 32, 2 layers, LoRA r=8
with a randomised ``lora_b``, 64-px images), inputs from numpy seeds.

Tolerance 1e-5 on activations and logits (fp32, the harness's ``TOL``); token
ids, prompt helpers, exported state dicts and report strings are compared
exactly.
"""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxrmate_tpu.generate import GenerationConfig as JGen
from cxrmate_tpu.generate import generate as jax_generate
from cxrmate_tpu.generate.beam import beam_search as jax_beam_search
from cxrmate_tpu.models import bert as jb
from cxrmate_tpu.models import encoder_decoder as jed
from cxrmate_tpu.models.api import CXRMate as JaxCXRMate
from cxrmate_tpu.ops.layers import lora_linear as jax_lora_linear
from cxrmate_tpu.tokenizer import ByteLevelBPETokenizer as JaxTokenizer
from cxrmate_torch.ckpt.hf import (
    head_is_tied,
    model_state_dict,
    save_hf_pretrained_dir,
    state_dict_from_jax,
)
from cxrmate_torch.generate.beam import beam_search
from cxrmate_torch.generate.decode import GenerationConfig, generate
from cxrmate_torch.models import bert as tb
from cxrmate_torch.models import encoder_decoder as ted
from cxrmate_torch.models.api import CXRMate
from cxrmate_torch.ops.layers import lora_linear
from cxrmate_torch.tokenizer import ByteLevelBPETokenizer
from tests.test_torch_harness import (
    BOS,
    EOS,
    PAD,
    REPO,
    SEP,
    TOL,
    VOCAB,
    hf_state_dict,
    jax_config,
    jax_variables,
    pixels,
    t,
    torch_config,
    torch_model,
)

LONG = "longitudinal"
PMT_SEP = 6  # a stand-in id for [PMT-SEP] in the 97-token vocabulary
TOKENIZER = os.path.join(REPO, "artifacts", "tokenizer", "bpe_prompt", "tokenizer.json")
B, S = 3, 32


# ------------------------------------------------------------ LoRA, weights
@pytest.mark.parametrize("with_lora", [True, False])
def test_lora_linear_matches_jax(with_lora):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 32).astype(np.float32)
    p = {"w": rs.randn(32, 24).astype(np.float32), "b": rs.randn(24).astype(np.float32)}
    if with_lora:
        p["lora_a"] = rs.randn(32, 8).astype(np.float32)
        p["lora_b"] = rs.randn(8, 24).astype(np.float32)
    want = jax_lora_linear(p, jnp.asarray(x), 4.0)
    got = lora_linear(t(x), t(p["w"].T), t(p["b"]),
                      t(p["lora_a"].T) if with_lora else None,
                      t(p["lora_b"].T) if with_lora else None, 4.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_state_dict_from_jax_with_lora_matches_export():
    """Key for key and value for value, PEFT names and prefix included; the
    port's modules hold exactly those tensors and give them back."""
    cfg = jax_config(variant=LONG)
    want = hf_state_dict(variant=LONG)
    got = state_dict_from_jax(jax_variables(variant=LONG), cfg.encoder, cfg.decoder)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    q = "decoder.base_model.model.bert.encoder.layer.0.attention.self.query"
    assert {f"{q}.base_layer.weight", f"{q}.lora_A.default.weight",
            f"{q}.lora_B.default.weight"} <= set(want)
    assert np.abs(want[f"{q}.lora_B.default.weight"]).max() > 0  # LoRA is not inert
    assert head_is_tied(want)
    back = model_state_dict(torch_model(variant=LONG))
    dropped = {k for k in want if k.endswith("cls.predictions.decoder.weight")
               or k.endswith("cls.predictions.decoder.bias")}
    assert set(back) == set(want) - dropped
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


# ------------------------------------------------------- LoRA decoder logits
@pytest.fixture(scope="module")
def dec():
    rs = np.random.RandomState(31)
    enc = rs.randn(2, S, 32).astype(np.float32)
    enc_mask = np.ones((2, S), np.int32)
    enc_mask[1, S // 2:] = 0
    return {"params": jax_variables(variant=LONG)["params"]["decoder"],
            "model": torch_model(variant=LONG).decoder, "enc": enc, "enc_mask": enc_mask,
            "ids": rs.randint(5, VOCAB, (2, 7)).astype(np.int32),
            "types": rs.randint(0, 2, (2, 7)).astype(np.int32)}


def test_lora_teacher_forced_logits(dec):
    cfg = jax_config(variant=LONG)
    mask = np.ones((2, 7), np.int32)
    mask[1, :2] = 0
    want = jax.jit(lambda p, *a: jb.bert_forward(p, cfg.decoder, *a, lora=cfg.lora))(
        dec["params"], dec["ids"], mask, dec["types"], None, dec["enc"], dec["enc_mask"])
    got = tb.bert_forward(dec["model"], t(dec["ids"]), t(mask), t(dec["types"]), None,
                          t(dec["enc"]), t(dec["enc_mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and LoRA moves the logits: the same call without it differs
    base = jax.jit(lambda p, *a: jb.bert_forward(p, cfg.decoder, *a))(
        dec["params"], dec["ids"], mask, dec["types"], None, dec["enc"], dec["enc_mask"])
    assert np.abs(np.asarray(base) - np.asarray(want)).max() > 1e-4  # 10x the tolerance


@pytest.mark.parametrize("spec", ["", "vpu-rowgroup:2", "cross-rowgroup-q8:2"])
def test_lora_prefill_and_steps(dec, spec):
    """Prefill logits, then four steps with a padded prompt's key mask and
    cumulative positions, per routing spec (the JAX side runs its Pallas
    kernels in interpret mode; ``""`` is its plain attention). The q8 spec is
    held to 1e-4: both sides quantise the same cache, and its sums run in
    another order."""
    cfg = jax_config(variant=LONG)
    p_len, steps = 3, 4
    t_len = p_len + steps
    ids, types = dec["ids"][:, :p_len], dec["types"][:, :p_len]
    attn = np.array([[1, 1, 1], [0, 1, 1]], np.int32)
    pos = np.maximum(np.cumsum(attn, 1) - 1, 0).astype(np.int32)
    jcache = jb.init_cache(cfg.decoder, 2, t_len, S)
    want, jcache = jax.jit(lambda p, c, *a: jb.bert_prefill(p, cfg.decoder, c, *a, lora=cfg.lora))(
        dec["params"], jcache, ids, attn, types, pos, dec["enc"], dec["enc_mask"])
    tcache = tb.init_cache(dec["model"].config, 2, t_len, S)
    got, tcache = tb.bert_prefill(dec["model"], tcache, t(ids), t(attn), t(types), t(pos),
                                  t(dec["enc"]), t(dec["enc_mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jcache, jq8 = jb.maybe_quantize_cross_cache(jcache, spec)
    tcache, tq8 = tb.maybe_quantize_cross_cache(tcache, spec)
    if tq8 is not None:
        assert tcache.cross_k[0].shape == (2, 4, 0, 8)  # the fp cross tensors are freed
        # the two fp caches agree to 1e-5, so a value may round to the next int8
        for a, b in zip(tq8[0], jq8[0]):
            np.testing.assert_allclose(a.numpy().astype(np.float32),
                                       np.asarray(b).astype(np.float32), rtol=1e-5, atol=1)
    step = jax.jit(lambda p, c, q8, *a: jb.bert_step(
        p, cfg.decoder, c, *a, lora=cfg.lora, decode_kernel=spec, cross_q8=q8))
    tol = dict(rtol=1e-4, atol=1e-4) if tq8 is not None else TOL
    rs = np.random.RandomState(32)
    key_mask = np.zeros((2, t_len), np.int32)
    key_mask[:, :p_len] = attn
    for n in range(steps):
        idx = p_len + n
        key_mask[:, idx] = 1
        tok = rs.randint(5, VOCAB, 2).astype(np.int32)
        ttype = rs.randint(0, 2, 2).astype(np.int32)
        spos = (key_mask.sum(1) - 1).astype(np.int32)
        want, jcache = step(dec["params"], jcache, jq8, tok, ttype, spos, jnp.int32(idx),
                            key_mask, dec["enc_mask"])
        got, tcache = tb.bert_step(dec["model"], tcache, t(tok), t(ttype), t(spos), idx,
                                   t(key_mask), t(dec["enc_mask"]), decode_kernel=spec,
                                   cross_q8=tq8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_step_rejects_unpaired_q8(dec):
    cache = tb.init_cache(dec["model"].config, 2, 4, S)
    args = (t(dec["ids"][:, 0]), t(dec["types"][:, 0]), torch.zeros(2, dtype=torch.long), 0,
            torch.ones(2, 4, dtype=torch.int32), t(dec["enc_mask"]))
    with pytest.raises(ValueError, match="cross_q8"):
        tb.bert_step(dec["model"], cache, *args, decode_kernel="cross-rowgroup-q8")
    with pytest.raises(ValueError, match="cross_q8"):
        tb.bert_step(dec["model"], cache, *args, decode_kernel="", cross_q8=[])
    with pytest.raises(ValueError, match="invalid CXRMATE_DECODE_KERNEL"):
        tb.bert_step(dec["model"], cache, *args, decode_kernel="rowgroup-q8")


# ------------------------------------------------------------ prompt helpers
PREV_F = ["The heart size is normal. No focal consolidation, pleural effusion or pneumothorax.",
          None, "Lungs are clear.", ""]
PREV_I = ["No acute cardiopulmonary process.", None, None,
          "Stable mild cardiomegaly; interval increase in the right pleural effusion."]


@pytest.mark.parametrize("max_len,add_bos", [(256, True), (256, False), (12, True), (12, False)])
def test_prompt_helpers_equal_jax(max_len, add_bos):
    """tokenize_prompt (max_len 12 truncates rows 0 and 3 and forces BOS into
    their last slot, with and without add_bos_token_id), bucket_prompt and
    tokenize_report_teacher_forcing, exactly."""
    jt, tt = JaxTokenizer.from_file(TOKENIZER), ByteLevelBPETokenizer.from_file(TOKENIZER)
    want = jed.tokenize_prompt(PREV_F, PREV_I, jt, max_len, add_bos)
    got = ted.tokenize_prompt(PREV_F, PREV_I, tt, max_len, add_bos)
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    if max_len == 12:
        assert got["input_ids"].shape[1] == 12
        assert (got["input_ids"][[0, 3], -1] == tt.bos_token_id).all()
    npf = tt.vocab["[NPF]"]
    assert got["input_ids"][1, 1] == npf
    for bucket, cap in ((32, 256), (8, 12), (5, None)):
        want_b = jed.bucket_prompt(want["input_ids"], want["attention_mask"], jt.pad_token_id,
                                   bucket, cap)
        got_b = ted.bucket_prompt(got["input_ids"], got["attention_mask"], tt.pad_token_id,
                                  bucket, cap)
        for a, b in zip(got_b, want_b):
            np.testing.assert_array_equal(a, b)
    f = [x or "" for x in PREV_F]
    i = [x or "" for x in PREV_I]
    want_tf = jed.tokenize_report_teacher_forcing(f, i, jt, max_len)
    got_tf = ted.tokenize_report_teacher_forcing(f, i, tt, max_len)
    assert set(got_tf) == set(want_tf)
    for k in want_tf:
        np.testing.assert_array_equal(got_tf[k], want_tf[k])


def test_position_and_type_helpers_equal_jax():
    rs = np.random.RandomState(33)
    mask = (rs.rand(4, 9) > 0.3).astype(np.int32)
    mask[0] = 0
    np.testing.assert_array_equal(ted.cumulative_position_ids(t(mask)).numpy(),
                                  np.asarray(jed.cumulative_position_ids(jnp.asarray(mask))))
    ids = rs.randint(0, 8, (6, 9)).astype(np.int32)
    for specials, sections in (((PMT_SEP, BOS, SEP), (0, 1, 0, 1)), ((SEP,), None),
                               ((SEP, EOS), (2, 0, 1))):
        want = jed.token_ids_to_token_type_ids_past(jnp.asarray(ids), specials, sections)
        got = ted.token_ids_to_token_type_ids_past(t(ids), specials, sections)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        want = jed.token_ids_to_token_type_ids(jnp.asarray(ids), specials, sections)
        got = ted.token_ids_to_token_type_ids(t(ids), specials, sections)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------- decoding with padded prompts
def _prompts():
    """Ragged prompts [PMT .. PMT-SEP .. BOS] of true widths 9, 5 and 7,
    right-padded with PAD to the 16-wide bucket."""
    rs = np.random.RandomState(34)
    ids = np.full((B, 16), PAD, np.int32)
    for r, n in enumerate((9, 5, 7)):
        row = rs.randint(7, VOCAB, n).astype(np.int32)
        row[n // 2] = PMT_SEP
        row[-1] = BOS
        ids[r, :n] = row
    return ids, (ids != PAD).astype(np.int32), 9


@functools.lru_cache(maxsize=None)
def _decode_setup(boost):
    import copy

    variables = copy.deepcopy(jax_variables(variant=LONG))
    variables["params"]["decoder"]["lm_head"]["decoder"]["b"][EOS] += boost
    model = torch_model(variant=LONG)
    with torch.no_grad():
        model.decoder.cls.predictions.bias[EOS] += boost
    rs = np.random.RandomState(35)
    enc = (rs.randn(B, S, 32) * 30).astype(np.float32)  # large: the studies decode differently
    enc_mask = np.ones((B, S), np.int32)
    enc_mask[2, S // 2:] = 0
    return variables, model, enc, enc_mask


def _cfgs(beams, max_new=10):
    kw = dict(max_new_tokens=max_new, bos_token_id=BOS, eos_token_id=EOS, pad_token_id=PAD,
              mask_token_id=PAD, special_token_ids=(PMT_SEP, BOS, SEP),
              token_type_sections=(0, 1, 0, 1), num_beams=beams)
    return JGen(**kw), GenerationConfig(**kw)


@pytest.mark.parametrize("boost", [0.0, 0.6], ids=["plain", "eos-boost"])
@pytest.mark.parametrize("beams", [1, 4])
def test_longitudinal_ids_identical(beams, boost):
    """Greedy and beam-4 token ids equal JAX's with ragged, bucket-padded
    prompts and prompt_logits_col; with the EOS boost rows finish early, so
    post-EOS pads are masked keys."""
    variables, model, enc, enc_mask = _decode_setup(boost)
    ids, mask, true_w = _prompts()
    jcfg, tcfg = _cfgs(beams)
    jargs = (variables, jax_config(variant=LONG), jcfg, jnp.asarray(enc), jnp.asarray(enc_mask),
             jnp.asarray(ids), jnp.asarray(mask))
    targs = (model, tcfg, t(enc), t(enc_mask), t(ids), t(mask))
    if beams == 1:
        want = jax_generate(*jargs, prompt_logits_col=true_w - 1)
        got = generate(*targs, prompt_logits_col=true_w - 1)
    else:
        want, want_scores = jax_beam_search(*jargs, prompt_logits_col=true_w - 1)
        got, got_scores = beam_search(*targs, prompt_logits_col=true_w - 1)
        np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if boost:
        assert (got.numpy()[:, 16:] == EOS).any()


def test_bucket_padding_changes_nothing():
    """The port's own check of what prompt_logits_col is for: the 16-wide
    bucket gives the tokens of the 9-wide batch."""
    _, model, enc, enc_mask = _decode_setup(0.0)
    ids, mask, true_w = _prompts()
    _, tcfg = _cfgs(1)
    padded = generate(model, tcfg, t(enc), t(enc_mask), t(ids), t(mask),
                      prompt_logits_col=true_w - 1)
    tight = generate(model, tcfg, t(enc), t(enc_mask), t(ids[:, :true_w]), t(mask[:, :true_w]))
    np.testing.assert_array_equal(padded.numpy()[:, 16:], tight.numpy()[:, true_w:])


@pytest.mark.parametrize("spec", ["cross-rowgroup-q8:2", "vpu-rowgroup:2", "cross-vpu-rowgroup"])
def test_greedy_ids_identical_under_kernel_spec(spec):
    """Greedy ids under a routing spec equal the JAX package's under the same
    spec (its Pallas kernels in interpret mode), q8's quantised cache
    included."""
    variables, model, enc, enc_mask = _decode_setup(0.0)
    ids, mask, true_w = _prompts()
    jcfg, tcfg = _cfgs(1, max_new=6)
    want = jax_generate(variables, jax_config(variant=LONG), jcfg, jnp.asarray(enc),
                        jnp.asarray(enc_mask), jnp.asarray(ids), jnp.asarray(mask),
                        prompt_logits_col=true_w - 1, decode_kernel=spec)
    got = generate(model, tcfg, t(enc), t(enc_mask), t(ids), t(mask),
                   prompt_logits_col=true_w - 1, decode_kernel=spec)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_beam4_ids_identical_under_q8_spec(monkeypatch):
    """Beam-4 with the spec read from the environment at call time."""
    variables, model, enc, enc_mask = _decode_setup(0.0)
    ids, mask, true_w = _prompts()
    jcfg, tcfg = _cfgs(4, max_new=6)
    monkeypatch.setenv("CXRMATE_DECODE_KERNEL", "cross-rowgroup-q8:2")
    want, _ = jax_beam_search(variables, jax_config(variant=LONG), jcfg, jnp.asarray(enc),
                              jnp.asarray(enc_mask), jnp.asarray(ids), jnp.asarray(mask),
                              prompt_logits_col=true_w - 1)
    got, _ = beam_search(model, tcfg, t(enc), t(enc_mask), t(ids), t(mask),
                         prompt_logits_col=true_w - 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------- the API
def _hub_dir(tmp_path_factory, variant):
    """The tiny model of ``variant`` with the repository tokenizer's
    vocabulary (word embeddings and LM bias extended with numpy), as an HF
    directory; the longitudinal one carries PEFT key names."""
    vocab = len(ByteLevelBPETokenizer.from_file(TOKENIZER))
    sd = dict(hf_state_dict(variant=variant))
    dp = "decoder.base_model.model." if variant == LONG else "decoder."
    rs = np.random.RandomState(36)
    word = sd[f"{dp}bert.embeddings.word_embeddings.weight"]
    extra = (rs.randn(vocab - word.shape[0], word.shape[1]) * 0.02).astype(np.float32)
    word = np.concatenate([word, extra])
    sd[f"{dp}bert.embeddings.word_embeddings.weight"] = word
    sd[f"{dp}cls.predictions.decoder.weight"] = word
    bias = np.concatenate([sd[f"{dp}cls.predictions.bias"],
                           rs.normal(0, 0.05, len(extra)).astype(np.float32)])
    sd[f"{dp}cls.predictions.bias"] = sd[f"{dp}cls.predictions.decoder.bias"] = bias
    path = str(tmp_path_factory.mktemp("hub") / f"cxrmate-{variant}")
    save_hf_pretrained_dir(path, {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                           torch_config(vocab, variant))
    shutil.copy(TOKENIZER, os.path.join(path, "tokenizer.json"))
    return path


@pytest.fixture(scope="module", params=[LONG, "single"])
def models(request, tmp_path_factory):
    path = _hub_dir(tmp_path_factory, request.param)
    return (request.param, JaxCXRMate.from_hf_checkpoint(path, variant=request.param),
            CXRMate.from_hf_checkpoint(path, variant=request.param, device="cpu"))


@pytest.mark.parametrize("beams", [1, 4])
def test_generate_report_strings_identical(models, beams):
    variant, jax_model, model = models
    assert (model.config.lora is not None) == (variant == LONG)
    if variant == LONG:
        assert model.config.lora.scaling == jax_model.config.lora.scaling
    px = pixels(37, studies=4, slots=2)
    if variant == "single":
        px = px[:, 0]
        kw = {}
    else:
        kw = dict(previous_findings=PREV_F, previous_impression=PREV_I)
    want = jax_model.generate_report(px, num_beams=beams, max_new_tokens=10, **kw)
    got = model.generate_report(px, num_beams=beams, max_new_tokens=10, **kw)
    assert got == want
    assert len(got[0]) == len(got[1]) == 4


def test_lora_rank_comes_from_the_checkpoint(tmp_path_factory):
    """A checkpoint whose LoRA factors have rank 4 (the tiny model's, cut in
    half) loads with rank 4 and the preset's scaling, and gives the JAX
    package's teacher-forced logits (1e-5)."""
    path = _hub_dir(tmp_path_factory, LONG)
    sd = torch.load(os.path.join(path, "pytorch_model.bin"))
    for k in list(sd):
        if ".lora_A." in k:
            sd[k] = sd[k][:4].clone()
        elif ".lora_B." in k:
            sd[k] = sd[k][:, :4].clone()
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    jax_model = JaxCXRMate.from_hf_checkpoint(path, variant=LONG)
    model = CXRMate.from_hf_checkpoint(path, variant=LONG, device="cpu")
    assert model.config.lora.r == 4
    assert model.config.lora.scaling == jax_model.config.lora.scaling == 4.0
    rs = np.random.RandomState(38)
    ids = rs.randint(5, 4000, (2, 6)).astype(np.int32)
    enc = rs.randn(2, S, 32).astype(np.float32)
    want = jb.bert_forward(jax_model.variables["params"]["decoder"], jax_model.config.decoder,
                           ids, encoder_hidden_states=enc,
                           encoder_attention_mask=np.ones((2, S), np.int32),
                           lora=jax_model.config.lora)
    got = tb.bert_forward(model.model.decoder, t(ids), encoder_hidden_states=t(enc),
                          encoder_attention_mask=torch.ones(2, S, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_api_helpers_and_random_init(models):
    variant, jax_model, model = models
    want = jax_model.tokenize_prompt(PREV_F, PREV_I, add_bos_token_id=True)
    got = model.tokenize_prompt(PREV_F, PREV_I, add_bos_token_id=True)
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    tf = model.tokenize_report_teacher_forcing(["a b"], ["c"])
    assert tf["decoder_input_ids"][0, 0] == model.tokenizer.bos_token_id
    tok = model.tokenizer
    rows = np.array([[tok.bos_token_id, 300, 301, tok.sep_token_id, 302, tok.eos_token_id]])
    assert model.split_and_decode_sections(rows, [tok.sep_token_id, tok.eos_token_id]) == \
        jax_model.split_and_decode_sections(rows, [tok.sep_token_id, tok.eos_token_id])
    fresh = CXRMate.random_init(tok, variant=variant, device="cpu",
                                config=torch_config(len(tok), variant))
    assert fresh.config.variant == variant
    names = [n for n, _ in fresh.model.named_parameters()]
    assert any(".lora_A." in n for n in names) == (variant == LONG)
    if variant == LONG:
        with pytest.raises(ValueError, match="previous_findings"):
            model.generate_report(pixels(37, studies=1, slots=2), num_beams=1, max_new_tokens=2)
