"""SCST in the port against the JAX package, fp32 on the CPU, on the harness's
longitudinal tiny model (BERT 32 wide, 2 layers, LoRA r=8 on q/k with a
randomised ``lora_b``), inputs from numpy seeds; and on a card the rollout's
kernels against their plain versions.

The JAX references run once per module: one jitted ``scst_rollout_decode``
and one jitted ``grad_step`` of ``make_scst_step`` (one value_and_grad and
its AdamW update; its optimizer records the gradients in its state). Both
take encoder states made by numpy, not the CvT encoder.

Tolerances (fp32):
  * token ids equal: the rollout's greedy half against JAX's baseline, its
    sample half against the port's ``generate(do_sample=True)`` with the same
    generator seed (torch's draws are not JAX's, so the JAX sample half is
    not compared);
  * ``reinforce_loss`` within 1e-6;
  * the grad step: loss rtol 1e-5, gradients within 1e-5 of each tensor's
    largest with a floor of 1e-9, updated parameters as in
    ``tests/test_torch_train.py`` (within 1e-6, or 2 lr where |g| < 1e-6),
    the encoder bit-unchanged;
  * prompt bucketing: the loss within rtol 1e-6 and the gradients within
    1e-6 of each tensor's largest.

This file imports neither JAX nor the shared harness at module level, so that
the CUDA test runs on the card's machine as it is:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_scst.py -m cuda
"""

import functools
import types

import numpy as np
import pytest
import torch

from cxrmate_torch.generate import decode as tdec
from cxrmate_torch.generate.decode import GenerationConfig
from cxrmate_torch.models import encoder_decoder as ted
from cxrmate_torch.train import optim
from cxrmate_torch.train import scst as tscst
from cxrmate_torch.train import tf_trainer as tt

torch.set_num_threads(2)  # the full suite runs six xdist workers on eight cores
LONG = "longitudinal"
BOS, EOS, SEP, PAD = 1, 2, 3, 4
PMT, PMT_SEP = 5, 6  # stand-in ids in the harness's 97-token vocabulary
MAX_NEW, S = 10, 32
LR = 1e-3  # as tests/test_torch_train.py, whose tolerances the update is held to
# the SCST configuration (cli/stages.py:867-882): the sample half with the
# specials (BOS, SEP), the baseline with (PMT-SEP, BOS, SEP)
COMMON = dict(max_new_tokens=MAX_NEW, bos_token_id=BOS, eos_token_id=EOS, pad_token_id=PAD,
              mask_token_id=PAD, token_type_sections=(0, 1, 0, 1))
SAMPLE = dict(COMMON, special_token_ids=(BOS, SEP), do_sample=True, top_k=50, top_p=1.0)
BASE = dict(COMMON, special_token_ids=(PMT_SEP, BOS, SEP))


def prompts():
    """Two previous-report prompts of true width 6, the first ending in a
    mask-token pad, then bucket-padded to 8 -> (prompt [2, 6], bucketed [2, 8],
    first_col 5)."""
    p = np.array([[PMT, 50, PMT_SEP, 52, BOS, PAD],
                  [PMT, 50, 51, PMT_SEP, 53, BOS]], np.int32)
    bucketed, _ = ted.bucket_prompt(p, (p != PAD).astype(np.int32), PAD, bucket=8)
    return p, bucketed, p.shape[1] - 1


def encoder_states(seed: int = 31):
    """[2, S, 32] states, the second study's last half masked."""
    rs = np.random.RandomState(seed)
    mask = np.ones((2, S), np.int32)
    mask[1, S // 2:] = 0
    return rs.randn(2, S, 32).astype(np.float32), mask


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def jax_variables():
    """The harness's longitudinal decoder in JAX (``init_bert_params``, then
    the harness's ``randomise``) under an empty encoder: the parity tests feed
    encoder states, so no CvT is initialised."""
    import jax

    from cxrmate_tpu.models.bert import init_bert_params
    from tests.test_torch_harness import jax_config, randomise

    cfg = jax_config(variant=LONG)
    dec = init_bert_params(jax.random.PRNGKey(1), cfg.decoder, lora=cfg.lora)
    return randomise({"params": {"encoder": {}, "decoder": dec}, "batch_stats": {}}, 2)


def hf_decoder(tree) -> dict:
    """A JAX decoder-only pytree -> its HF-layout state dict (PEFT names)."""
    from cxrmate_torch.ckpt.hf import state_dict_from_jax

    return state_dict_from_jax(tree, None, None)


def torch_model(jax_decoder: bool = True):
    """The port's longitudinal tiny model (the harness's config) on the CPU:
    its encoder seeded random, its decoder JAX's (or, without
    ``jax_decoder``, seeded random with a random lora_B)."""
    from cxrmate_torch.ckpt.hf import load_model_state
    from cxrmate_torch.models.api import CXRMate
    from tests.test_torch_harness import torch_config

    model = CXRMate.random_init(None, LONG, seed=0, device="cpu",
                                config=torch_config(variant=LONG)).model
    if jax_decoder:
        encoder = {k: v for k, v in model.state_dict().items() if k.startswith("encoder.")}
        load_model_state(model, {**encoder, **hf_decoder(jax_variables())})
    else:
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if ".lora_B." in name:
                    p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return model


def port_steps(model, mask=None, dtype=None):
    """(rollout, grad_step, tx) of the port for ``model``; ``tx.grads`` keeps
    the last gradients ``tx.update`` was given."""
    mask = mask or optim.mask_for_stage(dict(model.named_parameters()), "scst")
    tx = optim.adamw(LR, trainable_mask=mask)
    update = tx.update

    def recording(grads, *a):
        tx.grads = {k: v.clone() for k, v in grads.items()}
        return update(grads, *a)

    tx.update = recording
    rollout, grad_step = tscst.make_scst_step(
        model.config, GenerationConfig(**SAMPLE), GenerationConfig(**BASE), tx, mask,
        pad_id=PAD, compute_dtype=dtype, decode_kernel="")
    return rollout, grad_step, tx


# ------------------------------------------------------------------ the loss
def test_reinforce_loss_equals_jax():
    import jax.numpy as jnp

    from cxrmate_tpu.train.scst import reinforce_loss

    rs = np.random.RandomState(0)
    logits = (rs.randn(3, 7, 13) * 4).astype(np.float32)
    ids = rs.randint(0, 13, (3, 7))
    ids[0, 4:] = PAD
    ids[2, :] = PAD
    reward = np.array([0.3, -0.2, 0.9], np.float32)
    want = float(reinforce_loss(jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(reward), PAD))
    got = float(tscst.reinforce_loss(t(logits), t(ids), t(reward), PAD))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)


# --------------------------------------------------------------- the rollout
@pytest.fixture(scope="module")
def rollout_case():
    """The port's rollout and JAX's, on the same encoder states and bucketed
    prompts, the first token read at the true longest column."""
    import jax

    from cxrmate_tpu.generate import GenerationConfig as JGen
    from cxrmate_tpu.generate.decode import scst_rollout_decode
    from tests.test_torch_harness import jax_config

    enc, enc_mask = encoder_states()
    _, prompt, col = prompts()
    j_sampled, j_base = scst_rollout_decode(
        jax_variables(), jax_config(variant=LONG), JGen(**SAMPLE), JGen(**BASE),
        enc, enc_mask, prompt, (prompt != PAD).astype(np.int32), jax.random.PRNGKey(3),
        prompt_logits_col=col)
    model = torch_model()
    args = (model, GenerationConfig(**SAMPLE), GenerationConfig(**BASE), t(enc), t(enc_mask),
            t(prompt), None)
    sampled, base = tdec.scst_rollout_decode(*args, torch.Generator().manual_seed(5),
                                             prompt_logits_col=col)
    return types.SimpleNamespace(model=model, enc=enc, enc_mask=enc_mask, prompt=prompt, col=col,
                                 j_base=np.asarray(j_base), j_sampled=np.asarray(j_sampled),
                                 sampled=sampled, base=base, args=args)


def test_rollout_greedy_half_equals_jax(rollout_case):
    c = rollout_case
    assert c.base.shape == c.sampled.shape == (2, c.prompt.shape[1] + MAX_NEW)
    np.testing.assert_array_equal(c.base.numpy(), c.j_base)
    np.testing.assert_array_equal(c.sampled[:, :8].numpy(), c.j_sampled[:, :8])  # the prompt


def test_rollout_halves_equal_generate(rollout_case):
    """The sample half is generate(do_sample=True) with the same generator
    seed; the greedy half is greedy generate with the baseline's specials."""
    c = rollout_case
    model, _, _, enc, enc_mask, prompt, _ = c.args
    sampled = tdec.generate(model, GenerationConfig(**SAMPLE), enc, enc_mask, prompt, None,
                            torch.Generator().manual_seed(5), prompt_logits_col=c.col)
    base = tdec.generate(model, GenerationConfig(**BASE), enc, enc_mask, prompt, None,
                         prompt_logits_col=c.col)
    assert torch.equal(c.sampled, sampled)
    assert torch.equal(c.base, base)
    assert not torch.equal(c.sampled, c.base)
    again, _ = tdec.scst_rollout_decode(*c.args, torch.Generator().manual_seed(5),
                                        prompt_logits_col=c.col)
    assert torch.equal(again, c.sampled)


def test_rollout_refuses_configs_outside_scst(rollout_case):
    c = rollout_case
    model, _, _, enc, enc_mask, prompt, _ = c.args
    for sample, base in ((dict(SAMPLE, do_sample=False), BASE),
                         (SAMPLE, dict(BASE, mask_token_id=None)),
                         (SAMPLE, dict(BASE, max_new_tokens=MAX_NEW + 1))):
        with pytest.raises(ValueError):
            tdec.scst_rollout_decode(model, GenerationConfig(**sample), GenerationConfig(**base),
                                     enc, enc_mask, prompt, None, torch.Generator())


def test_generate_scores_and_width_pad(rollout_case):
    """return_scores gives each step's logits (greedy) or warped logits
    (sampled), 0 after the loop stopped; max_new_tokens_pad decodes that many
    new tokens (the first MAX_NEW as without it)."""
    c = rollout_case
    model, _, _, enc, enc_mask, prompt, _ = c.args
    base, scores = tdec.generate(model, GenerationConfig(**BASE), enc, enc_mask, prompt, None,
                                 prompt_logits_col=c.col, return_scores=True)
    assert torch.equal(base, c.base) and scores.shape == (2, MAX_NEW, 97)
    assert scores.dtype == torch.float32
    assert torch.equal(scores.argmax(-1), base[:, 8:].long())
    wide = tdec.generate(model, GenerationConfig(**BASE), enc, enc_mask, prompt, None,
                         prompt_logits_col=c.col, max_new_tokens_pad=MAX_NEW + 3)
    assert wide.shape == (2, 8 + MAX_NEW + 3) and torch.equal(wide[:, :8 + MAX_NEW], base)
    sampled, warped = tdec.generate(model, GenerationConfig(**SAMPLE), enc, enc_mask, prompt,
                                    None, torch.Generator().manual_seed(5),
                                    prompt_logits_col=c.col, return_scores=True)
    assert torch.equal(sampled, c.sampled)
    kept = warped > torch.finfo(torch.float32).min
    assert (kept.sum(-1) == 50).all()  # top-50 of 97
    assert kept.gather(-1, sampled[:, 8:, None].long()).all()


# ------------------------------------------------------------- the grad step
def sampled_sequences(c):
    """The port's sampled rollout, with the first row cut short by pads
    after its fifth new token: fixed sequences for the grad step."""
    seq = c.sampled.clone()
    seq[0, 8 + 5:] = PAD
    return seq


ADVANTAGE = np.array([0.35, -0.6], np.float32)


@pytest.fixture(scope="module")
def grad_case(rollout_case):
    """One grad step of JAX's make_scst_step and of the port's on the same
    sampled sequences (prompt bucketed to 8, first_col 5) and advantages."""
    import jax
    import jax.numpy as jnp
    import optax

    from cxrmate_tpu.generate import GenerationConfig as JGen
    from cxrmate_tpu.train import optim as jopt
    from cxrmate_tpu.train.scst import make_scst_step as jax_make_scst_step
    from cxrmate_tpu.train.tf_trainer import create_train_state
    from tests.test_torch_harness import jax_config

    c = rollout_case
    seq = sampled_sequences(c)
    variables, cfg = jax_variables(), jax_config(variant=LONG)
    mask = jopt.mask_for_stage(variables["params"], "scst")
    inner = jopt.adamw(LR, trainable_mask=mask)

    def update(grads, opt_state, params=None):
        updates, inner_state = inner.update(grads, opt_state[0], params)
        return updates, (inner_state, grads)

    # the optimizer keeps the (frozen-zeroed) gradients it was given in its state
    tx = optax.GradientTransformation(
        lambda p: (inner.init(p), jax.tree.map(jnp.zeros_like, p)), update)
    _, jax_grad_step = jax_make_scst_step(cfg, JGen(**SAMPLE), JGen(**BASE), tx,
                                          trainable_mask=mask, pad_id=PAD)
    state, loss = jax_grad_step(create_train_state(variables, tx), jnp.asarray(c.enc),
                                jnp.asarray(c.enc_mask), 8, np.int32(c.col),
                                jnp.asarray(seq.numpy()), jnp.asarray(ADVANTAGE))

    def export(params):
        return hf_decoder({"params": jax.tree.map(np.asarray, params)})

    model = torch_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, grad_step, ptx = port_steps(model)
    pstate = tt.create_train_state(model, ptx)
    pstate, ploss = grad_step(pstate, t(c.enc), t(c.enc_mask), 8, c.col, seq, ADVANTAGE)
    return types.SimpleNamespace(loss=float(loss), grads=export(state.opt_state[1]),
                                 stepped=export(state.params), ploss=float(ploss),
                                 pgrads=ptx.grads, model=model, before=before, state=pstate,
                                 seq=seq)


def test_grad_step_loss_and_gradients_equal_jax(grad_case):
    from tests.test_torch_train import assert_grads_close

    g = grad_case
    assert np.isfinite(g.ploss) and g.ploss != 0.0
    np.testing.assert_allclose(g.ploss, g.loss, rtol=1e-5)
    assert set(g.pgrads) == {n for n, _ in g.model.named_parameters() if n.startswith("decoder.")}
    assert_grads_close(g.pgrads, g.grads)


def test_grad_step_updates_the_decoder_like_jax_and_freezes_the_encoder(grad_case):
    from cxrmate_torch.ckpt.hf import model_state_dict
    from tests.test_torch_train import _hf, assert_stepped_close

    g = grad_case
    after = g.model.state_dict()
    for name, value in after.items():
        if name.startswith("encoder."):  # parameters and BatchNorm statistics
            assert torch.equal(value, g.before[name]), name
    assert g.state.step == 1 and g.state.opt_state.count == 1
    stepped = model_state_dict(g.model)
    for name, grad in g.pgrads.items():
        key = _hf(name, g.stepped)
        assert not torch.equal(after[name], g.before[name]) or not grad.any(), name
        assert_stepped_close(stepped[key].numpy(), g.stepped[key], g.grads[key], name)


def test_prompt_bucketing_leaves_the_step_unchanged(rollout_case, grad_case):
    """The same sampled tokens behind the prompt at its true width 6 and
    bucket-padded to 8 (first_col 5 both times): the same loss and gradients."""
    g = grad_case
    seq6 = torch.cat([g.seq[:, :6], g.seq[:, 8:]], dim=1)
    model = torch_model()
    _, grad_step, tx = port_steps(model)
    _, loss6 = grad_step(tt.create_train_state(model, tx), t(rollout_case.enc),
                         t(rollout_case.enc_mask), 6, 5, seq6, ADVANTAGE)
    np.testing.assert_allclose(float(loss6), g.ploss, rtol=1e-6)
    for name, grad in tx.grads.items():
        atol = 1e-6 * float(g.pgrads[name].abs().max()) + 1e-9  # the floor: see the docstring
        np.testing.assert_allclose(grad.numpy(), g.pgrads[name].numpy(), rtol=0, atol=atol,
                                   err_msg=name)


def test_grad_step_keeps_a_sampled_token_the_rewarp_would_mask(rollout_case):
    """Where the re-forward ranks a sampled token outside the top-k (bf16
    rounding near the boundary; forced here with the step's lowest logit),
    JAX's re-warp masks it (an NLL of ~3.4e38); the port's grad step keeps its
    logit and its loss stays finite: the same loss as the re-warp with that
    one logit put back."""
    from cxrmate_torch.generate.logits_process import NEG, warp_logits

    c = rollout_case
    seq = sampled_sequences(c).long()
    model = torch_model()

    def generated_logits(seq):  # the re-forward's logits of the generated tokens
        attn = (seq != PAD).int()
        types = ted.token_ids_to_token_type_ids(seq, SAMPLE["special_token_ids"], (0, 1, 0, 1))
        logits, _ = ted.forward(model, None, seq, decoder_attention_mask=attn,
                                decoder_token_type_ids=types,
                                decoder_position_ids=ted.cumulative_position_ids(attn),
                                encoder_outputs=(t(c.enc), t(c.enc_mask)))
        return torch.cat([logits[:, c.col:c.col + 1], logits[:, 8:-1]], dim=1).detach()

    # the lowest logit of row 1's fourth step: outside the top 50
    seq[1, 8 + 3] = int(generated_logits(seq)[1, 3].argmin())
    gen, adv = generated_logits(seq), t(ADVANTAGE)
    warped = warp_logits(gen, top_k=50)
    assert warped[1, 3, seq[1, 11]] == NEG
    assert abs(float(tscst.reinforce_loss(warped, seq[:, 8:], adv, PAD))) > 1e30  # JAX's loss
    kept = warped.clone()
    kept[1, 3, seq[1, 11]] = gen[1, 3, seq[1, 11]]
    want = float(tscst.reinforce_loss(kept, seq[:, 8:], adv, PAD))
    _, grad_step, tx = port_steps(model)
    _, loss = grad_step(tt.create_train_state(model, tx), t(c.enc), t(c.enc_mask), 8, c.col,
                        seq, ADVANTAGE)
    assert np.isfinite(float(loss)) and all(torch.isfinite(g).all() for g in tx.grads.values())
    np.testing.assert_allclose(float(loss), want, rtol=1e-5)


# ---------------------------------------------------------------- the trainer
class IdText:
    """A stand-in tokenizer for split_and_decode_sections: ids as digits."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids if int(i) not in (BOS, EOS, SEP, PAD))


def test_trainer_step_runs_with_the_cxrbert_reward(tmp_path):
    """SCSTTrainer.step on the tiny models, CvT encoder and CXR-BERT reward
    included: finite logs, the encoder bit-unchanged, the decoder moved."""
    from cxrmate_torch.reward.cxrbert import CXRBERTReward
    from cxrmate_torch.tokenizer import WordPieceTokenizer
    from tests.test_torch_harness import pixels
    from tests.test_torch_reward import cxrbert_state_dict, port_cxrbert, write_vocab

    model = torch_model(jax_decoder=False)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rollout, grad_step, tx = port_steps(model)
    reward = CXRBERTReward(port_cxrbert(cxrbert_state_dict()),
                           WordPieceTokenizer.from_file(write_vocab(tmp_path)))

    def split_fn(ids):
        return ted.split_and_decode_sections(ids, [BOS, SEP, EOS], IdText())

    trainer = tscst.SCSTTrainer(model.config, rollout, grad_step, reward, split_fn)
    _, prompt, col = prompts()
    state, logs, (b_f, b_i) = trainer.step(
        tt.create_train_state(model, tx), pixels(4), prompt, (prompt != PAD).astype(np.int32),
        ["the heart size is normal", "stable"], ["no acute process", "small effusion"],
        torch.Generator().manual_seed(9), prompt_logits_col=col)
    assert set(logs) == {"scst_loss", "reward", "baseline"}
    assert all(np.isfinite(v) for v in logs.values()), logs
    assert -2.0 <= logs["reward"] <= 2.0 and -1.0 <= logs["baseline"] <= 1.0
    assert len(b_f) == len(b_i) == 2 and all(isinstance(s, str) for s in b_f + b_i)
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items() if k.startswith("encoder."))
    assert any(not torch.equal(after[k], v) for k, v in before.items() if k.startswith("decoder."))
    assert state.step == 1


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def card_model():
    """A small longitudinal model whose attention heads are 64 wide (the
    kernels' width): CvT 64/128/192 with one layer a stage, BERT 128 wide with
    2 heads and 2 layers, LoRA r=8 with a random lora_B; seeded."""
    from cxrmate_torch import configs
    from cxrmate_torch.models.api import CXRMate

    cfg = configs.EncoderDecoderConfig(
        encoder=configs.CvtConfig(embed_dim=(64, 128, 192), num_heads=(1, 2, 3),
                                  depth=(1, 1, 1), projection_size=128),
        decoder=configs.BertDecoderConfig(vocab_size=97, hidden_size=128, num_hidden_layers=2,
                                          num_attention_heads=2, intermediate_size=256,
                                          max_position_embeddings=96,
                                          cross_attention_hidden_size=128),
        variant=LONG, image_size=64, lora=configs.LoraConfig(r=8, alpha=32.0))
    model = CXRMate.random_init(None, LONG, seed=3, device="cuda", config=cfg).model
    g = torch.Generator(device="cuda").manual_seed(4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".lora_B." in name:
                p.copy_(torch.randn(p.shape, generator=g, device="cuda") * 0.05)
    return model


@pytest.mark.cuda
def test_scst_step_kernels_match_plain_on_card(cuda_device, monkeypatch):
    """One SCST step (rollout, then a grad step on its samples) with the
    decode and flash kernels against the same step over their plain versions,
    fp32 with TF32 off: the same tokens; the loss and each decoder gradient
    within 1e-3 of the largest."""
    from cxrmate_torch.ops import decode_attention as da
    from cxrmate_torch.ops import flash_attention as fa
    from cxrmate_torch.utils.precision import parity_mode

    model = card_model()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    rs = np.random.RandomState(0)
    px = torch.from_numpy(rs.randn(2, 2, 3, 64, 64).astype(np.float32)).cuda()
    px[1, 1] = 0.0
    _, prompt, col = prompts()
    runs = []
    for plain in (False, True):
        model.load_state_dict(start)
        if plain:
            for mod, name in ((da, "decode_attention"), (fa, "flash_attention")):
                monkeypatch.setattr(mod, name, getattr(mod, name + "_plain"))
        da.decode_attention.launches = fa.flash_attention.launches = 0
        rollout, grad_step, tx = port_steps(model)
        with parity_mode():
            sampled, base, hidden, mask = rollout(
                model, px, prompt, None, torch.Generator(device="cuda").manual_seed(1), col)
            state, loss = grad_step(tt.create_train_state(model, tx), hidden, mask, 8, col,
                                    sampled, ADVANTAGE)
        torch.cuda.synchronize()
        if not plain:
            assert da.decode_attention.launches > 0 and fa.flash_attention.launches == 3
        runs.append((sampled.cpu(), base.cpu(), float(loss), tx.grads))
    (s_k, b_k, l_k, g_k), (s_p, b_p, l_p, g_p) = runs
    assert torch.equal(s_k, s_p) and torch.equal(b_k, b_p)
    assert abs(l_k - l_p) <= 1e-3 * max(1.0, abs(l_p))
    big = max(float(g.abs().max()) for g in g_p.values())
    for name, grad in g_k.items():
        assert float((grad - g_p[name]).abs().max()) <= 1e-3 * big, name
