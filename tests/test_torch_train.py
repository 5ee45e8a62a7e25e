"""Teacher-forcing training in the port against the JAX package, fp32 on the
CPU, tiny model (the harness's: CvT 16/24/40 wide, BERT 32 wide, 2 layers,
64-px images), inputs from numpy seeds; and on a card the three kernels of
``flash_attention_grad`` against their plain versions.

The JAX reference runs once per module (two jitted ``value_and_grad``
evaluations in the file: multi, and longitudinal with LoRA); the updates
are optax's own ``adamw`` on those gradients, as the JAX train step applies
them, and stepped values are compared through the JAX export (HF names).

Tolerances (fp32):
  * loss rtol 1e-5;
  * gradients within 1e-5 of each tensor's largest |g|, with a floor of 1e-9
    for the gradients that are zero in exact arithmetic (a key bias, or a
    BatchNorm bias before a key projection: softmax ignores a shift shared
    by all keys) and sit at rounding level in both frameworks;
  * BatchNorm running statistics 1e-5;
  * updated parameters: Adam's first update is lr * g / (|g| + eps), about
    lr * sign(g), so an element whose gradient is at rounding level may move
    the other way: within 1e-6, except elements with |g| < 1e-6 (100 eps),
    which are held within 2 lr.
Dropout and drop-path draw from torch generators: their statistics and
determinism are tested, not their draws (another RNG than JAX's).

This file imports neither JAX nor the shared harness at module level, so that
the CUDA tests run on the card's machine as they are:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train.py -m cuda
"""

import os
import types

import numpy as np
import pytest
import torch

from cxrmate_torch.ckpt.hf import model_state_dict, save_hf_pretrained_dir
from cxrmate_torch.models import cvt as tcvt
from cxrmate_torch.models import encoder_decoder as ted
from cxrmate_torch.ops import flash_attention as fa
from cxrmate_torch.ops import layers
from cxrmate_torch.train import optim
from cxrmate_torch.train import tf_trainer as tt
from cxrmate_torch.utils.precision import parity_mode

# as in the harness: the full suite runs six xdist workers on eight cores
torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER = os.path.join(REPO, "artifacts", "tokenizer", "bpe_prompt", "tokenizer.json")
LR = 1e-3
PAD = 4
VOCAB = 97  # the harness's


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture
def cuda_device():
    """The card, for the tests of the CUDA kernels; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def tiny_batch(seed: int, variant: str = "multi"):
    """Two studies of two image slots (the last slot all-zero), reports of
    10 tokens, the second padded after 7, labels with pads."""
    from tests.test_torch_harness import pixels

    rs = np.random.RandomState(seed)
    b, l = 2, 10
    mask = np.ones((b, l), np.int32)
    mask[1, 7:] = 0
    ids = rs.randint(6, VOCAB, (b, l)).astype(np.int32)
    ids[1, 7:] = PAD
    labels = np.where(rs.rand(b, l) < 0.2, PAD, rs.randint(6, VOCAB, (b, l))).astype(np.int32)
    labels[1, 6:] = PAD
    batch = {"pixel_values": pixels(seed), "decoder_input_ids": ids,
             "decoder_attention_mask": mask,
             "decoder_token_type_ids": np.repeat((np.arange(l) > 4)[None], b, 0).astype(np.int32),
             "label_ids": labels}
    if variant == "longitudinal":
        batch["decoder_position_ids"] = np.maximum(np.cumsum(mask, axis=1) - 1, 0)
    return batch


def jax_reference(variant: str, stage: str, seed: int):
    """One JAX value_and_grad of ``ed.forward`` + ``cross_entropy_ignore_pad``
    in train mode with ``rng=None``, then optax's update of the stage's
    optimizer -> loss, and HF-named gradients, stepped parameters and new
    BatchNorm statistics (numpy)."""
    import jax
    import jax.numpy as jnp
    import optax

    from cxrmate_tpu.ckpt.hf_convert import export_encoder_decoder
    from cxrmate_tpu.models import encoder_decoder as jed
    from cxrmate_tpu.train import optim as jopt
    from cxrmate_tpu.train.tf_trainer import cross_entropy_ignore_pad
    from tests.test_torch_harness import jax_config, jax_variables

    cfg, variables = jax_config(variant=variant), jax_variables(variant=variant)
    batch = {k: jnp.asarray(v) for k, v in tiny_batch(seed, variant).items()}

    mask = jopt.mask_for_stage(variables["params"], stage)

    def loss_fn(params, stats):
        # frozen leaves get no gradient (the step zeroes theirs anyway), so the
        # compiled program holds no backward for them
        params = jax.tree.map(lambda p, m: p if m else jax.lax.stop_gradient(p), params, mask)
        logits, new_stats = jed.forward(
            {"params": params, "batch_stats": stats}, batch["pixel_values"],
            batch["decoder_input_ids"], cfg, decoder_attention_mask=batch["decoder_attention_mask"],
            decoder_token_type_ids=batch["decoder_token_type_ids"],
            decoder_position_ids=batch.get("decoder_position_ids"), train=True, rng=None)
        return cross_entropy_ignore_pad(logits, batch["label_ids"], PAD), new_stats

    @jax.jit  # as the JAX train step runs it (and one compile, not one per leaf shape)
    def update(grads, params):
        grads = jopt.zero_frozen_grads(grads, mask)
        tx = jopt.adamw(LR, trainable_mask=mask)
        updates, _ = tx.update(grads, tx.init(params), params)
        return grads, optax.apply_updates(params, updates)

    (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    grads, stepped = update(grads, variables["params"])

    def export(params):
        tree = {"params": jax.tree.map(np.asarray, params),
                "batch_stats": jax.tree.map(np.asarray, new_stats)}
        return export_encoder_decoder(tree, cfg.encoder, cfg.decoder)

    return types.SimpleNamespace(loss=float(loss), grads=export(grads), stepped=export(stepped))


def port_step(variant: str, stage: str, seed: int):
    """The port's model before and after one ``make_train_step`` step of
    ``stage`` (fp32, generator None), and that step's loss and gradients."""
    from tests.test_torch_harness import torch_model

    model = torch_model(variant=variant)
    before = {k: v.clone() for k, v in model_state_dict(model).items()}
    params = dict(model.named_parameters())
    mask = optim.mask_for_stage(params, stage)
    batch = tiny_batch(seed, variant)
    grad_model = torch_model(variant=variant)  # the gradients, from the same state
    _, grads = tt.loss_and_grads(grad_model, batch, None, pad_id=PAD, trainable_mask=mask)
    tx = optim.adamw(LR, trainable_mask=mask)
    state = tt.create_train_state(model, tx)
    step = tt.make_train_step(model.config, tx, mask, pad_id=PAD)
    state, loss = step(state, batch, None)
    return types.SimpleNamespace(model=model, before=before, loss=float(loss), grads=grads,
                                 after=model_state_dict(model), mask=mask)


@pytest.fixture(scope="module")
def multi():
    return jax_reference("multi", "multi", 5), port_step("multi", "multi", 5)


@pytest.fixture(scope="module")
def lora():
    return (jax_reference("longitudinal", "gt_prompt", 6),
            port_step("longitudinal", "gt_prompt", 6))


def _hf(name: str, sd) -> str:
    """A port parameter name under the export's key (PEFT-prefixed when the
    export has the prefix)."""
    peft = "decoder.base_model.model." + name[len("decoder."):]
    return peft if name.startswith("decoder.") and peft in sd else name


def assert_grads_close(got, want_sd):
    for name, g in got.items():
        want = want_sd[_hf(name, want_sd)]
        atol = 1e-5 * float(np.abs(want).max()) + 1e-9
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=atol, err_msg=name)


def assert_stepped_close(got, want, grad, err_msg):
    """Within 1e-6, except where |g| < 1e-6 (within 100 eps of zero, where
    Adam's normalisation turns a rounding-level difference of g into a
    visible one of lr * g / (|g| + eps)): there within 2 lr."""
    diff = np.abs(got - want)
    assert diff.max() <= 2 * LR, (err_msg, diff.max())
    far = diff > 1e-6
    assert (np.abs(grad[far]) < 1e-6).all(), (err_msg, diff[far], grad[far])


def stats_of(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


# ---------------------------------------------------------------- the step
def test_multi_step_loss_and_gradients_match_jax(multi):
    ref, port = multi
    np.testing.assert_allclose(port.loss, ref.loss, rtol=1e-5)
    assert len(port.grads) == len(port.mask)  # every parameter trains in the multi stage
    assert_grads_close(port.grads, ref.grads)


def test_multi_step_updates_params_and_batch_stats_like_jax(multi):
    ref, port = multi
    for name, v in port.after.items():
        if name.endswith("num_batches_tracked"):
            assert int(v) == 1, name  # one train-mode forward
        elif name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), ref.stepped[name], rtol=1e-5, atol=1e-5,
                                       err_msg=name)
            assert not torch.equal(v, port.before[name]), name
        else:
            assert_stepped_close(v.detach().numpy(), ref.stepped[name], ref.grads[name], name)


def test_lora_step_trains_only_the_lora_factors(lora):
    """gt_prompt: every frozen parameter bit-unchanged, the LoRA factors as
    JAX steps them, and the encoder's BatchNorm statistics updated all the
    same (train mode), as in JAX."""
    ref, port = lora
    np.testing.assert_allclose(port.loss, ref.loss, rtol=1e-5)
    trained = {n for n, m in port.mask.items() if m}
    assert trained and all(".lora_A." in n or ".lora_B." in n for n in trained)
    assert set(port.grads) == trained
    assert_grads_close(port.grads, ref.grads)
    lora_keys = 0
    for key, v in port.after.items():
        if ".lora_A." in key or ".lora_B." in key:
            lora_keys += 1
            assert_stepped_close(v.detach().numpy(), ref.stepped[key], ref.grads[key], key)
            assert not torch.equal(v, port.before[key]), key
        elif key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), ref.stepped[key], rtol=1e-5, atol=1e-5,
                                       err_msg=key)
        elif not key.endswith("num_batches_tracked"):
            assert torch.equal(v, port.before[key]), key
    assert lora_keys == len(trained)


# ------------------------------------------------------------ accumulation
def test_accumulation_matches_optax_multisteps():
    """k = 2 over four micro-steps, a frozen leaf beside: no update after
    micro-steps 1 and 3, then what optax.MultiSteps(masked adamw) applies."""
    import jax.numpy as jnp
    import optax

    from cxrmate_tpu.train import optim as jopt

    rs = np.random.RandomState(7)
    init = {"a": rs.randn(5, 3).astype(np.float32), "b": rs.randn(4).astype(np.float32),
            "frozen": rs.randn(3).astype(np.float32)}
    mask = {"a": True, "b": True, "frozen": False}
    jtx = jopt.adamw(LR, accumulate_steps=2, trainable_mask=mask)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jtx.init(jparams)
    tparams = {k: t(v) for k, v in init.items()}
    ttx = optim.adamw(LR, accumulate_steps=2, trainable_mask=mask)
    tstate = ttx.init(tparams)
    for i in range(4):
        g = {k: (rs.randn(*v.shape) * 10.0 ** (i - 2)).astype(np.float32) for k, v in init.items()}
        jg = jopt.zero_frozen_grads({k: jnp.asarray(v) for k, v in g.items()}, mask)
        updates, jstate = jtx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        applied = ttx.update({k: t(v) for k, v in g.items() if mask[k]}, tstate, tparams)
        assert applied == (i % 2 == 1)
        for k in init:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} after micro-step {i}")
        np.testing.assert_array_equal(tparams["frozen"].numpy(), init["frozen"])
    assert tstate.count == 2 and tstate.mini_step == 0


def test_accumulating_step_leaves_params_but_updates_batch_stats():
    """The port's train step with accumulate_steps = 2: the first micro-step
    applies no update (BatchNorm statistics move: train mode), the second
    does."""
    from tests.test_torch_harness import torch_model

    model = torch_model()
    tx = optim.adamw(LR, accumulate_steps=2)
    state = tt.create_train_state(model, tx)
    step = tt.make_train_step(model.config, tx, pad_id=PAD)
    w0 = model.decoder.cls.predictions.bias.detach().clone()
    stats0 = {k: v.clone() for k, v in stats_of(model.state_dict()).items()}
    state, _ = step(state, tiny_batch(8), tt.train_generator(0, 0, "cpu"))
    assert torch.equal(model.decoder.cls.predictions.bias, w0)
    assert all(not torch.equal(v, stats0[k]) for k, v in stats_of(model.state_dict()).items())
    state, _ = step(state, tiny_batch(9), tt.train_generator(0, 1, "cpu"))
    assert not torch.equal(model.decoder.cls.predictions.bias, w0)
    assert state.step == 2 and state.opt_state.count == 1


# ------------------------------------------------------------ batch, loss
@pytest.mark.parametrize("variant,pad_report,pad_prompt", [
    ("multi", None, None), ("multi", 48, None), ("longitudinal", None, None),
    ("longitudinal", 40, 64)])
def test_build_tf_batch_equals_jax(variant, pad_report, pad_prompt):
    from cxrmate_tpu.tokenizer import ByteLevelBPETokenizer as JaxTokenizer
    from cxrmate_tpu.train.tf_trainer import build_tf_batch as jax_build
    from cxrmate_torch.tokenizer import ByteLevelBPETokenizer
    from tests.test_torch_harness import jax_config, torch_config

    findings = ["No acute cardiopulmonary process.", "Heart size is normal. Lungs clear.",
                "Small left effusion."]
    impression = ["Normal chest.", "No change.", "Effusion, small."]
    prev_f = ["Stable cardiomegaly.", None, "Left basilar opacity."]
    prev_i = [None, None, "Likely atelectasis."]
    images = np.random.RandomState(0).randn(3, 2, 3, 8, 8).astype(np.float32)
    kw = dict(pad_report_to=pad_report, pad_prompt_to=pad_prompt)
    if variant == "longitudinal":
        kw.update(previous_findings=prev_f, previous_impression=prev_i)
    want = jax_build(JaxTokenizer.from_file(TOKENIZER), jax_config(variant=variant), images,
                     findings, impression, **kw)
    got = tt.build_tf_batch(ByteLevelBPETokenizer.from_file(TOKENIZER),
                            torch_config(variant=variant), images, findings, impression, **kw)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    if pad_report and not pad_prompt:
        assert got["label_ids"].shape[1] == pad_report


def test_cross_entropy_ignore_pad_matches_jax():
    import jax.numpy as jnp

    from cxrmate_tpu.train.tf_trainer import cross_entropy_ignore_pad

    rs = np.random.RandomState(3)
    logits = rs.randn(3, 7, 19).astype(np.float32) * 3
    labels = rs.randint(0, 19, (3, 7))
    labels[0, :3] = PAD
    want = float(cross_entropy_ignore_pad(jnp.asarray(logits), jnp.asarray(labels), PAD))
    got = tt.cross_entropy_ignore_pad(t(logits), t(labels), PAD)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    all_pad = tt.cross_entropy_ignore_pad(t(logits), torch.full((3, 7), PAD), PAD)
    assert float(all_pad) == 0.0  # no label: 0, not NaN


# ------------------------------------------------------ layers and kernels
def test_flash_attention_grad_plain_matches_jax_interpret():
    """out, lse, dq, dk and dv of the plain path against the JAX Pallas
    kernels in interpret mode, blocks of 32 queries and 16 keys over ragged
    lengths (37 queries, 19 keys), fp32 2e-5."""
    import jax
    import jax.numpy as jnp

    from cxrmate_tpu.ops import flash_attention as jfa

    rs = np.random.RandomState(11)
    q, k, v = (rs.randn(3, n, 16).astype(np.float32) for n in (37, 19, 19))
    dout = rs.randn(3, 37, 16).astype(np.float32)
    scale = 40 ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_out, want_lse = jfa._flash_fwd_res(jq, jk, jv, scale, 32, 16, True)
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention_grad(a, b, c, scale, 32, 16, True),
                     jq, jk, jv)
    want_grads = vjp(jnp.asarray(dout))
    tq, tk, tv = (t(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention_grad(tq, tk, tv, scale)
    grads = torch.autograd.grad(out, (tq, tk, tv), t(dout))
    _, lse = fa.flash_attention_fwd_lse(tq.detach(), tk.detach(), tv.detach(), scale)
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **tol)
    for name, g, w in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"d{name}", **tol)
    assert fa.flash_attention_fwd_lse.launches == fa.flash_attention_bwd_dq.launches == 0


@pytest.mark.parametrize("x_dtype", [np.float32, "bfloat16"])
def test_batch_norm_train_matches_jax(x_dtype):
    """On running statistics rounded to bf16 (where the bf16 train step
    rounds them): y (1e-5 in fp32; one bf16 ulp in bf16) and the new
    running statistics (1e-5)."""
    import jax.numpy as jnp

    from cxrmate_tpu.ops.layers import batch_norm_train as jax_bn

    rs = np.random.RandomState(4)
    x = (rs.randn(3, 6, 5, 4) * 2 + 0.5).astype(np.float32)
    w, b = rs.randn(6).astype(np.float32), rs.randn(6).astype(np.float32)
    stats = [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
             for a in (rs.randn(6).astype(np.float32) * 0.1, rs.uniform(0.5, 1.5, 6).astype(np.float32))]
    tx, jx = t(x), jnp.asarray(x.transpose(0, 2, 3, 1))
    if x_dtype == "bfloat16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    y, mean, var = layers.batch_norm_train(tx, t(w), t(b), t(stats[0]), t(stats[1]), 1e-5, 0.1)
    want_y, want_stats = jax_bn({"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
                                {"mean": jnp.asarray(stats[0]), "var": jnp.asarray(stats[1])},
                                jx, 1e-5, 0.1)
    want_y = np.asarray(want_y.astype(jnp.float32)).transpose(0, 3, 1, 2)
    tol = 1e-5 if x_dtype == np.float32 else 2 ** -7 * np.abs(want_y).max()
    np.testing.assert_allclose(y.float().numpy(), want_y, rtol=1e-5, atol=tol)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_stats["mean"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(want_stats["var"]), rtol=1e-5, atol=1e-5)
    assert y.dtype == tx.dtype and mean.dtype == var.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_and_drop_path_statistics_and_determinism(dtype):
    """Inverted dropout keeps about 1 - rate of the elements, scaled by
    1 / (1 - rate); drop-path keeps or drops whole examples; the same seed
    gives the same draws, another seed others; no generator or rate 0 is the
    identity."""
    x = torch.ones(200, 500, dtype=dtype)
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    y = layers.dropout(x, 0.1, gen(1))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 4 * (0.09 / x.numel()) ** 0.5
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1.0) / 0.9)
    assert torch.equal(y, layers.dropout(x, 0.1, gen(1)))
    assert not torch.equal(y, layers.dropout(x, 0.1, gen(2)))
    assert layers.dropout(x, 0.1, None) is x and layers.dropout(x, 0.0, gen(1)) is x
    xs = torch.ones(4000, 3, 5, dtype=dtype)
    z = tcvt._drop_path(xs, 0.25, gen(3))
    per = z.flatten(1)
    assert bool(((per == per[:, :1]).all()))  # one draw per example
    assert abs((per[:, 0] != 0).float().mean().item() - 0.75) < 4 * (0.1875 / 4000) ** 0.5
    assert torch.equal(z, tcvt._drop_path(xs, 0.25, gen(3)))
    assert tcvt._drop_path(xs, 0.25, None) is xs
    rate = tcvt._stage_drop_path_rate(tcvt.CvtConfig(depth=(1, 4, 16)), 2)
    np.testing.assert_allclose(rate, 0.1 * 2 / 15)  # HF: linspace over depth, stage index


def test_train_forward_is_deterministic_per_generator():
    """Dropout on (the train step's generator): the same (trial, step) gives
    the same loss and gradients, another step other ones; the loss differs
    from the dropout-free one."""
    from tests.test_torch_harness import torch_model

    batch = tiny_batch(12)
    out = []
    for step in (3, 3, 4, None):
        model = torch_model()
        gen = None if step is None else tt.train_generator(1, step, "cpu")
        out.append(tt.loss_and_grads(model, batch, gen, pad_id=PAD))
    name = "decoder.bert.encoder.layer.0.attention.self.query.weight"
    assert out[0][0] == out[1][0] and torch.equal(out[0][1][name], out[1][1][name])
    assert out[0][0] != out[2][0] and out[0][0] != out[3][0]


def test_bf16_step_is_close_to_fp32_step():
    """The mixed-precision step (bf16 forward and backward on fp32 masters)
    within 5% of the fp32 step: loss, the gradients' global norm and their
    direction, and the new BatchNorm statistics; gradients arrive fp32."""
    from tests.test_torch_harness import torch_model

    batch = tiny_batch(13)
    res = {}
    for dtype in (None, torch.bfloat16):
        model = torch_model()
        loss, grads = tt.loss_and_grads(model, batch, None, pad_id=PAD, compute_dtype=dtype)
        assert all(g.dtype == torch.float32 for g in grads.values())
        flat = torch.cat([g.flatten() for g in grads.values()])
        res[dtype] = (float(loss), flat, stats_of(model.state_dict()))
    (l32, g32, s32), (l16, g16, s16) = res[None], res[torch.bfloat16]
    assert abs(l16 - l32) <= 0.05 * abs(l32)
    assert abs(g16.norm() - g32.norm()) <= 0.05 * g32.norm()
    assert float(torch.nn.functional.cosine_similarity(g16, g32, dim=0)) >= 0.95
    for k in s32:
        assert float((s16[k] - s32[k]).abs().max()) <= 0.05 * float(s32[k].abs().max()), k


def test_trained_weights_serve_after_save_and_load(tmp_path):
    """A trained model saved with save_hf_pretrained_dir and loaded with
    CXRMate.from_hf_checkpoint gives the trained model's logits exactly, with
    its running statistics and num_batches_tracked counters (as HF's
    BatchNorm2d holds them)."""
    import shutil

    from cxrmate_torch.models.api import CXRMate
    from tests.test_torch_harness import torch_model

    model = torch_model()
    tx = optim.adamw(LR)
    state = tt.create_train_state(model, tx)
    step = tt.make_train_step(model.config, tx, pad_id=PAD)
    for i in range(2):
        state, _ = step(state, tiny_batch(14 + i), tt.train_generator(0, i, "cpu"))
    sd = model_state_dict(model)
    counters = [k for k in sd if k.endswith("num_batches_tracked")]
    assert counters and all(int(sd[k]) == 2 for k in counters)
    save_hf_pretrained_dir(str(tmp_path), sd, model.config)
    shutil.copy(TOKENIZER, tmp_path / "tokenizer.json")
    served = CXRMate.from_hf_checkpoint(str(tmp_path), variant="multi", device="cpu")
    loaded = served.model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(loaded[k], v), k
    batch = tiny_batch(16)
    kw = dict(decoder_attention_mask=t(batch["decoder_attention_mask"]),
              decoder_token_type_ids=t(batch["decoder_token_type_ids"]))
    with torch.no_grad():
        want, _ = ted.forward(model, t(batch["pixel_values"]), t(batch["decoder_input_ids"]), **kw)
        got, _ = ted.forward(served.model, t(batch["pixel_values"]),
                             t(batch["decoder_input_ids"]), **kw)
    assert torch.equal(got, want)


def test_masks_for_each_stage():
    from tests.test_torch_harness import torch_model

    params = dict(torch_model(variant="longitudinal").named_parameters())
    assert all(optim.mask_for_stage(params, "multi").values())
    lora = optim.mask_for_stage(params, "gt_prompt")
    assert sum(lora.values()) == 8  # A and B of q and k in 2 layers
    dec = optim.mask_for_stage(params, "scst")
    assert all(v == n.startswith("decoder.") for n, v in dec.items()) and any(dec.values())
    assert not any(optim.mask_none(params).values())
    zeroed = optim.zero_frozen_grads({n: torch.ones(1) for n in params}, lora)
    assert all(bool(g.sum()) == lora[n] for n, g in zeroed.items())
    with pytest.raises(ValueError):
        optim.mask_for_stage(params, "bogus")


# ---------------------------------------------- card: kernel vs plain version
SHAPES = [(6, 300, 52, 384), (120, 577, 145, 384)]  # ragged; CvT-21 stage 2 of 20 images


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("bh,lq,lk,dim", SHAPES)
def test_flash_grad_kernels_match_plain_on_card(cuda_device, dtype, tol, bh, lq, lk, dim):
    """Each of the three kernels against its plain version, the tolerance
    relative to the largest output (bf16: one ulp of the output rounding);
    the forward's out bit-equal to the inference kernel's."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(bh, n, 64, generator=g, device=cuda_device).to(dtype)
                   for n in (lq, lk, lk, lq))
    scale = dim ** -0.5
    with parity_mode():
        out, lse = fa.flash_attention_fwd_lse(q, k, v, scale)
        assert torch.equal(out, fa.flash_attention(q, k, v, scale))
        delta = (do.float() * out.float()).sum(-1)
        got = {"out": out, "lse": lse,
               "dq": fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale),
               "dkv": torch.stack(fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale))}
        out_p, lse_p = fa.flash_attention_fwd_lse_plain(q, k, v, scale)
        want = {"out": out_p, "lse": lse_p,
                "dq": fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, scale),
                "dkv": torch.stack(fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                                    scale))}
    torch.cuda.synchronize()
    for key in got:
        err = float((got[key].float() - want[key].float()).abs().max())
        assert err <= tol * float(want[key].float().abs().max()), (key, err)


@pytest.mark.cuda
def test_flash_attention_grad_launches_only_its_kernels_on_card(cuda_device):
    q, k, v = (torch.randn(12, n, 64, device=cuda_device, requires_grad=True)
               for n in (577, 145, 145))
    counts = (fa.flash_attention, fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq,
              fa.flash_attention_bwd_dkv)
    for fn in counts:
        fn.launches = 0
    with parity_mode():
        out = fa.flash_attention_grad(q, k, v, 384 ** -0.5)
        dout = torch.randn_like(out)
        grads = torch.autograd.grad(out, (q, k, v), dout)
        assert [fn.launches for fn in counts] == [0, 1, 1, 1]
        plain = fa.flash_attention_grad_plain(q, k, v, 384 ** -0.5)
        want = torch.autograd.grad(plain, (q, k, v), dout)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counts] == [0, 1, 1, 1]
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))


@pytest.mark.cuda
def test_flash_grad_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(2, 8, 64, device=cuda_device)
    stats = torch.zeros(2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_fwd_lse(q.half(), q.half(), q.half(), 0.125)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_dq(q, q, q, q, stats.double(), stats, 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bwd_dkv(q, q, q, q.transpose(1, 2).contiguous().transpose(1, 2),
                                   stats, stats, 0.125)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_bwd_dq(q, q, q, q.bfloat16(), stats, stats, 0.125)
