"""The port's training checkpoints against the JAX package's: the tree that
``save_checkpoint`` writes (tags, ``MARKER.json``, ``index.json`` with top-k
pruning, ``last/`` and its ``EPOCH``, extra files) and the selection
functions over it; a resume mid-accumulation bit-equal to the run it
interrupts; and the BPE tokenizer's ``batch_decode`` and ``save``.

The same sequence of saves goes through the port's ``save_checkpoint`` (a
small train state) and the JAX package's (its orbax writer stood in for by
one that makes the directory):
the two trees hold the same entries, indexes, markers and epochs, and the
JAX package's selection functions, which read plain files, return on the
port's tree what the port's return (the same paths). The resume runs the
port alone: a tiny CvT + BERT model (CvT 16/24/40 wide, BERT 32 wide, 2
layers, 64-px images) with seeded random weights, AdamW accumulating over 2
micro-steps and dropout on; bit-equal means ``torch.equal`` on every tensor.

This file imports neither JAX nor ``tests.*`` at module level, so that its
CUDA test runs on the card's machine as it is:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_checkpoints.py -m cuda
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from cxrmate_torch import configs as tcfg
from cxrmate_torch.ckpt import checkpoints as tck
from cxrmate_torch.models.api import CXRMate
from cxrmate_torch.tokenizer import ByteLevelBPETokenizer
from cxrmate_torch.train import optim
from cxrmate_torch.train import tf_trainer as tt

torch.set_num_threads(2)  # the full suite runs six xdist workers on eight cores
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENIZER = os.path.join(REPO, "artifacts", "tokenizer", "bpe_prompt", "tokenizer.json")
MONITOR = "val_report_chexbert_f1_macro"
# (epoch, step, monitor value, keep_top_k, extra files) of each save, in order:
# mid-epoch saves, a save that prunes itself, one that prunes an older one,
# a re-save of an epoch, an unranked one
SAVES = [
    (0, 5, 0.30, 2, {"history_rank0.json": "[1, 2]"}),
    (0, None, 0.50, 2, {}),
    (1, 3, 0.10, 2, {"history_rank0.json": "[3]"}),
    (1, 12, 0.70, 2, {}),
    (1, None, 0.60, 2, {}),
    (2, None, None, 2, {}),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def small_state():
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    tx = optim.adamw(1e-3, accumulate_steps=2)
    return tt.TrainState(model=model, opt_state=tx.init(dict(model.named_parameters())), step=7)


class _DirCheckpointer:
    """orbax's StandardCheckpointer as far as the layout needs it: a save
    makes the directory (the stored pytree is not compared)."""

    def save(self, path, state, force=False):
        os.makedirs(path, exist_ok=True)

    def wait_until_finished(self):
        pass


def jax_save(exp_dir, save):
    from cxrmate_tpu.ckpt import orbax_io

    epoch, step, value, k, extra = save
    return orbax_io.save_checkpoint(
        exp_dir, {"w": np.zeros(2, np.float32)}, epoch, monitor_value=value, keep_top_k=k,
        step=step, n_batches=step, global_step=None if step is None else 100 + step,
        extra_files=extra, mbatch_size=4, world_size=1)


def port_save(exp_dir, state, save):
    epoch, step, value, k, extra = save
    return tck.save_checkpoint(
        exp_dir, state, epoch, monitor_value=value, keep_top_k=k, step=step, n_batches=step,
        global_step=None if step is None else 100 + step, extra_files=extra, mbatch_size=4,
        world_size=1)


def tree(exp_dir):
    """Every checkpoint directory's entries less the stored state, and the
    text of the plain files."""
    root = os.path.join(exp_dir, "checkpoints")
    out = {"index.json": json.load(open(os.path.join(root, "index.json")))}
    for tag in sorted(os.listdir(root)):
        d = os.path.join(root, tag)
        if os.path.isdir(d):
            for name in sorted(os.listdir(d)):
                if name in ("MARKER.json", "EPOCH") or name.startswith("history"):
                    out[f"{tag}/{name}"] = open(os.path.join(d, name)).read()
    return out


def selections(ck, exp_dir):
    """What each selection function returns on ``exp_dir``, relative to it."""
    def rel(p):
        return None if p is None else os.path.relpath(p, exp_dir)

    out = {"best_max": rel(ck.best_checkpoint(exp_dir)),
           "best_min": rel(ck.best_checkpoint(exp_dir, "min")),
           "last": rel(ck.last_checkpoint(exp_dir)),
           "resume_last": rel(ck.resolve_resume(exp_dir, resume_last=True)),
           "resume_none": rel(ck.resolve_resume(exp_dir)),
           "test": rel(ck.get_test_ckpt_path(exp_dir)),
           "test_min": rel(ck.get_test_ckpt_path(exp_dir, "min")),
           "last_epoch": ck.last_checkpoint_epoch(exp_dir)}
    for epoch in (0, 1, 2, 3):
        out[f"epoch{epoch}"] = rel(ck.checkpoint_for_epoch(exp_dir, epoch))
        if out[f"epoch{epoch}"] is not None:
            out[f"resume{epoch}"] = rel(ck.resolve_resume(exp_dir, resume_epoch=epoch))
            out[f"test{epoch}"] = rel(ck.get_test_ckpt_path(exp_dir, test_epoch=epoch))
    for tag in sorted(os.listdir(os.path.join(exp_dir, "checkpoints"))):
        path = os.path.join(exp_dir, "checkpoints", tag)
        if os.path.isdir(path):
            out[f"{tag}:info"] = ck.checkpoint_resume_info(path)
            out[f"{tag}:epoch"] = ck.checkpoint_epoch_from_path(path)
            out[f"{tag}:extra"] = ck.checkpoint_extra_file(path, "history_rank0.json")
            out[f"{tag}:explicit"] = rel(ck.resolve_resume(exp_dir, resume_ckpt_path=path))
    return out


def test_checkpoint_tree_and_selection_equal_jax(tmp_path, monkeypatch):
    from cxrmate_tpu.ckpt import orbax_io

    ocp = types.ModuleType("orbax.checkpoint")  # the layout logic without orbax's import
    ocp.StandardCheckpointer = _DirCheckpointer
    orbax = types.ModuleType("orbax")
    orbax.checkpoint = ocp
    monkeypatch.setitem(sys.modules, "orbax", orbax)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", ocp)

    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    state = small_state()
    for i, save in enumerate(SAVES):
        got = port_save(port_dir, state, save)
        want = jax_save(jax_dir, save)
        assert os.path.relpath(got, port_dir) == os.path.relpath(want, jax_dir)
        assert tree(port_dir) == tree(jax_dir), f"after save {i}"
        sel = selections(tck, port_dir)
        assert sel == selections(orbax_io, port_dir), f"after save {i}"  # JAX reads the port's
        assert sel == selections(orbax_io, jax_dir), f"after save {i}"
    # top-2 of the ranked saves, the unranked one, last/
    assert sorted(os.listdir(os.path.join(port_dir, "checkpoints"))) == [
        "epoch=1-step=12-val_report_chexbert_f1_macro=0.700000",
        "epoch=1-val_report_chexbert_f1_macro=0.600000", "epoch=2", "index.json", "last"]
    assert sel["test"].endswith("epoch=1-step=12-val_report_chexbert_f1_macro=0.700000")
    assert sel["last_epoch"] == 2
    info = sel["epoch=1-step=12-val_report_chexbert_f1_macro=0.700000:info"]
    assert info == {"epoch": 1, "step": 12, "n_batches": 12, "global_step": 112,
                    "mbatch_size": 4, "world_size": 1, "global_schedule": False}
    with pytest.raises(FileNotFoundError):
        tck.get_test_ckpt_path(port_dir, test_epoch=7)


def test_restore_loads_every_tensor_and_refuses_another_state(tmp_path):
    state = small_state()
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    grads = {n: torch.ones_like(p) for n, p in state.model.named_parameters()}
    for _ in range(3):
        optim.adamw(1e-3, accumulate_steps=2).update(grads, state.opt_state,
                                                     dict(state.model.named_parameters()))
    state.model.train()(torch.randn(5, 3))  # BatchNorm statistics and counter move
    path = tck.save_checkpoint(str(tmp_path), state, 0)
    fresh = tck.restore_checkpoint(path, small_state())
    assert fresh.step == 7 and (fresh.opt_state.count, fresh.opt_state.mini_step) == (1, 1)
    assert_states_equal(fresh, state)
    other = small_state()
    other.opt_state.mu.pop("0.bias")
    with pytest.raises(KeyError):
        tck.restore_checkpoint(path, other)
    model = tck.restore_model(path, torch.nn.Sequential(torch.nn.Linear(3, 4),
                                                        torch.nn.BatchNorm1d(4)))
    for (k, a), b in zip(model.state_dict().items(), state.model.state_dict().values()):
        assert torch.equal(a, b), k


# ------------------------------------------------------------ resume, bit-equal
def tiny_config(vocab: int, embed_dim=(16, 24, 40), num_heads=(1, 2, 4)
                ) -> tcfg.EncoderDecoderConfig:
    """The port tests' tiny multi model (tests/test_torch_harness.py's widths;
    the card's CvT attention kernels take heads of 64 alone)."""
    return tcfg.EncoderDecoderConfig(
        encoder=tcfg.CvtConfig(embed_dim=embed_dim, num_heads=num_heads, depth=(1, 2, 3),
                               drop_path_rate=(0.0, 0.0, 0.1), projection_size=32),
        decoder=tcfg.BertDecoderConfig(vocab_size=vocab, hidden_size=32, num_hidden_layers=2,
                                       num_attention_heads=4, intermediate_size=64,
                                       max_position_embeddings=96, type_vocab_size=2,
                                       cross_attention_hidden_size=32),
        variant="multi", image_size=64)


def tiny_batch(seed: int, vocab: int, pad: int):
    """Two studies of two 64-px image slots (the last all-zero), 10-token
    reports, the second padded after 7."""
    rs = np.random.RandomState(seed)
    px = rs.randn(2, 2, 3, 64, 64).astype(np.float32)
    px[-1, -1] = 0.0
    ids = rs.randint(6, vocab, (2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.int32)
    ids[1, 7:], mask[1, 7:] = pad, 0
    labels = np.where(rs.rand(2, 10) < 0.2, pad, rs.randint(6, vocab, (2, 10))).astype(np.int32)
    labels[1, 6:] = pad
    return {"pixel_values": px, "decoder_input_ids": ids, "decoder_attention_mask": mask,
            "decoder_token_type_ids": np.repeat((np.arange(10) > 4)[None], 2, 0).astype(np.int32),
            "label_ids": labels}


def assert_states_equal(a, b):
    for (k, x), (k2, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert k == k2 and torch.equal(x, y), k
    for name in ("mu", "nu", "acc"):
        xa, xb = getattr(a.opt_state, name), getattr(b.opt_state, name)
        assert list(xa) == list(xb), name
        for k in xa:
            assert torch.equal(xa[k], xb[k]), (name, k)
    assert (a.step, a.opt_state.count, a.opt_state.mini_step) == \
        (b.step, b.opt_state.count, b.opt_state.mini_step)


def resume_run(tmp_path, device: str, total: int = 5, save_at: int = 3, **widths):
    """``total`` micro-steps straight through, and ``save_at`` micro-steps,
    a save, a restore into a train state built anew from other weights, and
    the rest; -> (the straight state, the resumed state)."""
    tok = ByteLevelBPETokenizer.from_file(TOKENIZER)
    config = tiny_config(len(tok), **widths)

    def fresh(seed):
        model = CXRMate.random_init(tok, config=config, seed=seed, device=device).model
        tx = optim.adamw(1e-3, accumulate_steps=2)
        step = tt.make_train_step(config, tx, pad_id=tok.pad_token_id)
        return tt.create_train_state(model, tx), step

    def run(state, step, micro_steps):
        for i in micro_steps:
            state, _ = step(state, tiny_batch(i, len(tok), tok.pad_token_id),
                            tt.train_generator(0, i, device))
        return state

    straight = run(*fresh(0), range(total))
    state, step = fresh(0)
    state = run(state, step, range(save_at))
    assert state.opt_state.mini_step == 1 and state.opt_state.count == 1  # mid-accumulation
    path = tck.save_checkpoint(str(tmp_path), state, 0, step=save_at, global_step=save_at)
    resumed, step = fresh(1)
    resumed = tck.restore_checkpoint(path, resumed)
    assert tck.checkpoint_resume_info(path)["global_step"] == save_at == resumed.step
    return straight, run(resumed, step, range(save_at, total))


def test_resume_mid_accumulation_is_bit_equal(tmp_path):
    straight, resumed = resume_run(tmp_path, "cpu")
    assert_states_equal(resumed, straight)
    assert straight.opt_state.count == 2 and straight.step == 5


@pytest.mark.cuda
def test_resume_mid_accumulation_is_bit_equal_on_card(cuda_device, tmp_path):
    straight, resumed = resume_run(tmp_path, "cuda", embed_dim=(64, 128, 192),
                                   num_heads=(1, 2, 3))
    assert next(resumed.model.parameters()).is_cuda
    assert_states_equal(resumed, straight)


# ------------------------------------------------------------------ tokenizer
def test_batch_decode_and_save_match_jax(tmp_path):
    from cxrmate_tpu.tokenizer.bpe import ByteLevelBPETokenizer as JBPE

    tok, jtok = ByteLevelBPETokenizer.from_file(TOKENIZER), JBPE.from_file(TOKENIZER)
    rs = np.random.RandomState(2)
    ids = rs.randint(0, len(tok), (6, 40))
    ids[0, :3] = [tok.bos_token_id, tok.sep_token_id, tok.eos_token_id]
    for skip in (True, False):
        assert tok.batch_decode(ids, skip) == jtok.batch_decode(ids, skip)
    tok.save(str(tmp_path / "port") + os.sep)
    jtok.save(str(tmp_path / "jax") + os.sep)
    port_file, jax_file = tmp_path / "port" / "tokenizer.json", tmp_path / "jax" / "tokenizer.json"
    assert port_file.read_bytes() == jax_file.read_bytes()
    texts = ["Heart size normal. [SEP] No effusion.", "Café  ✓ 3.5cm\nnew line", ""]
    want = jtok(texts)["input_ids"]
    for loaded in (ByteLevelBPETokenizer.from_file(str(port_file)),
                   JBPE.from_file(str(port_file))):
        np.testing.assert_array_equal(loaded(texts)["input_ids"], want)
        assert loaded.all_special_tokens == tok.all_special_tokens


def test_save_hf_pretrained_dir_writes_the_tokenizer(tmp_path):
    from cxrmate_torch.ckpt.hf import model_state_dict, save_hf_pretrained_dir

    tok = ByteLevelBPETokenizer.from_file(TOKENIZER)
    model = CXRMate.random_init(tok, config=tiny_config(len(tok)), device="cpu")
    save_hf_pretrained_dir(str(tmp_path), model_state_dict(model.model), model.config, tok)
    again = CXRMate.from_hf_checkpoint(str(tmp_path), variant="multi", device="cpu")
    assert again.tokenizer.vocab == tok.vocab
    for (k, a), b in zip(model.model.state_dict().items(), again.model.state_dict().values()):
        assert torch.equal(a, b), k
