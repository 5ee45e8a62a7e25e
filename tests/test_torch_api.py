"""Public API of the port against the JAX package: one exported HF checkpoint
directory (``pytorch_model.bin``, the repository's ``tokenizer.json``, a tiny
``config.json``) gives the same findings and impression strings from
``cxrmate_tpu.models.api.CXRMate`` and the port's ``CXRMate(device="cpu")``,
greedy and beam-4. The port's tokenizer copy encodes and decodes as the JAX
one does. Both packages read the same state dict out of a ``pytorch_model.bin``
that holds it bare or wrapped (``state_dict``, ``model_state_dict``)."""

import os
import shutil

import numpy as np
import pytest
import torch

from cxrmate_tpu.ckpt.orbax_io import load_hf_pretrained_dir as jax_load_hf_dir
from cxrmate_tpu.models.api import CXRMate as JaxCXRMate
from cxrmate_tpu.tokenizer import ByteLevelBPETokenizer as JaxTokenizer
from cxrmate_torch.ckpt.hf import load_hf_pretrained_dir, save_hf_pretrained_dir
from cxrmate_torch.models.api import CXRMate
from cxrmate_torch.tokenizer import ByteLevelBPETokenizer
from tests.test_torch_harness import REPO, hf_state_dict, pixels, torch_config

TOKENIZER = os.path.join(REPO, "artifacts", "tokenizer", "bpe_prompt", "tokenizer.json")
REPORTS = [
    "The heart size is normal. No focal consolidation, pleural effusion or pneumothorax.",
    "Stable mild cardiomegaly; interval increase in the right pleural effusion [SEP]",
    "Lungs are clear.  Tubes and lines: ET tube 4.5 cm above the carina, NG tube in 2nd loop!",
    "No acute cardiopulmonary process. (Compared with 03/2019 - unchanged.)",
]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """The tiny model with the repository tokenizer's vocabulary: the JAX
    initialisation of the harness, its word embeddings and LM bias extended
    to the tokenizer's size with numpy."""
    vocab = len(ByteLevelBPETokenizer.from_file(TOKENIZER))
    sd = dict(hf_state_dict())
    rs = np.random.RandomState(5)
    word = sd["decoder.bert.embeddings.word_embeddings.weight"]
    extra = (rs.randn(vocab - word.shape[0], word.shape[1]) * 0.02).astype(np.float32)
    sd["decoder.bert.embeddings.word_embeddings.weight"] = np.concatenate([word, extra])
    sd["decoder.cls.predictions.decoder.weight"] = sd["decoder.bert.embeddings.word_embeddings.weight"]
    bias = np.concatenate([sd["decoder.cls.predictions.bias"],
                           rs.normal(0, 0.05, vocab - word.shape[0]).astype(np.float32)])
    sd["decoder.cls.predictions.bias"] = sd["decoder.cls.predictions.decoder.bias"] = bias
    path = str(tmp_path_factory.mktemp("hub") / "cxrmate-multi-tf")
    save_hf_pretrained_dir(path, {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                           torch_config(vocab))
    shutil.copy(TOKENIZER, os.path.join(path, "tokenizer.json"))
    return path


@pytest.fixture(scope="module")
def models(hf_dir):
    return (JaxCXRMate.from_hf_checkpoint(hf_dir, variant="multi"),
            CXRMate.from_hf_checkpoint(hf_dir, variant="multi", device="cpu"))


@pytest.mark.parametrize("beams", [1, 4])
def test_generate_report_strings_identical(models, beams):
    jax_model, model = models
    px = pixels(6, studies=2, slots=2)
    want = jax_model.generate_report(px, num_beams=beams, max_new_tokens=12)
    got = model.generate_report(px, num_beams=beams, max_new_tokens=12)
    assert got == want
    assert all(isinstance(s, str) for s in got[0] + got[1])


def test_entry_points_run_on_the_card_unless_asked(hf_dir):
    """Without a card, the default device raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CXRMate.from_hf_checkpoint(hf_dir, variant="multi")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CXRMate.random_init(ByteLevelBPETokenizer.from_file(TOKENIZER), config=torch_config())


def test_unported_variants_raise(hf_dir):
    """No variant of the JAX package is left unported: all three load (a
    checkpoint without LoRA factors drops the longitudinal preset's LoRA), and
    only a name outside them raises."""
    for variant in ("single", "multi", "longitudinal"):
        model = CXRMate.from_hf_checkpoint(hf_dir, variant=variant, device="cpu")
        assert model.config.variant == variant and model.config.lora is None
    with pytest.raises(ValueError, match="unknown variant"):
        CXRMate.from_hf_checkpoint(hf_dir, variant="bogus", device="cpu")


def test_tokenizer_copy_matches_jax():
    jt, tt = JaxTokenizer.from_file(TOKENIZER), ByteLevelBPETokenizer.from_file(TOKENIZER)
    assert len(tt) == len(jt) == 4720
    for text in REPORTS:
        ids = tt.encode(text)
        assert ids == jt.encode(text)
        assert tt.decode(ids) == jt.decode(ids)
        assert tt.decode(ids, skip_special_tokens=False) == jt.decode(ids, skip_special_tokens=False)
    assert (tt.bos_token_id, tt.eos_token_id, tt.sep_token_id, tt.pad_token_id) == \
        (jt.bos_token_id, jt.eos_token_id, jt.sep_token_id, jt.pad_token_id)


@pytest.mark.parametrize("wrapper", [None, "state_dict", "model_state_dict"])
def test_load_hf_pretrained_dir_unwraps_as_jax_does(tmp_path, wrapper):
    """A bare state dict, a Lightning checkpoint (``state_dict`` beside other
    entries) and a CheXbert one (``model_state_dict``): the same keys and
    tensors from both packages."""
    rs = np.random.RandomState(11)
    sd = {"encoder.projection_head.projection.weight": rs.randn(6, 4).astype(np.float32),
          "decoder.cls.predictions.bias": rs.randn(6).astype(np.float32),
          "decoder.bert.embeddings.word_embeddings.weight": rs.randn(6, 4).astype(np.float32)}
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    blob = sd if wrapper is None else {wrapper: sd, "epoch": 3, "global_step": 120}
    torch.save(blob, tmp_path / "pytorch_model.bin")
    got, want = load_hf_pretrained_dir(str(tmp_path)), jax_load_hf_dir(str(tmp_path))
    assert sorted(got) == sorted(want) == sorted(sd)
    for key, value in sd.items():
        assert torch.equal(got[key], want[key]) and torch.equal(got[key], value), key
