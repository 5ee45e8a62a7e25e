"""The port's checkpoint-zoo helpers against the JAX package's:
``ckpt.hf.load_torch_checkpoint`` (the file form of
``cxrmate_tpu/ckpt/orbax_io.py:315``) and
``data.synthetic.build_synthetic_cxrbert`` (the counterpart of
``cxrmate_tpu/data/synthetic.py:91``), whose zoo both packages' reward
builders load."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from cxrmate_torch.ckpt import hf
from cxrmate_torch.data.synthetic import _CXRBERT_VOCAB, build_synthetic_cxrbert

torch.set_num_threads(2)

TEXTS = ["the heart size is normal and the lungs are clear",
         "there is a small left pleural effusion",
         "stable cardiomegaly with no focal consolidation",
         "no acute cardiopulmonary process is seen , ."]
LABELS = [["the heart size is normal"], ["small left effusion"],
          ["stable appearance with cardiomegaly"], ["no acute disease ."]]


def _state_dict(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"bert.embeddings.word_embeddings.weight": torch.randn(5, 3, generator=g),
            "linear_heads.0.bias": torch.randn(4, generator=g)}


@pytest.mark.parametrize("shape", ["lightning", "chexbert", "bare"])
def test_load_torch_checkpoint_unwraps_as_jax(tmp_path, shape):
    """A Lightning-shaped file (state_dict beside the epoch and
    hyper-parameters, which the safe loader would refuse), a CheXbert-shaped
    one (model_state_dict beside the optimizer's) and a bare state dict
    unwrap to what the JAX package's loader gives."""
    from cxrmate_tpu.ckpt import orbax_io

    sd = _state_dict(3)
    blob = {"lightning": {"state_dict": sd, "epoch": 3, "global_step": 120,
                          "hyper_parameters": {"lr": 5e-5, "warm_start": None},
                          "loops": {"fit_loop": {"epoch_progress": np.arange(3)}}},
            "chexbert": {"model_state_dict": sd, "optimizer_state_dict": {"state": {}},
                         "epoch": 7},
            "bare": sd}[shape]
    path = str(tmp_path / "model.ckpt")
    torch.save(blob, path)
    got, want = hf.load_torch_checkpoint(path), orbax_io.load_torch_checkpoint(path)
    assert list(got) == list(want) == list(sd)
    for k in sd:
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], sd[k])
        assert got[k].device.type == "cpu"


def test_synthetic_cxrbert_loads_in_both_packages(tmp_path):
    """The port-written CXR-BERT zoo: the JAX builder's file set and widths,
    and through each package's build_cxrbert_reward the same rewards
    (<= 1e-5) on a few texts."""
    from cxrmate_tpu.cli import config as jconfig
    from cxrmate_tpu.cli import stages as jstages
    from cxrmate_torch.cli import config as tconfig
    from cxrmate_torch.cli import stages as tstages

    zoo = str(tmp_path / "checkpoints")
    path = build_synthetic_cxrbert(zoo)
    assert path == os.path.join(zoo, "microsoft", "BiomedVLP-CXR-BERT-specialized")
    assert sorted(os.listdir(path)) == ["config.json", "pytorch_model.bin", "vocab.txt"]
    with open(os.path.join(path, "vocab.txt")) as f:
        assert f.read().split("\n")[:-1] == _CXRBERT_VOCAB
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["hidden_size"], cfg["num_hidden_layers"], cfg["num_attention_heads"],
            cfg["intermediate_size"], cfg["max_position_embeddings"]) == (24, 2, 2, 48, 64)
    sd = hf.load_hf_pretrained_dir(path)
    assert sd["cls_projection_head.weight"].shape == (16, 24)
    assert all(k.startswith("bert.") for k in sd if k != "cls_projection_head.weight")
    # the same seed writes the same weights
    again = hf.load_hf_pretrained_dir(build_synthetic_cxrbert(str(tmp_path / "again")))
    assert all(torch.equal(sd[k], again[k]) for k in sd)

    port = tstages.build_cxrbert_reward(tconfig.TaskConfig(ckpt_zoo_dir=zoo, device="cpu"))
    ref = jstages.build_cxrbert_reward(jconfig.TaskConfig(ckpt_zoo_dir=zoo))
    assert port.model.config.num_attention_heads == ref.config.num_attention_heads == 2
    got, want = port(TEXTS, LABELS), np.asarray(ref(TEXTS, LABELS))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.ptp(got) > 5e-3  # the texts do score differently
