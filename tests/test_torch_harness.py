"""Shared harness of the PyTorch port's tests, and its own checks.

One source of weights: the JAX package initialises a tiny model (multi by
default; ``variant="longitudinal"`` adds LoRA r=8 on the decoder's q/k with a
randomised ``lora_b``, which JAX initialises to zeros)
(``init_cvt_variables``, ``init_bert_params``; the shapes of
tests/oracles.py:80-105, written out here because importing oracles pulls in
``transformers``), numpy randomises the BatchNorm running statistics and the
biases and norm parameters (which JAX initialises to constants), and
``export_encoder_decoder`` turns it into the HF-layout state dict the port
loads. Inputs come from ``np.random.RandomState(seed)``.

Other test files import the helpers from ``tests.test_torch_harness``; the
JAX initialisation is cached per process.
"""

from __future__ import annotations

import functools
import importlib
import os
import subprocess
import sys

import jax
import numpy as np
import torch

from cxrmate_tpu import configs as jcfg
from cxrmate_tpu.ckpt.hf_convert import export_encoder_decoder
from cxrmate_tpu.models.bert import init_bert_params
from cxrmate_tpu.models.cvt import init_cvt_variables
from cxrmate_torch import configs as tcfg
from cxrmate_torch.ckpt.hf import load_model_state, state_dict_from_jax
from cxrmate_torch.models.encoder_decoder import EncoderDecoder

# the full suite runs six xdist workers on eight cores
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 97
BOS, EOS, SEP, PAD = 1, 2, 3, 4
TOL = dict(rtol=1e-5, atol=1e-5)  # fp32 activations and logits

_ENC = dict(embed_dim=(16, 24, 40), num_heads=(1, 2, 4), depth=(1, 2, 3),
            drop_path_rate=(0.0, 0.0, 0.0), projection_size=32)
_DEC = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=96, type_vocab_size=2, pad_token_id=PAD,
            cross_attention_hidden_size=32)


_LORA = dict(r=8, alpha=32.0)  # the longitudinal preset's


def jax_config(vocab: int = VOCAB, variant: str = "multi") -> jcfg.EncoderDecoderConfig:
    return jcfg.EncoderDecoderConfig(
        encoder=jcfg.CvtConfig(**_ENC),
        decoder=jcfg.BertDecoderConfig(vocab_size=vocab, **_DEC),
        variant=variant, image_size=64,
        lora=jcfg.LoraConfig(**_LORA) if variant == "longitudinal" else None)


def torch_config(vocab: int = VOCAB, variant: str = "multi") -> tcfg.EncoderDecoderConfig:
    return tcfg.EncoderDecoderConfig(
        encoder=tcfg.CvtConfig(**_ENC),
        decoder=tcfg.BertDecoderConfig(vocab_size=vocab, **_DEC),
        variant=variant, image_size=64,
        lora=tcfg.LoraConfig(**_LORA) if variant == "longitudinal" else None)


def randomise(variables, seed: int):
    """Numpy leaves, with the BatchNorm running statistics randomised (as
    tests/oracles.py:146-150) and the biases, norm parameters and ``lora_b``
    (constants at JAX's init) perturbed, from ``np.random.RandomState(seed)``."""
    rs = np.random.RandomState(seed)

    def one(path, x):
        x = np.array(x)
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        if name == "mean":  # BN running statistics, as tests/oracles.py:146-150
            return rs.normal(0.0, 0.02, x.shape).astype(x.dtype)
        if name == "var":
            return rs.uniform(0.8, 1.2, x.shape).astype(x.dtype)
        if name in ("b", "bias", "scale", "lora_b"):  # constants at init: make them count
            return (x + rs.normal(0.0, 0.05, x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(one, variables)


@functools.lru_cache(maxsize=None)
def jax_variables(seed: int = 0, vocab: int = VOCAB, variant: str = "multi"):
    """The tiny model's JAX variables, numpy leaves."""
    cfg = jax_config(vocab, variant)
    enc = init_cvt_variables(jax.random.PRNGKey(seed), cfg.encoder)
    dec = init_bert_params(jax.random.PRNGKey(seed + 1), cfg.decoder, lora=cfg.lora)
    variables = {"params": {"encoder": enc["params"], "decoder": dec},
                 "batch_stats": enc["batch_stats"]}
    return randomise(variables, seed + 2)


@functools.lru_cache(maxsize=None)
def hf_state_dict(seed: int = 0, vocab: int = VOCAB, variant: str = "multi"):
    cfg = jax_config(vocab, variant)
    return export_encoder_decoder(jax_variables(seed, vocab, variant), cfg.encoder, cfg.decoder)


def torch_model(seed: int = 0, vocab: int = VOCAB, variant: str = "multi") -> EncoderDecoder:
    """The same model in the port, fp32 on the CPU."""
    model = EncoderDecoder(torch_config(vocab, variant), device="cpu", dtype=torch.float32)
    load_model_state(model, hf_state_dict(seed, vocab, variant))
    return model


def pixels(seed: int = 0, studies: int = 2, slots: int = 2) -> np.ndarray:
    """[studies, slots, 3, 64, 64] images; the last study's last slot is an
    all-zero (padding) image."""
    px = np.random.RandomState(seed).randn(studies, slots, 3, 64, 64).astype(np.float32)
    px[-1, -1] = 0.0
    return px


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ----------------------------------------------------------------- own checks
def _shared():
    # pytest imports this file under its own name too; use the copy the other
    # test files import so the JAX initialisation runs once per process
    return importlib.import_module("tests.test_torch_harness")


def test_port_imports_no_jax():
    """Importing every module of cxrmate_torch (SCST and the CXR-BERT reward,
    the scorers, the checkpoints, the data pipeline, the CLI, the process
    group, the tracing helpers, the examples, the scripts and the native
    tokenizer among them),
    and chip_smoke.py, loads neither jax nor cxrmate_tpu, nor yaml, pandas,
    PIL or safetensors, which the port must not need (checked in a fresh
    interpreter: this one has JAX loaded)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cxrmate_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(cxrmate_torch.__path__, 'cxrmate_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cxrmate_tpu'))\n"
        "assert 'cxrmate_torch.generate.logits_process' in names, names\n"
        "assert 'cxrmate_torch.ops.fused_decode' in names, names\n"
        "assert {'cxrmate_torch.train.tf_trainer', 'cxrmate_torch.train.optim'} <= set(names), names\n"
        "assert {'cxrmate_torch.train.scst', 'cxrmate_torch.reward.cxrbert',\n"
        "        'cxrmate_torch.models.bert_encoder', 'cxrmate_torch.tokenizer.wordpiece'} <= set(names), names\n"
        "assert {'cxrmate_torch.eval.' + m for m in ('ptb', 'nlg', 'stem', 'meteor', 'spice',\n"
        "        'metrics', 'chexbert', 'bertscore')} <= set(names), names\n"
        "assert 'cxrmate_torch.ckpt.checkpoints' in names, names\n"
        "assert {'cxrmate_torch.data.' + m for m in ('table', 'index', 'datasets', 'pipeline',\n"
        "        'image', 'synthetic', 'native')} <= set(names), names\n"
        "assert {'cxrmate_torch.cli.config', 'cxrmate_torch.cli.stages',\n"
        "        'cxrmate_torch.cli.yaml_subset'} <= set(names), names\n"
        "assert {'cxrmate_torch.parallel.mesh', 'cxrmate_torch.parallel.multihost',\n"
        "        'cxrmate_torch.parallel.dryrun', 'cxrmate_torch.utils.tracing'} <= set(names), names\n"
        "assert {'cxrmate_torch.examples.' + m for m in ('generate_single', 'generate_multi',\n"
        "        'generate_longitudinal', 'train_tokenizer')} <= set(names), names\n"
        "assert {'cxrmate_torch.scripts.' + m for m in ('warm_cache', 'reproduce_test_set',\n"
        "        'convert_checkpoint')} <= set(names), names\n"
        "assert {'cxrmate_torch.tokenizer.native_binding',\n"
        "        'cxrmate_torch.utils.host_build'} <= set(names), names\n"
        "assert len(names) >= 50, names\n"
        "assert not bad, bad\n"
        "heavy = sorted(m for m in sys.modules if m.split('.')[0] in ('yaml', 'pandas', 'PIL', 'safetensors'))\n"
        "assert not heavy, heavy\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_state_dict_from_jax_matches_export():
    h = _shared()
    cfg = h.jax_config()
    variables = h.jax_variables()
    want = h.hf_state_dict()
    got = state_dict_from_jax(variables, cfg.encoder, cfg.decoder)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_model_loads_every_parameter():
    """The port's modules hold exactly the export's tensors under HF names
    (the tied head and the decoder.bias alias excepted), and BatchNorm's
    num_batches_tracked counters, which the export lacks, at 0."""
    h = _shared()
    model = h.torch_model()
    want = h.hf_state_dict()
    got = model.state_dict()
    counters = {k for k in got if k.endswith("num_batches_tracked")}
    assert counters and all(int(got.pop(k)) == 0 for k in counters)
    dropped = {"decoder.cls.predictions.decoder.weight", "decoder.cls.predictions.decoder.bias"}
    assert set(got) == set(want) - dropped
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
