"""The port's user entry points (cxrmate_torch/examples, cxrmate_torch/scripts)
in this process, on the CPU, on a synthetic tree and tiny checkpoints, against
the JAX package's own examples and scripts: the scripts through ``main(argv)``,
the generate examples through the ``generate`` that their ``main`` calls, at
64 px and 12 new tokens (each ``main`` is held to its default device):

- ``generate_longitudinal``: the strings of JAX's ``CXRMate.generate_report``
  on the same exported checkpoint and images; ``generate_single`` and
  ``generate_multi`` the port's own ``generate_report`` (one JAX
  generation per file);
- ``train_tokenizer``: the JAX example's ``tokenizer.json``, byte for byte;
- ``warm_cache``: the JAX script's cache tree, file for file, and its exit
  code on a corrupt file;
- ``reproduce_test_set``: its CSV, 100% agreement with itself, and the JAX
  script's printed lines on a reference CSV that differs from it;
- ``convert_checkpoint``: the HF directory's weights in ``state.pt``, and
  ``--export`` giving ``export_encoder_decoder``'s keys and arrays.
"""

from __future__ import annotations

import glob
import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from cxrmate_torch.ckpt import checkpoints as ck
from cxrmate_torch.ckpt import hf
from cxrmate_torch.cli import config as tconfig
from cxrmate_torch.cli import stages as tstages
from cxrmate_torch.data.image import eval_transform, load_image
from cxrmate_torch.data.synthetic import build_synthetic_dataset
from cxrmate_torch.examples import generate_longitudinal, generate_multi, generate_single
from cxrmate_torch.examples import train_tokenizer
from cxrmate_torch.models.api import CXRMate
from cxrmate_torch.scripts import convert_checkpoint, reproduce_test_set, warm_cache
from cxrmate_torch.tokenizer import ByteLevelBPETokenizer
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = dict(device="cpu", image_size=64, max_new_tokens=12)


def _jax_script(relpath: str):
    """A JAX example or script (not a package) as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_" + os.path.basename(relpath)[:-3], os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hub_dir(root: str, name: str, variant: str, tok, seed: int):
    """A tiny-preset model of the port's random init as an HF directory, its
    biases, norm parameters, BatchNorm statistics and LoRA B (constants at
    init) randomised from ``np.random.RandomState(seed)``."""
    task = tconfig.TaskConfig(device="cpu", variant=variant, model_preset="tiny", image_size=64,
                              decoder_max_len=24, trial=seed)
    config = tstages.build_model_config(task, len(tok))
    rs = np.random.RandomState(seed)
    sd = {}
    for k, v in hf.model_state_dict(tstages.init_variables(task, config)).items():
        if k.endswith("running_var"):
            v = torch.from_numpy(rs.uniform(0.8, 1.2, v.shape).astype(np.float32))
        elif k.endswith(("bias", "running_mean")) or ".lora_B." in k or "LayerNorm" in k \
                or "layer_norm" in k or "normalization" in k:
            v = v + torch.from_numpy(rs.normal(0.0, 0.05, v.shape).astype(np.float32))
        sd[k] = v
    path = os.path.join(root, "hub", name)
    hf.save_hf_pretrained_dir(path, sd, config, tokenizer=tok)
    return path


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two train, one validate and two test studies of one 72 x 66 JPEG (the
    train loader decodes them at 1/2 for 32 px), the tree's tokenizer, and
    tiny-preset multi and longitudinal (LoRA) checkpoints as HF
    directories."""
    root = tmp_path_factory.mktemp("entry")
    paths = build_synthetic_dataset(str(root), n_train=2, n_val=1, n_test=2,
                                    studies_per_subject=1, image_hw=(72, 66))
    tok = ByteLevelBPETokenizer.from_file(paths["tokenizer_dir"])
    jpgs = sorted(glob.glob(os.path.join(paths["dataset_dir"], "**", "*.jpg"), recursive=True))
    return {"root": str(root), "multi": _hub_dir(str(root), "cxrmate-multi-tf", "multi", tok, 1),
            "long": _hub_dir(str(root), "cxrmate", "gt_prompt", tok, 4), "jpgs": jpgs,
            "tok": tok, **paths}


# ------------------------------------------------------------------ examples
def test_generate_longitudinal_equals_jax(tree, capsys):
    from cxrmate_tpu.data.image import eval_transform as jax_eval_transform
    from cxrmate_tpu.data.image import load_image as jax_load_image
    from cxrmate_tpu.models.api import CXRMate as JaxCXRMate

    images, prev = tree["jpgs"][:2], ("the heart size is normal", "no acute disease")
    got = generate_longitudinal.generate(tree["long"], images, *prev, num_beams=1, **SMALL)
    assert capsys.readouterr().out == f"Findings: {got[0][0]}\nImpression: {got[1][0]}\n"
    import jax

    jmodel = JaxCXRMate.from_hf_checkpoint(tree["long"], variant="longitudinal")
    jmodel.encode = jax.jit(jmodel.encode)  # one compile, where eager compiles each op
    px = np.stack([jax_eval_transform(jax_load_image(p), 64) for p in images])[None]
    want = jmodel.generate_report(px, previous_findings=[prev[0]], previous_impression=[prev[1]],
                                  num_beams=1, max_new_tokens=12)
    assert got == want


@pytest.mark.parametrize("example", ["single", "multi"])
def test_generate_examples_equal_generate_report(tree, capsys, example):
    images = tree["jpgs"][:2]
    mod = generate_single if example == "single" else generate_multi
    got = mod.generate(tree["multi"], images, num_beams=4, **SMALL)
    out = capsys.readouterr().out
    model = CXRMate.from_hf_checkpoint(tree["multi"], variant=example, device="cpu")
    px = np.stack([eval_transform(load_image(p), 64) for p in images])
    want = model.generate_report(px if example == "single" else px[None], num_beams=4,
                                 max_new_tokens=12)
    assert got == want
    if example == "single":
        assert out == "".join(f"== {p}\nFindings: {f}\nImpression: {i}\n\n"
                              for p, f, i in zip(images, *want))
    else:
        assert out == f"Findings: {want[0][0]}\nImpression: {want[1][0]}\n"


@pytest.mark.parametrize("example", ["single", "multi", "longitudinal"])
def test_examples_default_to_the_card(tree, example):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod = {"single": generate_single, "multi": generate_multi,
           "longitudinal": generate_longitudinal}[example]
    argv = ["--checkpoint", tree["multi"], "--images", tree["jpgs"][0]]
    if example == "longitudinal":
        argv += ["--previous-findings", "none", "--previous-impression", "none"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


def test_train_tokenizer_equals_jax(tree, tmp_path, monkeypatch, capsys):
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    tok = train_tokenizer.main(["--dataset-dir", tree["dataset_dir"], "--out", out_p,
                                "--vocab-size", "280"])
    assert capsys.readouterr().out == f"saved {len(tok)}-token tokenizer to {out_p}\n"
    monkeypatch.setattr(sys, "argv", ["train_tokenizer.py", "--dataset-dir", tree["dataset_dir"],
                                      "--out", out_j, "--vocab-size", "280"])
    _jax_script("examples/train_tokenizer.py").main()
    a = open(os.path.join(out_p, "tokenizer.json"), "rb").read()
    assert a == open(os.path.join(out_j, "tokenizer.json"), "rb").read()


# ------------------------------------------------------------------- scripts
def _cache_tree(d):
    return {os.path.relpath(f, d): open(f, "rb").read()
            for f in sorted(glob.glob(os.path.join(d, "*", "*.npy")))}


def test_warm_cache_equals_jax_file_for_file(tree, tmp_path, capsys):
    jax_warm = _jax_script("scripts/warm_cache.py")
    trees = {}
    for name, run in (("port", warm_cache.main), ("jax", jax_warm.main)):
        d = str(tmp_path / name)
        assert run(["--dataset_dir", tree["dataset_dir"], "--cache_dir", d, "--image_size", "32",
                    "--trial", "3", "--workers", "2"]) == 0
        trees[name] = _cache_tree(d)
    err = capsys.readouterr().err
    assert "train: 2 images" in err and "warmed 5 cache entries" in err
    assert len(trees["jax"]) == 5 and list(trees["port"]) == list(trees["jax"])
    assert all(trees["port"][k] == trees["jax"][k] for k in trees["jax"])

    # a corrupt file: reported, the rest warmed, exit code 1 (as the JAX script)
    copy = str(tmp_path / "copy")
    shutil.copytree(tree["dataset_dir"], copy)
    bad = sorted(glob.glob(os.path.join(copy, "**", "*.jpg"), recursive=True))[-1]
    with open(bad, "r+b") as f:
        f.truncate(200)
    codes = [run(["--dataset_dir", copy, "--cache_dir", str(tmp_path / f"bad-{name}"),
                  "--image_size", "32", "--workers", "1"])
             for name, run in (("port", warm_cache.main), ("jax", jax_warm.main))]
    assert codes == [1, 1]
    err = capsys.readouterr().err
    assert f"FAILED {bad}: ValueError" in err
    assert len(_cache_tree(str(tmp_path / "bad-port"))) == 4


def test_reproduce_test_set_csv_and_agreement(tree, tmp_path, capsys, monkeypatch):
    from cxrmate_torch.eval import meteor

    # METEOR's synonyms from the vendored table: nltk's import alone takes seconds
    monkeypatch.setattr(meteor, "_DEFAULT_SYNONYMS", meteor.load_synonym_table())
    argv = ["--checkpoint", tree["multi"], "--variant", "multi", "--dataset-dir",
            tree["dataset_dir"], "--greedy", "--model-preset", "tiny", "--image-size", "64",
            "--decoder-max-len", "24", "--mbatch-size", "2", "--device", "cpu"]
    scores = reproduce_test_set.main(argv + ["--exp-dir", str(tmp_path / "first")])
    out = capsys.readouterr().out
    first = out.split("our reports: ")[1].strip()
    assert first.startswith(str(tmp_path / "first")) and first.endswith(".csv")
    assert "test_report_nlg_bleu_1:" in out
    from cxrmate_torch.data.table import read_csv

    rows = read_csv(first)
    assert len(rows) == 2 and {"findings", "impression"} <= set(rows.columns)
    reproduce_test_set.main(argv + ["--exp-dir", str(tmp_path / "second"),
                                    "--reference-csv", first])
    out = capsys.readouterr().out
    assert "findings: 100.00% identical (2/2)" in out
    assert "impression: 100.00% identical (2/2)" in out

    # the agreement against the JAX script's pandas merge, on the first run's
    # CSV (whose empty impressions pandas reads as NaN) and a reference with
    # changed cells, an empty cell, padded cells, a row of its own and a
    # second row for one key; the test stage itself is replaced by the first
    # run's scores in both scripts
    import csv

    import cxrmate_tpu.cli.stages as jax_stages

    with open(first, newline="") as f:
        table = list(csv.reader(f))
    header, body = table[0], table[1:]
    key = header.index("dicom_id" if "dicom_id" in header else "study_id")
    fi, im = header.index("findings"), header.index("impression")
    assert body[1][fi]  # the cell made empty below
    again, extra = list(body[0]), list(body[1])
    again[fi] = f" {again[fi]}  "
    extra[key] = "999999"
    body[0][fi] += " changed"
    body[0][im] = f"  {body[0][im]} \t"
    body[1][fi] = ""
    body[1][im] += " changed"
    body += [extra, again]
    ref = str(tmp_path / "reference.csv")
    with open(ref, "w", newline="") as f:
        csv.writer(f).writerows([header, *body])
    ref_argv = argv + ["--exp-dir", str(tmp_path / "first"), "--reference-csv", ref]
    monkeypatch.setattr(tstages, "test", lambda task: scores)
    reproduce_test_set.main(ref_argv)
    port_out = capsys.readouterr().out
    monkeypatch.setattr(jax_stages, "test", lambda task: scores)
    _jax_script("scripts/reproduce_test_set.py").main(ref_argv[:-6] + ref_argv[-4:])  # no --device
    jax_out = capsys.readouterr().out
    assert port_out == jax_out
    assert "findings: 33.33% identical (1/3)" in port_out
    assert "impression: 66.67% identical (2/3)" in port_out


def test_convert_checkpoint_both_ways(tree, tmp_path, capsys):
    dst = str(tmp_path / "ckpt")
    convert_checkpoint.main(["--src", tree["long"], "--dst", dst, "--variant", "longitudinal"])
    model = CXRMate.from_hf_checkpoint(tree["long"], variant="longitudinal", device="cpu").model
    saved = torch.load(os.path.join(dst, ck.STATE_FILE), weights_only=True)["model"]
    want = model.state_dict()
    assert list(saved) == list(want)
    assert all(torch.equal(saved[k], want[k]) for k in want)
    fresh = CXRMate.from_hf_checkpoint(tree["long"], variant="longitudinal", device="cpu").model
    for p in fresh.parameters():
        p.data.zero_()
    ck.restore_model(dst, fresh)
    assert all(torch.equal(fresh.state_dict()[k], want[k]) for k in want)

    from cxrmate_tpu import configs as jconfigs
    from cxrmate_tpu.ckpt.hf_convert import convert_encoder_decoder, export_encoder_decoder
    from cxrmate_tpu.models.api import config_from_hf_dir as jax_config_from_hf_dir

    npz = str(tmp_path / "sd.npz")
    convert_checkpoint.main(["--src", dst, "--dst", npz, "--export"])
    got = dict(np.load(npz))
    jcfg = jax_config_from_hf_dir(tree["long"], "longitudinal", len(tree["tok"]))
    assert isinstance(jcfg, jconfigs.EncoderDecoderConfig)
    sd = {k: v.numpy() for k, v in hf.load_hf_pretrained_dir(tree["long"]).items()}
    ref = export_encoder_decoder(convert_encoder_decoder(sd, jcfg.encoder, jcfg.decoder),
                                 jcfg.encoder, jcfg.decoder)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    assert capsys.readouterr().out.endswith(f"wrote {len(ref)} tensors to {npz}\n")
