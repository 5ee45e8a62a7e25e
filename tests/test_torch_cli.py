"""The port's train/test CLI (cxrmate_torch/cli: yaml_subset, config, stages)
against the JAX package's cxrmate_tpu/cli on the same inputs: parsed configs,
model configs, monitor resolution, schedules, metric keys, datasets, the
warm-start modes, and one decode step's tokens and sections (the only JAX
model call here: longitudinal, beam-4, padded rows). The port's own fit ->
test through ``main([... "device=cpu"])`` writes a checkpoint tree that the
JAX package's selection functions read, and mid-epoch resumes of ``fit`` and
``fit_scst`` are bit-equal to the uninterrupted runs.

Tiny preset, 64-pixel images, decoder_max_len 24, torch at two threads."""

from __future__ import annotations

import csv
import dataclasses
import glob
import json
import math
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from cxrmate_tpu.cli import config as jconfig
from cxrmate_tpu.cli import stages as jstages
from cxrmate_torch.ckpt import checkpoints as ck
from cxrmate_torch.ckpt import hf
from cxrmate_torch.cli import config as tconfig
from cxrmate_torch.cli import stages as tstages
from cxrmate_torch.cli import yaml_subset
from cxrmate_torch.data.synthetic import build_synthetic_cxrbert, build_synthetic_dataset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "config", "*", "*.yaml")))
OVERRIDES = ["lr=1e-4", "max_epochs=3", "val_check_interval=0.25", "monitor=val_report_nlg_bleu_4",
             "sections_to_evaluate=[findings, impression]", "warm_start_name=null",
             "fast_dev_run=yes", "image_cache_dir=", "num_test_beams=0x2", "eval_decode_rows=1_024",
             "precision=16", "trial_note='a # b'", "decoder_max_len=24", "save_top_k=-1"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The port's synthetic tree: 6 subjects of two one-image studies (2 per
    split), the tokenizer, and the tiny CXR-BERT."""
    root = tmp_path_factory.mktemp("cli")
    paths = build_synthetic_dataset(str(root), n_train=4, n_val=4, n_test=4,
                                    studies_per_subject=2)
    build_synthetic_cxrbert(paths["ckpt_zoo_dir"])
    return {"root": str(root), **paths}


def task_kwargs(tree, exp: str, **kw) -> dict:
    base = dict(dataset_dir=tree["dataset_dir"], ckpt_zoo_dir=tree["ckpt_zoo_dir"],
                exp_dir=os.path.join(tree["root"], exp), model_preset="tiny", image_size=64,
                decoder_max_len=24, max_images_per_study=2, mbatch_size=2,
                accumulated_mbatch_size=4, max_epochs=1, num_test_beams=4,
                monitor="val_report_nlg_bleu_1", num_workers=2, image_cache_dir=None)
    base.update(kw)
    return base


def both(tree, exp: str, **kw):
    """The same task as (JAX TaskConfig, port TaskConfig on the CPU)."""
    kw = task_kwargs(tree, exp, **kw)
    return jconfig.TaskConfig(**kw), tconfig.TaskConfig(device="cpu", **kw)


def typed_equal(a, b) -> bool:
    """Equal values of equal types (True is not 1), NaN equal to NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, list):
        return len(a) == len(b) and all(typed_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(typed_equal(a[k], b[k]) for k in a)
    return a == b


# ------------------------------------------------------------------ YAML subset
@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_yaml_subset_equals_safe_load_on_configs(path):
    text = open(path).read()
    assert typed_equal(yaml_subset.load(text), yaml.safe_load(text))


_INTS = st.integers(-10**7, 10**7).flatmap(lambda n: st.sampled_from(
    [str(n), f"{n:+d}", f"{n:_}"] + ([hex(n), f"0b{n:b}", f"0{n:o}", f"{n // 60}:{n % 60:02d}"]
                                     if n > 0 else [])))
_FLOATS = st.one_of(
    st.floats(allow_nan=False, allow_infinity=False).map(repr),
    st.floats(-1e4, 1e4, allow_nan=False).map(lambda x: f"{x:.3f}"),
    st.sampled_from([".inf", "-.inf", "+.inf", ".nan", ".NaN", "1e-4", "5.0e-6", "1.0e6", "1.5E+3",
                     "0.", ".5", "1_000.5", "1:30.5", "6.02e+23", "-0.0"]))
_WORDS = st.sampled_from(["yes", "No", "TRUE", "false", "off", "On", "OFF", "y", "n", "null",
                          "Null", "NULL", "~", "", "nan", "inf", "yES", "abc", "a/b-c.d",
                          "aehrc/cxrmate-tf", "../train/single_tf", "val_report_nlg_bleu_1"])
_QUOTED = st.one_of(
    st.text(alphabet="ab #:,'[]{}-\\", max_size=6).map(
        lambda s: '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'),
    st.text(alphabet="ab #:,\"[]{}-", max_size=6).map(lambda s: "'" + s + "'"))
_IN_SUBSET = st.one_of(_INTS, _FLOATS, _WORDS, _QUOTED)
_FLOW_ITEM = st.one_of(_INTS, _FLOATS, _WORDS.filter(bool), _QUOTED)
_VALUES = st.one_of(_IN_SUBSET,
                    st.lists(_FLOW_ITEM, max_size=4).map(lambda xs: "[" + ", ".join(xs) + "]"))
_ANY = st.text(alphabet="ab01.e+-_:#~ ,[]'\"xo", max_size=8)


@settings(max_examples=300, deadline=None)
@given(_VALUES)
def test_yaml_subset_equals_safe_load_on_override_scalars(value):
    """Every scalar and flow list of the subset parses to safe_load's value
    and type, and apply_overrides (with its scientific-notation rule) to
    the JAX package's."""
    assert typed_equal(yaml_subset.load(value), yaml.safe_load(value)), value
    got = tconfig.apply_overrides({}, [f"k={value}"])
    assert typed_equal(got, jconfig.apply_overrides({}, [f"k={value}"])), value


@settings(max_examples=300, deadline=None)
@given(_ANY)
def test_yaml_subset_refuses_or_agrees(value):
    """Arbitrary short strings: the reader either agrees with safe_load or
    refuses with a ValueError naming the line; it never guesses."""
    try:
        got = yaml_subset.load(value)
    except ValueError as e:
        assert str(e).startswith("line "), e
        return
    try:
        want = yaml.safe_load(value)
    except yaml.YAMLError:
        pytest.fail(f"{value!r}: safe_load refuses it, the reader gives {got!r}")
    assert typed_equal(got, want), value


@pytest.mark.parametrize("text", ["0[' #", "-' #", "0[a, 'b #", "a: 0[' # c", "- -' # c",
                                  "[a, 'b # c'] # d"])
def test_yaml_subset_quote_inside_a_plain_scalar_is_text(text):
    """A quote or ``[`` inside a plain scalar opens nothing: the comment
    after it is stripped, as safe_load strips it."""
    assert typed_equal(yaml_subset.load(text), yaml.safe_load(text)), text


@pytest.mark.parametrize("text", ["[:']", "[a, :b]", "0x_", "-0b_"])
def test_yaml_subset_refuses_what_safe_load_refuses(text):
    """A flow scalar led by ':' and an integer without digits: safe_load
    fails on them, and the reader refuses them naming the line."""
    with pytest.raises((yaml.YAMLError, ValueError)):
        yaml.safe_load(text)
    with pytest.raises(ValueError, match=r"^line \d+: "):
        yaml_subset.load(text)


@pytest.mark.parametrize("text", [
    "{a: 1}", "a: {b: 1}", "&x 1", "a: *x", "!!str 1", "a: |\n  text", "a: >\n  text",
    "a: b\n  c", "---\na: 1", "a: 2001-12-14", "=", "<<: 1", "\ta: 1", "a:\n\t- 1",
    "a: 'open", "a: [1, [2]]", "- a: 1", "a: [1, 2", "? a", "%YAML 1.1"])
def test_yaml_subset_refuses_outside_the_subset(text):
    with pytest.raises(ValueError, match=r"^line \d+: "):
        yaml_subset.load(text)


# ---------------------------------------------------------------------- config
@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_config_parsing_equals_jax(path):
    """load_config, apply_overrides and parse_args give the JAX package's
    values: the same dicts and the same TaskConfig fields (the port's device
    aside)."""
    raw = tconfig.load_config(path)
    assert typed_equal(raw, jconfig.load_config(path))
    assert typed_equal(tconfig.apply_overrides(raw, OVERRIDES),
                       jconfig.apply_overrides(raw, OVERRIDES))
    argv = ["--config", path, "--train", "--trial", "3"] + OVERRIDES[:-2]
    got, want = tconfig.parse_args(argv), jconfig.parse_args(argv)
    got_d = dataclasses.asdict(got)
    assert got_d.pop("device") == "cuda"
    assert typed_equal(got_d, dataclasses.asdict(want))
    assert (got._train, got._test) == (want._train, want._test) == (True, False)
    for prop in ("resolved_image_cache_dir", "resolved_xla_cache_dir", "exp_dir_trial",
                 "accumulate_steps"):
        assert getattr(got, prop) == getattr(want, prop), prop


def test_task_config_fields_and_errors_equal_jax(tmp_path, capsys):
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.TaskConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.TaskConfig)}
    assert tf.pop("device") == "cuda"
    assert list(tf) == list(jf) and tf == jf
    assert tconfig.VALID_VARIANTS == jconfig.VALID_VARIANTS
    for argv in (["--config", str(tmp_path / "missing.yaml")],
                 ["--config", CONFIGS[0], "variant=bogus"]):
        with pytest.raises(SystemExit) as a:
            tconfig.parse_args(argv)
        err_t = capsys.readouterr().err.split("error: ")[1]
        with pytest.raises(SystemExit) as b:
            jconfig.parse_args(argv)
        assert a.value.code == b.value.code == 2
        assert err_t == capsys.readouterr().err.split("error: ")[1]
    bad = tmp_path / "bad.yaml"
    bad.write_text("variant: multi\nlr: {a: 1}\n")
    with pytest.raises(ValueError, match="line 2"):
        tconfig.load_config(str(bad))
    cyc = tmp_path / "cyc.yaml"
    cyc.write_text("defaults:\n  - cyc\n")
    with pytest.raises(AssertionError, match="config cycle"):
        tconfig.load_config(str(cyc))


@pytest.mark.parametrize("preset", ["tiny", "cxrmate"])
@pytest.mark.parametrize("variant", jconfig.VALID_VARIANTS)
def test_build_model_config_equals_jax(variant, preset):
    kw = dict(variant=variant, model_preset=preset, image_size=96, decoder_max_len=40,
              max_images_per_study=3)
    got = tstages.build_model_config(tconfig.TaskConfig(**kw), 321)
    want = jstages.build_model_config(jconfig.TaskConfig(**kw), 321)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tstages.VARIANT_TO_MODEL == jstages.VARIANT_TO_MODEL


@pytest.mark.parametrize("scores,monitor", [
    ({"val_report_chexbert_f1_macro": 0.3, "val_report_nlg_cider": 0.1},
     "val_report_chexbert_f1_macro"),
    ({"val_report_nlg_bleu_4": 0.2, "val_report_nlg_bleu_1": 0.5, "val_report_nlg_cider": 0.1},
     "val_report_chexbert_f1_macro"),
    ({"val_report_nlg_bleu_1": 0.5, "val_findings_nlg_rouge": 0.4}, "val_report_chexbert_f1_macro"),
    ({"val_findings_nlg_rouge": 0.4, "val_findings_nlg_bleu_2": 0.3}, "val_x"),
    ({"val_report_chexbert_f1_macro": 0.3}, "test_report_bertscore_f1"),
])
def test_resolve_monitor_equals_jax(scores, monitor):
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = tstages.resolve_monitor(scores, monitor)
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want = jstages.resolve_monitor(scores, monitor)
    assert got == want
    assert [(w.category, str(w.message)) for w in got_w] == \
        [(w.category, str(w.message)) for w in want_w]


def test_schedules_collate_and_metric_keys_equal_jax(tree, monkeypatch):
    from cxrmate_tpu.eval import meteor as jmeteor

    # the JAX package's WordNet load takes seconds; the keys do not depend on it
    monkeypatch.setattr(jmeteor, "default_synonyms", lambda: None)
    for n, interval, mb in [(0, None, 4), (7, 0.5, 2), (100, 0.1, 8), (100, 1.0, 8), (5, 0.01, 1)]:
        jt, tt_ = both(tree, "sched", val_check_interval=interval, mbatch_size=mb)
        assert tstages._mid_epoch_schedule(tt_, n) == jstages._mid_epoch_schedule(jt, n)
    for variant in jconfig.VALID_VARIANTS:
        for pad in ("batch", "max"):
            jt, tt_ = both(tree, "sched", variant=variant, pad_images=pad)
            assert tstages._collate_max_images(tt_) == jstages._collate_max_images(jt)
    with pytest.raises(AssertionError):
        tstages._collate_max_images(both(tree, "sched", pad_images="bogus")[1])

    def fake(*a):
        return None

    def shape(metrics):
        return {k: type(v).__name__ for k, v in metrics.items()}

    for variant in ("single", "multi"):
        for split in ("val", "test"):
            jt, tt_ = both(tree, "metrics", variant=variant,
                           sections_to_evaluate=("report", "findings"))
            got = tstages.make_metrics(tt_, split, reward_fn=fake, chexbert_fn=fake,
                                       bertscorer=fake)
            want = jstages.make_metrics(jt, split, reward_fn=fake, chexbert_fn=fake,
                                        bertscorer=fake)
            assert shape(got) == shape(want)
            assert [m.metrics for m in got.values() if hasattr(m, "metrics")] == \
                [m.metrics for m in want.values() if hasattr(m, "metrics")]
            assert {m.accumulate_over_dicoms for m in got.values()} == {variant == "single"}


# -------------------------------------------------------------------- datasets
def _same_item(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        if k == "images":
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        else:
            x, y = a[k], b[k]
            x = x.item() if isinstance(x, np.generic) else x
            y = y.item() if isinstance(y, np.generic) else y
            assert x == y, k


@pytest.mark.parametrize("variant", ["single", "multi", "gt_prompt", "gen_prompt", "scst"])
def test_make_datasets_equals_jax(tree, variant):
    for split, train in (("train", True), ("validate", False), ("test", False)):
        jt, tt_ = both(tree, "data", variant=variant)
        got, want = tstages.make_datasets(tt_, split, train), jstages.make_datasets(jt, split, train)
        assert type(got).__name__ == type(want).__name__
        assert len(got) == len(want) > 0
        assert [str(s) for s in got.examples] == [str(s) for s in want.examples]
        assert getattr(got, "mbatch_size", None) == getattr(want, "mbatch_size", None)
        if hasattr(want, "load_image") and hasattr(want.load_image, "set_epoch"):
            want.load_image.set_epoch(1)
            got.load_image.set_epoch(1)
        for i in range(len(want)):
            a, b = got[i], want[i]
            _same_item(a, b)
            if getattr(want, "use_generated", False):  # the history a decode writes back
                for ds in (got, want):
                    ds.record_generated(a["study_ids"], f"found {i}", f"impressed {i}")


# ------------------------------------------------------------------ warm start
def _randomised_state_dict(tree, variant: str, seed: int) -> dict:
    """A fresh tiny-preset port model's HF state dict (numpy), with the
    biases, norm parameters, BatchNorm statistics and LoRA B (constants at
    init) randomised from ``np.random.RandomState(seed)``."""
    _, t = both(tree, "export", variant=variant, trial=seed)
    model = tstages.init_variables(t, tstages.build_model_config(t, len(tstages.load_tokenizer(t))))
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in hf.model_state_dict(model).items():
        if k.endswith("num_batches_tracked"):
            continue
        v = v.numpy().copy()
        if k.endswith("running_var"):
            v = rs.uniform(0.8, 1.2, v.shape).astype(v.dtype)
        elif k.endswith(("bias", "running_mean")) or ".lora_B." in k or "LayerNorm" in k \
                or "layer_norm" in k or "normalization" in k:
            v = (v + rs.normal(0.0, 0.05, v.shape)).astype(v.dtype)
        out[k] = v
    return out


@pytest.fixture(scope="module")
def exports(tree):
    """JAX tiny-preset variables (multi and longitudinal; converted from a
    randomised state dict, faster than JAX's own init) written by the JAX
    package's export as HF dirs into the zoo; also the multi one as a
    Lightning-shaped file."""
    from cxrmate_tpu.ckpt.hf_convert import convert_encoder_decoder, export_encoder_decoder

    out = {}
    for variant, name in (("multi", "multi"), ("gt_prompt", "longitudinal")):
        jt, _ = both(tree, "export", variant=variant)
        cfg = jstages.build_model_config(jt, len(jstages.load_tokenizer(jt)))
        variables = convert_encoder_decoder(_randomised_state_dict(tree, variant, 11),
                                            cfg.encoder, cfg.decoder)
        sd = export_encoder_decoder(variables, cfg.encoder, cfg.decoder)
        path = os.path.join(tree["ckpt_zoo_dir"], "test", f"tiny-{name}")
        os.makedirs(path, exist_ok=True)
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   os.path.join(path, "pytorch_model.bin"))
        out[name] = (f"test/tiny-{name}", variables)
    ckpt = os.path.join(tree["ckpt_zoo_dir"], "tiny-multi.ckpt")
    blob = torch.load(os.path.join(tree["ckpt_zoo_dir"], "test", "tiny-multi",
                                   "pytorch_model.bin"), weights_only=True)
    torch.save({"state_dict": blob, "epoch": 3, "hyper_parameters": {"lr": 5e-5}}, ckpt)
    out["ckpt"] = ckpt
    return out


def _raises_same(fn_t, fn_j):
    with pytest.raises(Exception) as a:
        fn_t()
    with pytest.raises(Exception) as b:
        fn_j()
    assert type(a.value) is type(b.value) and str(a.value) == str(b.value)


def _equal_to_jax_export(model, variables) -> None:
    """The port model's parameters and buffers are the JAX pytree's, key for
    key (BatchNorm's num_batches_tracked, which JAX has none of, aside)."""
    want = hf.state_dict_from_jax(jax_numpy(variables), model.config.encoder, None)
    got = {k: v for k, v in hf.model_state_dict(model).items()
           if not k.endswith("num_batches_tracked")}
    dropped = {k for k in want if k.endswith("cls.predictions.decoder.bias")
               or (k.endswith("cls.predictions.decoder.weight")
                   and model.config.decoder.tie_word_embeddings)}
    assert set(got) == set(want) - dropped
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def jax_numpy(variables):
    import jax

    return jax.tree_util.tree_map(np.asarray, variables)


def test_resolve_warm_start_modes_equal_jax(tree, exports):
    jt, tt_ = both(tree, "warm")
    jtok = jstages.load_tokenizer(jt)
    jcfg = jstages.build_model_config(jt, len(jtok))
    tcfg = tstages.build_model_config(tt_, len(jtok))
    fresh = tstages.init_variables(tt_, tcfg)
    jfresh = {}  # no JAX init (slow on the CPU): every JAX mode below ignores or refuses it
    # fresh init: the model itself
    assert tstages.resolve_warm_start(tt_, tcfg, fresh) is fresh
    # the errors
    for kw in (dict(warm_start_ckpt_path="/nonexistent/ckpt"),
               dict(warm_start_exp_dir=os.path.join(tree["root"], "nowhere")),
               dict(warm_start_name="aehrc/not-there"),
               dict(multi_ckpt_name="aehrc/not-there")):
        j, t = both(tree, "warm", **kw)
        _raises_same(lambda: tstages.resolve_warm_start(t, tcfg, fresh),
                     lambda: jstages.resolve_warm_start(j, jcfg, jfresh))
    # an HF dir under the zoo, and a Lightning-shaped file by path
    for kw in (dict(warm_start_name=exports["multi"][0]), dict(warm_start_name=exports["ckpt"])):
        j, t = both(tree, "warm", **kw)
        got = tstages.resolve_warm_start(t, tcfg, fresh)
        want = jstages.resolve_warm_start(j, jcfg, jfresh)
        _equal_to_jax_export(got, want)
        _equal_to_jax_export(got, exports["multi"][1])


def test_warm_start_gt_prompt_from_multi_equals_jax(tree, exports):
    """The trap: gt_prompt warm-started from a multi checkpoint (no LoRA
    factors) holds the parameter set JAX's convert_encoder_decoder gives it
    (no LoRA), so both trainable masks are empty; from a longitudinal
    checkpoint the LoRA factors are there and are all that trains."""
    from cxrmate_tpu.train import optim as joptim
    from cxrmate_torch.train import optim as toptim
    import jax

    for name, lora in ((exports["multi"][0], False), (exports["longitudinal"][0], True)):
        jt, tt_ = both(tree, "trap", variant="gt_prompt", multi_ckpt_name=name)
        jtok = jstages.load_tokenizer(jt)
        jcfg = jstages.build_model_config(jt, len(jtok))
        tcfg = tstages.build_model_config(tt_, len(jtok))
        want = jstages.resolve_warm_start(jt, jcfg, {})  # the HF mode ignores the init
        got = tstages.resolve_warm_start(tt_, tcfg, tstages.init_variables(tt_, tcfg))
        _equal_to_jax_export(got, want)
        assert (got.config.lora is not None) == lora
        jmask = joptim.mask_for_stage(want["params"], "gt_prompt")
        tmask = toptim.mask_for_stage(dict(got.named_parameters()), "gt_prompt")
        n_true = sum(int(np.prod(np.shape(x))) for x, m in zip(
            jax.tree_util.tree_leaves(want["params"]), jax.tree_util.tree_leaves(jmask)) if m)
        assert sum(p.numel() for n, p in got.named_parameters() if tmask[n]) == n_true
        assert (n_true > 0) == lora
    # a LoRA checkpoint for a variant without LoRA is refused
    _, t = both(tree, "trap", variant="multi", warm_start_name=exports["longitudinal"][0])
    cfg = tstages.build_model_config(t, 300)
    with pytest.raises(ValueError, match="LoRA"):
        tstages.resolve_warm_start(t, cfg, tstages.init_variables(t, cfg))


# ---------------------------------------------------------------------- decode
def test_decode_step_outputs_equal_jax(tree, exports):
    """Longitudinal, beam-4, three studies padded to four rows, one without a
    previous report: the same token ids and sections as the JAX package's
    _decode_step_outputs."""
    from cxrmate_torch.models.encoder_decoder import EncoderDecoder

    name, variables = exports["longitudinal"]
    jt, tt_ = both(tree, "decode", variant="gt_prompt")
    jtok, ttok = jstages.load_tokenizer(jt), tstages.load_tokenizer(tt_)
    jcfg = jstages.build_model_config(jt, len(jtok))
    model = tstages.resolve_warm_start(
        dataclasses.replace(tt_, warm_start_name=name), tstages.build_model_config(tt_, len(ttok)),
        EncoderDecoder(tstages.build_model_config(tt_, len(ttok)), device="cpu"))
    rs = np.random.RandomState(5)
    images = rs.randn(3, 2, 3, 64, 64).astype(np.float32)
    images[1, 1] = 0.0
    batch = {"images": images,
             "previous_findings": ["the heart size is normal", None, "small left effusion"],
             "previous_impression": ["no acute disease", None, "stable appearance"]}
    got = tstages._decode_step_outputs(tt_, model.config, ttok, model, batch, 4, pad_rows=4)
    want = jstages._decode_step_outputs(jt, jcfg, jtok, variables, batch, 4, pad_rows=4)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert list(got[1]) == list(want[1]) and list(got[2]) == list(want[2])
    assert got[0].shape[0] == 3


# --------------------------------------------------------------- stages (port)
def _write_config(tree, name: str, **kw) -> str:
    path = os.path.join(tree["root"], f"{name}.yaml")
    fields = task_kwargs(tree, name, **kw)
    with open(path, "w") as f:
        for k, v in fields.items():
            f.write(f"{k}: {json.dumps(v) if not isinstance(v, str) else v}\n")
    return path


def _ids_csv(task) -> dict:
    (path,) = glob.glob(os.path.join(task.exp_dir_trial, "generated_report_ids", "*.csv"))
    with open(path) as f:
        return {int(r["study_id"]): json.loads(r["report_ids"]) for r in csv.DictReader(f)}


def test_fit_then_test_through_main(tree):
    """--train --test through main on the CPU: the checkpoint tree reads with
    the JAX package's selection functions, metrics.jsonl has the JAX
    package's keys, and the test CSV's token ids are the port's
    _decode_step_outputs on the same batches from the best checkpoint."""
    from cxrmate_tpu.ckpt import orbax_io
    from cxrmate_torch.data.pipeline import batch_iterator

    cfg = _write_config(tree, "main", variant="multi", image_cache_dir="auto")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # no CheXbert/roberta in the zoo
        tstages.main(["--config", cfg, "--train", "--test", "device=cpu"])
    task = tconfig.parse_args(["--config", cfg, "device=cpu"])
    last = orbax_io.last_checkpoint(task.exp_dir_trial)
    assert orbax_io.checkpoint_resume_info(last) == ck.checkpoint_resume_info(last)
    assert orbax_io.checkpoint_resume_info(last)["epoch"] == 0
    best = orbax_io.get_test_ckpt_path(task.exp_dir_trial, "max")
    assert best == ck.get_test_ckpt_path(task.exp_dir_trial, "max")
    assert "val_report_nlg_bleu_1=" in best
    assert os.listdir(os.path.join(task.exp_dir, ".image_cache"))

    # metrics.jsonl: the JAX package's keys for the same metric set
    jt, _ = both(tree, "main_keys", variant="multi")
    jm = jstages.make_metrics(jt, "val")
    for m in jm.values():
        m.update(["a b"], [["a c"]], study_ids=[1])
    jkeys = {f"{n}_{k}" for n, m in jm.items() for k in m.compute(0)}
    with open(os.path.join(task.exp_dir_trial, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert set(lines[0]) == {"epoch", "step", "train_loss"}
    assert np.isfinite(lines[0]["train_loss"])
    assert set(lines[-1]) == {"epoch"} | jkeys

    # the CSV's ids: the best checkpoint through _decode_step_outputs
    tok = tstages.load_tokenizer(task)
    config = tstages.build_model_config(task, len(tok))
    model = ck.restore_model(best, tstages.init_variables(task, config))
    ds = tstages.make_datasets(task, "test", train=False)
    rows = min(task.eval_decode_rows // task.num_test_beams, len(ds))
    want = {}
    for batch in batch_iterator(ds, rows, sort_key=ds.image_counts()):
        seqs, _, _ = tstages._decode_step_outputs(task, config, tok, model, batch,
                                                  task.num_test_beams, pad_rows=rows)
        want.update({int(s): list(map(int, r)) for s, r in zip(batch["study_ids"], seqs)})
    assert _ids_csv(task) == want


class _Interrupt(Exception):
    pass


def _interrupt_after_mid_epoch_save(monkeypatch):
    real = ck.save_checkpoint

    def wrapper(*a, **kw):
        out = real(*a, **kw)
        if kw.get("step") is not None:
            raise _Interrupt
        return out

    monkeypatch.setattr(ck, "save_checkpoint", wrapper)
    return real


def _assert_same_state(a_dir: str, b_dir: str) -> None:
    a = torch.load(os.path.join(a_dir, ck.STATE_FILE), weights_only=True)
    b = torch.load(os.path.join(b_dir, ck.STATE_FILE), weights_only=True)

    def flat(x, prefix=""):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from flat(v, f"{prefix}{k}/")
        else:
            yield prefix, x

    fa, fb = dict(flat(a)), dict(flat(b))
    assert list(fa) == list(fb)
    for k in fa:
        if torch.is_tensor(fa[k]):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


@pytest.mark.parametrize("variant", ["multi", "scst"])
def test_mid_epoch_resume_is_bit_equal(tree, monkeypatch, variant):
    """fit (multi; AdamW accumulating over 3, the save mid-accumulation) and
    fit_scst (scst: generated prompts, the history sidecar), cut right after
    their mid-epoch checkpoint and resumed with resume_last: the final state
    equals the uninterrupted run's bit for bit."""
    if variant == "scst":
        common = dict(variant="scst", mbatch_size=1, accumulated_mbatch_size=1,
                      val_check_interval=0.5, trial=12)
        reward = tstages.build_cxrbert_reward(both(tree, "r")[1])

        def run(task):
            tstages.fit_scst(task, reward)
    else:
        common = dict(variant="multi", mbatch_size=1, accumulated_mbatch_size=3,
                      val_check_interval=0.5)

        def run(task):
            tstages.fit(task)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _, gold = both(tree, f"resume_gold_{variant}", **common)
        run(gold)
        _, crash = both(tree, f"resume_crash_{variant}", **common)
        real = _interrupt_after_mid_epoch_save(monkeypatch)
        with pytest.raises(_Interrupt):
            run(crash)
        monkeypatch.setattr(ck, "save_checkpoint", real)
        last = ck.last_checkpoint(crash.exp_dir_trial)
        info = ck.checkpoint_resume_info(last)
        assert info["step"] is not None and info["n_batches"] == 2
        assert info["mbatch_size"] == 1 and info["world_size"] == 1
        if variant == "scst":
            assert ck.checkpoint_extra_file(last, "scst_history.rank0.json") is not None
        bad = dataclasses.replace(crash, resume_last=True, mbatch_size=2)
        with pytest.raises(ValueError, match="mbatch_size"):
            tstages._resolve_fit_resume(bad, state=None)
        run(dataclasses.replace(crash, resume_last=True))
    _assert_same_state(ck.last_checkpoint(gold.exp_dir_trial),
                       ck.last_checkpoint(crash.exp_dir_trial))


def test_main_refuses_what_the_port_does_not_run(tree, monkeypatch):
    """gen_prompt training (test-only, as in JAX), a model axis that does not
    divide the process group (mesh_model=2 in one process), a mesh_data
    other than the world size (one rank per card), and WORLD_SIZE=2 without
    a reachable rendezvous: the group's failure raises, and nothing trains
    alone."""
    cfg = _write_config(tree, "refuse", variant="gen_prompt")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.raises(ValueError, match="test-only"):
            tstages.main(["--config", cfg, "--train", "device=cpu"])
        with pytest.raises(ValueError, match="mesh_model=2 does not divide the process group's 1"):
            tstages.main(["--config", cfg, "--test", "device=cpu", "mesh_model=2"])
        with pytest.raises(ValueError, match="mesh_data=2 but the process group has 1"):
            tstages.main(["--config", cfg, "--test", "device=cpu", "mesh_data=2"])
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("RANK", "0")
        monkeypatch.delenv("MASTER_ADDR", raising=False)
        cfg = _write_config(tree, "refuse_alone", variant="multi")
        with pytest.raises(ValueError, match="MASTER_ADDR"):
            tstages.main(["--config", cfg, "--train", "device=cpu"])
    assert not os.path.exists(tconfig.parse_args(["--config", cfg]).exp_dir)
    assert not torch.distributed.is_initialized()


def test_module_help_exits_zero():
    out = subprocess.run([sys.executable, "-m", "cxrmate_torch.cli.stages", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert "--config" in out.stdout and "--train" in out.stdout
