"""Tensor parallelism in the port: the JAX mesh's ``model`` axis.

In process: the port's sharding table (``parallel.mesh.shard_dim``) against
the JAX package's ``variables_specs(variables, tp=True)`` after
``_feasible_spec``, mapped to the HF names and torch's layout (a JAX ``w``
``[in, out]`` is a torch ``weight`` ``[out, in]``); the shard -> gather round
trip; the rank grid of worlds 4 and 8; the layouts that do not divide.

One launch of two gloo ranks on the CPU at mesh 1x2
(``parallel.multihost.launch_ranks`` of this file, ``tests/
test_torch_tensor_parallel.py SPEC``; it imports no JAX and runs torch at one
thread a rank), against the same work in this process at 1x1:

  * the harness's tiny model (vocabulary 96, 4 heads, intermediate 64:
    everything splits 2 ways; weights from ``np.random.RandomState``, read
    by JAX through its own ``convert_encoder_decoder``): an fp32 micro-step
    of a 4-study batch with dropout off (its loss also held against JAX's
    forward) and on (the same generator), a LoRA-only micro-step of the
    longitudinal model with dropout on, and greedy and beam-2 decodes (the
    greedy tokens also held against JAX's argmax);
  * the CLI (``cli.stages.main``) on the tiny preset (vocabulary 154, 2
    heads, intermediate 32) with ``mesh_model=2``, fp32: a multi fit of
    one AdamW update, a beam-2 test of its checkpoint, and an SCST step
    with the synthetic CXR-BERT reward.

Tolerances: losses rtol 1e-6 against one process (fp32; the only
difference is the order of the reductions over two ranks), rel 2e-5
against JAX (``tests/test_train.py:170``); gradients gathered over the
model group within 1e-5 of each tensor's largest |g|, with a floor of
1e-9 (``ROADMAP.md`` "Traps": some gradients are rounding in both runs);
token ids and report CSVs equal; AdamW's first moments of the checkpoints
within 1e-4 of each part's norm, and the parameters within 2 lr (Adam's
first step is about lr * sign(g)); SCST's loss rtol 1e-5, its reward and
baseline 1e-6.
"""

from __future__ import annotations

import csv
import dataclasses
import glob
import json
import os
import sys
import threading
import types
import warnings

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a rank's program from tests/
    sys.path.insert(0, REPO)

from cxrmate_torch.ckpt import checkpoints as ck  # noqa: E402
from cxrmate_torch.ckpt import hf  # noqa: E402
from cxrmate_torch.cli import stages  # noqa: E402
from cxrmate_torch.cli.config import TaskConfig, parse_args  # noqa: E402
from cxrmate_torch.generate.beam import beam_search  # noqa: E402
from cxrmate_torch.generate.decode import GenerationConfig, generate  # noqa: E402
from cxrmate_torch.models import encoder_decoder as ed  # noqa: E402
from cxrmate_torch.parallel import mesh  # noqa: E402
from cxrmate_torch.parallel import multihost  # noqa: E402
from cxrmate_torch.parallel.dryrun import model_axis  # noqa: E402
from cxrmate_torch.train import optim  # noqa: E402
from cxrmate_torch.train import tf_trainer as tt  # noqa: E402
from cxrmate_torch.utils import dist  # noqa: E402

# two threads, as tests/test_torch_harness.py sets them: the ranks take a
# core each, and idle threads of a larger pool spin against them
torch.set_num_threads(2)

PAD, BOS, EOS, SEP = 4, 1, 2, 3
VOCAB = 96  # splits 2 and 4 ways
ROWS = 4  # the micro-steps' batch
NEW_TOKENS = 10
MODEL = 2  # the launch's model axis


# ------------------------------------------------------------ the work
def micro_batch(seed: int = 11) -> dict:
    """Four studies of two image slots, reports of 10 tokens with pads and
    padded labels (as tests/test_torch_multiprocess.py's)."""
    rs = np.random.RandomState(seed)
    b, l = ROWS, 10
    mask = np.ones((b, l), np.int32)
    mask[1, 7:] = 0
    mask[3, 5:] = 0
    ids = np.where(mask == 1, rs.randint(6, VOCAB, (b, l)), PAD).astype(np.int32)
    labels = np.where((rs.rand(b, l) < 0.2) | (mask == 0), PAD,
                      rs.randint(6, VOCAB, (b, l))).astype(np.int32)
    px = rs.randn(b, 2, 3, 32, 32).astype(np.float32)
    px[2, 1] = 0.0
    return {"pixel_values": px, "decoder_input_ids": ids, "decoder_attention_mask": mask,
            "decoder_token_type_ids": np.repeat((np.arange(l) > 4)[None], b, 0).astype(np.int32),
            "decoder_position_ids": np.repeat(np.arange(l)[None], b, 0).astype(np.int32),
            "label_ids": labels}


def micro_step(model, batch, dropout: bool, stage: str = "multi", trial: int = 3):
    """One fp32 micro-step of the whole batch: the loss and the gradients of
    ``stage``'s trainable parameters, gathered over the model group (the
    identity at 1x1). Dropout (and BatchNorm's global moments) through the
    stages' own generator: a RowStripe over every row."""
    gen = (tt.train_generator(trial, 0, device="cpu", row_range=(0, ROWS)) if dropout
           else tt.RowStripe(None, 0, ROWS, ROWS))
    mask = optim.mask_for_stage(dict(model.named_parameters()), stage)
    loss, grads = tt.all_reduce_loss_and_grads(
        *tt.loss_and_grads(model, batch, gen, pad_id=PAD, trainable_mask=mask))
    return float(loss), ck.gather_shards(grads, model)


def decode_ids(model, pixels) -> dict:
    """Greedy and beam-2 token ids of the multi model."""
    with torch.no_grad():
        hidden, enc_mask = ed.encode_images(model, torch.from_numpy(pixels))
    b = pixels.shape[0]
    prompt = torch.full((b, 1), BOS, dtype=torch.int32)
    ones = torch.ones(b, 1, dtype=torch.int32)
    cfg = GenerationConfig(max_new_tokens=NEW_TOKENS, bos_token_id=BOS, eos_token_id=EOS,
                           pad_token_id=PAD, special_token_ids=(SEP,))
    greedy = generate(model, cfg, hidden, enc_mask, prompt, ones)
    beam, _ = beam_search(model, dataclasses.replace(cfg, num_beams=2), hidden, enc_mask,
                          prompt, ones)
    return {"greedy": greedy.numpy(), "beam2": beam.numpy()}


def function_runs(models: dict, batch: dict) -> dict:
    """The function-level work on ``models`` ({"multi", "longitudinal"}:
    whole, or already cut to this rank's shard)."""
    out = {"fp32": micro_step(models["multi"], batch, dropout=False),
           "dropout": micro_step(models["multi"], batch, dropout=True),
           "gt_prompt": micro_step(models["longitudinal"], batch, dropout=True,
                                   stage="gt_prompt")}
    out.update(decode_ids(models["multi"], batch["pixel_values"][:, :1]))
    return out


def cli_runs(root: str, tag: str, extra=()) -> dict:
    """The CLI's argv lists of the launch (``extra``: ``mesh_model=2``), by
    name."""
    common = [f"dataset_dir={root}/datasets", f"ckpt_zoo_dir={root}/checkpoints",
              "device=cpu", "model_preset=tiny", "image_size=32", "decoder_max_len=16",
              "max_images_per_study=1", "monitor=val_report_nlg_bleu_1", "num_workers=0",
              "image_cache_dir=null", "precision=32", "static_tf_pad=true",
              "pad_images=max"] + list(extra)
    fit_dir = f"{root}/{tag}_fit"
    return {
        "fit": ["--config", f"{REPO}/config/train/multi_tf.yaml", "--train", "max_epochs=1",
                "mbatch_size=4", "accumulated_mbatch_size=8", f"exp_dir={fit_dir}"] + common,
        "test": ["--config", f"{REPO}/config/test/multi_tf.yaml", "--test", "test_ckpt_name=null",
                 "num_test_beams=2", "mbatch_size=2", f"exp_dir={root}/{tag}_test",
                 f"test_ckpt_path={fit_dir}/mimic_cxr/multi/trial_0/checkpoints/last"] + common,
        "scst": ["--config", f"{REPO}/config/train/longitudinal_gen_prompt_cxr-bert.yaml",
                 "--train", "warm_start_name=null", "fast_dev_run=true", "mbatch_size=2",
                 "accumulated_mbatch_size=2", "val_check_interval=1.0",
                 f"exp_dir={root}/{tag}_scst"] + common,
    }


def run_cli(argvs: dict) -> None:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for argv in argvs.values():
            stages.main(argv)


def random_state(variant: str, seed: int = 0) -> dict:
    """The harness's tiny model (``tests/test_torch_harness.torch_config``
    at VOCAB) as an HF-layout state dict of numpy arrays: every weight
    N(0, 0.02), biases, norm parameters and LoRA's B perturbed about their
    init by N(0, 0.05), BatchNorm statistics random (as the harness
    randomises them)."""
    from cxrmate_torch.models.encoder_decoder import EncoderDecoder

    rs = np.random.RandomState(seed)
    model = EncoderDecoder(config(variant), device="cpu", dtype=torch.float32)
    out = {}
    for k, v in model.state_dict().items():
        leaf = k.rsplit(".", 1)[-1]
        if k.endswith("num_batches_tracked"):
            x = np.zeros((), np.int64)
        elif leaf == "running_mean":
            x = rs.normal(0.0, 0.02, v.shape)
        elif leaf == "running_var":
            x = rs.uniform(0.8, 1.2, v.shape)
        elif any(n in k for n in ("LayerNorm", "layer_norm", "normalization")):
            x = (leaf == "weight") + rs.normal(0.0, 0.05, v.shape)
        elif leaf == "bias" or ".lora_B." in k:
            x = rs.normal(0.0, 0.05, v.shape)
        else:
            x = rs.normal(0.0, 0.02, v.shape)
        out[k] = np.asarray(x, np.int64 if k.endswith("num_batches_tracked") else np.float32)
    return hf.export_state_dict({k: torch.from_numpy(v) for k, v in out.items()})


def config(variant: str):
    """The harness's tiny configuration at VOCAB (tests/test_torch_harness.py
    ``torch_config``, written out: the rank imports nothing of JAX)."""
    from cxrmate_torch import configs as tcfg

    return tcfg.EncoderDecoderConfig(
        encoder=tcfg.CvtConfig(embed_dim=(16, 24, 40), num_heads=(1, 2, 4), depth=(1, 2, 3),
                               drop_path_rate=(0.0, 0.0, 0.0), projection_size=32),
        decoder=tcfg.BertDecoderConfig(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
                                       num_attention_heads=4, intermediate_size=64,
                                       max_position_embeddings=96, type_vocab_size=2,
                                       pad_token_id=PAD, cross_attention_hidden_size=32),
        variant=variant, image_size=64,
        lora=tcfg.LoraConfig(r=8, alpha=32.0) if variant == "longitudinal" else None)


def load_models(blob: dict) -> dict:
    from cxrmate_torch.models.encoder_decoder import EncoderDecoder

    out = {}
    for name in ("multi", "longitudinal"):
        model = EncoderDecoder(config(name), device="cpu", dtype=torch.float32)
        hf.load_model_state(model, blob[name])
        out[name] = model
    return out


# ------------------------------------------------------------------ a rank
def rank_main(spec_path: str) -> None:
    """One rank of the launch: the function-level work at mesh 1x2, then the
    CLI runs with ``mesh_model=2``."""
    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    with open(spec_path) as f:
        spec = json.load(f)
    assert multihost.initialize_if_needed("cpu") and dist.world_size() == MODEL
    rank = dist.rank()
    try:
        mesh.make_mesh(None, MODEL)
        blob = torch.load(spec["input"], weights_only=False)
        models = {k: mesh.shard_model(m) for k, m in load_models(blob).items()}
        out = function_runs(models, blob["batch"])
        out["heads"] = {k: m.decoder.tp is not None and m.decoder.tp.heads
                        for k, m in models.items()}
        out["rank_grid"] = (dist.data_rank(), dist.data_size(), dist.model_rank(),
                            dist.model_size())
        torch.save(out, os.path.join(spec["root"], f"rank{rank}.pt"))
        run_cli(cli_runs(spec["root"], "tp", [f"mesh_model={MODEL}"]))
    finally:
        torch.distributed.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)


# ------------------------------------------------------------------ fixture
def _in_thread(fn):
    box = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised by join()
            box["error"] = e

    thread = threading.Thread(target=target, daemon=True)
    thread.start()

    def join():
        thread.join(timeout=300)
        if thread.is_alive():
            raise TimeoutError("the launch of the ranks is still running after 300 s")
        if "error" in box:
            raise box["error"]
        return box["value"]

    return join


def jax_reference(state: dict, batch: dict, ids: np.ndarray) -> dict:
    """The multi model (the HF-layout ``state``, read by JAX's
    ``convert_encoder_decoder``) in one jitted JAX call: the loss of the
    batch in train mode with rng None (BatchNorm's batch moments, no
    dropout), and the argmax at every column of an eval-mode forward of the
    greedy sequences ``ids``."""
    import jax
    import jax.numpy as jnp

    from cxrmate_tpu.ckpt.hf_convert import convert_encoder_decoder
    from cxrmate_tpu.models import encoder_decoder as jed
    from cxrmate_tpu.train.tf_trainer import cross_entropy_ignore_pad
    from tests.test_torch_harness import jax_config

    cfg = jax_config(VOCAB)
    variables = convert_encoder_decoder(state, cfg.encoder, cfg.decoder)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "decoder_position_ids"}

    def run(v, px, x):
        logits, _ = jed.forward(
            v, jb["pixel_values"], jb["decoder_input_ids"], cfg,
            decoder_attention_mask=jb["decoder_attention_mask"],
            decoder_token_type_ids=jb["decoder_token_type_ids"], train=True, rng=None)
        greedy, _ = jed.forward(v, px, x, cfg, decoder_attention_mask=jnp.ones_like(x),
                                decoder_token_type_ids=jed.token_ids_to_token_type_ids(x, (SEP,)))
        return cross_entropy_ignore_pad(logits, jb["label_ids"], PAD), jnp.argmax(greedy, -1)

    loss, argmax = jax.jit(run)(variables, jnp.asarray(batch["pixel_values"][:, :1]),
                                jnp.asarray(ids))
    return {"loss": float(loss), "argmax": np.asarray(argmax)}


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    from cxrmate_torch.data.synthetic import build_synthetic_cxrbert, build_synthetic_dataset

    root = str(tmp_path_factory.mktemp("tp"))
    paths = build_synthetic_dataset(root, n_train=8, n_val=4, n_test=4, studies_per_subject=2)
    build_synthetic_cxrbert(paths["ckpt_zoo_dir"])
    batch = micro_batch()
    blob = {"batch": batch, **{name: random_state(name, seed)
                               for seed, name in enumerate(("multi", "longitudinal"))}}
    torch.save(blob, os.path.join(root, "input.pt"))
    spec = os.path.join(root, "spec.json")
    with open(spec, "w") as f:
        json.dump({"root": root, "input": os.path.join(root, "input.pt")}, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    spawn = _in_thread(lambda: multihost.launch_ranks(
        MODEL, [os.path.abspath(__file__), spec], timeout=240, env=env, cwd=REPO))

    # the same work in one process, while the ranks run
    one = function_runs(load_models(blob), batch)
    run_cli(cli_runs(root, "one"))
    jax_ref = jax_reference(blob["multi"], batch, one["greedy"])
    out = spawn()
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(MODEL)]
    return {"root": root, "one": one, "ranks": ranks, "jax": jax_ref, "out": out}


# ------------------------------------------------------------- in process
def _marker(x, spec) -> np.ndarray:
    """An array of x's shape that varies only along the axis ``spec``
    splits over ``model`` (zeros where it splits none)."""
    out = np.zeros(x.shape, np.float32)
    for axis, name in enumerate(spec):
        if name == "model":
            shape = [1] * out.ndim
            shape[axis] = out.shape[axis]
            out = out + np.arange(out.shape[axis], dtype=np.float32).reshape(shape)
    return out


def _varying_axis(a: np.ndarray):
    axes = [i for i in range(a.ndim) if a.shape[i] > 1 and not np.all(
        a == np.take(a, [0], axis=i))]
    assert len(axes) <= 1, axes
    return axes[0] if axes else None


TABLE_CASES = {
    "vocab97-model2": (97, "multi", None, 2),
    "vocab97-model4": (97, "multi", None, 4),
    "lora-vocab96-model2": (96, "longitudinal", None, 2),
    "lora-vocab96-model4": (96, "longitudinal", None, 4),
    "cli-tiny-model4": (154, "longitudinal", "tiny", 4),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_sharding_table_equals_jax(case):
    """Every decoder tensor's split dimension (and whether it splits): the
    port's ``shard_dim`` equals JAX's ``variables_specs`` after
    ``_feasible_spec``, through the export's names and transposes. The one
    stated deviation, heads that do not split (the tiny preset's 2 heads at
    model 4): the port keeps that attention whole, JAX cuts its width."""
    import jax

    from cxrmate_tpu import configs as jcfg
    from cxrmate_tpu.models.bert import init_bert_params
    from cxrmate_tpu.parallel.mesh import _feasible_spec, variables_specs
    from tests.oracles import small_bert_cfg_dataclass

    vocab, variant, preset, model = TABLE_CASES[case]
    if preset == "tiny":
        tcfg = stages.build_model_config(TaskConfig(variant="gt_prompt", model_preset="tiny",
                                                    decoder_max_len=24), vocab)
        jdec = jcfg.BertDecoderConfig(**dataclasses.asdict(tcfg.decoder))
    else:
        jdec = small_bert_cfg_dataclass(vocab)
        tcfg = types.SimpleNamespace(decoder=stages.model_configs.BertDecoderConfig(
            **dataclasses.asdict(jdec)))
    lora = jcfg.LoraConfig(r=8, alpha=32.0) if variant == "longitudinal" else None
    dec = jax.eval_shape(lambda: init_bert_params(jax.random.PRNGKey(0), jdec, lora=lora))
    variables = {"params": {"encoder": {}, "decoder": dec}, "batch_stats": {}}
    specs = variables_specs(variables, tp=True)
    fake_mesh = types.SimpleNamespace(shape={"data": 1, "model": model})
    marked = jax.tree_util.tree_map(
        lambda x, s: _marker(x, _feasible_spec(x, s, fake_mesh)), variables, specs)
    exported = hf.state_dict_from_jax(marked, None, jdec)
    want = {k: _varying_axis(v) for k, v in exported.items()}
    got = {k: mesh.shard_dim(k, tcfg.decoder, model) for k in exported}
    differ = {k for k in want if want[k] != got[k]}
    if tcfg.decoder.num_attention_heads % model:
        attention = {k for k in want if (".attention.self." in k or ".crossattention.self." in k
                                         or ".output.dense.weight" in k and "attention" in k)
                     and "lora_A" not in k and want[k] is not None}
        assert attention and differ == attention
        assert all(got[k] is None for k in differ)
    else:
        assert not differ, {k: (want[k], got[k]) for k in differ}
    assert any(v is not None for v in got.values())
    # a LoRA decoder's keys carry PEFT's prefix in the export, the port's not
    assert (lora is not None) == any("base_model" in k for k in exported)


def _fresh(config) -> torch.nn.Module:
    from cxrmate_torch.models.api import _fill_random

    model = ed.EncoderDecoder(config, device="cpu", dtype=torch.float32)
    _fill_random(model, torch.Generator().manual_seed(0))
    return model


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("model", [2, 4])
def test_shard_then_gather_is_bit_equal(model, tied):
    """Every model rank's shard of a whole state dict, gathered, is that
    state dict bit for bit, for the model's own names and for a released
    checkpoint's (PEFT names, the head's bias alias, numpy leaves); each
    split key's shard is 1 / model of it."""
    cfg = stages.build_model_config(TaskConfig(variant="gt_prompt", model_preset="tiny",
                                               decoder_max_len=24), 96)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                               tie_word_embeddings=tied))
    sd = _fresh(cfg).state_dict()
    for whole in (sd, hf.export_state_dict(sd)):
        shards = [hf.shard_state_dict(whole, r, model, cfg.decoder) for r in range(model)]
        back = hf.gather_state_dict(shards, cfg.decoder)
        assert list(back) == list(whole)
        split = 0
        for k, v in whole.items():
            b = back[k]
            assert (torch.equal(b, v) if torch.is_tensor(v)
                    else np.array_equal(b, v) and b.dtype == v.dtype), k
            dim = mesh.shard_dim(k, cfg.decoder, model)
            if dim is not None:
                split += 1
                assert shards[1][k].shape[dim] * model == v.shape[dim], k
        assert split > 0


def test_shard_model_cuts_each_parameter_to_its_slice(monkeypatch):
    """``shard_model`` on model rank 1 of 2: each split parameter is its
    slice of the whole (a new tensor; the rest untouched), the decoder
    marked with what splits, and the tied head still the embedding."""
    cfg = stages.build_model_config(TaskConfig(variant="gt_prompt", model_preset="tiny",
                                               decoder_max_len=24), 154)
    model = _fresh(cfg)
    whole = {k: v.clone() for k, v in model.state_dict().items()}
    monkeypatch.setattr(dist, "mesh", lambda: dist.Mesh(1, 2, 0, 1, None, "group"))
    mesh.shard_model(model)
    want = hf.shard_state_dict(whole, 1, 2, cfg.decoder)
    got = model.state_dict()
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert any(got[k].shape != whole[k].shape for k in got)
    tp_ = model.decoder.tp
    assert (tp_.rank, tp_.size, tp_.group, tp_.vocab, tp_.heads, tp_.ffn) == (
        1, 2, "group", True, True, True)
    assert not hasattr(model.decoder.cls.predictions, "decoder")


@pytest.mark.parametrize("world, model", [(4, 1), (4, 2), (4, 4), (8, 2), (8, 4), (8, 8)])
def test_rank_grid(world, model):
    """Rank ``d * model + m``: consecutive ranks form a model group, ranks
    with the same ``m`` a data group; every rank in exactly one of each."""
    model_groups, data_groups = dist.grid(world, model)
    assert len(model_groups) == world // model and len(data_groups) == model
    for r in range(world):
        d, m = divmod(r, model)
        assert model_groups[d] == list(range(d * model, (d + 1) * model))
        assert data_groups[m] == list(range(m, world, model))
        assert sum(r in g for g in model_groups) == sum(r in g for g in data_groups) == 1


@pytest.mark.parametrize("world, data, model, ok", [
    (1, None, 2, False), (4, None, 3, False), (4, 4, 2, False), (4, None, 2, True),
    (4, 2, 2, True), (8, 2, 4, True), (8, None, 8, True), (2, 1, 1, False)])
def test_validate_mesh(monkeypatch, world, data, model, ok):
    """A model axis that divides the world and a data axis unset or
    world / model pass; the rest raise ``ValueError`` naming the numbers."""
    monkeypatch.setattr(dist, "world_size", lambda: world)
    if ok:
        mesh.validate_mesh(data, model)
    else:
        with pytest.raises(ValueError, match=f"mesh_(model|data)={model if world % model else data}"):
            mesh.validate_mesh(data, model)


def test_operators_are_the_identity_without_a_group():
    x = torch.ones(2, 3, requires_grad=True)
    for op in (dist.copy_to_group, dist.reduce_from_group, dist.gather_from_group):
        assert op(x, None) is x
    assert dist.mesh() == dist.Mesh(1, 1, 0, 0)
    assert (dist.data_group(), dist.model_group()) == (None, None)


def test_fused_decode_refuses_a_shard():
    """``generate(use_fused=True)`` on a decoder cut to a shard raises: the
    fused kernels take a whole layer."""
    from cxrmate_torch.generate.decode import GenerationConfig as G

    model = _fresh(config("multi"))
    model.decoder.tp = mesh.Shard(0, 2, None, False, False, False)
    with pytest.raises(NotImplementedError, match="whole layer"):
        generate(model, G(max_new_tokens=2), torch.zeros(1, 3, 32), torch.ones(1, 3),
                 torch.ones(1, 1, dtype=torch.int32), torch.ones(1, 1, dtype=torch.int32),
                 use_fused=True)


@pytest.mark.parametrize("world, model", [(1, 1), (2, 1), (4, 4), (6, 1), (8, 4), (16, 4)])
def test_dryrun_model_axis(world, model):
    """As ``__graft_entry__.py`` picks it: 4 where 4 divides the ranks."""
    assert model_axis(world) == model


# ------------------------------------------------------------- the launch
def test_ranks_reported_ok_on_a_1x2_grid(tp):
    assert all(f"RANK_OK {r}" in tp["out"] for r in range(MODEL))
    for r, rank in enumerate(tp["ranks"]):
        assert rank["rank_grid"] == (0, 1, r, MODEL)
        assert rank["heads"] == {"multi": True, "longitudinal": True}


def _close_grads(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for name, g in got.items():
        w = want[name].numpy() if torch.is_tensor(want[name]) else want[name]
        atol = 1e-5 * float(np.abs(w).max()) + 1e-9
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("name", ["fp32", "dropout", "gt_prompt"])
def test_micro_step_matches_one_process(tp, name):
    """The loss and the gradients gathered over the model group: dropout
    off, dropout on (hidden, attention-probs and LoRA-input draws of the
    one-process shape), and the LoRA-only step, whose lora_A gradient is
    whole only through the copy operator on the rank-r product. Both ranks
    hold the same loss and gradients."""
    loss, grads = tp["one"][name]
    for rank in tp["ranks"]:
        r_loss, r_grads = rank[name]
        np.testing.assert_allclose(r_loss, loss, rtol=1e-6)
        _close_grads(r_grads, grads)
    if name == "gt_prompt":
        assert all(".lora_" in k for k in grads) and any("lora_A" in k for k in grads)
    for k in grads:
        assert torch.equal(tp["ranks"][0][name][1][k], tp["ranks"][1][name][1][k]), k


def test_micro_step_loss_matches_jax(tp):
    """The 1x2 fp32 micro-step's loss (dropout off, BatchNorm in train mode)
    against JAX's single-device forward of the same batch, rel 2e-5
    (tests/test_train.py:170); both ranks hold it."""
    for rank in tp["ranks"]:
        assert rank["fp32"][0] == pytest.approx(tp["jax"]["loss"], rel=2e-5)


@pytest.mark.parametrize("mode", ["greedy", "beam2"])
def test_decode_matches_one_process(tp, mode):
    """Token ids at 1x2 (this rank's heads in the caches and the decode
    kernels' wrappers, the gathered logits choosing) equal one process's,
    on both ranks."""
    for rank in tp["ranks"]:
        np.testing.assert_array_equal(rank[mode], tp["one"][mode])


def test_greedy_tokens_are_jax_argmax(tp):
    """Each 1x2 greedy token, up to its row's EOS, is JAX's argmax given the
    same prefix (one JAX forward of the decoded rows): JAX's greedy decode,
    token by token."""
    ids, argmax = tp["ranks"][0]["greedy"], tp["jax"]["argmax"]
    checked = 0
    for row, best in zip(ids, argmax):
        for col in range(1, ids.shape[1]):
            assert row[col] == best[col - 1], (row, col)
            checked += 1
            if row[col] == EOS:
                break
    assert checked >= ids.shape[0]


def _metrics(argv) -> list:
    task = parse_args(argv)
    with open(os.path.join(task.exp_dir_trial, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _state(argv) -> dict:
    path = ck.last_checkpoint(parse_args(argv).exp_dir_trial)
    return torch.load(os.path.join(path, ck.STATE_FILE), weights_only=True)


def _close_checkpoints(got: dict, want: dict, lr: float) -> None:
    """One AdamW update of two runs: the first moments within 1e-4 of each
    part's norm (encoder, decoder), the parameters within 2 lr."""
    assert got["opt_state"]["count"] == want["opt_state"]["count"] == 1
    assert list(got["model"]) == list(want["model"])
    mu_a, mu_b = got["opt_state"]["mu"], want["opt_state"]["mu"]
    assert list(mu_a) == list(mu_b)
    for part in ("encoder.", "decoder."):
        keys = [k for k in mu_b if k.startswith(part)]
        if keys:
            diff = sum(float((mu_a[k] - mu_b[k]).double().square().sum()) for k in keys)
            norm = sum(float(mu_b[k].double().square().sum()) for k in keys)
            assert diff <= (1e-4) ** 2 * norm, (part, diff, norm)
    for k, v in want["model"].items():
        assert got["model"][k].shape == v.shape, k
        if v.is_floating_point():
            assert float((got["model"][k] - v).abs().max()) <= 2 * lr, k


def test_cli_fit_matches_one_process(tp):
    """``cli.stages.main --train mesh_model=2`` (multi, dropout on, one AdamW
    update over two micro-steps): the logged losses, the validation scores,
    and rank 0's checkpoint, gathered whole, against one process's."""
    tp_fit, one_fit = cli_runs(tp["root"], "tp")["fit"], cli_runs(tp["root"], "one")["fit"]
    got, want = _metrics(tp_fit), _metrics(one_fit)
    losses = [[r["train_loss"] for r in x if "train_loss" in r] for x in (got, want)]
    assert len(losses[0]) == len(losses[1]) >= 1
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
    val = [[r for r in x if "train_loss" not in r] for x in (got, want)]
    assert len(val[0]) == len(val[1]) == 1
    for k, v in val[1][0].items():
        assert val[0][0][k] == pytest.approx(v, rel=1e-4), k
    _close_checkpoints(_state(tp_fit), _state(one_fit), TaskConfig().lr)


def _rows(argv, subdir: str) -> list:
    (path,) = glob.glob(os.path.join(parse_args(argv).exp_dir_trial, subdir, "*.csv"))
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    key = rows[0].index("study_id")
    return [rows[0]] + sorted(rows[1:], key=lambda r: int(r[key]))


def test_cli_test_matches_one_process(tp):
    """``--test mesh_model=2`` (beam-2) of the 1x2 fit's checkpoint against
    one process's test of its own: the reports and token ids, row for row
    (the two checkpoints are one update from the same start: tokens may
    only differ where the weights do, and here they do not decide)."""
    for subdir in ("generated_reports", "generated_report_ids"):
        assert _rows(cli_runs(tp["root"], "tp")["test"], subdir) == \
            _rows(cli_runs(tp["root"], "one")["test"], subdir)


def test_cli_scst_matches_one_process(tp):
    """``--train`` of the SCST config with ``mesh_model=2`` (the sampled
    rollout on gathered logits, the CXR-BERT reward replicated): the loss,
    reward and baseline, and the checkpoint, against one process's."""
    tp_run, one_run = cli_runs(tp["root"], "tp")["scst"], cli_runs(tp["root"], "one")["scst"]
    got, want = ([r for r in _metrics(a) if "scst_loss" in r] for a in (tp_run, one_run))
    assert len(got) == len(want) == 1
    assert got[0]["scst_loss"] == pytest.approx(want[0]["scst_loss"], rel=1e-5, abs=1e-7)
    for key in ("reward", "baseline"):
        assert got[0][key] == pytest.approx(want[0][key], rel=1e-6, abs=1e-7), key
    _close_checkpoints(_state(tp_run), _state(one_run), parse_args(one_run).lr)


def test_checkpoint_resumes_bit_equal_at_1x1(tp):
    """Rank 0's 1x2 checkpoint holds the whole model and AdamW state (the
    shapes of one process's), restores into a 1x1 train state bit for bit
    (saved again, the same tensors), and the JAX package's readers select
    it and read it as the port does."""
    from cxrmate_tpu.ckpt import orbax_io

    argv = cli_runs(tp["root"], "tp")["fit"]
    task = parse_args(argv)
    path = ck.last_checkpoint(task.exp_dir_trial)
    saved = torch.load(os.path.join(path, ck.STATE_FILE), weights_only=True)
    one = _state(cli_runs(tp["root"], "one")["fit"])
    assert {k: v.shape for k, v in saved["model"].items()} == \
        {k: v.shape for k, v in one["model"].items()}
    cfg = stages.build_model_config(task, len(stages.load_tokenizer(task)))
    model = stages.init_variables(dataclasses.replace(task, device="cpu"), cfg)
    mask = optim.mask_for_stage(dict(model.named_parameters()), task.variant)
    tx = optim.adamw(task.lr, accumulate_steps=task.accumulate_steps, trainable_mask=mask)
    state = ck.restore_checkpoint(path, tt.create_train_state(model, tx))
    again = ck._state_dict(state)
    for part in ("model",):
        assert all(torch.equal(again[part][k], v) for k, v in saved[part].items())
    for k in ("mu", "nu", "acc"):
        assert all(torch.equal(again["opt_state"][k][n], v)
                   for n, v in saved["opt_state"][k].items())
    assert (again["step"], again["opt_state"]["count"]) == (saved["step"],
                                                            saved["opt_state"]["count"])
    trial = task.exp_dir_trial
    assert orbax_io.last_checkpoint(trial) == ck.last_checkpoint(trial)
    assert orbax_io.best_checkpoint(trial) == ck.best_checkpoint(trial)
    assert orbax_io.checkpoint_resume_info(path)["global_step"] == \
        ck.checkpoint_resume_info(path)["global_step"]
    read = orbax_io.load_torch_checkpoint(os.path.join(path, ck.STATE_FILE))
    assert all(torch.equal(read["model"][k], v) for k, v in saved["model"].items())


if __name__ == "__main__":
    rank_main(sys.argv[1])
