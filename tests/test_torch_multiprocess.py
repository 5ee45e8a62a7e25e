"""Multi-process data parallelism in the port: two gloo ranks on the CPU
against the port's own one-process runs, and the 2-rank gradient against
one JAX ``value_and_grad`` of the global batch.

One module fixture starts the two ranks once (``parallel.multihost.
launch_ranks``: ``torch.distributed.run`` of this file, ``tests/
test_torch_multiprocess.py SPEC``, which imports no JAX and runs torch at
one thread). In that spawn
each rank takes one train step's gradient of the harness's tiny model on its
stripe of a 4-study batch, then runs the CLI stages on the tiny preset: a
multi fit and its test, a gt_prompt fit, SCST with a mid-epoch checkpoint
(``val_check_interval`` 0.5, ``save_top_k`` 0, a length reward), and a
gen_prompt test from the gt_prompt checkpoint. Meanwhile this process runs
the one-process references, and afterwards a 2 -> 1 resume of the SCST
run's mid-epoch checkpoint.

Tolerances, as ``tests/test_multiprocess.py`` holds the JAX package (the
reduction order over two ranks is the only difference): losses rtol 2e-5;
validation and test scores rel 1e-4; checkpoint parameters rtol 1e-4, atol
1e-6, and AdamW's first moments (the accumulated gradients) per tensor
within 3e-2 of its norm (bf16 compute); SCST ``scst_loss`` rtol 2e-5, ``reward`` and ``baseline`` rtol 1e-6
(atol 1e-7); token ids and report CSVs equal. Against JAX (fp32, dropout
off): the loss rtol 1e-5, each gradient within 1e-5 of its tensor's largest
|g| with a floor of 1e-9, BatchNorm running statistics 1e-5 (as
``tests/test_torch_train.py``).

World 1 draws what the parent commit drew: dropout and drop-path
``torch.rand`` of the input's shape, sampling ``torch.multinomial``; a
rank's stripe of a global draw equals those rows of the world-1 draw."""

from __future__ import annotations

import csv
import glob
import json
import os
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a rank's program from tests/
    sys.path.insert(0, REPO)

from cxrmate_torch.ckpt import checkpoints as ck  # noqa: E402
from cxrmate_torch.cli import stages  # noqa: E402
from cxrmate_torch.cli.config import TaskConfig  # noqa: E402
from cxrmate_torch.generate.decode import _draw  # noqa: E402
from cxrmate_torch.models.cvt import _drop_path  # noqa: E402
from cxrmate_torch.ops.layers import RowStripe, dropout  # noqa: E402
from cxrmate_torch.parallel import multihost  # noqa: E402
from cxrmate_torch.train import optim  # noqa: E402
from cxrmate_torch.train import tf_trainer as tt  # noqa: E402
from cxrmate_torch.utils import dist  # noqa: E402

PAD = 4
GRAD_ROWS = 4  # the gradient check's global batch


def length_reward(preds, labels):
    """A deterministic, row-independent SCST reward of the text's length (as
    the JAX package's multi-process test uses; taken modulo 13, since the
    tiny random model's reports all outgrow its 20-character cap and would
    leave every advantage 0)."""
    return np.asarray([(len(p) % 13) / 13.0 for p in preds], np.float32)


def task_kwargs(root: str, exp: str, **kw) -> dict:
    base = dict(exp_dir=os.path.join(root, exp), dataset_dir=os.path.join(root, "datasets"),
                ckpt_zoo_dir=os.path.join(root, "checkpoints"), device="cpu",
                variant="multi", mbatch_size=4, accumulated_mbatch_size=8, max_epochs=1,
                decoder_max_len=24, max_images_per_study=1, num_test_beams=2,
                model_preset="tiny", image_size=32, monitor="val_report_nlg_bleu_1",
                num_workers=0, image_cache_dir=None,
                # the one-process reference tokenizes to the static widths
                # the ranks are held to (the pads are masked either way)
                static_tf_pad=True)
    base.update(kw)
    return base


def runs(root: str) -> dict:
    """The CLI runs of the spawn, by name: (stage, task kwargs)."""
    # one AdamW update a run (gradients accumulated over the epoch's
    # micro-steps; SCST's mid-epoch save falls inside the accumulation)
    scst = dict(variant="scst", mbatch_size=2, accumulated_mbatch_size=8,
                val_check_interval=0.5, save_top_k=0)
    multi = task_kwargs(root, "mp_multi")
    gt_prompt = task_kwargs(root, "mp_gt", variant="gt_prompt")
    return {
        "multi": ("fit", multi),
        # a test's test_ckpt_path: the trial dir of the fit whose last
        # checkpoint it tests (resolved when the test runs)
        "test": ("test", task_kwargs(root, "mp_test", mbatch_size=2,
                                     test_ckpt_path=TaskConfig(**multi).exp_dir_trial)),
        "gt_prompt": ("fit", gt_prompt),
        "scst": ("fit_scst", task_kwargs(root, "mp_scst", **scst)),
        "gen_prompt": ("test", task_kwargs(root, "mp_gen", variant="gen_prompt",
                                           mbatch_size=2, num_test_beams=1,
                                           test_ckpt_path=TaskConfig(**gt_prompt).exp_dir_trial)),
    }


def last_ckpt(kwargs: dict) -> str:
    return ck.last_checkpoint(TaskConfig(**kwargs).exp_dir_trial)


def resolve_test_ckpt(kwargs: dict) -> dict:
    """``test_ckpt_path`` given as a fit's trial dir -> its last checkpoint
    (known only once that fit has run)."""
    return dict(kwargs, test_ckpt_path=ck.last_checkpoint(kwargs["test_ckpt_path"]))


def run_stage(stage: str, kwargs: dict):
    task = TaskConfig(**kwargs)
    if stage == "fit":
        return stages.fit(task)
    if stage == "fit_scst":
        return stages.fit_scst(task, length_reward)
    return stages.test(TaskConfig(**resolve_test_ckpt(kwargs)))


def grad_step(model, batch):
    """One micro-step's loss and gradients of this rank's stripe of the
    global batch, all-reduced: fp32, dropout off (a RowStripe without a
    generator), the encoder's BatchNorm in train mode over the global batch."""
    from cxrmate_torch.parallel import mesh

    mask = optim.mask_for_stage(dict(model.named_parameters()), "multi")
    lo, hi = mesh.local_row_range(GRAD_ROWS)
    stripe = RowStripe(None, lo, hi, GRAD_ROWS)
    return tt.all_reduce_loss_and_grads(*tt.loss_and_grads(
        model, {k: v[lo:hi] for k, v in batch.items()}, stripe, pad_id=PAD,
        trainable_mask=mask))


# ------------------------------------------------------------------ a rank
def rank_main(spec_path: str) -> None:
    """One rank of the spawn: the gradient check, then the CLI runs."""
    from cxrmate_torch.ckpt.hf import load_model_state
    from cxrmate_torch.models.encoder_decoder import EncoderDecoder
    from cxrmate_torch.parallel.multihost import initialize_if_needed

    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    with open(spec_path) as f:
        spec = json.load(f)
    assert initialize_if_needed("cpu") and dist.world_size() == 2
    rank = dist.rank()
    try:
        blob = torch.load(spec["grad_input"], weights_only=False)
        model = EncoderDecoder(blob["config"], device="cpu", dtype=torch.float32)
        load_model_state(model, blob["state"])
        loss, grads = grad_step(model, blob["batch"])
        stats = {k: v for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        torch.save({"loss": loss, "grads": grads, "stats": stats,
                    "main": multihost.is_main_process()},
                   os.path.join(spec["root"], f"grad.rank{rank}.pt"))
        for name, (stage, kwargs) in runs(spec["root"]).items():
            out = run_stage(stage, kwargs)
            if stage == "test" and rank == 0:
                with open(os.path.join(spec["root"], f"scores_{name}.json"), "w") as f:
                    json.dump({k: float(v) for k, v in out.items()}, f)
    finally:
        torch.distributed.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)


# ------------------------------------------------------------------ fixture
def global_batch(seed: int = 11) -> dict:
    """Four studies of two image slots (the last all-zero in two), reports
    of 10 tokens with pads and padded labels (tests/test_torch_train.py's
    batch, at 4 rows)."""
    from tests.test_torch_harness import VOCAB, pixels

    rs = np.random.RandomState(seed)
    b, l = GRAD_ROWS, 10
    mask = np.ones((b, l), np.int32)
    mask[1, 7:] = 0
    mask[3, 5:] = 0
    ids = np.where(mask == 1, rs.randint(6, VOCAB, (b, l)), PAD).astype(np.int32)
    labels = np.where((rs.rand(b, l) < 0.2) | (mask == 0), PAD,
                      rs.randint(6, VOCAB, (b, l))).astype(np.int32)
    px = pixels(seed, studies=b, slots=2)
    px[2, 1] = 0.0
    return {"pixel_values": px, "decoder_input_ids": ids, "decoder_attention_mask": mask,
            "decoder_token_type_ids": np.repeat((np.arange(l) > 4)[None], b, 0).astype(np.int32),
            "label_ids": labels}


def jax_gradient(batch: dict) -> dict:
    """One JAX value_and_grad of the tiny model on the global batch (train
    mode, rng None) -> loss, HF-named gradients and BatchNorm statistics."""
    import jax
    import jax.numpy as jnp

    from cxrmate_tpu.ckpt.hf_convert import export_encoder_decoder
    from cxrmate_tpu.models import encoder_decoder as jed
    from cxrmate_tpu.train.tf_trainer import cross_entropy_ignore_pad
    from tests.test_torch_harness import jax_config, jax_variables

    cfg, variables = jax_config(), jax_variables()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params, stats):
        logits, new_stats = jed.forward(
            {"params": params, "batch_stats": stats}, jb["pixel_values"],
            jb["decoder_input_ids"], cfg, decoder_attention_mask=jb["decoder_attention_mask"],
            decoder_token_type_ids=jb["decoder_token_type_ids"], train=True, rng=None)
        return cross_entropy_ignore_pad(logits, jb["label_ids"], PAD), new_stats

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    tree = {"params": jax.tree.map(np.asarray, grads),
            "batch_stats": jax.tree.map(np.asarray, stats)}
    return {"loss": float(loss),
            "export": export_encoder_decoder(tree, cfg.encoder, cfg.decoder)}


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
            raise TimeoutError("a launch of the ranks is still running after 300 s")
        if "error" in box:
            raise box["error"]
        return box["value"]

    return join


@pytest.fixture(scope="module")
def mp(tmp_path_factory):
    from cxrmate_torch.data.synthetic import build_synthetic_dataset
    from tests.test_torch_harness import hf_state_dict, torch_config

    root = str(tmp_path_factory.mktemp("mp"))
    # two studies a subject: real prompts; 4 train subjects on 2 SCST lanes
    build_synthetic_dataset(root, n_train=8, n_val=4, n_test=4, studies_per_subject=2)
    batch = global_batch()
    torch.save({"config": torch_config(),
                "state": {k: torch.from_numpy(np.array(v)) for k, v in hf_state_dict().items()},
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}},
               os.path.join(root, "grad_input.pt"))
    spec = os.path.join(root, "spec.json")
    with open(spec, "w") as f:
        json.dump({"root": root, "grad_input": os.path.join(root, "grad_input.pt")}, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    spawn = _in_thread(lambda: multihost.launch_ranks(
        2, [os.path.abspath(__file__), spec], timeout=240, env=env, cwd=REPO))
    cases = {c: _in_thread(lambda c=c: launch_case(os.path.join(root, f"launch_{c}"), c))
             for c in LAUNCH_CASES}

    # the one-process references, while the ranks run
    refs = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in ("multi", "gt_prompt", "scst"):
            stage, kwargs = runs(root)[name]
            refs[name] = dict(kwargs, exp_dir=os.path.join(root, f"ref_{name}"))
            run_stage(stage, refs[name])
        jax_ref = jax_gradient(batch)
        out = spawn()
        scores = {}
        for name in ("test", "gen_prompt"):
            stage, kwargs = runs(root)[name]
            refs[name] = dict(kwargs, exp_dir=os.path.join(root, f"ref_{name}"))
            scores[name] = {k: float(v) for k, v in run_stage(stage, refs[name]).items()}
    return {"root": root, "refs": refs, "ref_scores": scores, "out": out, "jax": jax_ref,
            "launch_cases": {c: join() for c, join in cases.items()}}


def records(kwargs: dict) -> list:
    with open(os.path.join(TaskConfig(**kwargs).exp_dir_trial, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def train_state(path: str) -> dict:
    return torch.load(os.path.join(path, ck.STATE_FILE), weights_only=True)


def assert_params_close(got: dict, want: dict) -> None:
    """Two checkpoints of one AdamW update after the same micro-steps: the
    parameters within rtol 1e-4, atol 1e-6, except where the update is not
    set by the data. AdamW's first update moves an element by about lr * g
    / (|g| + eps): lr * sign(g) where |g| >> eps. The ranks sum their
    stripes' gradients in another order than one process's backward, so
    where a gradient is within rounding of 0 (a small difference of large
    terms) its sign, or its size next to eps, can differ: where the two
    accumulated gradients (the bias-corrected first moments) differ in sign
    or either is below 1e-6 (100 eps), the parameters are held within 2 lr an
    update (as tests/test_torch_train.py holds the port's step against
    JAX's), and such sign flips are rare (at most 1% of the elements). The
    first moments themselves, which carry the gradients' size, are held
    per tensor within 3e-2 of its norm: the stages compute in bf16 on fp32
    masters (``precision`` bf16), and the largest difference read on this
    file's runs was 1.0e-2 (global 3.4e-3), where a gradient off by a
    scale, or missing a rank's stripe, is off by 0.5 or more."""
    a, b = got["model"], want["model"]
    assert list(a) == list(b)
    count = want["opt_state"]["count"]
    assert got["opt_state"]["count"] == count >= 1
    lr = TaskConfig().lr
    m_hat = [{k: (v / (1 - 0.9 ** count)).numpy() for k, v in s["opt_state"]["mu"].items()}
             for s in (got, want)]
    assert list(m_hat[0]) == list(m_hat[1])
    flips = elements = 0
    for k in b:
        x, y = a[k].float().numpy(), b[k].float().numpy()
        diff, limit = np.abs(x - y), 1e-6 + 1e-4 * np.abs(y)
        if k in m_hat[1]:
            ga, gb = m_hat[0][k], m_hat[1][k]
            assert np.linalg.norm(ga - gb) <= 3e-2 * np.linalg.norm(gb) + 1e-12, k
            flip = np.sign(ga) != np.sign(gb)
            flips, elements = flips + int(flip.sum()), elements + ga.size
            loose = flip | (np.minimum(np.abs(ga), np.abs(gb)) < 1e-6)
            assert (diff[loose] <= 2 * lr * count).all(), (k, diff[loose].max())
            limit = np.where(loose, np.inf, limit)
        assert (diff <= limit).all(), (k, diff.max(), int((diff > limit).sum()))
    assert flips <= 0.01 * elements, (flips, elements)


def report_rows(kwargs: dict, subdir: str) -> list:
    """The CSV's header and its rows sorted by study id (the ranks' rows
    arrive in rank order, one process's in decode order)."""
    (path,) = glob.glob(os.path.join(TaskConfig(**kwargs).exp_dir_trial, subdir, "*.csv"))
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    key = rows[0].index("study_id")
    return [rows[0]] + sorted(rows[1:], key=lambda r: int(r[key]))


# ------------------------------------------------------------------- tests
def test_ranks_reported_ok(mp):
    assert all(f"RANK_OK {r}" in mp["out"] for r in range(2))


@pytest.mark.parametrize("name", ["multi", "gt_prompt"])
def test_fit_losses_and_val_scores_match_one_process(mp, name):
    """The global batch's loss at every logged step and the validation
    scores (each rank decodes its share; rows gathered)."""
    got, want = records(runs(mp["root"])[name][1]), records(mp["refs"][name])
    losses = [[r["train_loss"] for r in x if "train_loss" in r] for x in (got, want)]
    assert len(losses[0]) == len(losses[1]) >= 1
    np.testing.assert_allclose(losses[0], losses[1], rtol=2e-5)
    val = [[r for r in x if "train_loss" not in r] for x in (got, want)]
    assert len(val[0]) == len(val[1]) == 1
    for k, v in val[1][0].items():
        assert val[0][0][k] == pytest.approx(v, rel=1e-4), k


@pytest.mark.parametrize("name", ["multi", "gt_prompt", "scst"])
def test_rank0_checkpoint_matches_one_process(mp, name):
    """Rank 0 saved the replica that one process trains, marked as a
    2-rank checkpoint counted in global batches."""
    path = last_ckpt(runs(mp["root"])[name][1])
    assert_params_close(train_state(path), train_state(last_ckpt(mp["refs"][name])))
    info = ck.checkpoint_resume_info(path)
    assert info["world_size"] == 2 and info["global_schedule"] is True


@pytest.mark.parametrize("name", ["test", "gen_prompt"])
def test_test_stage_matches_one_process(mp, name):
    """--test rank-strided (multi, beam-2) and lane-strided (gen_prompt,
    the generated history threaded per lane): the scores, and the reports
    and token ids, row for row."""
    kwargs = runs(mp["root"])[name][1]
    with open(os.path.join(mp["root"], f"scores_{name}.json")) as f:
        got = json.load(f)
    want = mp["ref_scores"][name]
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-4), k
    for subdir in ("generated_reports", "generated_report_ids"):
        assert report_rows(kwargs, subdir) == report_rows(mp["refs"][name], subdir)


def test_scst_matches_one_process(mp):
    """SCST (generated prompts, global lanes): the loss, the global reward
    and baseline means at every step, the validations (mid-epoch and
    epoch-end), and both ranks' history sidecars in the mid-epoch save."""
    kwargs = runs(mp["root"])["scst"][1]
    got, want = records(kwargs), records(mp["refs"]["scst"])
    train = [[r for r in x if "scst_loss" in r] for x in (got, want)]
    assert len(train[0]) == len(train[1]) >= 2
    for key, tol in (("scst_loss", 2e-5), ("reward", 1e-6), ("baseline", 1e-6)):
        np.testing.assert_allclose([r[key] for r in train[0]], [r[key] for r in train[1]],
                                   rtol=tol, atol=1e-7, err_msg=key)
    val = [[r for r in x if "scst_loss" not in r] for x in (got, want)]
    assert len(val[0]) == len(val[1]) == 2
    for a, b in zip(*val):
        for k, v in b.items():
            assert a[k] == pytest.approx(v, rel=1e-4), k
    (mid,) = glob.glob(os.path.join(TaskConfig(**kwargs).exp_dir_trial, "checkpoints",
                                    "epoch=0-step=*"))
    assert sorted(n for n in os.listdir(mid) if n.startswith("scst_history.rank")) == [
        "scst_history.rank0.json", "scst_history.rank1.json"]


def test_scst_mid_epoch_resume_from_two_ranks_to_one(mp):
    """The 2-rank run's mid-epoch checkpoint resumes in one process (the
    history the union of the sidecars) and ends where the uninterrupted
    one-process run ends: parameters and global step."""
    kwargs = runs(mp["root"])["scst"][1]
    (mid,) = glob.glob(os.path.join(TaskConfig(**kwargs).exp_dir_trial, "checkpoints",
                                    "epoch=0-step=*"))
    info = ck.checkpoint_resume_info(mid)
    assert info["world_size"] == 2 and info["global_schedule"] is True and info["step"]
    resumed = dict(kwargs, exp_dir=os.path.join(mp["root"], "resumed"), resume_ckpt_path=mid)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run_stage("fit_scst", resumed)
    gold = last_ckpt(mp["refs"]["scst"])
    assert_params_close(train_state(last_ckpt(resumed)), train_state(gold))
    assert (ck.checkpoint_resume_info(last_ckpt(resumed))["global_step"]
            == ck.checkpoint_resume_info(gold)["global_step"])


def test_two_rank_gradient_matches_jax_on_the_global_batch(mp):
    """Each rank's all-reduced gradient of its stripe (BatchNorm over the
    global batch, the loss's mean over the global non-pad labels) is JAX's
    value_and_grad over the whole batch; both ranks hold the same gradient
    and the same BatchNorm running statistics."""
    ranks = [torch.load(os.path.join(mp["root"], f"grad.rank{r}.pt"), weights_only=True)
             for r in range(2)]
    ref = mp["jax"]
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), ref["loss"], rtol=1e-5)
        for name, g in r["grads"].items():
            want = ref["export"][name]
            atol = 1e-5 * float(np.abs(want).max()) + 1e-9
            np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=atol, err_msg=name)
        for name, v in r["stats"].items():
            np.testing.assert_allclose(v.numpy(), ref["export"][name], rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    assert len(ranks[0]["grads"]) > 200  # every parameter trains in the multi stage
    for name in ranks[0]["grads"]:
        assert torch.equal(ranks[0]["grads"][name], ranks[1]["grads"][name]), name


# ------------------------------------------------------------------- draws
def _parent_draw(kind: str, x: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """The parent commit's draws, as it wrote them."""
    if kind == "dropout":
        mask = torch.rand(x.shape, generator=g, device=x.device) < 0.7
        return torch.where(mask, x / 0.7, torch.zeros((), dtype=x.dtype))
    if kind == "drop_path":
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        u = torch.rand(shape, generator=g, device=x.device, dtype=x.dtype)
        return x / 0.7 * torch.floor(0.7 + u)
    return torch.multinomial(torch.softmax(x, dim=-1), 1, generator=g)[:, 0]


def _port_draw(kind: str, x: torch.Tensor, g) -> torch.Tensor:
    if kind == "dropout":
        return dropout(x, 0.3, g)
    if kind == "drop_path":
        return _drop_path(x, 0.3, g)
    return _draw(x, g)


def _input(kind: str, rows: int) -> torch.Tensor:
    rs = np.random.RandomState(3)
    shape = (rows, 50) if kind == "sample" else (rows, 7, 5)
    return torch.from_numpy(rs.randn(*shape).astype(np.float32) * 3)


@pytest.mark.parametrize("kind", ["dropout", "drop_path", "sample"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_world1_draws_bit_equal_to_the_parent(kind, seed):
    """dropout, drop-path and sampling with a torch.Generator: the parent's
    tensors bit for bit (sampling: torch.multinomial's)."""
    x = _input(kind, 12)
    want = _parent_draw(kind, x, torch.Generator().manual_seed(seed))
    got = _port_draw(kind, x, torch.Generator().manual_seed(seed))
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind, fold", [("dropout", 1), ("dropout", 3), ("drop_path", 1),
                                        ("drop_path", 3), ("sample", 1)])
@pytest.mark.parametrize("stripe", [(0, 3), (3, 6), (2, 4)])
def test_stripe_of_a_global_draw_is_the_world1_rows(kind, fold, stripe):
    """A RowStripe's draw for rows [lo, hi) of a 6-row batch equals those
    rows of the world-1 draw; with a fold of k rows a study (CvT's images;
    sampling draws one row a study) rows k*lo:k*hi."""
    lo, hi = stripe
    x = _input(kind, 6 * fold)
    whole = _port_draw(kind, x, torch.Generator().manual_seed(5))
    part = _port_draw(kind, x[fold * lo:fold * hi],
                      RowStripe(torch.Generator().manual_seed(5), lo, hi, 6))
    assert torch.equal(part, whole[fold * lo:fold * hi])


@pytest.mark.parametrize("train", [False, True])
def test_one_image_encode_hands_the_kernels_contiguous_rows(monkeypatch, train):
    """A rank's stripe can hold one study of one image: CvT's flash calls
    then get [heads, L, 64] rows that a reshape would leave strided, which
    the CUDA kernels refuse; the encoder makes them contiguous."""
    from cxrmate_torch.models import encoder_decoder as ted
    from cxrmate_torch.ops import flash_attention as fa
    from tests.test_torch_harness import pixels, torch_model

    name = "flash_attention_grad" if train else "flash_attention"
    real, seen = getattr(fa, name), []

    def checked(q, k, v, scale):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        return real(q, k, v, scale)

    monkeypatch.setattr(fa, name, checked)
    model = torch_model()
    with torch.set_grad_enabled(train):
        ted.encode_images(model, torch.from_numpy(pixels(4, studies=1, slots=1)), train)
    assert len(seen) == sum(model.config.encoder.depth) and all(seen)


def test_collectives_are_the_identity_without_a_group():
    t = [torch.arange(3.0), torch.ones(2)]
    assert dist.all_reduce_sum(t)[0].tolist() == [0.0, 1.0, 2.0]
    assert dist.broadcast(t)[1].tolist() == [1.0, 1.0]
    assert dist.all_reduce_max(7) == 7
    x = torch.ones(2, requires_grad=True)
    assert dist.all_reduce_sum_grad(x) is x



def test_is_main_process_is_rank_0(mp):
    assert multihost.is_main_process()  # no group here
    assert [torch.load(os.path.join(mp["root"], f"grad.rank{r}.pt"), weights_only=True)["main"]
            for r in range(2)] == [True, False]


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_draw_marks_the_rows_multinomial_refuses(bad):
    """A row whose probabilities are not finite gets token -1 (no host
    sync), where torch.multinomial raises; the other rows draw as before."""
    x = _input("sample", 4)
    x[2, 5] = bad
    with pytest.raises(RuntimeError):
        torch.multinomial(torch.softmax(x, dim=-1), 1, generator=torch.Generator().manual_seed(0))
    got = _draw(x, torch.Generator().manual_seed(0))
    want = _draw(x[[0, 1, 3]], torch.Generator().manual_seed(0))
    assert got[2] == -1 and (got[[0, 1, 3]] >= 0).all()
    assert torch.equal(got[[0, 1, 3]], torch.where(want >= 0, got[[0, 1, 3]], want))


@pytest.mark.parametrize("step", [0, 7])
def test_sampling_refuses_logits_that_are_not_finite(monkeypatch, step):
    """A NaN in one row's logits at the first or the last draw of a sampled
    decode raises, where the parent's torch.multinomial raised."""
    from cxrmate_torch.generate import decode as dec
    from cxrmate_torch.generate.decode import GenerationConfig, generate
    from tests.test_torch_harness import BOS, EOS, SEP, torch_model

    real, calls = dec.warp_logits, []

    def poisoned(logits, *args):
        out = real(logits, *args)
        if len(calls) == step:
            out = out.clone()
            out[1, 3] = float("nan")
        calls.append(step)
        return out

    monkeypatch.setattr(dec, "warp_logits", poisoned)
    enc = torch.from_numpy((np.random.RandomState(42).randn(3, 32, 32) * 30).astype(np.float32))
    cfg = GenerationConfig(max_new_tokens=8, bos_token_id=BOS, eos_token_id=EOS, pad_token_id=PAD,
                           special_token_ids=(SEP,), do_sample=True, top_k=20)
    with pytest.raises(FloatingPointError, match="not finite"):
        generate(torch_model(), cfg, enc, torch.ones(3, 32, dtype=torch.int32),
                 torch.full((3, 1), BOS, dtype=torch.int32), None,
                 torch.Generator().manual_seed(3))
    assert len(calls) == step + 1


# --------------------------------------------------------------- launcher
LAUNCH_CASES = {"hang": "hung past", "fail": "exited"}


def launch_case(root: str, case: str) -> dict:
    """Two ranks of a script through ``multihost.launch_ranks``: both sleep
    past the 8 s limit (as ranks blocked in a collective do), or rank 1
    exits with an error. -> the launch's error and each rank's process state
    after it (None: gone)."""
    os.makedirs(root)
    script = os.path.join(root, "rank.py")
    with open(script, "w") as f:
        f.write("import os, sys, time\n"
                "rank = int(os.environ['RANK'])\n"
                "with open(os.path.join(sys.argv[1], f'pid{rank}'), 'w') as f:\n"
                "    f.write(str(os.getpid()))\n"
                f"if {case!r} == 'fail' and rank == 1:\n"
                "    time.sleep(1)\n"
                "    sys.exit(3)\n"
                "time.sleep(600)\n")
    try:
        multihost.launch_ranks(2, [script, root], timeout=8 if case == "hang" else 120, cwd=root)
        error = None
    except RuntimeError as e:
        error = str(e)
    states = []
    for r in range(2):
        with open(os.path.join(root, f"pid{r}")) as f:
            pid = int(f.read())
        try:
            with open(f"/proc/{pid}/status") as f:
                states.append(next(line for line in f if line.startswith("State:")).split()[1])
        except OSError:
            states.append(None)
    return {"error": error, "states": states}


@pytest.mark.parametrize("case", sorted(LAUNCH_CASES))
def test_launch_ranks_stops_every_rank(mp, case):
    """When one rank exits with an error, or the ranks outlast the time
    limit, the launch raises and no rank is left running (run by the
    module fixture, beside its own launch)."""
    got = mp["launch_cases"][case]
    assert got["error"] is not None and LAUNCH_CASES[case] in got["error"], got
    assert all(state in (None, "Z") for state in got["states"]), got


def test_tracing_annotate_profile_and_step_timer(tmp_path):
    """The stages' spans ("decode", "train_step") show in a ``profile``
    session's events and its trace file, and are recorded as one request
    with its counts; outside a session a span records nothing."""
    from cxrmate_torch.utils import tracing

    before = tracing.requests()
    with tracing.span("train_step"):
        tracing.count("host_read")
    assert tracing.requests() == before
    with tracing.profile(str(tmp_path / "trace")) as trace:
        with tracing.span("train_step"):
            with tracing.span("decode"):
                tracing.count("host_read", 2)
            out = torch.ones(4) * 2
    assert out.tolist() == [2.0] * 4
    names = {e.key for e in trace.session.key_averages()}
    assert {"cxr.train_step", "cxr.decode"} <= names, names
    assert len(os.listdir(tmp_path / "trace")) == 2
    step, decode = tracing.requests()[-1]
    assert (step.name, step.parent, decode.name, decode.parent) == (
        "train_step", None, "decode", step.id)
    assert decode.counts == {"host_read": 2} and step.t0 <= decode.t0 <= decode.t1 <= step.t1


if __name__ == "__main__":
    rank_main(sys.argv[1])
