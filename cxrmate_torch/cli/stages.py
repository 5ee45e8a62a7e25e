"""Train/test stage orchestration: the port's entry point.

    python -m cxrmate_torch.cli.stages --config config/train/multi_tf.yaml --train [key=value ...]
    python -m cxrmate_torch.cli.stages --config config/test/multi_tf.yaml --test [key=value ...]

(or ``cxrmate-torch`` once the package is installed). The port of
``cxrmate_tpu/cli/stages.py``, the counterpart of the reference's
``tools/stages.py``: resolve the warm start (explicit checkpoint, best
checkpoint of another experiment, HF checkpoint dir or file, or fresh
init), fit with per-epoch validation and checkpoint selection on the
monitored metric, and test with beam search and the metric battery.

The stages run on ``task.device`` ("cuda" unless a config or override says
"cpu"; there is no fallback), in one process or in N under ``torchrun``:

    torchrun --nproc_per_node N -m cxrmate_torch.cli.stages --config ... --train|--test \
        [mesh_model=M]

``main`` joins the process group (``parallel.multihost``: NCCL when every
rank has a card of its own, gloo on the CPU or when ranks share a card),
and each stage lays it out as the JAX package's (data x model) mesh
(``parallel.mesh.make_mesh``: ``mesh_model`` divides N, ``mesh_data`` unset
or N / M, else ``ValueError``). Along ``data`` the stages run the
reference's DDP semantics, as the JAX package's data axis does: every rank
iterates the same global batches and loads its data rank's row stripe
(``parallel.mesh.local_row_range``), at static widths; the loss and the
gradients are the global batch's (``train.tf_trainer``), BatchNorm's
moments too (``ops.layers.batch_norm_train``), and dropout, drop-path and
sampling draw per row what one process draws (``ops.layers.RowStripe``).
Along ``model`` (M > 1) the decoder is split as the JAX package's
``model`` axis splits it (``parallel.mesh.shard_model``: vocabulary,
attention heads, intermediate), each rank of a model group holding the
same rows and its shard, with the one-process logits gathered on every
rank (``models.bert``). The train state is one replica of its shard on
every rank of a data group; rank 0 saves it whole (gathered over its model
group); evaluation decodes each data rank's share of the one-process
batches (generated prompts by lane) and gathers the rows over the data
group.

Precision as the JAX package runs it: training keeps fp32 masters and
computes in ``precision`` (bf16 unless it says otherwise); validation and test
decode with the fp32 masters themselves (or, for ``--test``, the restored fp32
weights), with no cast. The stages change no TF32 setting: they run under the
process's, PyTorch's defaults unless the caller changed them, i.e.
``torch.backends.cuda.matmul.allow_tf32 = False`` (fp32 matmuls in full fp32)
and ``torch.backends.cudnn.allow_tf32 = True`` (CvT's convolutions through
cuDNN in TF32).

Deviations from the JAX stages: a fresh init (``init_variables``) draws the
JAX package's scheme from a ``torch.Generator`` seeded with ``trial``, not
JAX's numbers; dropout draws from ``tf_trainer.train_generator(trial,
global_step)`` in place of ``fold_in(PRNGKey(trial), global_step)``, so a
resumed run still draws what the uninterrupted one drew; a checkpoint with
LoRA factors for a variant without LoRA (single, multi) is refused, where the
JAX package carries the factors unused.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cxrmate_torch import configs as model_configs
from cxrmate_torch.ckpt import checkpoints as ck
from cxrmate_torch.ckpt import hf
from cxrmate_torch.cli.config import TaskConfig
from cxrmate_torch.data import image as image_mod
from cxrmate_torch.data.datasets import DicomDataset, PreviousReportDataset, StudyDataset
from cxrmate_torch.data.index import build_merged_index, filter_split
from cxrmate_torch.data.pipeline import Prefetcher, batch_iterator
from cxrmate_torch.generate.beam import beam_search
from cxrmate_torch.generate.decode import GenerationConfig, generate
from cxrmate_torch.models import encoder_decoder as ed
from cxrmate_torch.models.api import _fill_random
from cxrmate_torch.parallel import mesh as mesh_mod
from cxrmate_torch.parallel.multihost import global_max_int, initialize_if_needed
from cxrmate_torch.tokenizer import ByteLevelBPETokenizer
from cxrmate_torch.train import optim
from cxrmate_torch.train import tf_trainer as tt
from cxrmate_torch.utils import dist
from cxrmate_torch.utils.device import resolve_device
from cxrmate_torch.utils.tracing import span

VARIANT_TO_MODEL = {
    "single": "single",
    "multi": "multi",
    "gt_prompt": "longitudinal",
    "gen_prompt": "longitudinal",
    "scst": "longitudinal",
    "scst_gt": "longitudinal",
}

def build_model_config(task: TaskConfig, vocab_size: int) -> model_configs.EncoderDecoderConfig:
    variant = VARIANT_TO_MODEL[task.variant]
    if task.model_preset == "tiny":
        return model_configs.EncoderDecoderConfig(
            encoder=model_configs.CvtConfig(
                embed_dim=(8, 12, 16), num_heads=(1, 2, 2), depth=(1, 1, 3),
                drop_path_rate=(0.0, 0.0, 0.0), projection_size=16,
            ),
            decoder=model_configs.BertDecoderConfig(
                vocab_size=vocab_size, hidden_size=16, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=32,
                max_position_embeddings=max(2 * task.decoder_max_len, 64),
                cross_attention_hidden_size=16,
            ),
            variant=variant,
            lora=model_configs.LoraConfig() if variant == "longitudinal" else None,
            image_size=task.image_size,
            decoder_max_len=task.decoder_max_len,
            max_images_per_study=task.max_images_per_study,
        )
    cfg = model_configs.preset(variant, vocab_size)
    # the task's data-shape fields reach the model config too, so training
    # and testing tokenise under the same length budgets
    return dataclasses.replace(
        cfg, image_size=task.image_size, decoder_max_len=task.decoder_max_len,
        max_images_per_study=task.max_images_per_study,
    )


def load_tokenizer(task: TaskConfig) -> ByteLevelBPETokenizer:
    path = task.tokenizer_dir or os.path.join(task.ckpt_zoo_dir, "mimic-cxr-tokenizers", "bpe_prompt")
    return ByteLevelBPETokenizer.from_file(path)


def init_variables(task: TaskConfig, config) -> ed.EncoderDecoder:
    """A fresh fp32 model on ``task.device``: the JAX package's
    initialisation scheme (``models.api._fill_random``) drawn from a
    generator seeded with ``trial``."""
    dev = resolve_device(task.device)
    model = ed.EncoderDecoder(config, device=dev, dtype=torch.float32)
    _fill_random(model, torch.Generator(device=dev).manual_seed(task.trial))
    return model


def model_from_state_dict(sd: Dict, config, device) -> ed.EncoderDecoder:
    """An fp32 model on ``device`` holding exactly the state dict's
    parameter set, as ``convert_encoder_decoder`` builds the JAX pytree from
    it: LoRA factors (at the state dict's rank, the variant's scaling) only
    when it has them, the LM head tied unless it holds a different one. So a
    longitudinal model warm-started from a multi checkpoint has no LoRA, and
    ``optim.mask_for_stage(..., "gt_prompt")`` trains nothing, as in JAX."""
    rank, lora = hf.lora_rank(sd), None
    if rank is not None:
        if config.lora is None:
            raise ValueError(f"the checkpoint holds LoRA factors, which a {config.variant!r} "
                             "model does not take")
        lora = dataclasses.replace(config.lora, r=rank, alpha=config.lora.scaling * rank)
    config = dataclasses.replace(
        config, lora=lora,
        decoder=dataclasses.replace(config.decoder, tie_word_embeddings=hf.head_is_tied(sd)))
    model = ed.EncoderDecoder(config, device="cpu", dtype=torch.float32)
    hf.load_model_state(model, sd)
    return model.to(device)


def _saved_model_state(path: str) -> Dict[str, torch.Tensor]:
    """A training checkpoint's model state dict, memory-mapped on the CPU."""
    return torch.load(os.path.join(path, ck.STATE_FILE), map_location="cpu",
                      weights_only=True, mmap=True)["model"]


def _load_orbax_variables(path: str, model: ed.EncoderDecoder) -> ed.EncoderDecoder:
    """Load the weights of a saved train state into ``model``; its keys and
    shapes must match the model's (strict, like Lightning's
    ``load_from_checkpoint``)."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in _saved_model_state(path).items()}
    if want != got:
        raise ValueError(
            f"checkpoint at {path} has an incompatible parameter structure for this "
            f"variant (did you warm-start across model families?)"
        )
    return ck.restore_model(path, model)


def resolve_warm_start(task: TaskConfig, config, model: ed.EncoderDecoder) -> ed.EncoderDecoder:
    """The reference's four warm-start modes in priority order
    (`tools/stages.py:52-85`): explicit checkpoint path, best checkpoint of another
    experiment's trial dir, HF checkpoint (dir or torch file), fresh init
    (``model`` itself). -> the model to train or test, on ``model``'s device."""
    if task.warm_start_ckpt_path:
        if not os.path.exists(task.warm_start_ckpt_path):
            raise FileNotFoundError(f"warm_start_ckpt_path not found: {task.warm_start_ckpt_path}")
        return _load_orbax_variables(task.warm_start_ckpt_path, model)
    if task.warm_start_exp_dir:
        # the other experiment's trial dir (tools/stages.py:63)
        exp_dir_trial = os.path.join(task.warm_start_exp_dir, f"trial_{task.trial}")
        path = ck.get_test_ckpt_path(
            exp_dir_trial, task.warm_start_monitor_mode, task.test_epoch, task.test_ckpt_path
        )
        if path is None:
            raise FileNotFoundError(f"no checkpoint to warm-start from under {exp_dir_trial}")
        return _load_orbax_variables(path, model)
    name = task.warm_start_name or task.multi_ckpt_name
    # HF Hub ids ('aehrc/cxrmate') resolve under the offline checkpoint zoo
    # (ckpt_zoo_dir/<org>/<name>); explicit paths win when they exist
    if name and not os.path.exists(name):
        zoo_name = os.path.join(task.ckpt_zoo_dir, name)
        if os.path.exists(zoo_name):  # dir (HF export) or file (torch .ckpt)
            name = zoo_name
    device = next(model.parameters()).device
    if name and os.path.isdir(name):
        return model_from_state_dict(hf.load_hf_pretrained_dir(name), config, device)
    if name and os.path.isfile(name):
        return model_from_state_dict(hf.load_torch_checkpoint(name), config, device)
    if name:
        # never fall through to a fresh init when a checkpoint was requested
        raise FileNotFoundError(
            f"warm_start_name/test_ckpt_name {name!r} is neither a checkpoint "
            f"dir/file nor present under the zoo ({task.ckpt_zoo_dir})"
        )
    return model


def make_datasets(task: TaskConfig, split: str, train: bool):
    df = build_merged_index(task.dataset_dir)
    sub = filter_split(df, split, task.max_images_per_study)
    mimic_dir = os.path.join(
        task.dataset_dir, "physionet.org", "files", "mimic-cxr-jpg", "2.0.0", "files"
    )
    cache_dir = task.resolved_image_cache_dir
    # the train split takes the native route (the DCT-scaled decode), as JAX's does
    load = (
        image_mod.make_train_loader_transform(
            size=task.image_size, seed=task.trial, cache_dir=cache_dir)
        if train
        else image_mod.make_eval_loader_transform(
            size=task.image_size, cache_dir=cache_dir)
    )
    if task.variant == "single":
        return DicomDataset(sub, mimic_dir, load)
    if task.variant == "multi":
        return StudyDataset(sub, mimic_dir, load)
    history = df[df["split"] == split]
    # gt_prompt: ground-truth prompts; gen_prompt/scst: model-generated prompts
    # (train-time SCST also bin-packs subjects onto lanes, prompt.py:75-80)
    ds = PreviousReportDataset(
        sub, history, mimic_dir, load,
        use_generated=task.variant in ("gen_prompt", "scst"),
        scst_generated=task.variant == "scst" and train and split == "train",
        mbatch_size=task.mbatch_size,
        world_size=1,
    )
    # generated-prompt evaluation decodes at the lane count: allocate about
    # eval_decode_rows // num_beams lanes (at most one per subject), token-
    # identical at any lane count; training keeps the parity allocator
    if ds.use_generated and not ds.scst_generated and not train \
            and split != "train" and task.eval_decode_rows:
        beams = task.num_test_beams if split == "test" else 1
        ds.allocate_eval_lanes(
            max(task.mbatch_size, task.eval_decode_rows // max(1, beams))
        )
    return ds


def _start_cache_warmer(task: TaskConfig, *datasets):
    """Background decoded-image-cache warmer over the given datasets' images,
    iff the cache is on (``image_cache_dir``, "auto" by default), started
    before a stage's main loop so that its threads decode the JPEGs while the
    stage sets up. Returns a CacheWarmer (stop() it in a finally) or None.
    ``CXRMATE_CACHE_WARMER=0`` turns the warmer off, not the cache."""
    if task.resolved_image_cache_dir is None:
        return None
    if os.environ.get("CXRMATE_CACHE_WARMER", "1") == "0":
        return None
    jobs = [(ds.load_image, ds.image_paths()) for ds in datasets]
    if dist.rank() == 0:
        n = sum(len(p) for _, p in jobs)
        print(
            f"decoded-image cache: {task.resolved_image_cache_dir} "
            f"({n} images, ~{n * 0.17 / 1024:.1f} GB when warm; "
            "set image_cache_dir: null to disable)"
        )
    return image_mod.CacheWarmer(jobs)


def make_metrics(task: TaskConfig, split: str, reward_fn=None, chexbert_fn=None,
                 bertscorer=None):
    from cxrmate_torch.eval.bertscore import BERTScoreMetric
    from cxrmate_torch.eval.metrics import COCONLGMetrics, CheXbertMetrics, CXRBERTMetric

    accumulate = task.variant == "single"
    # METEOR's synonym module is on for --test (the jar's exact -> stem ->
    # synonym stack): nltk's WordNet where its corpus loads, else the
    # vendored table; the paraphrase table and the jar's function-word list
    # are file-gated
    meteor_syn = None
    meteor_para = None
    meteor_fw = None
    if split == "test":
        from cxrmate_torch.eval.meteor import (default_synonyms, load_function_words,
                                               load_paraphrase_table)

        meteor_syn = default_synonyms()
        para_path = os.environ.get("CXRMATE_METEOR_PARAPHRASES")
        if para_path:
            meteor_para = load_paraphrase_table(para_path)
        fw_path = os.environ.get("CXRMATE_METEOR_FUNCTION_WORDS")
        if fw_path:
            meteor_fw = load_function_words(fw_path)
    out = {}
    for section in task.sections_to_evaluate:
        out[f"{split}_{section}_nlg"] = COCONLGMetrics(
            f"{split}_{section}", task.exp_dir_trial, accumulate,
            metrics=("bleu", "cider", "rouge") + (("meteor",) if split == "test" else ()),
            meteor_synonyms=meteor_syn,
            meteor_paraphrases=meteor_para,
            meteor_function_words=meteor_fw,
        )
        if chexbert_fn is not None:
            out[f"{split}_{section}_chexbert"] = CheXbertMetrics(
                f"{split}_{section}", task.exp_dir_trial, accumulate, chexbert_fn, task.mbatch_size
            )
        if reward_fn is not None and split == "test":
            out[f"{split}_{section}_cxr-bert"] = CXRBERTMetric(
                f"{split}_{section}", task.exp_dir_trial, accumulate, reward_fn, task.mbatch_size
            )
        if bertscorer is not None and split == "test":
            out[f"{split}_{section}_bertscore"] = BERTScoreMetric(
                f"{split}_{section}", task.exp_dir_trial, accumulate, bertscorer, task.mbatch_size
            )
    return out


def _pad_prompt(prompt: Dict[str, np.ndarray], width: int, pad_id: int):
    """A tokenized prompt right-padded (masked) to ``width`` columns -> (the
    prompt, ``width``)."""
    extra = ((0, 0), (0, width - prompt["input_ids"].shape[1]))
    return {"input_ids": np.pad(prompt["input_ids"], extra, constant_values=pad_id),
            "attention_mask": np.pad(prompt["attention_mask"], extra, constant_values=0)}, width


def _decode_step_outputs(task, config, tokenizer, model, batch, num_beams: int,
                         pad_rows: int = 0):
    """Greedy (val) or beam (test) decode of one batch -> (token ids [B, T]
    numpy, findings, impression), in the model's dtype on its device.

    The batch axis is padded (repeating the last study) up to ``pad_rows``
    when set, so a ragged tail decodes at the full batch's shape, and the
    outputs are sliced back to the true batch. Row padding is exact: every
    decode path is row-independent."""
    true_b = batch["images"].shape[0]
    images = np.asarray(batch["images"], np.float32)
    prev_f, prev_i = batch.get("previous_findings"), batch.get("previous_impression")
    target = max(true_b, pad_rows or 0)
    if target > true_b:
        pad = target - true_b
        images = np.concatenate([images, np.repeat(images[-1:], pad, axis=0)], axis=0)
        if prev_f is not None:
            prev_f = list(prev_f) + [prev_f[-1]] * pad
            prev_i = list(prev_i) + [prev_i[-1]] * pad
    p = next(model.parameters())
    dev = p.device
    with torch.no_grad():
        pixels = torch.from_numpy(images).to(dev, p.dtype)
        enc_hidden, enc_mask = ed.encode_images(model, pixels)
    longitudinal = VARIANT_TO_MODEL[task.variant] == "longitudinal"
    if longitudinal:
        prompt = ed.tokenize_prompt(
            prev_f, prev_i, tokenizer,
            task.decoder_max_len, add_bos_token_id=True,
        )
        # bucket prompt widths to a few shapes; the first-token logits column
        # is pinned to the true batch-longest width so outputs equal the
        # unbucketed batch exactly
        true_width = prompt["input_ids"].shape[1]
        if dist.world_size() > 1:
            # this rank holds a stripe of a batch (evaluate): the batch's
            # longest prompt is the longest over every rank
            prompt, true_width = _pad_prompt(prompt, global_max_int(true_width),
                                             tokenizer.pad_token_id)
        ids_b, mask_b = ed.bucket_prompt(
            prompt["input_ids"], prompt["attention_mask"], tokenizer.pad_token_id,
            bucket=32, max_len=task.decoder_max_len,
        )
        prompt_ids = torch.from_numpy(ids_b.astype(np.int32)).to(dev)
        prompt_mask = torch.from_numpy(mask_b.astype(np.int32)).to(dev)
        prompt_logits_col = true_width - 1
        pmt_sep = tokenizer.vocab["[PMT-SEP]"]
        specials = (pmt_sep, tokenizer.bos_token_id, tokenizer.sep_token_id)
        gen_cfg = GenerationConfig(
            max_new_tokens=task.decoder_max_len - 1,
            bos_token_id=tokenizer.bos_token_id, eos_token_id=tokenizer.eos_token_id,
            pad_token_id=tokenizer.pad_token_id, mask_token_id=tokenizer.pad_token_id,
            special_token_ids=specials, token_type_sections=(0, 1, 0, 1),
            num_beams=num_beams,
        )
        split_specials = [tokenizer.bos_token_id, tokenizer.sep_token_id, tokenizer.eos_token_id]
    else:
        b = pixels.shape[0]
        prompt_ids = torch.full((b, 1), tokenizer.bos_token_id, dtype=torch.int32, device=dev)
        prompt_mask = torch.ones(b, 1, dtype=torch.int32, device=dev)
        prompt_logits_col = None
        if task.variant == "single":
            enc_mask = torch.ones_like(enc_mask)
        gen_cfg = GenerationConfig(
            max_new_tokens=task.decoder_max_len - 1,
            bos_token_id=tokenizer.bos_token_id, eos_token_id=tokenizer.eos_token_id,
            pad_token_id=tokenizer.pad_token_id,
            special_token_ids=(tokenizer.sep_token_id,),
            num_beams=num_beams,
        )
        split_specials = [tokenizer.sep_token_id, tokenizer.eos_token_id]

    if num_beams > 1:
        seqs, _ = beam_search(model, gen_cfg, enc_hidden, enc_mask, prompt_ids, prompt_mask,
                              prompt_logits_col=prompt_logits_col)
    else:
        seqs = generate(model, gen_cfg, enc_hidden, enc_mask, prompt_ids, prompt_mask,
                        prompt_logits_col=prompt_logits_col)
    seqs = seqs.cpu().numpy()[:true_b]
    sections = ed.split_and_decode_sections(seqs, split_specials, tokenizer)
    if longitudinal:
        _, findings, impression = sections
    else:
        findings, impression = sections
    return seqs, findings, impression


def _collate_max_images(task: TaskConfig):
    """Image-slot count of the collate pad: None (each batch's own largest
    count, the reference's ``pad_sequence``) under ``pad_images: batch``,
    ``max_images_per_study`` under "max"; the single variant is per-DICOM
    (one image per example, None). Padded slots are all-zero images whose
    cross-attention columns are masked, so outputs are the same either way."""
    if task.variant == "single":
        return None
    assert task.pad_images in ("batch", "max"), (
        f"pad_images must be 'batch' or 'max', got {task.pad_images!r}"
    )
    return None if task.pad_images == "batch" else task.max_images_per_study


def _stripe(rows: int) -> Tuple[int, int]:
    """This data rank's contiguous rows ``[lo, hi)`` of a decode batch of
    ``rows`` (uneven where the data size does not divide ``rows``); a rank
    whose share is empty decodes the last row again (the same outputs; the
    metric layer keeps one row per study)."""
    r, w = dist.data_rank(), dist.data_size()
    lo, hi = r * rows // w, (r + 1) * rows // w
    return (lo, hi) if hi > lo else (rows - 1, rows)


def evaluate(task, config, tokenizer, model, dataset, split: str, metrics: Dict,
             num_beams: int, epoch: int, loggers=()):
    """Decode ``dataset`` with ``model`` (greedy or beam) and score it.

    Under a process group each data rank decodes its share of what one
    process decodes (the ranks of its model group together, each on its
    shard), and the metric layer gathers the rows over the data group
    (every rank gets the same scores; rank 0 writes the CSVs). Every rank
    walks the one-process batches: generated-prompt datasets by lane (data
    rank r decodes lanes r::data in step order, so a subject's history
    thread stays on one data rank), the others by the one-process batches
    cut into contiguous row stripes (``_stripe``). ``_decode_step_outputs`` gives a
    longitudinal batch the width of its longest prompt over every rank,
    which sets its first token's column, so each row decodes what it
    decodes in one process."""
    rank, world = dist.data_rank(), dist.data_size()
    if getattr(dataset, "use_generated", False):
        # generated-prompt datasets read history written back during
        # consumption: never prefetched (the reference's num_workers=0,
        # gen_prompt.py:66-82); the decode batch is the allocator's lane count
        order, batch_rows = None, dataset.mbatch_size or task.mbatch_size
        if world > 1:
            # the dataset order is the allocator's step-major lane
            # interleave (index = step * lanes + lane), every lane full
            lanes = dataset.mbatch_size
            if not lanes or len(dataset) % lanes:
                raise ValueError(f"lane-strided evaluation needs an allocator-interleaved "
                                 f"dataset: mbatch_size={lanes!r}, len={len(dataset)}")
            # a rank left without a lane decodes the last one again (its rows
            # are the same; the metric layer keeps one per study)
            my_lanes = list(range(rank, lanes, world)) or [lanes - 1]
            order = [s * lanes + j for s in range(len(dataset) // lanes) for j in my_lanes]
            batch_rows = len(my_lanes)
        it = batch_iterator(dataset, batch_rows, order=order,
                            max_images=_collate_max_images(task))
        pad_rows = 0
    else:
        # under the per-batch collate pad, iterate in image-count order so
        # batches are slot-homogeneous (per-study outputs do not depend on
        # the order; the metric and CSV layers key on study_id)
        sort_key = None
        if (task.eval_sort_by_images and task.variant != "single"
                and _collate_max_images(task) is None
                and hasattr(dataset, "image_counts")):
            sort_key = dataset.image_counts()
        # decode in batches of about eval_decode_rows beam rows (at most the
        # dataset), ragged tails padded to the same shape
        batch_rows, pad_rows = task.mbatch_size, 0
        if task.eval_decode_rows:
            batch_rows = max(1, min(task.eval_decode_rows // max(1, num_beams), len(dataset)))
            pad_rows = batch_rows
        kw = dict(max_images=_collate_max_images(task), num_workers=task.num_workers)
        if world > 1:
            # the one-process batches (the tail padded by repeating the last
            # study, as pad_rows does), each rank its stripe of every one
            order = np.arange(len(dataset))
            if sort_key is not None:
                order = order[np.argsort(np.asarray(sort_key), kind="stable")]
            order = mesh_mod.pad_to_multiple(order, batch_rows)
            it = Prefetcher(batch_iterator(dataset, batch_rows, order=order,
                                           row_shard=_stripe(batch_rows), **kw))
            pad_rows = 0
        else:
            it = Prefetcher(batch_iterator(dataset, batch_rows, sort_key=sort_key, **kw))
    for batch in it:
        with span("decode"):
            seqs, findings, impression = _decode_step_outputs(
                task, config, tokenizer, model, batch, num_beams, pad_rows=pad_rows,
            )
        kw = {"study_ids": batch["study_ids"]}
        if task.variant == "single":
            kw["dicom_ids"] = batch["dicom_ids"]
        for logger in loggers:
            if logger.__class__.__name__ == "ReportTokenIdentifiersLogger":
                logger.update(seqs, **kw)
            else:
                logger.update(findings, impression, **kw)
        if getattr(dataset, "use_generated", False):
            for sid, f, i in zip(batch["study_ids"], findings, impression):
                dataset.record_generated(sid, f, i)
        for name, metric in metrics.items():
            if "findings" in name:
                metric.update(findings, [[j] for j in batch["findings"]], **kw)
            elif "impression" in name:
                metric.update(impression, [[j] for j in batch["impression"]], **kw)
            else:
                metric.update(
                    [f"{f} {i}" for f, i in zip(findings, impression)],
                    [[f"{f} {i}"] for f, i in zip(batch["findings"], batch["impression"])],
                    **kw,
                )
    scores = {}
    for logger in loggers:
        logger.compute(epoch)
        logger.reset()
    for name, metric in metrics.items():
        out = metric.compute(epoch)
        if isinstance(out, dict):
            scores.update({f"{name}_{k}": v for k, v in out.items()})
        metric.reset()
    return scores


def resolve_monitor(scores: Dict, monitor: str) -> Tuple[Optional[float], Optional[str]]:
    """Resolve the checkpoint-selection value: the configured monitor if computed,
    else an explicit surrogate NLG score (mode 'max', like the reference's
    CheXbert-F1 monitor) with a loud warning — never silently save unranked
    checkpoints (reference behaviour: `tools/stages.py:103-105` always has the
    monitor because the CheXbert weights ship with the checkpoint zoo)."""
    if monitor in scores:
        return scores[monitor], monitor
    split = monitor.split("_", 1)[0]
    surrogates = [
        f"{split}_report_nlg_cider",
        f"{split}_report_nlg_bleu_4",
        f"{split}_report_nlg_bleu_1",
    ] + sorted(k for k in scores if "_nlg_" in k)
    for key in surrogates:
        if key in scores:
            warnings.warn(
                f"monitor {monitor!r} not in computed scores (CheXbert weights "
                f"missing from the checkpoint zoo?) — falling back to surrogate "
                f"{key!r} for checkpoint selection",
                RuntimeWarning,
                stacklevel=2,
            )
            return scores[key], key
    warnings.warn(
        f"monitor {monitor!r} not in computed scores and no NLG surrogate found; "
        "checkpoints will be saved UNRANKED (no top-k pruning, best=latest)",
        RuntimeWarning,
        stacklevel=2,
    )
    return None, None


def _log_scalars(task: TaskConfig, record: Dict) -> None:
    """Append a JSON line to the trial's metrics log (the reference's log_dict
    stream, without the Lightning logger); rank 0 only."""
    if dist.rank() != 0:
        return
    os.makedirs(task.exp_dir_trial, exist_ok=True)
    with open(os.path.join(task.exp_dir_trial, "metrics.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\n")


def _resolve_fit_resume(task: TaskConfig, state):
    """Restore the trainer position for fit/fit_scst (reference: Lightning
    ``trainer.fit(ckpt_path=...)`` via `tools/stages.py:88`, which resumes every
    fit, SCST included, and restarts mid-epoch checkpoints inside the same
    epoch). Returns (state, start_epoch, skip_batches, global_step, resume_path).

    Mid-epoch checkpoints (``epoch=E-step=S`` tags from ``val_check_interval``)
    resume into epoch E with the loader fast-forwarded to the saved in-epoch
    batch count; markerless ones restart epoch E from its beginning. Under a
    process group every rank restores the rank-0-written checkpoint from the
    shared file system into its replica. A checkpoint marked
    ``global_schedule`` (written under a process group) counts its position
    in global batches and resumes at any world size, 2 -> 1 included."""
    resume_path = ck.resolve_resume(
        task.exp_dir_trial, task.resume_last, task.resume_epoch, task.resume_ckpt_path
    )
    if not resume_path:
        return state, 0, 0, 0, None
    info = ck.checkpoint_resume_info(resume_path)
    if info["step"] is not None:  # mid-epoch save: validate BEFORE the restore
        # the saved in-epoch batch count is measured in the saving run's
        # loader schedule; under another mbatch_size or world size it would
        # skip (or re-train) the wrong samples
        checks = [("mbatch_size", task.mbatch_size)]
        if not info.get("global_schedule"):
            checks.append(("world_size", dist.world_size()))
        for field, current in checks:
            saved = info.get(field)
            if saved is not None and saved != current:
                raise ValueError(
                    f"cannot resume mid-epoch checkpoint {resume_path}: it was "
                    f"saved with {field}={saved} but this run has {field}="
                    f"{current}; restart with the saving run's {field} (or "
                    f"resume an epoch-end checkpoint instead)"
                )
    state = ck.restore_checkpoint(resume_path, state)
    epoch = info["epoch"]
    if epoch is None:
        epoch = ck.last_checkpoint_epoch(task.exp_dir_trial)
    if epoch is None:
        return state, 0, 0, 0, resume_path
    gstep = info["global_step"] or 0
    if info["step"] is not None:
        return state, epoch, info["n_batches"] or 0, gstep, resume_path
    return state, epoch + 1, 0, gstep, resume_path


def _mid_epoch_schedule(task: TaskConfig, dataset_len: int):
    """(val_every, total_batches) for Lightning's fractional val_check_interval;
    (None, total) when validation is epoch-end only."""
    total_batches = max(1, dataset_len // task.mbatch_size)  # drop_last
    if task.val_check_interval and task.val_check_interval < 1.0:
        return max(1, int(task.val_check_interval * total_batches)), total_batches
    return None, total_batches


def _checkpoint_state(task: TaskConfig, state, epoch, monitor_value, **kw) -> None:
    """Save a fit checkpoint (``ckpt.checkpoints.save_checkpoint``): every
    rank enters, rank 0 writes the state, whole (gathered over its model
    group; each rank writes its own ``extra_files``)."""
    ck.save_checkpoint(task.exp_dir_trial, state, epoch, monitor_value, **kw)


def _compute_dtype(task: TaskConfig) -> Optional[torch.dtype]:
    """The reference's ``precision: 16``: bf16 compute on fp32 masters."""
    return torch.bfloat16 if str(task.precision) in ("bf16", "16") else None


def _validate_and_save(task, config, tokenizer, state, val_set, metrics, epoch, step=None,
                       n_batches=None, gstep=None, extra_files=None) -> None:
    """Validation (greedy, on the fp32 masters; under a process group on
    each rank's replica, the rows gathered), its metrics line, and a
    checkpoint ranked by the monitor, marked ``global_schedule`` under a
    process group."""
    if getattr(val_set, "use_generated", False):
        val_set.reset_generated()  # each validation pass starts prompt history clean
    scores = evaluate(task, config, tokenizer, state.model, val_set, "val", metrics, 1, epoch)
    record = {"epoch": epoch, **{k: float(v) for k, v in scores.items()}}
    if step is not None:
        record["step"] = step
    _log_scalars(task, record)
    monitor_value, monitor_key = resolve_monitor(scores, task.monitor)
    _checkpoint_state(
        task, state, epoch, monitor_value,
        monitor=monitor_key or task.monitor, mode=task.monitor_mode,
        keep_top_k=task.save_top_k, step=step,
        n_batches=n_batches, global_step=gstep, extra_files=extra_files,
        mbatch_size=task.mbatch_size, world_size=dist.world_size(),
        global_schedule=dist.initialized(),
    )


def fit(task: TaskConfig, chexbert_fn=None) -> None:
    """Teacher-forcing training (single, multi, gt_prompt): AdamW on fp32
    masters with bf16 compute, ``optim.mask_for_stage(..., task.variant)``,
    gradient accumulation over ``accumulate_steps`` micro-batches, validation
    and a checkpoint every ``every_n_epochs`` (and every
    ``val_check_interval`` of an epoch).

    Under a process group every rank iterates the same shuffled global
    schedule (``mbatch_size`` is the global batch) and loads its data rank's
    row stripe, at static widths so that every stripe of a batch has one
    shape; the step counts global batches, and validation runs on each
    rank's replica (of its shard, under ``mesh_model`` > 1)."""
    device = resolve_device(task.device)
    mesh_mod.make_mesh(task.mesh_data, task.mesh_model)
    multiprocess = dist.world_size() > 1
    tokenizer = load_tokenizer(task)
    config = build_model_config(task, len(tokenizer))
    model = resolve_warm_start(task, config, init_variables(task, config))
    model = mesh_mod.replicate_tree(model)  # rank 0's weights on every rank
    model = mesh_mod.shard_model(model)  # whole, then this model rank's shard
    config = model.config  # the warm start's parameter set (LoRA, tied head)
    mask = optim.mask_for_stage(dict(model.named_parameters()), task.variant)
    tx = optim.adamw(task.lr, accumulate_steps=task.accumulate_steps, trainable_mask=mask)
    state = tt.create_train_state(model, tx)
    step = tt.make_train_step(config, tx, trainable_mask=mask, pad_id=tokenizer.pad_token_id,
                              compute_dtype=_compute_dtype(task))

    state, start_epoch, skip_batches, global_step, _ = _resolve_fit_resume(task, state)

    train_set = make_datasets(task, "train", train=True)
    val_set = make_datasets(task, "validate", train=False)
    metrics = make_metrics(task, "val", chexbert_fn=chexbert_fn)

    row_shard = mesh_mod.local_row_range(task.mbatch_size) if dist.initialized() else None
    static_pad = task.static_tf_pad or multiprocess
    pad_report_to = config.decoder_max_len if static_pad else None
    pad_prompt_to = (
        config.prompt_max_len if static_pad and config.variant == "longitudinal" else None
    )
    collate_max = _collate_max_images(task)
    if multiprocess and collate_max is None and task.variant != "single":
        collate_max = task.max_images_per_study
    val_every, total_batches = _mid_epoch_schedule(task, len(train_set))
    warmer = _start_cache_warmer(task, train_set, val_set)
    try:
        for epoch in range(start_epoch, task.max_epochs):
            if hasattr(train_set.load_image, "set_epoch"):
                train_set.load_image.set_epoch(epoch)
            skip = skip_batches if epoch == start_epoch else 0
            it = Prefetcher(
                batch_iterator(
                    train_set, task.mbatch_size, shuffle=True, seed=epoch,
                    max_images=collate_max, drop_last=True, row_shard=row_shard,
                    num_workers=task.num_workers, skip_batches=skip,
                )
            )
            n_batches = skip
            fresh = 0
            for batch in it:
                tf_batch = tt.build_tf_batch(
                    tokenizer, config, batch["images"].astype(np.float32),
                    batch["findings"], batch["impression"],
                    batch.get("previous_findings"), batch.get("previous_impression"),
                    pad_report_to=pad_report_to, pad_prompt_to=pad_prompt_to,
                )
                gen = tt.train_generator(task.trial, global_step, device=device,
                                         row_range=row_shard)
                with span("train_step"):
                    state, loss = step(state, tf_batch, gen)
                n_batches += 1
                fresh += 1
                global_step += 1
                if n_batches % 50 == 0 or n_batches == skip + 1:
                    # skip+1, not 1: a mid-epoch resume starts counting at skip
                    _log_scalars(task, {"epoch": epoch, "step": n_batches,
                                        "train_loss": float(loss)})
                if val_every and n_batches % val_every == 0 and n_batches < total_batches:
                    _validate_and_save(task, config, tokenizer, state, val_set, metrics, epoch,
                                       step=global_step, n_batches=n_batches, gstep=global_step)
                if task.fast_dev_run and fresh >= 1:
                    break
            it.close()
            # ModelCheckpoint every_n_epochs / check_val_every_n_epoch
            if (epoch + 1) % task.every_n_epochs == 0 or task.fast_dev_run:
                _validate_and_save(task, config, tokenizer, state, val_set, metrics, epoch,
                                   gstep=global_step)
            if task.fast_dev_run:
                break
    finally:
        if warmer is not None:
            warmer.stop()


def fit_scst(task: TaskConfig, reward_fn, chexbert_fn=None) -> None:
    """SCST training: sampled rollouts + greedy baseline + CXR-BERT reward.

    variant 'scst' (reference scst/gen_prompt.py:146-259): self-generated prompts
    with per-epoch subject re-allocation and generated-history threading.
    variant 'scst_gt' (reference scst/gt_prompt.py:8-255, GTPromptCXRBERT):
    ground-truth prompts, ordinary shuffled batching, no history writes.

    Under a process group, as ``fit``: the lanes are global (the allocator
    at world 1), every rank iterates the same global schedule and loads its
    row stripe, so a subject's lane, a fixed row of every global batch,
    keeps its generated-prompt history on one rank; prompt widths agree
    through ``global_max_int``; each rank writes the history sidecar of its
    own lanes."""
    from cxrmate_torch.train.scst import SCSTTrainer, make_scst_step

    device = resolve_device(task.device)
    mesh_mod.make_mesh(task.mesh_data, task.mesh_model)
    multiprocess = dist.world_size() > 1
    tokenizer = load_tokenizer(task)
    config = build_model_config(task, len(tokenizer))
    model = resolve_warm_start(task, config, init_variables(task, config))
    model = mesh_mod.replicate_tree(model)  # rank 0's weights on every rank
    model = mesh_mod.shard_model(model)  # whole, then this model rank's shard
    config = model.config
    mask = optim.mask_for_stage(dict(model.named_parameters()), "scst")
    tx = optim.adamw(task.lr, accumulate_steps=task.accumulate_steps, trainable_mask=mask)
    state = tt.create_train_state(model, tx)

    pmt_sep = tokenizer.vocab["[PMT-SEP]"]
    gen_sample = GenerationConfig(
        max_new_tokens=task.decoder_max_len - 1,
        bos_token_id=tokenizer.bos_token_id, eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id, mask_token_id=tokenizer.pad_token_id,
        special_token_ids=(tokenizer.bos_token_id, tokenizer.sep_token_id),
        token_type_sections=(0, 1, 0, 1),
        do_sample=True, top_k=50, top_p=1.0, temperature=1.0,
    )
    gen_base = GenerationConfig(
        max_new_tokens=task.decoder_max_len - 1,
        bos_token_id=tokenizer.bos_token_id, eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id, mask_token_id=tokenizer.pad_token_id,
        special_token_ids=(pmt_sep, tokenizer.bos_token_id, tokenizer.sep_token_id),
        token_type_sections=(0, 1, 0, 1),
    )
    rollout, grad_step = make_scst_step(config, gen_sample, gen_base, tx, trainable_mask=mask,
                                        pad_id=tokenizer.pad_token_id,
                                        compute_dtype=_compute_dtype(task))

    def split_fn(token_ids):
        return ed.split_and_decode_sections(
            token_ids,
            [tokenizer.bos_token_id, tokenizer.sep_token_id, tokenizer.eos_token_id],
            tokenizer,
        )

    row_shard = mesh_mod.local_row_range(task.mbatch_size) if dist.initialized() else None
    trainer = SCSTTrainer(config, rollout, grad_step, reward_fn, split_fn, row_range=row_shard)
    train_set = make_datasets(task, "train", train=True)
    val_set = make_datasets(task, "validate", train=False)
    metrics = make_metrics(task, "val", chexbert_fn=chexbert_fn)
    gen_prompt_scst = task.variant == "scst"

    # Resume (reference tools/stages.py:88 resumes every fit, SCST included).
    # Mid-epoch saves restart inside the same epoch with the loader
    # fast-forwarded; the generated-prompt history written back earlier in
    # that epoch comes from the checkpoint's sidecar, and the epoch's
    # subject->lane allocation is rebuilt from its seed.
    state, start_epoch, skip_batches, global_step, resume_path = _resolve_fit_resume(task, state)
    # per-rank sidecar name, the JAX package's (each rank's history covers its own lanes)
    history_sidecar = f"scst_history.rank{dist.rank()}.json"
    resume_history = None
    if resume_path and skip_batches and gen_prompt_scst:
        # the union over every rank's sidecar is the whole history
        resume_history = {}
        for name in sorted(os.listdir(resume_path)):
            if name.startswith("scst_history.rank") and name.endswith(".json"):
                blob = ck.checkpoint_extra_file(resume_path, name)
                if blob is not None:
                    resume_history.update(json.loads(blob))
        if not resume_history:
            # checkpoints from before the per-rank sidecars
            blob = ck.checkpoint_extra_file(resume_path, "scst_history.json")
            resume_history = json.loads(blob) if blob is not None else None

    def run_validation(state, epoch, step=None, n_batches=None, gstep=None):
        extra_files = None
        if gen_prompt_scst and step is not None:
            extra_files = {history_sidecar: json.dumps(train_set.export_generated())}
        _validate_and_save(task, config, tokenizer, state, val_set, metrics, epoch, step=step,
                           n_batches=n_batches, gstep=gstep, extra_files=extra_files)

    collate_max = _collate_max_images(task)
    if multiprocess and collate_max is None and task.variant != "single":
        collate_max = task.max_images_per_study
    warmer = _start_cache_warmer(task, train_set, val_set)
    try:
        for epoch in range(start_epoch, task.max_epochs):
            if hasattr(train_set.load_image, "set_epoch"):
                train_set.load_image.set_epoch(epoch)
            skip = skip_batches if epoch == start_epoch else 0
            if gen_prompt_scst:
                # per-epoch subject->lane reallocation + history reset (scst/gen_prompt.py:152-158)
                train_set.allocate_subjects_to_rank(
                    seed=(epoch + task.trial + 1) * (task.trial + 1)
                )
                train_set.reset_generated()
                if skip and resume_history is not None:
                    train_set.import_generated(resume_history)
                # sequential in allocator order (scst/gen_prompt.py:118), batch t
                # row j is lane j; no prefetch: __getitem__ reads history written
                # back after each step (the reference's num_workers=0 loaders)
                it = batch_iterator(train_set, task.mbatch_size, max_images=collate_max,
                                    drop_last=True, row_shard=row_shard, skip_batches=skip)
            else:
                # scst_gt inherits GTPrompt's ordinary shuffled loader
                it = Prefetcher(
                    batch_iterator(train_set, task.mbatch_size, shuffle=True, seed=epoch,
                                   max_images=collate_max, drop_last=True,
                                   row_shard=row_shard, skip_batches=skip)
                )
            # len(train_set) can change per epoch (the allocator oversamples to
            # lane divisibility): the fractional-validation schedule is per epoch
            val_every, total_batches = _mid_epoch_schedule(task, len(train_set))
            n_batches = skip
            fresh = 0
            for batch in it:
                prompt = ed.tokenize_prompt(
                    batch["previous_findings"], batch["previous_impression"], tokenizer,
                    task.decoder_max_len, add_bos_token_id=True,
                )
                # bucketed like the eval prompts; exact: the first token comes
                # from the true batch-longest column, the pad columns are masked
                true_width = prompt["input_ids"].shape[1]
                if multiprocess:
                    # every rank takes the global batch's longest width (what
                    # one process pads to) and its first-token column
                    prompt, true_width = _pad_prompt(prompt, global_max_int(true_width),
                                                     tokenizer.pad_token_id)
                p_ids, p_mask = ed.bucket_prompt(
                    prompt["input_ids"], prompt["attention_mask"], tokenizer.pad_token_id,
                    bucket=32, max_len=task.decoder_max_len,
                )
                gen = tt.train_generator(task.trial, global_step, device=device)
                state, logs, (b_f, b_i) = trainer.step(
                    state, np.asarray(batch["images"], np.float32), p_ids.astype(np.int32),
                    p_mask.astype(np.int32), batch["findings"], batch["impression"], gen,
                    prompt_logits_col=true_width - 1,
                )
                _log_scalars(task, {"epoch": epoch, **logs})
                if gen_prompt_scst:
                    # baseline outputs feed the history for later studies of the subject
                    for sid, f, i in zip(batch["study_ids"], b_f, b_i):
                        train_set.record_generated(sid, f, i)
                n_batches += 1
                fresh += 1
                global_step += 1
                if val_every and n_batches % val_every == 0 and n_batches < total_batches:
                    run_validation(state, epoch, step=global_step, n_batches=n_batches,
                                   gstep=global_step)
                if task.fast_dev_run and fresh >= 1:
                    break
            if hasattr(it, "close"):
                it.close()
            if (epoch + 1) % task.every_n_epochs == 0 or task.fast_dev_run:
                run_validation(state, epoch, gstep=global_step)
            if task.fast_dev_run:
                break
    finally:
        if warmer is not None:
            warmer.stop()


def _restore_for_test(path: str, config, device) -> ed.EncoderDecoder:
    """The weights of a training checkpoint as a model holding exactly its
    parameter set (as the JAX test stage restores the saved tree itself)."""
    return model_from_state_dict(_saved_model_state(path), config, device)


def test(task: TaskConfig, chexbert_fn=None, reward_fn=None, bertscorer=None) -> Dict:
    """The test stage: restore, decode (beam ``num_test_beams``), score.
    Under a process group every rank restores the same checkpoint, whole,
    cuts its model rank's shard and decodes its data rank's share
    (``evaluate``); every rank returns the gathered scores, and rank 0
    writes the CSVs."""
    from cxrmate_torch.eval.metrics import ReportLogger, ReportTokenIdentifiersLogger

    mesh_mod.make_mesh(task.mesh_data, task.mesh_model)
    tokenizer = load_tokenizer(task)
    config = build_model_config(task, len(tokenizer))
    model = init_variables(task, config)
    if task.test_ckpt_name:
        # dataclasses.replace, NOT TaskConfig(**task.__dict__): parse_args sets
        # non-field attributes (_train/_test) on the instance
        model = resolve_warm_start(
            dataclasses.replace(task, warm_start_name=task.test_ckpt_name,
                                warm_start_ckpt_path=None, warm_start_exp_dir=None),
            config, model,
        )
    elif task.fast_dev_run:
        pass  # fresh init, no checkpoint resolution (tools/stages.py:97-99)
    else:
        # explicit path > specific epoch > best-by-monitor (tools/stages.py:103-105)
        path = ck.get_test_ckpt_path(
            task.exp_dir_trial, task.monitor_mode, task.test_epoch, task.test_ckpt_path
        )
        if not path:
            # never silently score random weights; fast_dev_run is the
            # sanctioned no-checkpoint smoke path
            raise FileNotFoundError(
                f"--test found no checkpoint under {task.exp_dir_trial} "
                f"(train first, pass test_ckpt_path/test_ckpt_name, or use "
                f"fast_dev_run for an untrained smoke run)"
            )
        model = _restore_for_test(path, config, next(model.parameters()).device)
    model = mesh_mod.shard_model(model)
    test_set = make_datasets(task, "test", train=False)
    metrics = make_metrics(task, "test", reward_fn=reward_fn, chexbert_fn=chexbert_fn,
                           bertscorer=bertscorer)
    loggers = (
        ReportLogger("test_reports", task.exp_dir_trial, task.variant == "single"),
        ReportTokenIdentifiersLogger("test_report_ids", task.exp_dir_trial,
                                     task.variant == "single"),
    )
    warmer = _start_cache_warmer(task, test_set)
    try:
        return evaluate(
            task, model.config, tokenizer, model, test_set, "test", metrics,
            task.num_test_beams, 0, loggers,
        )
    finally:
        if warmer is not None:
            warmer.stop()


def _hf_config(path: str) -> Optional[Dict]:
    cfg_json = os.path.join(path, "config.json")
    if not os.path.exists(cfg_json):
        return None
    with open(cfg_json) as f:
        return json.load(f)


def build_cxrbert_reward(task: TaskConfig):
    """Load the CXR-BERT reward model from the checkpoint zoo
    (``microsoft/BiomedVLP-CXR-BERT-specialized``: weights + vocab.txt), fp32
    on ``task.device``. The architecture comes from the state dict's shapes,
    the head count from config.json when present, else 64-dim heads
    (``reward.cxrbert.cxrbert_config_from_state_dict``); so the synthetic zoo's
    tiny CXR-BERT (``data.synthetic.build_synthetic_cxrbert``) drives the same
    code path in dry runs."""
    from cxrmate_torch.reward.cxrbert import (CXRBERTReward, cxrbert_config_from_state_dict,
                                              load_cxrbert)
    from cxrmate_torch.tokenizer.wordpiece import WordPieceTokenizer

    path = os.path.join(task.ckpt_zoo_dir, "microsoft", "BiomedVLP-CXR-BERT-specialized")
    sd = hf.load_hf_pretrained_dir(path)
    model = load_cxrbert(sd, cxrbert_config_from_state_dict(sd, _hf_config(path)),
                         device=task.device)
    tok = WordPieceTokenizer.from_file(os.path.join(path, "vocab.txt"))
    return CXRBERTReward(model, tok)


def build_bertscorer(task: TaskConfig):
    """Load the BERTScore encoder from the checkpoint zoo: roberta-large at
    hidden layer 17 with bert-score's rescale baseline
    (``tools/metrics/bertscore.py:84-94``), an HF checkpoint dir
    (``roberta-large`` or ``FacebookAI/roberta-large``) with the baseline
    (``roberta-large.tsv``) beside the weights. A missing baseline warns and
    reports raw scores under keys suffixed ``_unrescaled``."""
    from cxrmate_torch.eval.bertscore import (BERTScorer, RobertaBPETokenizer, load_rescale_baseline,
                                              load_roberta)

    candidates = [
        os.path.join(task.ckpt_zoo_dir, "roberta-large"),
        os.path.join(task.ckpt_zoo_dir, "FacebookAI", "roberta-large"),
    ]
    path = next((p for p in candidates if os.path.isdir(p)), None)
    if path is None:
        raise FileNotFoundError(
            f"no roberta-large checkpoint dir under {task.ckpt_zoo_dir} "
            f"(looked for {candidates})"
        )
    heads = (_hf_config(path) or {}).get("num_attention_heads")
    model = load_roberta(hf.load_hf_pretrained_dir(path), num_attention_heads=heads,
                         device=task.device)
    cfg = model.config
    tok = RobertaBPETokenizer.from_dir(path)
    num_layers = min(17, cfg.num_hidden_layers)  # roberta-large: layer 17
    baseline = None
    for bl in (os.path.join(path, "roberta-large.tsv"),
               os.path.join(path, "rescale_baseline.tsv")):
        if os.path.exists(bl):
            baseline = load_rescale_baseline(bl, num_layers)
            break
    if baseline is None:
        warnings.warn(
            "BERTScore rescale baseline file not found next to the roberta-large "
            "weights — reporting raw (unrescaled) scores; the reference rescales "
            "(tools/metrics/bertscore.py:93)",
            RuntimeWarning,
            stacklevel=2,
        )
    return BERTScorer(
        model, tok, num_layers=num_layers, roberta_positions=True,
        baseline=baseline, max_length=cfg.max_position_embeddings - 2,
    )


def build_chexbert_fn(task: TaskConfig):
    """Load the CheXbert labeler (Stanford checkpoint + bert-base-uncased vocab)."""
    from cxrmate_torch.eval.chexbert import chexbert_predict, load_chexbert
    from cxrmate_torch.tokenizer.wordpiece import WordPieceTokenizer

    ckpt = os.path.join(task.ckpt_zoo_dir, "stanford", "chexbert", "chexbert.pth")
    vocab = os.path.join(task.ckpt_zoo_dir, "bert-base-uncased", "vocab.txt")
    model = load_chexbert(hf.load_torch_checkpoint(ckpt), device=task.device)
    tok = WordPieceTokenizer.from_file(vocab)
    return lambda reports: chexbert_predict(model, tok, reports)


def _optional(builder, task):
    """Build an optional metric model (CheXbert / CXR-BERT); on failure, warn
    LOUDLY about the degradation instead of silently dropping the metric."""
    try:
        return builder(task)
    except (FileNotFoundError, AssertionError, KeyError) as e:
        warnings.warn(
            f"{builder.__name__} unavailable ({type(e).__name__}: {e}) — the "
            "corresponding metrics are skipped and checkpoint selection falls back "
            "to an NLG surrogate (see resolve_monitor)",
            RuntimeWarning,
            stacklevel=2,
        )
        return None


def main(argv=None):
    from cxrmate_torch.cli.config import parse_args

    task = parse_args(argv)
    # join the process group of a torchrun launch (WORLD_SIZE set) before
    # anything else; a failure raises rather than train alone
    joined = initialize_if_needed(task.device)
    try:
        _main(task)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _main(task: TaskConfig) -> None:
    resolve_device(task.device)
    if task.resolved_xla_cache_dir is not None:
        warnings.warn(
            f"xla_cache_dir={task.xla_cache_dir!r} is the JAX package's compilation "
            "cache; the port compiles no XLA programs and ignores it",
            RuntimeWarning,
            stacklevel=2,
        )
    chexbert_fn = _optional(build_chexbert_fn, task)
    if getattr(task, "_train", False):
        if task.variant == "gen_prompt":
            # the reference's GeneratedPrompt is test-only (gen_prompt.py:33-34
            # raises 'Only testing can be performed'): its dataset prompts from
            # history generated DURING evaluation; training it is undefined
            # (the trainable generated-prompt task is `scst`)
            raise ValueError(
                "variant 'gen_prompt' is test-only (the reference raises the "
                "same); train with 'gt_prompt' (teacher-forced) or 'scst' "
                "(self-generated prompts + CXR-BERT reward) instead"
            )
        if task.variant in ("scst", "scst_gt"):
            fit_scst(task, build_cxrbert_reward(task), chexbert_fn=chexbert_fn)
        else:
            fit(task, chexbert_fn=chexbert_fn)
    if getattr(task, "_test", False):
        scores = test(task, chexbert_fn=chexbert_fn,
                      reward_fn=_optional(build_cxrbert_reward, task),
                      bertscorer=_optional(build_bertscorer, task))
        if dist.rank() == 0:
            for k, v in sorted(scores.items()):
                print(f"{k}: {v}")


if __name__ == "__main__":
    main()
