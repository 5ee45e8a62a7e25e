#!/usr/bin/env python3
"""Drive the PyTorch port (cxrmate_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout; needs one card

Phases, each printing one JSON line:
  1. device  - the card (nvidia-smi name and power limit), torch and CUDA.
  2. build   - builds the CUDA kernels from cxrmate_torch/csrc (nvcc, sm_90a);
               the registers and spills of the split kernel's
               instantiations (decode_attention, decode_attention_vpu,
               decode_attention_q8, fused_cross_attn) and of fused_qkv_attn,
               fused_out_ln_q, fused_out_ln_ffn and fused_layer_step (v1)
               from the build log (-Xptxas -v).
  3. kernels - each of the thirteen kernels against its plain PyTorch version on
               the card at every shape a main path below gives it (one table,
               main_path_calls, lists them: the multi, single and longitudinal
               calls, self caches 256 to 511 columns wide behind prompts whose
               pads are masked inside the key range, 8 and 32 rows, and the
               SCST rollout's 2 and 16 rows), fp32 (TF32
               off, <= 1e-5) and bf16 (<= 1e-2), each decode kernel also with
               a fully masked row, the reorder bit-exact at the first, a
               middle and the last column; times of the kernel, the plain
               version, one PyTorch library call computing the same function
               (timed only, never used by the port) and the least time the
               card could take (bound); for the decode kernels also the
               device time of the kernel alone and of the library call from
               torch.profiler, in a last phase (kernels_device: a profiler
               session slows every later launch, and with it the host-bound
               decode steps). decode_attention, decode_attention_vpu and
               decode_attention_q8 split each (row, head)'s keys over a
               thread-block cluster and never read a masked key: each shape
               prints n_split, the share of keys read and the bytes read
               against every key's, and setting the masked keys' K/V rows to
               NaN (for the int8 kernel: the rows random, both scales NaN)
               must leave the output's bits as they were; the same checks at
               edge shapes of the split (DECODE_EDGES: S below a tile, around
               full blocks, every key of one block masked, the only unmasked
               key in the last tile, the largest S, the int8 kernel's own
               for it). In bf16 the rounding
               points, which a tolerance cannot see, are held by bit shares:
               decode_attention must match its plain version more often than
               a version that skips rounding the probs, the int8 kernel more
               often than versions that round the probs before the V-scale
               fold or never.
               For the int8 kernel also integer-valued K/V (<= 2e-3) and its
               distance from exact attention on the unquantised K/V (max <
               0.1, RMS < 0.02). For the multiply-reduce kernel also the share
               of outputs bit-identical to its plain version and to
               decode_attention's kernel, and that a row's bits are the same
               alone and in its batch. The four kernels of the fused
               decoder-layer step at the fused path's shapes (8 studies, T =
               256, S = 2,880 with 15 of 40 image slots masked, the step at
               columns 1, 128 and 255), also with a fully masked row, the new
               K/V column written where it belongs and the rest of the cache
               bit-exact, the self-attention kernel (its q/k/v projection
               split-K), fused_out_ln_q and the FFN kernel (split-K passes)
               also at 11 studies with each row's bits (and the written
               column's) the same alone, among 8 and among 11, the
               cross-attention kernel (the split body under the
               fused contract) also at the edges of its split (CROSS_EDGES: S
               from 1 to its largest) with NaN in the masked keys' K/V rows
               leaving its bits unchanged and a fully masked study finite;
               their times are
               taken one launch at a time with the L2 cache flushed before
               each, as a decode step finds it.
               The three kernels of flash_attention_grad (the forward with
               log-sum-exp rows, dq, dk/dv) at the CvT-21@384 stage shapes
               of a training micro-step of 20 images, fp32 and bf16, within
               1e-5 / 1e-2 of the largest output, the forward's out bit-equal
               to flash_attention's; timed beside SDPA's forward and aten's
               flash backward (dq, dk and dv in one call, bf16), the
               yardsticks, per stage shape and in sum. All three run on
               tensor cores in bf16 (per stage shape and call counts in
               per_shape) and as SIMT kernels in fp32. Where bf16 F.linear
               (ops/layers.py:linear) adds the bias: the share of its outputs
               bit-equal to the fp32 product plus the fp32 bias rounded once,
               and to the same rounded twice (the product first), at the main
               paths' linear shapes, 2-D and 3-D, contiguous and transposed
               views. fused_layer_step (v1, one kernel per layer; no
               path calls it, as in the JAX package) at the fused path's
               shapes against its plain version (fp32 <= 1e-5, bf16 <= 1e-2
               of the largest output), the written column and the untouched
               rest, with fully masked self and cross rows, and against v2 on
               the same operands; each row's bits the same alone, among 8 and
               among 11, and, at the edges of its cross split (V1_EDGES: S
               from 1 to the fused cross kernel's largest), NaN in the masked
               cross keys' K/V rows leaving its bits unchanged; timed cold
               beside v2's four kernels summed.
  4. main    - seeded random full-width models (CvT-21@384, BERT 6x768, the
               repository tokenizer's vocabulary) written as HF directories,
               loaded with CXRMate.from_hf_checkpoint and run through
               generate_report on 8 studies in bf16, one untimed call before
               the timed ones: multi (5 image slots, some all-zero), greedy
               and beam-4, three timed calls each; longitudinal (LoRA with a
               randomised lora_B, PEFT key names, synthetic previous reports
               whose prompts fall in the 64-, 128- and 256-token buckets, two
               studies without a previous report, one prompt truncated at 256)
               beam-4 with the default spec, beam-4 and greedy with
               cross-rowgroup-q8, greedy and beam-4 with vpu-rowgroup and one
               sampled call; single (one image per study), greedy and beam-4.
               Then the fused path: CXRMate.encode -> generate(use_fused=True)
               -> split_and_decode_sections on the multi model, three timed
               calls, in turns with the unfused greedy through the same entry
               points. studies/s, new tokens/s and ms per step of every call;
               each call's launch counts checked against the counts its path
               and spec imply.
  5. parity  - the whole path with the kernels against the same path with
               every kernel swapped for its plain version: encoder states,
               greedy decoder logits over a prefill and 16 teacher-fed steps,
               and beam-4 logits over 16 teacher-fed steps with the deferred
               write and the reorder; for the multi model and, with a padded
               prompt, for the longitudinal model under the default spec,
               vpu-rowgroup and cross-rowgroup-q8 (against the plain path over
               the same quantised cache); fp32 (TF32 off) held to 1e-3, bf16
               to 0.25; the greedy token agreement and the q8 path's distance
               from the unquantised path are printed. The fused path against
               the fused path over the plain versions (same limits), and in
               fp32 against the unfused path (1e-3), with the share of greedy
               tokens that agree; one decode step with every layer through
               v1 against the same step through v2, from the caches of a
               prefill and 7 teacher-fed steps (same limits, 6 v1 launches).
  6. train   - 8 bf16 teacher-forcing micro-steps of the multi model at full
               width (one AdamW update), their launch counts and the
               forward/backward split; then a micro-step against the plain
               path, fp32 and bf16.
  7. scst    - SCST of the longitudinal model at full width with a random
               CXR-BERT at its published widths (BERT-base, projection 128,
               vocabulary 30,522 with its own vocab.txt), bf16 on fp32
               masters, lr 5e-6, an update every step, through make_scst_step
               -> SCSTTrainer.step: at 1 and 8 studies one untimed step and 3
               timed ones, each split into encode, the rollout's decode (ms
               per decode step), the reward and the grad step (the AdamW
               update apart); studies/s, peak memory, launch counts (21
               flash_attention per encode, 12 decode_attention per decode
               step, no other kernel), the sampled tokens that the
               re-forward's own top-50 would mask; each sampled token
               inside the top 50 of its step's warped logits; the encoder's
               parameters and BatchNorm statistics bit-unchanged. Then the
               step against its plain path: the rollout's logits over both
               halves, teacher-fed (fp32 <= 1e-3, bf16 <= 0.25), one fp32
               grad step's loss and decoder gradients (<= 1e-3 of each
               tensor's largest), and the reward on fixed strings, card
               against CPU (<= 1e-5).
  8. checkpoint - (after train) training checkpoints (ckpt/checkpoints.py) of
               the multi model at full width, bf16 on fp32 masters, dropout
               on: 8 micro-steps straight through against 5 micro-steps,
               save_checkpoint mid-accumulation (AdamW over 4: one update
               applied, one micro-step accumulated), restore_checkpoint into
               a train state built anew, and 3 more; every master, BatchNorm
               buffer, moment and accumulated gradient bit-equal at the end.
               Three epoch-end saves with monitor values under keep_top_k 1:
               get_test_ckpt_path picks the best, the rest pruned, last/
               kept. Save and restore ms, MB on disk, launch counts.
  9. score   - (after the SCST parity) the test stage below the CLI: the
               checkpoint get_test_ckpt_path picked restored into a CXRMate
               (bf16), 8 studies decoded with beam-4 through generate_report
               (launch counts checked), then 64 studies (those 8 and 56
               synthetic) through the accumulators of make_metrics(test) for
               findings and impression: NLG (BLEU, CIDEr, ROUGE-L, METEOR on
               the host), CheXbert (random BERT-base + 14 heads), CXR-BERT
               (the SCST phase's random reward model) and BERTScore (random
               roberta-large cut at layer 17, a synthetic baseline), fp32:
               each family's compute() ms (median of 3 after one untimed run;
               the model families at micro-batches of 4 and 16), peak memory,
               no custom kernel launched inside compute(), two NLG runs'
               scores and CSV files identical, and the scorers on the card
               against the CPU on the 8 decoded and 8 synthetic findings
               (TF32 off: CheXbert logits <= 1e-5 of the largest and its
               class ids where the CPU's top two are > 1e-4 apart, BERTScore
               P/R/F1 and CXR-BERT <= 1e-5; BERTScore relative to the value
               on a row where a text has no token to match, which scores
               about -1e9 there, as in the JAX package).
  10. data    - (after score) the data pipeline (cxrmate_torch/data) feeding
               the test stage: the port's JPEG decoder held bit for bit to
               PIL's pixels of the committed fixtures
               (cxrmate_torch/tools/jpeg_fixtures); a MIMIC-CXR-JPG-layout
               tree of 24 studies of 12 subjects (two a day apart, 5, 4, 3,
               2, 1 images in turn: 74 gray 3,056 x 2,544 JPEGs from the
               port's encoder at quality 75, the merged CSV from the port's
               table) and build_synthetic_dataset at its defaults; the
               codec's decode, resize + crop and cache put/get ms on one
               thread; build_merged_index -> filter_split -> StudyDataset ->
               batch_iterator (8 studies, 5 slots) epochs with the cache off,
               cold and warm at 0 and 5 threads (images/s; every epoch's
               batches equal); device_normalize_gray_u8 on the card
               bit-equal to the host path in bf16, device_preprocess within
               1e-5 of the CPU (fp32, TF32 off); then the test stage: the
               score phase's restored multi model, beam-4 in bf16, the
               batches from memory, then file-fed through a Prefetcher (5
               threads) with the cache off, cold and warm: studies/s, the
               wait on the Prefetcher and host-to-device ms per batch, each
               batch on the card bit-equal to the CPU's, the same token ids
               as from memory, launch counts; one PreviousReportDataset
               batch (ground-truth prompts) through the longitudinal model;
               one training micro-step fed by make_train_loader_transform's
               full-scale route (native_decode=False; 21 launches of each
               flash_attention_grad kernel); peak device memory.
  11. cli     - (after data) the train/test CLI, cxrmate_torch.cli.stages.main
               on the repository's configs at full width: a MIMIC-CXR-JPG-
               layout tree of 10 subjects (4 train, 2 validate, 4 test; two
               studies each, 5, 4, 3, 2, 1 images in turn) and a zoo holding
               the main phases' random multi and longitudinal checkpoints as
               aehrc/cxrmate-multi-tf and aehrc/cxrmate-tf, the repository
               tokenizer and build_synthetic_cxrbert's CXR-BERT: --train
               config/train/multi_tf.yaml (2 bf16 micro-steps, one AdamW
               update, greedy validation in fp32, a checkpoint); --test
               config/test/multi_tf.yaml on its best checkpoint (beam-4 over 8
               studies, fp32); --train longitudinal_gt_prompt_tf.yaml and
               longitudinal_gen_prompt_cxr-bert.yaml (SCST) with
               fast_dev_run; the test again as `python -m
               cxrmate_torch.cli.stages` in a subprocess. Each run's launch
               counts against what its encodes, decode steps and beam
               searches imply, no plain version run, losses finite,
               metrics.jsonl with the JAX package's keys, the test's token
               ids equal across the two test runs and to restore_model +
               _decode_step_outputs; wall seconds, ms per micro-step, decode
               and save seconds, MB written, peak memory; whether yaml and
               transformers import there; the TF32 settings.
  12. tensor_parallel - (after multiprocess, beside its one-process runs)
               the CLI with mesh_model=2 on gloo ranks sharing the card
               (python -m torch.distributed.run ... cli.stages): the multi
               fit (bf16) and the beam-4 test (fp32) at mesh 2x2, SCST (fp32)
               at 1x2, under the multiprocess phase's gates; decode_attention
               and beam_reorder_write at 6 and 3 heads (a model rank's at
               model 2 and 4) against their plain versions; each rank's
               launches, ms per micro-step, model-group collectives (per
               decode step and their ms) and peak memory.
  13. entry   - (after tensor_parallel, on the cli phase's tree and zoo) the
               user entry points and the loaders' native routes: the scaled
               and fast decodes held bit for bit to the route fixtures
               (cxrmate_torch/tools/jpeg_fixtures, tied to libjpeg by
               tests/test_torch_scaled_decode.py); ms per image on one thread
               of the decode at denoms 1 (the full decode), 2, 4 and 8, of
               the fast route (IFAST and ISLOW) and of the train and eval
               loaders' prefixes, on the tree's 3,056 x 2,544 JPEGs; one bf16
               training micro-step fed by the default (native) train loader
               (21 launches of each flash_attention_grad kernel); the fast
               eval loader -> device_normalize_gray_u8 (padding slots zeroed)
               -> multi beam-4 over 8 studies; the three generate examples
               through main(argv) (their defaults: beam-4, 384 px, up to
               decoder_max_len - 1 new tokens, fp32), their reports
               and printed lines equal to a direct generate_report call;
               scripts.warm_cache over the tree, then the test stage from that
               cache (no JPEG decoded) and with the cache off, the same token
               ids; scripts.reproduce_test_set (greedy) twice, the second 100%
               identical to the first's CSV; scripts.convert_checkpoint both
               ways, state.pt and the exported .npz decoding the HF
               directory's token ids; examples.train_tokenizer on the tree and
               the native BPE encoder equal to the Python encoder, both
               encoders' rates. Every run's launch counts checked.
  14. kernels_device - the device time of each decode-attention kernel and of
               its library call at every main-path call shape, and of the
               beam reorder and its library calls at every main-path cache
               width (bf16), from torch.profiler; last, because a profiler
               session slows every later launch.
Then the card's name and power limit, the kernels summary line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is then
non-zero and the last line is not printed. The summary line has one row per
kernel and set of shapes, with the launches of the timed calls that ran the
kernel at those shapes.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
STUDIES, SLOTS = 8, 5
IMAGES_PER_STUDY = (5, 4, 3, 2, 1, 5, 3, 2)  # the remaining slots are all-zero
SEED = 0
HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate
# H100 SXM peaks: dense bf16 tensor cores; fp32 without tensor cores (TF32 off)
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PARITY_TOL = 1e-3  # fp32 end to end: reassociation through 21 CvT + 6 decoder layers
# bf16 end to end: the kernel path against the plain path, same token feed;
# about 8x the 0.031 measured on an H100 (chip_smoke.py), to catch a broken
# kernel rather than bf16 rounding
BF16_PARITY_TOL = 0.25
MAIN_RUNS = 3  # timed generate_report calls per decoding mode
SMOKE_DIR = os.path.join(REPO, ".chip_smoke")
NEG = -3.4028234663852886e38  # finfo(float32).min, the additive mask of a masked key


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- timing
def time_ms(fns, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, cycling through ``fns`` (the same call on
    different inputs, so that a cache-sized input is not found in L2)."""
    import torch

    fns = list(fns)
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fns, reps: int = 20, warmup: int = 3):
    """Mean device time of one call from torch.profiler: the self device
    time of every kernel the calls launched, over ``reps`` calls, cycling
    through ``fns``; "not measured" where the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fns = list(fns)
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    return total / reps if total > 0 else "not measured"


def ptxas_report(log: str):
    """Registers and spills of each instantiation of the split decode kernel
    (csrc/decode_split.cuh: decode_attention, decode_attention_vpu,
    decode_attention_q8 and fused_cross_attn) and of the kernels of
    fused_qkv_attn, fused_out_ln_q, fused_out_ln_ffn and fused_layer_step
    (v1), from the -Xptxas -v lines of the build log."""
    import re

    out, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
        split = name and re.search(
            r"decode_split_kernelI(f|13__nv_bfloat16)(a|f|S\d*_)Li(\d)ELb(\d)E", name)
        dense = name and re.search(
            r"(out_ln_ffn|qkv_attn|out_ln_q|layer_step)_kernelI(f|13__nv_bfloat16)E", name)
        if not (split or dense):
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        used = re.search(r"Used (\d+) registers", line)
        if spill or used:
            if not out or out[-1]["mangled"] != name:
                if dense:
                    row = {"kernel": f"fused_{dense.group(1)}",
                           "dtype": "fp32" if dense.group(2) == "f" else "bf16"}
                else:
                    row = {"kernel": "fused_cross_attn" if "5FusedE" in name else
                           "decode_attention_q8" if split.group(2) == "a" else
                           "decode_attention_vpu" if split.group(4) == "1" else
                           "decode_attention",
                           "dtype": "fp32" if split.group(1) == "f" else "bf16",
                           "max_m": int(split.group(3))}
                out.append({**row, "mangled": name})
            if spill:
                out[-1].update(spill_store_bytes=int(spill.group(1)),
                               spill_load_bytes=int(spill.group(2)))
            if used:
                out[-1]["registers"] = int(used.group(1))
    return out


def bound_ms(nbytes: float, flops: float, dtype: str):
    """Least time: the larger of bytes over the memory rate and operations
    over the peak rate for their type; and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -------------------------------------------------------------- kernel checks
LAYERS, HEADS, HEAD_DIM = 6, 12, 64  # decoder layers; heads and their width
NEW_TOKENS = 255  # cache columns after the prompt: decoder_max_len - 1
COPIES = 4  # input sets a timing cycles through
# kernel: (source, the TPU kernel it replaces)
KERNELS = {
    "flash_attention": ("cxrmate_torch/csrc/flash_attention.cu",
                        "cxrmate_tpu/ops/flash_attention.py:60"),
    "decode_attention": ("cxrmate_torch/csrc/decode_attention.cu",
                         "cxrmate_tpu/ops/decode_attention.py:50"),
    "decode_attention_vpu": ("cxrmate_torch/csrc/decode_attention_vpu.cu",
                             "cxrmate_tpu/ops/decode_attention.py:221"),
    "decode_attention_q8": ("cxrmate_torch/csrc/decode_attention_q8.cu",
                            "cxrmate_tpu/ops/decode_attention.py:310"),
    "beam_reorder_write": ("cxrmate_torch/csrc/beam_reorder.cu",
                           "cxrmate_tpu/ops/beam_reorder.py:58"),
    "fused_qkv_attn": ("cxrmate_torch/csrc/fused_qkv_attn.cu",
                       "cxrmate_tpu/ops/fused_decode.py:251"),
    "fused_out_ln_q": ("cxrmate_torch/csrc/fused_out_ln_q.cu",
                       "cxrmate_tpu/ops/fused_decode.py:304"),
    "fused_cross_attn": ("cxrmate_torch/csrc/fused_cross_attn.cu",
                         "cxrmate_tpu/ops/fused_decode.py:291"),
    "fused_out_ln_ffn": ("cxrmate_torch/csrc/fused_out_ln_ffn.cu",
                         "cxrmate_tpu/ops/fused_decode.py:320"),
    "flash_attention_fwd_lse": ("cxrmate_torch/csrc/flash_attention.cu",
                                "cxrmate_tpu/ops/flash_attention.py:109"),
    "flash_attention_bwd_dq": ("cxrmate_torch/csrc/flash_attention_bwd.cu",
                               "cxrmate_tpu/ops/flash_attention.py:137"),
    "flash_attention_bwd_dkv": ("cxrmate_torch/csrc/flash_attention_bwd.cu",
                                "cxrmate_tpu/ops/flash_attention.py:161"),
    "fused_layer_step": ("cxrmate_torch/csrc/fused_layer_step.cu",
                         "cxrmate_tpu/ops/fused_decode.py:164"),
}
FUSED = ("fused_qkv_attn", "fused_out_ln_q", "fused_cross_attn", "fused_out_ln_ffn")
# the kernels of flash_attention_grad, CvT's attention in training
FLASH_GRAD = ("flash_attention_fwd_lse", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# teacher-forcing training (config/train/multi_tf.yaml): 4 studies x 5 image
# slots per micro-step, reports up to decoder_max_len, AdamW lr 5e-5, 8
# micro-steps per update (accumulated_mbatch_size 32), bf16 on fp32 masters
TRAIN_IMAGES = IMAGES_PER_STUDY[:4]
TRAIN_ACCUM, TRAIN_LR = 8, 5e-5
# fp32 (TF32 off) / bf16 kernel-vs-plain limits of the three flash_attention_grad
# kernels, relative to the largest output: sums over up to 9,216 terms in
# another order (2.4e-6 in fp32 on an H100); in bf16 the one rounding of the
# output, 2^-8 relative, where the two fp32 sums round to neighbouring values
FLASH_GRAD_TOL = {"fp32": 1e-5, "bf16": 1e-2}
D_MODEL, D_FF = HEADS * HEAD_DIM, 3072  # the decoder's width and its FFN's
# (mode, beams, routing spec, longest prompt in tokens, the 32-token bucket the
# batch's prompts are padded to, sampling arguments): the longitudinal calls
LONGITUDINAL_RUNS = (
    ("beam4", 4, None, 300, 256, None),  # truncated at 256
    ("beam4-q8", 4, "cross-rowgroup-q8", 104, 128, None),
    ("greedy-q8", 1, "cross-rowgroup-q8", 44, 64, None),
    ("greedy-vpu", 1, "vpu-rowgroup", 200, 224, None),
    ("beam4-vpu", 4, "vpu-rowgroup", 44, 64, None),
    ("sampled", 1, None, 104, 128, {"top_k": 50, "top_p": 0.9}),
)


# SCST (config/train/longitudinal_gen_prompt_cxr-bert.yaml): lr 5e-6 on fp32
# masters, bf16 compute, the decoder-only mask; mbatch_size 1 (the config's)
# and 8 (the serving phases' STUDIES); accumulate_steps 1, not the config's 32,
# so that every step applies an update; one untimed step, then SCST_RUNS timed
SCST_BATCHES, SCST_LR, SCST_RUNS = (1, 8), 5e-6, 3
# the previous reports' longest prompt (study 0's) and its 32-token bucket
SCST_LONGEST, SCST_BUCKET = 104, 128
# CXR-BERT at the widths of microsoft/BiomedVLP-CXR-BERT-specialized's
# config.json (BERT-base: 768 wide, 12 layers of 12 heads, intermediate 3,072,
# 512 positions; vocab_size 30,522, projection_size 128); random weights
CXRBERT_VOCAB, CXRBERT_PROJECTION, CXRBERT_LAYERS, CXRBERT_POSITIONS = 30522, 128, 12, 512
CXRBERT_SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
# checkpoints (config/train/multi_tf.yaml, as the train phase): CKPT_STEPS bf16
# micro-steps straight through against CKPT_SAVE_AT, a save, a restore into a
# train state built anew and the rest; AdamW accumulating over CKPT_ACCUM, a
# cut from the config's 8 so that the save holds an applied update and a
# running accumulation; then three epoch-end saves with these monitor values
# under keep_top_k 1 (the second is the best)
CKPT_ACCUM, CKPT_STEPS, CKPT_SAVE_AT = 4, 8, 5
CKPT_MONITORS = (0.41, 0.47, 0.44)
CKPT_MONITOR = "val_report_chexbert_f1_macro"
# scoring (cli/stages.py:test on config/test/multi_tf.yaml): SCORE_STUDIES
# studies, the decoded batch and synthetic reports, findings and impression;
# the model metrics in micro-batches of 4 (the config's mbatch_size) and 16;
# one untimed compute and SCORE_RUNS timed; the card against the CPU on
# SCORE_PARITY decoded and SCORE_PARITY synthetic findings
SCORE_STUDIES, SCORE_MBATCH, SCORE_RUNS, SCORE_PARITY = 64, (4, 16), 3, 8
SCORE_SECTIONS = ("findings", "impression")
# BERTScore's encoder at roberta-large's published widths (config.json:
# vocabulary 50,265, 514 positions, one token type, 24 layers of 16 heads,
# 1,024 wide, intermediate 4,096), cut after layer 17 as the reference scores;
# random weights; a synthetic rescale baseline in bert-score's file format
ROBERTA_VOCAB, ROBERTA_POSITIONS, ROBERTA_LAYERS, ROBERTA_LAYER = 50265, 514, 24, 17
ROBERTA_WIDTH, ROBERTA_HEADS, ROBERTA_FF = 1024, 16, 4096
ROBERTA_BASELINE = "LAYER,P,R,F\n16,0.8312,0.8309,0.8303\n17,0.8301,0.8298,0.8292\n"
# the data pipeline (cxrmate_torch/data) on a MIMIC-CXR-JPG-layout tree:
# DATA_SUBJECTS subjects of two studies a day apart with DATA_IMAGES images
# per study in turn (24 studies, 74 JPEGs), each gray DATA_HW, the portrait
# size of MIMIC-CXR-JPG's PA views, written by the port's encoder at quality
# 75; batches of STUDIES studies padded to SLOTS images, DATA_WORKERS decode
# threads under a Prefetcher; DATA_TIMED images decoded one at a time for the
# codec's own times
DATA_SUBJECTS, DATA_IMAGES, DATA_HW = 12, (5, 4, 3, 2, 1), (3056, 2544)
DATA_WORKERS, DATA_TIMED, DATA_SIZE = 5, 24, 384


def main_path_calls(da):
    """What every timed main-path call of this script asks of the kernels:
    {(variant, mode): {"images": image slots per encode, "reorder_t": width of
    the self cache a beam step reorders (None for greedy), "decode": the self
    and the cross call of one decoder layer as (kernel, B, M, S, mask kind)}}.
    The self cache is prompt width + NEW_TOKENS columns wide. The kernels
    phase checks and times exactly these shapes; the summary line pairs each
    with the launches of the calls that gave the kernel that shape."""
    paths = {}
    for variant, s_cross, kind, images in (("multi", SLOTS * 576, "slots", STUDIES * SLOTS),
                                           ("single", 576, "open", STUDIES)):
        for mode, beams in (("greedy", 1), ("beam4", 4)):
            paths[(variant, mode)] = {
                "images": images, "reorder_t": 1 + NEW_TOKENS if beams > 1 else None,
                "decode": [("decode_attention", STUDIES * beams, 1, 1 + NEW_TOKENS, "prefix"),
                           ("decode_attention", STUDIES, beams, s_cross, kind)]}
    for mode, beams, spec, _, bucket, _ in LONGITUDINAL_RUNS:
        spec = da.resolve_decode_kernel(spec or "")
        t_len = bucket + NEW_TOKENS
        self_kernel = "decode_attention_vpu" if da.uses_vpu(spec, False) else "decode_attention"
        cross_kernel = ("decode_attention_q8" if da.is_q8(spec) else
                        "decode_attention_vpu" if da.uses_vpu(spec, True) else "decode_attention")
        paths[("longitudinal", mode)] = {
            "images": STUDIES * SLOTS, "reorder_t": t_len if beams > 1 else None,
            "decode": [(self_kernel, STUDIES * beams, 1, t_len, f"prompt:{bucket}"),
                       (cross_kernel, STUDIES, beams, SLOTS * 576, "slots")]}
    # the score phase decodes the multi batch with beam-4 from the restored
    # checkpoint, and so does the data phase its batches loaded from JPEG files
    paths[("multi", "score")] = dict(paths[("multi", "beam4")])
    paths[("multi", "data")] = dict(paths[("multi", "beam4")])
    # and the entry phase its batch from the fast loader
    paths[("multi", "entry")] = dict(paths[("multi", "beam4")])
    for b in SCST_BATCHES:  # the SCST rollout: b sampled rows, then b greedy rows
        paths[("longitudinal", f"scst-b{b}")] = {
            "images": b * SLOTS, "reorder_t": None,
            "decode": [("decode_attention", 2 * b, 1, SCST_BUCKET + NEW_TOKENS,
                        f"rollout:{SCST_BUCKET}"),
                       ("decode_attention", 2 * b, 1, SLOTS * 576, f"slots:{b}")]}
    return paths


def key_mask(torch, kind, b, s):
    """The [b, s] additive key mask of a decode call mid-way through a run.
    ``slots``: the cross mask with the all-zero image slots masked; ``open``:
    nothing masked; ``prefix``: a self cache half written; ``prompt:P``: a
    self cache behind a prompt padded to P columns: each study's pads (from
    its true width to P; study 0 fills the bucket) are masked inside the key
    range, then 200 written columns, then the unwritten tail. ``slots:B`` and
    ``rollout:P``: the same for the SCST rollout's 2B rows, row i the study
    i % B."""
    mask = torch.zeros(b, s, device="cuda")
    if kind == "slots":
        for i, n in enumerate(IMAGES_PER_STUDY):
            mask[i, n * 576:] = NEG
    elif kind.startswith("slots:"):  # the rollout's cross rows: row i is study i % B
        studies = int(kind.split(":")[1])
        for i in range(b):
            mask[i, IMAGES_PER_STUDY[i % studies] * 576:] = NEG
    elif kind.startswith("rollout:"):  # the rollout's self rows: as prompt:P, row i study i % (b/2)
        bucket = int(kind.split(":")[1])
        study = torch.arange(b, device="cuda") % (b // 2)
        width = torch.where(study == 0, bucket, 4 + (bucket - 4) * study // STUDIES)
        cols = torch.arange(s, device="cuda")
        pad = (cols[None, :] >= width[:, None]) & (cols[None, :] < bucket)
        mask[pad | (cols[None, :] >= bucket + 200)] = NEG
    elif kind == "prefix":
        mask[:, s // 2:] = NEG
    elif kind.startswith("prompt:"):
        bucket = int(kind.split(":")[1])
        study = torch.arange(b, device="cuda") // (b // STUDIES)
        width = torch.where(study == 0, bucket, 4 + (bucket - 4) * study // STUDIES)
        cols = torch.arange(s, device="cuda")
        pad = (cols[None, :] >= width[:, None]) & (cols[None, :] < bucket)
        mask[pad | (cols[None, :] >= bucket + 200)] = NEG
    elif kind != "open":
        raise ValueError(kind)
    return mask


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _mismatch(a, b) -> float:
    """Share of elements that are not bit-equal."""
    return float((a != b).float().mean())


def check_flash(torch, fa, F, dtype, n_img):
    """One encode of ``n_img`` images: the three CvT-21@384 stage shapes as
    (BH, Lq, Lk, calls per encode), summed over the encode's 21 calls."""
    shapes = [(n_img * 1, 9216, 2304, 1), (n_img * 3, 2304, 576, 4), (n_img * 6, 577, 145, 16)]
    out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "flops": 0.0,
           "max_abs_err": 0.0, "per_shape": []}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for bh, lq, lk, calls in shapes:
        q = torch.randn(bh, lq, 64, generator=g, device="cuda").to(dtype)
        k = torch.randn(bh, lk, 64, generator=g, device="cuda").to(dtype)
        v = torch.randn(bh, lk, 64, generator=g, device="cuda").to(dtype)
        scale = (64 * (bh // n_img)) ** -0.5  # embed_dim ** -0.5, as CvT passes it
        got = fa.flash_attention(q, k, v, scale)
        want = fa.flash_attention_plain(q, k, v, scale)
        err = _err(got, want)
        del want
        ms = time_ms([lambda: fa.flash_attention(q, k, v, scale)])
        plain = time_ms([lambda: fa.flash_attention_plain(q, k, v, scale)], reps=3, warmup=1)
        lib = time_ms([lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None], scale=scale)])
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = 4.0 * bh * lq * lk * 64
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bytes", nbytes), ("flops", flops)):
            out[key] += calls * val
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["per_shape"].append({"bh": bh, "lq": lq, "lk": lk, "calls": calls, "ms": ms,
                                 "plain_ms": plain, "library_ms": lib, "max_abs_err": err})
        del q, k, v, got
    return out


def check_flash_grad(torch, fa, F, dtype, name):
    """The three kernels of flash_attention_grad at the CvT-21@384 stage
    shapes of one training micro-step (20 images: (BH, Lq, Lk, calls) summed
    over its 21 calls), each against its plain version on the same inputs,
    the forward's out bit-equal to flash_attention's; times of the kernels,
    the plain versions and, as the library yardsticks, SDPA's forward and (bf16)
    aten's flash backward, fed aten's flash forward on the same inputs and
    timed alone (dq, dk and dv in one call)."""
    n_img = len(TRAIN_IMAGES) * SLOTS
    shapes = [(n_img * 1, 9216, 2304, 1), (n_img * 3, 2304, 576, 4), (n_img * 6, 577, 145, 16)]
    tol = FLASH_GRAD_TOL[name]
    res = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0, "max_abs_err": 0.0,
               "max_rel_err": 0.0, "per_shape": []} for k in FLASH_GRAD}
    res["flash_attention_fwd_lse"]["library_ms"] = 0.0
    lib_bwd = 0.0
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    for bh, lq, lk, calls in shapes:
        q, k, v, do = (torch.randn(bh, n, 64, generator=g, device="cuda").to(dtype)
                       for n in (lq, lk, lk, lq))
        scale = (64 * (bh // n_img)) ** -0.5  # embed_dim ** -0.5, as CvT passes it
        out, lse = fa.flash_attention_fwd_lse(q, k, v, scale)
        if not torch.equal(out, fa.flash_attention(q, k, v, scale)):
            raise AssertionError(f"flash_attention_fwd_lse {dtype} {(bh, lq, lk)}: out is not "
                                 "bit-equal to flash_attention's")
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta, scale)
        got = {"flash_attention_fwd_lse": (out, lse),
               "flash_attention_bwd_dq": (fa.flash_attention_bwd_dq(*args),),
               "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv(*args)}
        runs = {"flash_attention_fwd_lse": ((q, k, v, scale), fa.flash_attention_fwd_lse,
                                            fa.flash_attention_fwd_lse_plain),
                "flash_attention_bwd_dq": (args, fa.flash_attention_bwd_dq,
                                           fa.flash_attention_bwd_dq_plain),
                "flash_attention_bwd_dkv": (args, fa.flash_attention_bwd_dkv,
                                            fa.flash_attention_bwd_dkv_plain)}
        e, rows = q.element_size(), bh * lq * 4  # a [BH, Lq] fp32 row set (lse, delta)
        work = {"flash_attention_fwd_lse": ((2 * q.numel() + 2 * k.numel()) * e + rows,
                                            4.0 * bh * lq * lk * 64),
                "flash_attention_bwd_dq": ((3 * q.numel() + 2 * k.numel()) * e + 2 * rows,
                                           6.0 * bh * lq * lk * 64),
                "flash_attention_bwd_dkv": ((2 * q.numel() + 4 * k.numel()) * e + 2 * rows,
                                            8.0 * bh * lq * lk * 64)}
        for kname, (a, run, plain) in runs.items():
            want = plain(*a)
            want = want if isinstance(want, tuple) else (want,)
            err = max(_err(x, y) for x, y in zip(got[kname], want))
            rel = max(_err(x, y) / float(y.float().abs().max()) for x, y in zip(got[kname], want))
            del want
            r = res[kname]
            ms = time_ms([lambda: run(*a)], reps=10, warmup=2)
            plain_ms = time_ms([lambda: plain(*a)], reps=3, warmup=1)
            r["per_shape"].append({"bh": bh, "lq": lq, "lk": lk, "calls": calls, "ms": ms,
                                   "plain_ms": plain_ms, "max_abs_err": err, "max_rel_err": rel})
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bytes", work[kname][0]),
                             ("flops", work[kname][1])):
                r[key] += calls * val
            r["max_abs_err"], r["max_rel_err"] = max(r["max_abs_err"], err), max(r["max_rel_err"], rel)
            if not rel <= tol:
                raise AssertionError(f"{kname} {dtype} {(bh, lq, lk)}: error {err} is {rel} of "
                                     f"the largest output, above {tol}")
        lib = time_ms([lambda: F.scaled_dot_product_attention(q[:, None], k[:, None],
                                                              v[:, None], scale=scale)],
                      reps=10, warmup=2)
        res["flash_attention_fwd_lse"]["library_ms"] += calls * lib
        res["flash_attention_fwd_lse"]["per_shape"][-1]["library_ms"] = lib
        if dtype == torch.bfloat16:  # the flash backward takes 16-bit inputs only
            q4, k4, v4, do4 = (x[:, None] for x in (q, k, v, do))
            o4, lse4, cq, ck, mq, mk, seed, offset, _ = \
                torch.ops.aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, False, False,
                                                                    scale=scale)
            bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
            lib = time_ms([lambda: bwd(do4, q4, k4, v4, o4, lse4, cq, ck, mq, mk, 0.0, False,
                                       seed, offset, scale=scale)], reps=10, warmup=2)
            lib_bwd += calls * lib
            for kname in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                res[kname]["per_shape"][-1]["library_ms"] = lib  # dq, dk and dv together
            del q4, k4, v4, do4, o4, lse4
        del q, k, v, do, out, lse, got, args, runs
    for kname in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        # one PyTorch call computes dq, dk and dv together; none computes one alone
        res[kname]["library_ms"] = lib_bwd if dtype == torch.bfloat16 else None
        res[kname]["library_computes"] = "dq, dk and dv"
    for r in res.values():
        r["tolerance_relative_to_largest_output"] = tol
    return res


# bf16 linears of the main paths (CvT's at a training micro-step's 20 images):
# (what, x's shape, output width, x a transposed view, as CvT's tokens of a
# convolution output are)
LINEAR_SHAPES = (
    ("decoder step, beam-4: q, k, v, out", (STUDIES * 4, 1, D_MODEL), D_MODEL, False),
    ("decoder step: FFN in", (STUDIES * 4, 1, D_MODEL), D_FF, False),
    ("decoder step: FFN out", (STUDIES * 4, 1, D_FF), D_MODEL, False),
    ("decoder step, 2-D", (STUDIES * 4, D_MODEL), D_MODEL, False),
    ("decoder step, 2-D transposed view", (STUDIES * 4, D_MODEL), D_MODEL, True),
    ("prefill: cross K/V of 5 images", (STUDIES, SLOTS * 576, D_MODEL), D_MODEL, False),
    ("training: decoder FFN in", (len(TRAIN_IMAGES), 256, D_MODEL), D_FF, False),
    ("CvT stage 0: q, k, v of conv tokens", (20, 9216, 64), 64, True),
    ("CvT stage 0: MLP in", (20, 9216, 64), 256, False),
    ("CvT stage 1: q, k, v of conv tokens", (20, 2304, 192), 192, True),
    ("CvT stage 2: q, k, v (with cls)", (20, 577, 384), 384, False),
    ("CvT stage 2: MLP out", (20, 577, 1536), 384, False),
)


def check_linear_rounding(torch, F):
    """Where bf16 ops/layers.py:linear adds the bias, which must be where the
    JAX package's linear adds it (fp32 product + fp32 bias, one rounding):
    per shape, the share of its outputs bit-equal to that, and to the same
    with the product rounded to bf16 before the bias (two roundings), both
    from an fp32 product with TF32 off. The sums differ in order from
    cuBLAS's, so neither share is 1; one rounding shows as the larger share,
    and a shape where two roundings do fails the run."""
    from cxrmate_torch.ops.layers import linear
    from cxrmate_torch.utils.precision import parity_mode

    bf16, rows = torch.bfloat16, []
    g = torch.Generator(device="cuda").manual_seed(SEED + 40)
    with parity_mode():
        for what, shape, n_out, transposed in LINEAR_SHAPES:
            n_in = shape[-1]
            if transposed:
                x = torch.randn(*shape[:-2], n_in, shape[-2], generator=g,
                                device="cuda").to(bf16).transpose(-1, -2)
            else:
                x = torch.randn(*shape, generator=g, device="cuda").to(bf16)
            w = (torch.randn(n_out, n_in, generator=g, device="cuda") * n_in ** -0.5).to(bf16)
            b = torch.randn(n_out, generator=g, device="cuda").to(bf16)
            got = linear(x, w, b)
            prod = F.linear(x.float(), w.float())
            once = (prod + b.float()).to(bf16)
            twice = (prod.to(bf16).float() + b.float()).to(bf16)
            share_once, share_twice = 1 - _mismatch(got, once), 1 - _mismatch(got, twice)
            rows.append({"what": what, "x": list(x.shape), "contiguous": x.is_contiguous(),
                         "out": n_out, "share_bit_equal_one_rounding": share_once,
                         "share_bit_equal_two_roundings": share_twice,
                         "rounds": "once" if share_once > share_twice else "twice"})
            del x, w, b, got, prod, once, twice
    res = {"phase": "kernels", "check": "linear_bias_rounding", "dtype": "bf16",
           "rows": rows, "rounds_twice_at": [r["what"] for r in rows if r["rounds"] == "twice"]}
    emit(res)
    if res["rounds_twice_at"]:
        raise AssertionError(f"bf16 linear rounds before the bias at {res['rounds_twice_at']}")
    return res


def decode_work(kernel, q, mask):
    """Bytes and operations a decode-attention call needs on these inputs: q,
    the output, the mask, and K and V of the unmasked keys only (a key under
    finfo(f32).min gets probability exactly 0 and cannot change the output).
    A key costs two rows of q's type, or for the int8 kernel two int8 rows and
    two fp32 scales."""
    b, h, m, dh = q.shape
    keys = float((mask == 0).sum())  # unmasked (row, key) pairs
    e = q.element_size()
    per_key = 2 * dh + 8 if kernel == "decode_attention_q8" else 2 * dh * e
    return 2 * q.numel() * e + keys * h * per_key + mask.numel() * 4, 4.0 * keys * h * m * dh


# the cluster-split kernels (decode_split.cuh's body)
SPLIT = ("decode_attention", "decode_attention_vpu", "decode_attention_q8")


def masked_rows_unread(torch, run, args, mask):
    """The split kernels' claim that no K or V row of a masked key is read
    while its row has an unmasked key: those rows set to NaN (for the int8
    kernel, args (q, kq, ks, vq, vs): the int8 rows random and both scales
    NaN), the output's bits must not change (a read would spread the NaN)."""
    q, kv = args[0], args[1:]
    poison = (mask == NEG)[:, None, :, None] & (mask != NEG).any(1)[:, None, None, None]
    nan = float("nan")
    if len(kv) == 2:
        dirty = tuple(x.masked_fill(poison, nan) for x in kv)
    else:
        kq, ks, vq, vs = kv
        g = torch.Generator(device="cuda").manual_seed(SEED + 13)
        keys = poison[..., 0][:, :, None, :].expand(ks.shape)
        noise = [torch.randint(-127, 128, kq.shape, generator=g, device="cuda", dtype=torch.int8)
                 for _ in range(2)]
        dirty = (torch.where(poison, noise[0], kq), ks.masked_fill(keys, nan),
                 torch.where(poison, noise[1], vq), vs.masked_fill(keys, nan))
    return bool(torch.equal(run(q, *kv, mask, 0.125), run(q, *dirty, mask, 0.125)))


def split_facts(torch, da, q, mask):
    """n_split and chunk of decode_schedule, and the share of (row, key)
    pairs the split kernels read (a fully masked row reads all its V rows)."""
    s = mask.shape[1]
    n_split, chunk = da.decode_schedule(s, q.shape[-1])
    read = mask != NEG
    full = ~read.any(1, keepdim=True)
    return {"n_split": n_split, "chunk": chunk,
            "keys_read_share": float((read | full).float().mean())}


def _softmax_scores(q, k, mask, scale):
    return ((q.float() @ k.float().transpose(-1, -2)) * scale + mask[:, None, None, :]).softmax(-1)


def extras_decode(torch, da, dtype, args, floats, mask, got, want, g):
    """bf16: the kernel must agree bit for bit with the plain version more
    often than with a version that keeps the probs in fp32 before P.V (what a
    kernel that skipped the contract's rounding would compute)."""
    if dtype != torch.bfloat16:
        return {}
    q, k, v = args
    unrounded = (_softmax_scores(q, k, mask, 0.125) @ v.float()).to(dtype)
    out = {"mismatch_share": _mismatch(got, want),
           "mismatch_share_unrounded": _mismatch(got, unrounded)}
    if not out["mismatch_share"] < out["mismatch_share_unrounded"]:
        raise AssertionError(f"decode_attention bf16 {out}: the probs do not look rounded to "
                             "bf16 before P.V")
    return out


def extras_q8(torch, da, dtype, args, floats, mask, got, want, g):
    """The int8 kernel's own checks: its distance from exact attention on the
    unquantised K/V; in fp32 integer-valued K/V; in bf16 the rounding point
    (probs x vs rounded once, after the fold), which only bit shares can see:
    the kernel must match the plain version more often than a version that
    rounds the bare probs before the fold and than one that never rounds."""
    q, kq, ks, vq, vs = args
    b, h, m, dh = q.shape
    s = kq.shape[2]
    exact = da.decode_attention_plain(q.float(), *floats, mask, 0.125)
    qerr = (got.float() - exact).abs()
    out = {"vs_unquantised": {"max": float(qerr.max()), "rms": float(qerr.pow(2).mean().sqrt())}}
    if not (out["vs_unquantised"]["max"] < 0.1 and out["vs_unquantised"]["rms"] < 0.02):
        raise AssertionError(f"decode_attention_q8 M={m}: quantisation error {out}")
    if dtype == torch.float32:
        # integer-valued K/V (every scale exactly 1): 2e-3 absolute at the
        # +-127 value range, as the JAX package's own test holds it
        ki = torch.randint(-127, 128, (b, h, s, dh), generator=g, device="cuda").float()
        vi = torch.randint(-127, 128, (b, h, s, dh), generator=g, device="cuda").float()
        ki[..., 0] = vi[..., 0] = 127.0
        kqi, ksi = da.quantize_kv_rowwise(ki)
        vqi, vsi = da.quantize_kv_rowwise(vi)
        if not (bool((ksi == 1).all()) and bool((vsi == 1).all())):
            raise AssertionError("quantize_kv_rowwise: integer rows must get scale 1")
        qi = q * 0.05  # keeps the softmax from collapsing onto one key
        out["integer_kv_err"] = _err(da.decode_attention_q8(qi, kqi, ksi, vqi, vsi, mask, 0.125),
                                     da.decode_attention_plain(qi, ki, vi, mask, 0.125))
        if not out["integer_kv_err"] <= 2e-3:
            raise AssertionError(f"decode_attention_q8 fp32 M={m}: integer-valued K/V {out}")
        return out
    scores = torch.matmul(q.float(), kq.float().transpose(-1, -2)) * ks
    probs = (scores * 0.125 + mask[:, None, None, :]).softmax(-1)
    early = torch.matmul(probs.to(dtype).float() * vs, vq.float()).to(dtype)
    never = torch.matmul(probs * vs, vq.float()).to(dtype)
    out.update(mismatch_share=_mismatch(got, want),
               mismatch_share_probs_rounded_before_fold=_mismatch(got, early),
               mismatch_share_unrounded=_mismatch(got, never))
    if not out["mismatch_share"] < min(out["mismatch_share_probs_rounded_before_fold"],
                                       out["mismatch_share_unrounded"]):
        raise AssertionError(f"decode_attention_q8 bf16 M={m} {out}: probs x vs does not look "
                             "rounded to bf16 once, after the V-scale fold")
    return out


def extras_vpu(torch, da, dtype, args, floats, mask, got, want, g):
    """The multiply-reduce kernel's verdict: the share of outputs bit-identical
    to its plain version and to decode_attention's kernel (printed), and each
    row's bits alone against the same row inside the batch (held)."""
    q, k, v = args
    alone = torch.cat([da.decode_attention_vpu(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                               mask[i:i + 1], 0.125) for i in range(q.shape[0])])
    out = {"bit_identical_to_plain": 1.0 - _mismatch(got, want),
           "bit_identical_to_decode_attention": 1.0 - _mismatch(
               got, da.decode_attention(q, k, v, mask, 0.125)),
           "alone_equals_in_batch": bool(torch.equal(alone, got))}
    if not out["alone_equals_in_batch"]:
        raise AssertionError(f"decode_attention_vpu {tuple(q.shape)}: a row's bits depend on "
                             "its batch")
    return out


EXTRAS = {"decode_attention": extras_decode, "decode_attention_q8": extras_q8,
          "decode_attention_vpu": extras_vpu}


def decode_inputs(torch, da, F, g, dtype, kernel, b, m, s, kind, heads=HEADS):
    """COPIES input sets of one decode-attention call shape (``heads`` heads;
    for the int8 kernel quantised, with the first set's unquantised K/V), its
    mask, and the library call on a set (SDPA; for the int8 kernel the
    dequantise too, which a library user would pay)."""
    mask = key_mask(torch, kind, b, s)
    bool_mask = (mask == 0)[:, None, None, :]
    sets, floats = [], None
    for _ in range(COPIES):
        q = torch.randn(b, heads, m, HEAD_DIM, generator=g, device="cuda").to(dtype)
        k = torch.randn(b, heads, s, HEAD_DIM, generator=g, device="cuda")
        v = torch.randn(b, heads, s, HEAD_DIM, generator=g, device="cuda")
        if kernel == "decode_attention_q8":
            sets.append((q, *da.quantize_kv_rowwise(k), *da.quantize_kv_rowwise(v)))
            floats = floats or (k, v)
        else:
            sets.append((q, k.to(dtype), v.to(dtype)))

    def library(q, k, v, *rest):
        if rest:  # int8 (q, kq, ks, vq, vs): dequantise first
            kq, ks, vq, vs = k, v, *rest
            k = kq.to(q.dtype) * ks.transpose(-1, -2).to(q.dtype)
            v = vq.to(q.dtype) * vs.transpose(-1, -2).to(q.dtype)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bool_mask, scale=0.125)

    return sets, floats, mask, library


def check_decode_call(torch, da, F, g, dtype, kernel, b, m, s, kind, heads=HEADS):
    """One decode-attention call shape of a main path (``heads`` heads: a
    model rank's under tensor parallelism): the kernel against its plain
    version, also with row 0 fully masked (the uniform softmax, finite), the
    kernel's own extra checks, and the times of the kernel, the plain
    version and the library call (decode_inputs) by the host clock around
    back-to-back calls; their device times come from decode_device_phase."""
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    run, plain = getattr(da, kernel), getattr(da, kernel + "_plain")
    sets, floats, mask, library = decode_inputs(torch, da, F, g, dtype, kernel, b, m, s, kind,
                                                heads)
    args = sets[0]
    got = run(*args, mask, 0.125)
    want = plain(*args, mask, 0.125)
    dark = mask.clone()
    dark[0] = NEG
    got_dark = run(*args, dark, 0.125)
    err_dark = _err(got_dark, plain(*args, dark, 0.125))
    if not (bool(torch.isfinite(got_dark.float()).all()) and err_dark <= tol):
        raise AssertionError(f"{kernel} {dtype} {(b, m, s, kind)}: fully masked row, "
                             f"err {err_dark}")
    out = {"b": b, "m": m, "s": s, "mask": kind, "max_abs_err": _err(got, want),
           "fully_masked_row_err": err_dark,
           **EXTRAS[kernel](torch, da, dtype, args, floats, mask, got, want, g)}
    out.update(split_facts(torch, da, args[0], mask),
               masked_rows_unread=masked_rows_unread(torch, run, args, mask))
    if not out["masked_rows_unread"]:
        raise AssertionError(f"{kernel} {dtype} {(b, m, s, kind)}: a masked key's K/V row or "
                             "scale was read")
    out["ms"] = time_ms([lambda a=a: run(*a, mask, 0.125) for a in sets])
    out["plain_ms"] = time_ms([lambda a=a: plain(*a, mask, 0.125) for a in sets], reps=5, warmup=1)
    out["library_ms"] = time_ms([lambda a=a: library(*a) for a in sets])
    out["bytes"], out["flops"] = decode_work(kernel, args[0], mask)
    # what the kernel reads: the bound's bytes (masked keys skipped), against
    # every key's K/V (and scales), which the one-block-per-(row, head)
    # kernels the cluster kernels replaced read
    e = args[0].element_size()
    per_key = 2 * HEAD_DIM + 8 if kernel == "decode_attention_q8" else 2 * HEAD_DIM * e
    every_key = 2 * args[0].numel() * e + b * s * heads * per_key + mask.numel() * 4
    out["bytes_read"] = out["bytes"]
    out["bytes_read_every_key"] = every_key
    return out


# (label, B, M, S, mask kind) around decode_schedule's block boundaries, for
# the cluster kernels beside the main-path shapes; "largest" is max_keys(4,
# 64) for the dtype of the K/V (int8 for the q8 kernel)
DECODE_EDGES = (
    ("one key", 8, 4, 1, "open"), ("below one tile", 8, 1, 37, "random"),
    ("2 full blocks of 256 keys - 1", 8, 4, 511, "random"),
    ("2 full blocks of 256 keys", 8, 1, 512, "chunk"),
    ("2 full blocks of 256 keys + 1", 8, 4, 513, "last"),
    ("8 full blocks of 384 keys - 1", 8, 1, 3071, "random"),
    ("8 full blocks of 384 keys", 8, 4, 3072, "chunk"),
    ("8 full blocks of 384 keys + 1", 8, 1, 3073, "last"),
    ("every key of one block masked", 8, 4, 2880, "chunk"),
    ("only unmasked key in the last tile", 8, 1, 2880, "last"),
    ("largest S", 1, 4, "largest", "chunk"),
)


def edge_mask(torch, da, kind, b, s, g):
    """``open``; ``random``: a quarter of the keys masked; ``chunk``: random,
    and every key of decode_schedule's second block masked in every row;
    ``last``: random, and the last row's only unmasked key the last one."""
    mask = torch.zeros(b, s, device="cuda")
    if kind != "open":
        mask[torch.rand(b, s, generator=g, device="cuda") < 0.25] = NEG
    blocks = da.block_tiles(s, HEAD_DIM)
    if kind == "chunk" and len(blocks) > 1:
        for t in blocks[1]:
            mask[:, t * 64:(t + 1) * 64] = NEG
    elif kind == "last":
        mask[-1] = NEG
        mask[-1, -1] = 0.0
    return mask


def check_decode_edges(torch, da, dtype):
    """The cluster kernels at DECODE_EDGES: against their plain versions
    (1e-5 fp32, 1e-2 bf16), with row 0 fully masked, no masked key's K/V
    row (or scale) read, and for the vpu kernel each row alone equal to the
    same row in the batch; each shape's n_split and share of keys read. The
    int8 kernel runs on the same K/V quantised, and its "largest S" is its
    own."""
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = []
    for label, b, m, s_edge, kind in DECODE_EDGES:
        for kernel in SPLIT:
            q8 = kernel == "decode_attention_q8"
            s = s_edge
            if s == "largest":
                s = da.max_keys(m, HEAD_DIM, 1 if q8 else torch.finfo(dtype).bits // 8)
            g.manual_seed(SEED + 11 + s)  # the same q, K, V and mask for the kernels of a shape
            q, k, v = (torch.randn(b, HEADS, n, HEAD_DIM, generator=g, device="cuda")
                       for n in (m, s, s))
            mask = edge_mask(torch, da, kind, b, s, g)
            kv = (*da.quantize_kv_rowwise(k), *da.quantize_kv_rowwise(v)) if q8 else \
                (k.to(dtype), v.to(dtype))
            args = (q.to(dtype), *kv)
            del k, v
            dark = mask.clone()
            dark[0] = NEG
            run, plain = getattr(da, kernel), getattr(da, kernel + "_plain")
            row = {"shape": label, "kernel": kernel, "b": b, "m": m, "s": s, "mask": kind,
                   **split_facts(torch, da, args[0], mask)}
            got = run(*args, mask, 0.125)
            row["max_abs_err"] = _err(got, plain(*args, mask, 0.125))
            got_dark = run(*args, dark, 0.125)
            row["fully_masked_row_err"] = _err(got_dark, plain(*args, dark, 0.125))
            row["masked_rows_unread"] = masked_rows_unread(torch, run, args, mask)
            ok = (bool(torch.isfinite(got_dark.float()).all()) and row["masked_rows_unread"]
                  and row["max_abs_err"] <= tol and row["fully_masked_row_err"] <= tol)
            if kernel == "decode_attention_vpu":
                alone = torch.cat([run(*(a[i:i + 1] for a in args), mask[i:i + 1], 0.125)
                                   for i in range(b)])
                row["alone_equals_in_batch"] = bool(torch.equal(alone, got))
                ok = ok and row["alone_equals_in_batch"]
            rows.append(row)
            if not ok:
                raise AssertionError(f"{kernel} {dtype} at {label}: {row}")
            del q, args, kv
    return rows


def decode_device_phase(torch, da, br, F, kernels):
    """The device time of each decode-attention kernel and of its library
    call at every main-path call shape, and of the beam reorder and its
    library calls at every main-path cache width, bf16, from torch.profiler,
    into the kernels phase's results (and so into the summary line). It runs
    after every other phase: a profiler session leaves a cost on every later
    launch, which would slow the host-bound decode steps timed after it."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    for t_len, r in kernels["bf16"]["reorder"].items():
        inputs, sel, library = reorder_inputs(torch, torch.bfloat16, t_len, g)
        sets = [inputs() for _ in range(COPIES)]
        r["device_ms"] = device_ms([lambda a=a: br.beam_reorder_write(*a, sel, 100, 4)
                                    for a in sets])
        r["library_device_ms"] = device_ms([lambda a=a: library(*a) for a in sets])
        emit({"phase": "kernels_device", "dtype": "bf16", "kernel": "beam_reorder_write",
              "t": t_len, "device_ms": r["device_ms"],
              "library_device_ms": r["library_device_ms"], "ms": r["ms"],
              "library_ms": r["library_ms"],
              "bound_ms": bound_ms(r["bytes"], r["flops"], "bf16")[0]})
        del sets
    for c, r in kernels["bf16"]["decode"].items():
        sets, _, mask, library = decode_inputs(torch, da, F, g, torch.bfloat16, *c)
        run = getattr(da, c[0])
        r["device_ms"] = device_ms([lambda a=a: run(*a, mask, 0.125) for a in sets])
        r["library_device_ms"] = device_ms([lambda a=a: library(*a) for a in sets])
        emit({"phase": "kernels_device", "dtype": "bf16", "kernel": c[0], "b": c[1], "m": c[2],
              "s": c[3], "mask": c[4], "device_ms": r["device_ms"],
              "library_device_ms": r["library_device_ms"], "ms": r["ms"],
              "library_ms": r["library_ms"],
              "bound_ms": bound_ms(r["bytes"], r["flops"], "bf16")[0]})
        del sets


def reorder_work(cache, sel, index, beams) -> float:
    """Bytes the in-place reorder of K and V needs on these inputs: a row that
    takes another beam's row is read from its source and written whole; a row
    that keeps its own (sel[j] == j) only gets the new column, if any."""
    import torch

    r, h, t_len, dh = cache.shape
    e = cache.element_size()
    local = torch.arange(r, device=sel.device) % beams
    moved = int((sel.long() != local).sum())
    kept = r - moved
    row, col = h * t_len * dh * e, h * dh * e
    per_cache = moved * 2 * row + (kept * 2 * col if index >= 0 else 0)
    return 2 * per_cache + sel.numel() * 4


def reorder_inputs(torch, dtype, t_len, g, heads=HEADS, studies=STUDIES):
    """A function making one input set (K/V caches of ``studies`` studies x 4
    beams, ``heads`` heads, and the new column) of a reorder at width t_len,
    the beam selection (with repeated sources), and the library call on a
    set (index_select + index_copy_ at column ``reorder_column(t_len)``)."""
    r, beams = studies * 4, 4

    def inputs():
        ck = torch.randn(r, heads, t_len, HEAD_DIM, generator=g, device="cuda").to(dtype)
        cv = torch.randn(r, heads, t_len, HEAD_DIM, generator=g, device="cuda").to(dtype)
        nk = torch.randn(r, heads, HEAD_DIM, generator=g, device="cuda").to(dtype)
        nv = torch.randn(r, heads, HEAD_DIM, generator=g, device="cuda").to(dtype)
        return ck, cv, nk, nv

    sel = torch.randint(0, beams, (r,), generator=g, device="cuda", dtype=torch.int32)
    sel[:beams] = torch.tensor([1, 1, 0, 1], dtype=torch.int32)  # repeated sources
    src = torch.arange(r, device="cuda") // beams * beams + sel.long()
    col = torch.tensor([reorder_column(t_len)], device="cuda")

    def library(ck, cv, nk, nv):
        for cache, new in ((ck, nk), (cv, nv)):
            out = cache.index_select(0, src)
            out.index_copy_(2, col, new.index_select(0, src)[:, :, None])

    return inputs, sel, library


def reorder_column(t_len: int) -> int:
    """The middle column a reorder check writes and is timed at: 100, or the
    middle of a cache narrower than 200."""
    return min(100, t_len // 2)


def check_reorder(torch, br, dtype, t_len, heads=HEADS, studies=STUDIES):
    """One in-place reorder of the [4 * studies, heads, t_len, 64] self K/V
    cache of ``studies`` studies x 4 beams (by default STUDIES and all 12
    heads) with the step's column written: bit-exact against the plain
    version at a middle column (``reorder_column``), the first and the last
    and without a write; timed at the middle column."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    beams = 4
    inputs, sel, library = reorder_inputs(torch, dtype, t_len, g, heads, studies)
    exact, mid = True, reorder_column(t_len)
    for index in (mid, 0, t_len - 1, -1):
        ck, cv, nk, nv = inputs()
        a, b = ck.clone(), cv.clone()
        br.beam_reorder_write(ck, cv, nk, nv, sel, index, beams)
        br.beam_reorder_write_plain(a, b, nk, nv, sel, index, beams)
        exact &= torch.equal(ck, a) and torch.equal(cv, b)
    sets = [inputs() for _ in range(COPIES)]
    return {"t": t_len, "heads": heads, "rows": 4 * studies, "exact": exact,
            "max_abs_err": 0.0 if exact else float("inf"),
            "ms": time_ms([lambda a=a: br.beam_reorder_write(*a, sel, mid, beams) for a in sets]),
            "plain_ms": time_ms([lambda a=a: br.beam_reorder_write_plain(*a, sel, mid, beams)
                                 for a in sets]),
            "library_ms": time_ms([lambda a=a: library(*a) for a in sets]),
            "bytes": reorder_work(sets[0][0], sel, mid, beams), "flops": 0.0}


def time_cold_ms(fns, reps: int = 20, warmup: int = 2) -> float:
    """Mean device time of one call that finds the L2 cache cold, as a layer's
    kernel does in a decode step (some 500 MB go by before the layer's weights
    are read again). Each call is timed alone, queued behind a 512 MB fill:
    the fill flushes L2 and keeps the card busy while the host enqueues the
    call, so that the two events bracket the call's own launches only."""
    import torch

    fns = list(fns)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.int32, device="cuda")
    total = 0.0
    for i in range(warmup + reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        flush.zero_()
        start.record()
        fns[i % len(fns)]()
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            total += start.elapsed_time(end)
    return total / reps


def fused_operands(torch, dtype, g):
    """One layer's operands of the fused step at the fused main path's shapes:
    8 studies, T = 256, S = 2,880 with the all-zero image slots masked, weights
    N(0, 0.02) as random_init draws them. LayerNorm gains near 0.3 keep the
    outputs inside (-2, 2), where one bf16 ulp is below the 1e-2 tolerance, and
    the cached self K/V have std 0.5 for the same reason (at column 1 the
    context is one cached row). Study 1 has masked columns inside the key
    range."""
    import types

    b, d, f, t_len, s = STUDIES, D_MODEL, D_FF, 1 + NEW_TOKENS, SLOTS * 576

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    def gain():
        return (0.3 + 0.05 * torch.randn(d, generator=g, device="cuda")).to(dtype)

    self_mask = torch.ones(b, t_len, dtype=torch.int32, device="cuda")
    self_mask[1, 3:9] = 0
    return types.SimpleNamespace(
        hidden=rn(b, d), res=rn(b, d), wqkv=rn(3 * d, d, scale=0.02), bqkv=rn(3 * d, scale=0.02),
        cache_k=rn(b, HEADS, t_len, HEAD_DIM, scale=0.5),
        cache_v=rn(b, HEADS, t_len, HEAD_DIM, scale=0.5),
        cross_k=rn(b, HEADS, s, HEAD_DIM), cross_v=rn(b, HEADS, s, HEAD_DIM),
        self_mask=self_mask, cross_mask=(key_mask(torch, "slots", b, s) == 0).int(),
        out_ln_q=(rn(d, d, scale=0.02), rn(d, scale=0.02), gain(), rn(d, scale=0.02),
                  rn(d, d, scale=0.02), rn(d, scale=0.02)),
        out_ln_ffn=(rn(d, d, scale=0.02), rn(d, scale=0.02), gain(), rn(d, scale=0.02),
                    rn(f, d, scale=0.02), rn(f, scale=0.02), rn(d, f, scale=0.02),
                    rn(d, scale=0.02), gain(), rn(d, scale=0.02)))


def attend_rows(mask, limit, new_open=None):
    """(K rows, V rows) an attention over these [B, n] integer masks has to
    read per head: the open keys below ``limit``; for a row with no open key
    at all (the uniform softmax) no K row and every V row."""
    opened = (mask[:, :limit] != 0).sum(1)
    lit = opened > 0 if new_open is None else (opened > 0) | new_open
    k_rows = int(opened[lit].sum())
    return k_rows, k_rows + int((~lit).sum()) * mask.shape[1]


def fused_work(x, index):
    """Bytes (each input read once, each output written once; only the K/V
    rows these masks need) and fp32 operations of each fused kernel."""
    b, d = x.hidden.shape
    f, e = x.out_ln_ffn[4].shape[0], x.hidden.element_size()
    k_self, v_self = attend_rows(x.self_mask, index, x.self_mask[:, index] != 0)
    k_cross, v_cross = attend_rows(x.cross_mask, x.cross_mask.shape[1])
    row = HEADS * HEAD_DIM * e  # one key's K or V row over all heads
    return {
        "fused_qkv_attn": (
            (2 * b * d + 3 * d * d + 3 * d + 2 * b * d) * e + x.self_mask.numel() * 4
            + (k_self + v_self) * row,
            2.0 * b * d * 3 * d + 2.0 * (k_self + v_self + 2 * b) * HEADS * HEAD_DIM),
        "fused_out_ln_q": ((4 * b * d + 2 * d * d + 4 * d) * e, 4.0 * b * d * d),
        "fused_cross_attn": (2 * b * d * e + x.cross_mask.numel() * 4 + (k_cross + v_cross) * row,
                             2.0 * (k_cross + v_cross) * HEADS * HEAD_DIM),
        "fused_out_ln_ffn": ((3 * b * d + d * d + 2 * d * f + 6 * d + f) * e,
                             2.0 * b * (d * d + 2 * d * f)),
    }


def layer_step_work(x, index):
    """Bytes and fp32 operations of one v1 layer step on these inputs: hidden
    in, out and the new K/V column written, every weight once, the masks, and
    the K/V rows the masks leave open; the intermediates never leave the
    kernel in this count."""
    b, d = x.hidden.shape
    f, e = x.out_ln_ffn[4].shape[0], x.hidden.element_size()
    k_self, v_self = attend_rows(x.self_mask, index, x.self_mask[:, index] != 0)
    k_cross, v_cross = attend_rows(x.cross_mask, x.cross_mask.shape[1])
    row = HEADS * HEAD_DIM * e
    weights = 6 * d * d + 2 * d * f + 13 * d + f
    nbytes = ((4 * b * d + weights) * e + (x.self_mask.numel() + x.cross_mask.numel()) * 4
              + (k_self + v_self + k_cross + v_cross) * row)
    flops = (2.0 * b * (6 * d * d + 2 * d * f)
             + 2.0 * (k_self + v_self + 2 * b + k_cross + v_cross) * HEADS * HEAD_DIM)
    return nbytes, flops


def check_layer_step(torch, F, fd, da, x, dtype, v2_ms):
    """fused_layer_step (v1, one kernel; no path calls it) at the fused path's
    shapes: against its plain version (fp32 <= 1e-5, bf16 <= 1e-2 of the
    largest output) with the step at columns 1, 128 and 255 and with a study
    whose self keys and one whose cross keys are all masked, the new column
    within tolerance and every other column bit-exact; against v2 on the same
    operands (fp32 <= 1e-5; bf16 printed: v2 rounds ctx, h1, cq and cctx);
    timed cold beside v2's four kernels summed and the same layer in library
    calls. Its rows' bits the same alone, among 8 and among 11; NaN in the
    masked cross keys' K/V rows leaving its bits unchanged at V1_EDGES."""
    b, d = x.hidden.shape
    t_len, mid = x.cache_k.shape[2], (1 + NEW_TOKENS) // 2
    prep = {"wqkv": x.wqkv, "bqkv": x.bqkv, "out_ln_q": x.out_ln_q, "out_ln_ffn": x.out_ln_ffn}
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    r = {"max_abs_err": 0.0, "max_rel_err": 0.0, "by_index": {}, "cache_exact": True}

    def step(fn, index, self_mask, cross_mask):
        ck, cv = x.cache_k.clone(), x.cache_v.clone()
        out = fn(x.hidden, None, ck, cv, x.cross_k, x.cross_v, index, self_mask, cross_mask,
                 1e-12, prep)
        return out[0] if isinstance(out, tuple) else out, ck, cv

    dark_self, dark_cross = x.self_mask.clone(), x.cross_mask.clone()
    dark_self[0] = 0
    dark_cross[2] = 0
    cases = [(i, x.self_mask, x.cross_mask) for i in (1, mid, t_len - 1)]
    cases.append((mid, dark_self, dark_cross))
    for index, smask, cmask in cases:
        got = step(fd.fused_layer_step, index, smask, cmask)
        want = step(fd.fused_layer_step_plain, index, smask, cmask)
        if not bool(torch.isfinite(got[0].float()).all()):
            raise AssertionError(f"fused_layer_step {dtype} index {index}: output not finite")
        err = max(_err(got[0], want[0]), _err(got[1][:, :, index], want[1][:, :, index]),
                  _err(got[2][:, :, index], want[2][:, :, index]))
        rel = err / float(want[0].float().abs().max())
        others = [c for c in range(t_len) if c != index]
        r["cache_exact"] &= (torch.equal(got[1][:, :, others], x.cache_k[:, :, others])
                             and torch.equal(got[2][:, :, others], x.cache_v[:, :, others]))
        if smask is dark_self:
            r["fully_masked_row_err"] = err
        else:
            r["by_index"][index] = err
        r["max_abs_err"], r["max_rel_err"] = max(r["max_abs_err"], err), max(r["max_rel_err"], rel)
    if not r["cache_exact"]:
        raise AssertionError(f"fused_layer_step {dtype}: a cache column other than the step's "
                             "changed")
    if not r["max_rel_err"] <= tol:
        raise AssertionError(f"fused_layer_step {dtype}: {r}, above {tol} of the largest output")
    r["rows_equal_alone_b8_b11"] = layer_step_rows_alone(torch, fd, x, prep)
    if not r["rows_equal_alone_b8_b11"]:
        raise AssertionError(f"fused_layer_step {dtype}: a row's bits depend on its batch")
    r["edges"] = check_v1_cross_edges(torch, fd, da, x, prep, dtype)
    v1 = step(fd.fused_layer_step, mid, x.self_mask, x.cross_mask)
    v2 = step(fd.fused_layer_step_v2, mid, x.self_mask, x.cross_mask)
    r["vs_v2_max_abs_err"] = max(_err(a, b) for a, b in zip(v1, v2))
    if dtype == torch.float32 and not r["vs_v2_max_abs_err"] <= tol:
        raise AssertionError(f"fused_layer_step fp32: {r['vs_v2_max_abs_err']} from v2")

    self_bool = ((x.self_mask != 0)
                 & (torch.arange(t_len, device="cuda") <= mid))[:, None, None, :]
    cross_bool = (x.cross_mask != 0)[:, None, None, :]

    def library():  # the same layer in F.linear / F.layer_norm / F.gelu / SDPA calls
        wo, bo, g1, be1, wq, bq = x.out_ln_q
        wco, bco, g2, be2, w1, b1, w2, b2, g3, be3 = x.out_ln_ffn
        q, k, v = (y.view(b, HEADS, 1, HEAD_DIM)
                   for y in F.linear(x.hidden, x.wqkv, x.bqkv).split(d, 1))
        x.cache_k[:, :, mid] = k[:, :, 0]
        x.cache_v[:, :, mid] = v[:, :, 0]
        ctx = F.scaled_dot_product_attention(q, x.cache_k, x.cache_v, attn_mask=self_bool)
        h1 = F.layer_norm(F.linear(ctx.reshape(b, d), wo, bo) + x.hidden, (d,), g1, be1, 1e-12)
        cq = F.linear(h1, wq, bq).view(b, HEADS, 1, HEAD_DIM)
        cctx = F.scaled_dot_product_attention(cq, x.cross_k, x.cross_v, attn_mask=cross_bool)
        h2 = F.layer_norm(F.linear(cctx.reshape(b, d), wco, bco) + h1, (d,), g2, be2, 1e-12)
        return F.layer_norm(F.linear(F.gelu(F.linear(h2, w1, b1)), w2, b2) + h2, (d,), g3, be3,
                            1e-12)

    def run(fn):
        return lambda: fn(x.hidden, None, x.cache_k, x.cache_v, x.cross_k, x.cross_v, mid,
                          x.self_mask, x.cross_mask, 1e-12, prep)

    r["ms"] = time_cold_ms([run(fd.fused_layer_step)])
    r["plain_ms"] = time_cold_ms([run(fd.fused_layer_step_plain)], reps=5, warmup=1)
    r["library_ms"] = time_cold_ms([library])
    r["v2_four_kernels_ms"] = v2_ms
    r["bytes"], r["flops"] = layer_step_work(x, mid)
    r["ops_dtype"] = "fp32"
    return r


# S of fused_cross_attn's edge checks around decode_schedule's tiles and
# blocks, beside the fused path's 2,880; "largest": cross_fits' limit
CROSS_EDGES = (1, 63, 64, 65, 2880, 3073, "largest")
# S of v1's: its cross stage keeps its scores in scratch, so no block limits
# S; "largest" is the fused cross kernel's, the most v2 takes
V1_EDGES = (1, 63, 64, 65, 2880, "largest")


def layer_step_rows_alone(torch, fd, x, prep) -> bool:
    """v1's output rows bit-equal alone, in the B = 8 call and in a B = 11
    call (three more studies with their own caches and cross K/V): its
    split-K passes and its cross parts add in a fixed order."""
    b = x.hidden.shape[0]
    index = x.cache_k.shape[2] // 2
    g = torch.Generator(device="cuda").manual_seed(SEED + 24)
    hidden, ck, cv, xk, xv = (
        torch.cat([t, torch.randn(3, *t.shape[1:], generator=g, device="cuda").to(t.dtype)])
        for t in (x.hidden, x.cache_k, x.cache_v, x.cross_k, x.cross_v))
    smask = torch.cat([x.self_mask, x.self_mask[:3]])
    cmask = torch.cat([x.cross_mask, x.cross_mask[:3]])

    def run(lo, hi):
        k, v = ck[lo:hi].clone(), cv[lo:hi].clone()
        return fd.fused_layer_step(hidden[lo:hi], None, k, v, xk[lo:hi], xv[lo:hi], index,
                                   smask[lo:hi], cmask[lo:hi], 1e-12, prep)[0]

    want = run(0, b + 3)
    return bool(torch.equal(want[:b], run(0, b))
                and all(torch.equal(want[i:i + 1], run(i, i + 1)) for i in range(b + 3)))


def check_v1_cross_edges(torch, fd, da, x, prep, dtype):
    """v1 at V1_EDGES with the fused path's weights and self caches, 8 studies
    (1 at the largest S): a quarter of the cross keys masked at random, for S
    >= 128 every key of one tile (2,880: the fused path's slot mask instead),
    study 1 fully masked. Against its plain version (fp32 1e-5, bf16 1e-2 of
    the largest output); the fully masked study finite; NaN in the K and V
    rows of the masked keys of every study with an open key leaves the
    output's bits unchanged (a read would spread it)."""
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    index = x.cache_k.shape[2] // 2
    g = torch.Generator(device="cuda")
    rows = []
    for s in V1_EDGES:
        if s == "largest":
            s = da.max_keys(1, HEAD_DIM, torch.finfo(dtype).bits // 8)
        b = 1 if s > 3073 else STUDIES
        g.manual_seed(SEED + 25 + s)
        k, v = (torch.randn(b, HEADS, s, HEAD_DIM, generator=g, device="cuda").to(dtype)
                for _ in range(2))
        if s == SLOTS * 576:
            mask = x.cross_mask.clone()
        else:
            mask = (torch.rand(b, s, generator=g, device="cuda") >= 0.25).int()
            if s >= 128:
                mask[:, 64:128] = 0
        if b > 1:
            mask[1] = 0

        def run(ck, cv, fn=fd.fused_layer_step):
            sk, sv = x.cache_k[:b].clone(), x.cache_v[:b].clone()
            return fn(x.hidden[:b], None, sk, sv, ck, cv, index, x.self_mask[:b], mask, 1e-12,
                      prep)[0]

        got = run(k, v)
        want = run(k, v, fd.fused_layer_step_plain)
        poison = (mask == 0)[:, None, :, None] & (mask != 0).any(1)[:, None, None, None]
        dirty = run(k.masked_fill(poison, float("nan")), v.masked_fill(poison, float("nan")))
        row = {"s": s, "b": b, "n_split": da.decode_schedule(s, HEAD_DIM)[0],
               "max_abs_err": _err(got, want),
               "fully_masked_study_finite": bool(torch.isfinite(got.float()).all()),
               "masked_rows_unread": bool(torch.equal(got, dirty))}
        row["max_rel_err"] = row["max_abs_err"] / float(want.float().abs().max())
        rows.append(row)
        if not (row["max_rel_err"] <= tol and row["fully_masked_study_finite"]
                and row["masked_rows_unread"]):
            raise AssertionError(f"fused_layer_step {dtype} at S={s}: {row}")
        del k, v, dirty
    return rows


def check_cross_edges(torch, fd, da, dtype):
    """fused_cross_attn at CROSS_EDGES, 8 studies (1 at the largest S): a
    quarter of the keys masked at random, for S >= 128 every key of one tile
    (2,880: the fused path's slot mask instead), study 1 fully masked.
    Against its plain version (1e-5 fp32, 1e-2 bf16); the fully masked study
    finite; NaN in the K and V rows of the masked keys of every study with an
    open key leaves the output's bits unchanged (a read would spread it)."""
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    g = torch.Generator(device="cuda")
    rows = []
    for s in CROSS_EDGES:
        if s == "largest":
            s = da.max_keys(1, HEAD_DIM, torch.finfo(dtype).bits // 8)
        b = 1 if s > 3073 else STUDIES
        g.manual_seed(SEED + 21 + s)
        cq = torch.randn(b, D_MODEL, generator=g, device="cuda").to(dtype)
        k, v = (torch.randn(b, HEADS, s, HEAD_DIM, generator=g, device="cuda").to(dtype)
                for _ in range(2))
        if s == SLOTS * 576:
            mask = (key_mask(torch, "slots", b, s) == 0).int()
        else:
            mask = (torch.rand(b, s, generator=g, device="cuda") >= 0.25).int()
            if s >= 128:
                mask[:, 64:128] = 0
        if b > 1:
            mask[1] = 0
        got = fd.fused_cross_attn(cq, k, v, mask)
        row = {"s": s, "b": b, "n_split": da.decode_schedule(s, HEAD_DIM)[0],
               "max_abs_err": _err(got, fd.fused_cross_attn_plain(cq, k, v, mask)),
               "fully_masked_study_finite": bool(torch.isfinite(got.float()).all())}
        poison = (mask == 0)[:, None, :, None] & (mask != 0).any(1)[:, None, None, None]
        dirty = fd.fused_cross_attn(cq, k.masked_fill(poison, float("nan")),
                                    v.masked_fill(poison, float("nan")), mask)
        row["masked_rows_unread"] = bool(torch.equal(got, dirty))
        rows.append(row)
        if not (row["max_abs_err"] <= tol and row["fully_masked_study_finite"]
                and row["masked_rows_unread"]):
            raise AssertionError(f"fused_cross_attn {dtype} at S={s}: {row}")
        del k, v, dirty
    return rows


def qkv_rows_alone(torch, fd, x):
    """fused_qkv_attn's rows (ctx and the written cache column) bit-equal
    alone, in the B = 8 call and in a B = 11 call (three more studies), its
    split-K projection summed in a fixed order; every other cache column of
    the B = 11 call untouched."""
    b = x.hidden.shape[0]
    index = x.cache_k.shape[2] // 2
    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    more = [torch.randn(3, *t.shape[1:], generator=g, device="cuda").to(t.dtype)
            for t in (x.hidden, x.cache_k, x.cache_v)]
    hidden = torch.cat([x.hidden, more[0]])
    ck, cv = torch.cat([x.cache_k, more[1]]), torch.cat([x.cache_v, more[2]])
    mask = torch.cat([x.self_mask, x.self_mask[:3]])

    def run(lo, hi):  # -> ctx, the caches after the call
        k, v = ck[lo:hi].clone(), cv[lo:hi].clone()
        return fd.fused_qkv_attn(hidden[lo:hi], x.wqkv, x.bqkv, k, v, index, mask[lo:hi]), k, v

    def rows(out):  # ctx and the written column
        return out[0], out[1][:, :, index], out[2][:, :, index]

    b11 = run(0, b + 3)
    want = rows(b11)
    equal = all(torch.equal(w[:b], got) for w, got in zip(want, rows(run(0, b))))
    for i in range(b + 3):
        equal &= all(torch.equal(w[i:i + 1], got) for w, got in zip(want, rows(run(i, i + 1))))
    others = [c for c in range(ck.shape[2]) if c != index]
    untouched = (torch.equal(b11[1][:, :, others], ck[:, :, others])
                 and torch.equal(b11[2][:, :, others], cv[:, :, others]))
    return {"rows_equal_alone_b8_b11": bool(equal), "b11_other_columns_exact": bool(untouched)}


def lnq_rows_alone(torch, fd, x):
    """fused_out_ln_q's rows (h1 and cq) bit-equal alone, in the B = 8 call
    and in a B = 11 call (three more studies), its split-K passes summed in
    a fixed order."""
    b = x.hidden.shape[0]
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    ctx, res = (torch.cat([t, torch.randn(3, t.shape[1], generator=g, device="cuda").to(t.dtype)])
                for t in (x.hidden, x.res))

    def run(lo, hi):
        return fd.fused_out_ln_q(ctx[lo:hi], res[lo:hi], *x.out_ln_q, 1e-12)

    want = run(0, b + 3)
    equal = all(torch.equal(w[:b], got) for w, got in zip(want, run(0, b)))
    for i in range(b + 3):
        equal &= all(torch.equal(w[i:i + 1], got) for w, got in zip(want, run(i, i + 1)))
    return {"rows_equal_alone_b8_b11": bool(equal)}


def check_fused(torch, F, fd, da, dtype):
    """The four kernels of the fused decoder-layer step against their plain
    versions at the fused main path's shapes: the self-attention kernel with
    the step at columns 1, 128 and 255 (the new K/V column within tolerance of
    the plain version's, every other cache column bit-exact), with a fully
    masked study, and its rows' bits alone, in B = 8 and in B = 11; the
    cross-attention kernel also with a fully masked study and at the edges of
    its split (check_cross_edges); times (cold L2) of the kernel, the plain
    version and the same stage in F.linear / F.layer_norm / F.gelu / SDPA
    calls, at column 128."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = fused_operands(torch, dtype, g)
    b, d = x.hidden.shape
    t_len, mid = x.cache_k.shape[2], (1 + NEW_TOKENS) // 2
    res = {k: {"max_abs_err": 0.0} for k in FUSED}

    def self_attn(index, mask, run):
        ck, cv = x.cache_k.clone(), x.cache_v.clone()
        return run(x.hidden, x.wqkv, x.bqkv, ck, cv, index, mask), ck, cv

    qkv = res["fused_qkv_attn"]
    qkv["by_index"], qkv["cache_exact"] = {}, True
    dark = x.self_mask.clone()
    dark[0] = 0
    for index, mask in [(i, x.self_mask) for i in (1, mid, t_len - 1)] + [(mid, dark)]:
        got, want = self_attn(index, mask, fd.fused_qkv_attn), \
            self_attn(index, mask, fd.fused_qkv_attn_plain)
        others = [c for c in range(t_len) if c != index]
        err = max(_err(got[0], want[0]), _err(got[1][:, :, index], want[1][:, :, index]),
                  _err(got[2][:, :, index], want[2][:, :, index]))
        qkv["cache_exact"] &= (torch.equal(got[1][:, :, others], x.cache_k[:, :, others])
                               and torch.equal(got[2][:, :, others], x.cache_v[:, :, others]))
        if mask is dark:
            qkv["fully_masked_row_err"] = err
            if not bool(torch.isfinite(got[0].float()).all()):
                raise AssertionError(f"fused_qkv_attn {dtype}: fully masked row not finite")
        else:
            qkv["by_index"][index] = err
        qkv["max_abs_err"] = max(qkv["max_abs_err"], err)
    if not qkv["cache_exact"]:
        raise AssertionError(f"fused_qkv_attn {dtype}: a cache column other than the step's changed")
    qkv.update(qkv_rows_alone(torch, fd, x))
    if not (qkv["rows_equal_alone_b8_b11"] and qkv["b11_other_columns_exact"]):
        raise AssertionError(f"fused_qkv_attn {dtype}: {qkv}")

    lnq = res["fused_out_ln_q"]
    got, want = fd.fused_out_ln_q(x.hidden, x.res, *x.out_ln_q, 1e-12), \
        fd.fused_out_ln_q_plain(x.hidden, x.res, *x.out_ln_q, 1e-12)
    lnq["max_abs_err"] = max(_err(got[0], want[0]), _err(got[1], want[1]))
    lnq.update(lnq_rows_alone(torch, fd, x))
    if not lnq["rows_equal_alone_b8_b11"]:
        raise AssertionError(f"fused_out_ln_q {dtype}: a row's bits depend on its batch")

    cross = res["fused_cross_attn"]
    dark = x.cross_mask.clone()
    dark[0] = 0
    for mask in (x.cross_mask, dark):
        got = fd.fused_cross_attn(x.hidden, x.cross_k, x.cross_v, mask)
        err = _err(got, fd.fused_cross_attn_plain(x.hidden, x.cross_k, x.cross_v, mask))
        if mask is dark:
            cross["fully_masked_row_err"] = err
            if not bool(torch.isfinite(got.float()).all()):
                raise AssertionError(f"fused_cross_attn {dtype}: fully masked row not finite")
        cross["max_abs_err"] = max(cross["max_abs_err"], err)
    cross["edges"] = check_cross_edges(torch, fd, da, dtype)

    # the FFN kernel at B = 8 and at B = 11 (a second, ragged chunk of rows);
    # its split-K sums run in a fixed order, so each row's bits are the same
    # alone, in the B = 8 call and in the B = 11 call
    ffn = res["fused_out_ln_ffn"]
    more = [(torch.randn(3, d, generator=g, device="cuda")).to(dtype) for _ in range(2)]
    h11, r11 = torch.cat([x.hidden, more[0]]), torch.cat([x.res, more[1]])
    got11 = fd.fused_out_ln_ffn(h11, r11, *x.out_ln_ffn, 1e-12)
    ffn["b8_max_abs_err"] = _err(fd.fused_out_ln_ffn(x.hidden, x.res, *x.out_ln_ffn, 1e-12),
                                 fd.fused_out_ln_ffn_plain(x.hidden, x.res, *x.out_ln_ffn, 1e-12))
    ffn["b11_max_abs_err"] = _err(got11, fd.fused_out_ln_ffn_plain(h11, r11, *x.out_ln_ffn, 1e-12))
    ffn["max_abs_err"] = max(ffn["b8_max_abs_err"], ffn["b11_max_abs_err"])
    alone = torch.cat([fd.fused_out_ln_ffn(h11[i:i + 1], r11[i:i + 1], *x.out_ln_ffn, 1e-12)
                       for i in range(h11.shape[0])])
    ffn["rows_equal_alone_b8_b11"] = bool(
        torch.equal(fd.fused_out_ln_ffn(x.hidden, x.res, *x.out_ln_ffn, 1e-12), got11[:b])
        and torch.equal(alone, got11))
    if not ffn["rows_equal_alone_b8_b11"]:
        raise AssertionError(f"fused_out_ln_ffn {dtype}: a row's bits depend on its batch")

    # the same stages in PyTorch library calls (timed only)
    qh = x.hidden.view(b, HEADS, 1, HEAD_DIM)
    self_bool = ((x.self_mask != 0)
                 & (torch.arange(t_len, device="cuda") <= mid))[:, None, None, :]
    cross_bool = (x.cross_mask != 0)[:, None, None, :]

    def lib_qkv():
        q, k, v = (y.view(b, HEADS, 1, HEAD_DIM) for y in F.linear(x.hidden, x.wqkv, x.bqkv).split(d, 1))
        x.cache_k[:, :, mid] = k[:, :, 0]
        x.cache_v[:, :, mid] = v[:, :, 0]
        return F.scaled_dot_product_attention(q, x.cache_k, x.cache_v, attn_mask=self_bool)

    def lib_lnq():
        wo, bo, g1, b1, wq, bq = x.out_ln_q
        y = F.layer_norm(F.linear(x.hidden, wo, bo) + x.res, (d,), g1, b1, 1e-12)
        return y, F.linear(y, wq, bq)

    def lib_ffn():
        wo, bo, g2, be2, w1, b1, w2, b2, g3, be3 = x.out_ln_ffn
        h = F.layer_norm(F.linear(x.hidden, wo, bo) + x.res, (d,), g2, be2, 1e-12)
        return F.layer_norm(F.linear(F.gelu(F.linear(h, w1, b1)), w2, b2) + h, (d,), g3, be3, 1e-12)

    runs = {
        "fused_qkv_attn": (lambda fn: lambda: fn(x.hidden, x.wqkv, x.bqkv, x.cache_k, x.cache_v,
                                                 mid, x.self_mask), lib_qkv),
        "fused_out_ln_q": (lambda fn: lambda: fn(x.hidden, x.res, *x.out_ln_q, 1e-12), lib_lnq),
        "fused_cross_attn": (lambda fn: lambda: fn(x.hidden, x.cross_k, x.cross_v, x.cross_mask),
                             lambda: F.scaled_dot_product_attention(
                                 qh, x.cross_k, x.cross_v, attn_mask=cross_bool)),
        "fused_out_ln_ffn": (lambda fn: lambda: fn(x.hidden, x.res, *x.out_ln_ffn, 1e-12), lib_ffn),
    }
    work = fused_work(x, mid)
    for name, (bind, library) in runs.items():
        r = res[name]
        r["ms"] = time_cold_ms([bind(getattr(fd, name))])
        r["plain_ms"] = time_cold_ms([bind(getattr(fd, name + "_plain"))], reps=5, warmup=1)
        r["library_ms"] = time_cold_ms([library])
        r["bytes"], r["flops"] = work[name]
        r["ops_dtype"] = "fp32"  # fp32 inside, whatever the storage type
    res["fused_layer_step"] = check_layer_step(torch, F, fd, da, x, dtype,
                                               sum(res[k]["ms"] for k in FUSED))
    return res


def kernel_phase(torch, F, fa, da, br, fd):
    """Each kernel against its plain version at every shape a main path gives
    it (main_path_calls; check_fused for the fused step; check_flash_grad for
    training), fp32 (TF32 off) then bf16; then where bf16 linear adds the
    bias. -> {dtype: {"flash": {images: result}, "decode": {call: result},
    "reorder": {width: result}, "fused": {kernel: result}, "flash_grad":
    {kernel: result}}, "linear_bias_rounding": result}, each kernel result per
    encode (flash), per call, or per training micro-step (flash_grad)."""
    from cxrmate_torch.utils.precision import parity_mode

    paths = main_path_calls(da).values()
    images = sorted({p["images"] for p in paths}, reverse=True)
    calls = sorted({c for p in paths for c in p["decode"]})
    widths = sorted({p["reorder_t"] for p in paths if p["reorder_t"]})
    results = {}
    for name, dtype, tol in (("fp32", torch.float32, 1e-5), ("bf16", torch.bfloat16, 1e-2)):
        g = torch.Generator(device="cuda").manual_seed(SEED + 1)
        with parity_mode():
            res = {"flash": {n: check_flash(torch, fa, F, dtype, n) for n in images},
                   "decode": {c: check_decode_call(torch, da, F, g, dtype, *c) for c in calls},
                   "decode_edges": check_decode_edges(torch, da, dtype),
                   "reorder": {t: check_reorder(torch, br, dtype, t) for t in widths},
                   "fused": check_fused(torch, F, fd, da, dtype),
                   "flash_grad": check_flash_grad(torch, fa, F, dtype, name)}
        checked = ([("flash_attention", {"images": n, **r}) for n, r in res["flash"].items()]
                   + [(c[0], r) for c, r in res["decode"].items()]
                   + [("beam_reorder_write", r) for r in res["reorder"].values()]
                   + list(res["fused"].items()) + list(res["flash_grad"].items()))
        for kname, r in checked:
            bound, bound_by = bound_ms(r["bytes"], r["flops"], r.get("ops_dtype", name))
            emit({"phase": "kernels", "dtype": name, "kernel": kname, "tolerance": tol,
                  "bound_ms": bound, "bound_by": bound_by,
                  **{k: v for k, v in r.items() if k not in ("bytes", "flops", "ops_dtype")}})
            if not r.get("fully_masked_row_err", 0.0) <= tol:
                raise AssertionError(f"{kname} {name} {r}: fully masked row differs by > {tol}")
            if kname not in FLASH_GRAD and not r["max_abs_err"] <= tol:
                raise AssertionError(f"{kname} {name} {r}: max abs err > {tol}")
        emit({"phase": "kernels", "dtype": name, "check": "decode_split_edges",
              "tolerance": tol, "rows": res["decode_edges"]})
        results[name] = res
    results["linear_bias_rounding"] = check_linear_rounding(torch, F)
    return results


# ------------------------------------------------------------------ main path
class Recorder:
    """Counts the calls of module-level functions the main path goes through
    (bert_step, the encoder, the decoders), keeps the decoders' outputs, and
    adds up the wall time of the timed ones (synchronised on both sides)."""

    def __init__(self):
        self.calls, self.outputs, self.seconds = {}, {}, {}
        self._undo = []

    def wrap(self, module, name, keep=False, timed=False):
        import torch

        fn = getattr(module, name)

        def wrapped(*a, **kw):
            self.calls[name] = self.calls.get(name, 0) + 1
            if timed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = fn(*a, **kw)
            if timed:
                torch.cuda.synchronize()
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
            if keep:
                self.outputs[name] = out
            return out

        setattr(module, name, wrapped)
        self._undo.append((module, name, fn))

    def restore(self):
        for module, name, fn in reversed(self._undo):
            setattr(module, name, fn)


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel wrapper for its plain version (the parity oracle)."""
    from cxrmate_torch.ops import beam_reorder as br
    from cxrmate_torch.ops import decode_attention as da
    from cxrmate_torch.ops import flash_attention as fa
    from cxrmate_torch.ops import fused_decode as fd

    swaps = [(fa, "flash_attention"), (fa, "flash_attention_grad"),
             (da, "decode_attention"), (da, "decode_attention_vpu"),
             (da, "decode_attention_q8"), (br, "beam_reorder_write"),
             (fd, "fused_layer_step")] + [(fd, n) for n in FUSED]
    saved = [getattr(mod, name) for mod, name in swaps]
    for mod, name in swaps:
        setattr(mod, name, getattr(mod, name + "_plain"))
    try:
        yield
    finally:
        for (mod, name), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def make_pixels(np):
    rs = np.random.RandomState(SEED)
    px = rs.randn(STUDIES, SLOTS, 3, 384, 384).astype(np.float32)
    for i, n in enumerate(IMAGES_PER_STUDY):
        px[i, n:] = 0.0
    return px


def write_checkpoint(torch, api, tokenizer_path, variant):
    """A seeded random full-width model as an HF directory, under the released
    checkpoints' key names. The longitudinal one gets a random lora_B (a
    fresh LoRA's is zero, which would leave LoRA inert)."""
    from cxrmate_torch.ckpt.hf import model_state_dict, save_hf_pretrained_dir
    from cxrmate_torch.tokenizer import ByteLevelBPETokenizer

    tok = ByteLevelBPETokenizer.from_file(tokenizer_path)
    model = api.CXRMate.random_init(tok, variant=variant, dtype=torch.float32, seed=SEED,
                                    device="cuda")
    if variant == "longitudinal":
        g = torch.Generator(device="cuda").manual_seed(SEED + 6)
        with torch.no_grad():
            for name, p in model.model.named_parameters():
                if ".lora_B." in name:
                    p.copy_(torch.randn(p.shape, generator=g, device="cuda") * 0.02)
    sd = model_state_dict(model.model)
    if variant == "longitudinal" and not any(
            k.startswith("decoder.base_model.model.") and ".lora_B.default." in k for k in sd):
        raise AssertionError("the longitudinal checkpoint lacks PEFT key names")
    path = os.path.join(SMOKE_DIR, f"cxrmate-{variant}-random")
    save_hf_pretrained_dir(path, sd, model.config, tok)  # tokenizer.json through tok.save
    return path


def synthetic_section(tok, rs, n_tokens):
    """A string decoded from random token ids whose encoding has about
    ``n_tokens`` tokens (grown four ids at a time: decoding then encoding
    does not keep the count)."""
    special = {tok.vocab[t] for t in tok.all_special_tokens}
    ordinary = [i for i in range(len(tok)) if i not in special]
    text = ""
    while len(tok.encode(text)) < n_tokens:
        text += tok.decode([ordinary[j] for j in rs.randint(0, len(ordinary), 4)])
    return text


def make_prompts(np, tok, longest, seed):
    """Previous reports for STUDIES studies: studies 1 and 6 have none
    ([NPF]/[NPI]), the others' prompts are spread up to ``longest`` tokens
    (study 0 the longest; above the 256-token limit it is truncated)."""
    rs = np.random.RandomState(seed)
    findings, impression = [], []
    for i in range(STUDIES):
        if i in (1, 6):
            findings.append(None)
            impression.append(None)
            continue
        total = longest if i == 0 else max(8, int(longest * rs.uniform(0.2, 0.8)))
        body = total - 3  # [PMT], [PMT-SEP] and [BOS]
        findings.append(synthetic_section(tok, rs, body * 2 // 3))
        impression.append(synthetic_section(tok, rs, body - body * 2 // 3))
    return findings, impression


def new_tokens(seqs, eos) -> int:
    """Tokens generated, each row counted up to and including its EOS."""
    total = 0
    for row in seqs:
        hits = (row == eos).nonzero()[0]
        total += int(hits[0]) + 1 if hits.size else row.size
    return total


def drive(model, px, mode, beams, depth, layers, spec=None, prompts=None, sample=None,
          use_fused=None, reports=None, sequences=None):
    """One report batch along a main path, with every launch count set to 0
    just before it and read just after; checks the counts against what the
    path and the routing spec imply, checks the output, and returns the
    call's figures. ``use_fused`` None: CXRMate.generate_report. True or
    False: the entry points that reach the fused step, CXRMate.encode ->
    generate.decode.generate(use_fused=...) -> split_and_decode_sections
    (generate_report has no use_fused argument, as in the JAX package): with
    it each of the four fused kernels runs layers x steps times and
    decode_attention not once, without it the other way round. ``reports``:
    a dict that receives the reports ("findings", "impression");
    ``sequences``: a list that receives the call's token ids."""
    from cxrmate_torch.generate import decode as decode_mod
    from cxrmate_torch.models import api
    from cxrmate_torch.models import bert as bert_mod
    from cxrmate_torch.models import encoder_decoder as ed
    from cxrmate_torch.ops import decode_attention as da
    import torch

    tok = model.tokenizer
    kw = dict(num_beams=beams, decode_kernel=spec)
    p_len = 1
    if prompts is not None:
        kw.update(previous_findings=prompts[0], previous_impression=prompts[1])
        width = model.tokenize_prompt(*prompts, add_bos_token_id=True)["input_ids"].shape[1]
        p_len = -(-width // 32) * 32
    if sample is not None:
        kw.update(do_sample=True, **sample,
                  generator=torch.Generator(device="cuda").manual_seed(SEED + 7))
    wrappers = all_wrappers()
    decoder = "beam_search" if beams > 1 else "generate"
    rec = Recorder()
    rec.wrap(bert_mod, "bert_step")
    rec.wrap(ed, "encode_images", timed=True)
    rec.wrap(api, decoder, keep=True)
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        if use_fused is None:
            findings, impression = model.generate_report(px, **kw)
        else:
            with torch.no_grad():
                hidden, mask = model.encode(px)
                prompt = torch.full((STUDIES, 1), tok.bos_token_id, dtype=torch.int32,
                                    device="cuda")
                seqs = decode_mod.generate(model.model, model._gen_cfg(1, None), hidden, mask,
                                           prompt, torch.ones_like(prompt),
                                           use_fused=use_fused).cpu().numpy()
            findings, impression = model.split_and_decode_sections(
                seqs, [tok.sep_token_id, tok.eos_token_id])
    finally:
        rec.restore()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if use_fused is None:
        out = rec.outputs[decoder]
        seqs = (out[0] if beams > 1 else out).cpu().numpy()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    steps = rec.calls.get("bert_step", 0)
    per_kind = layers * steps  # self calls per decode, and as many cross calls
    spec = spec or ""
    want = dict.fromkeys(wrappers, 0)
    want.update(flash_attention=depth, decode_attention=2 * per_kind,
                beam_reorder_write=layers * (steps + 1) if beams > 1 else 0)
    if use_fused:
        want.update(dict.fromkeys(FUSED, per_kind), decode_attention=0)
    elif da.is_q8(spec):
        want.update(decode_attention=per_kind, decode_attention_q8=per_kind)
    elif da.uses_vpu(spec, False):
        want.update(decode_attention=0, decode_attention_vpu=2 * per_kind)
    if launches != want or steps == 0:
        raise AssertionError(f"{mode}: launches {launches}, expected {want} ({steps} steps)")
    if not (len(findings) == len(impression) == STUDIES
            and all(isinstance(s, str) for s in list(findings) + list(impression))):
        raise AssertionError(f"{mode}: malformed reports")
    if seqs.shape != (STUDIES, p_len + model.config.decoder_max_len - 1) or \
            not ((seqs >= 0) & (seqs < len(tok))).all():
        raise AssertionError(f"{mode}: sequences {seqs.shape} out of range")
    ntok = new_tokens(seqs[:, p_len:], tok.eos_token_id)
    enc_s = rec.seconds["encode_images"]
    if reports is not None:
        reports.update(findings=list(findings), impression=list(impression))
    if sequences is not None:
        sequences.append(seqs)
    return {"seconds": secs, "studies_per_s": STUDIES / secs, "new_tokens_per_s": ntok / secs,
            "new_tokens": ntok, "encode_s": enc_s, "decode_s": secs - enc_s,
            "decode_ms_per_step": (secs - enc_s) / steps * 1e3, "decode_steps": steps,
            "prompt_width": p_len, "launches": launches, "first_findings": findings[0][:80]}


def main_phase(torch, np, ckpt):
    """The multi path. Each mode: one untimed call at the timed shapes (full
    length: cuBLAS handles, allocator growth), then MAIN_RUNS timed calls; the
    median call's figures are reported beside every call's studies/s."""
    from cxrmate_torch.models import api

    t0 = time.perf_counter()
    model = api.CXRMate.from_hf_checkpoint(ckpt, variant="multi", dtype=torch.bfloat16,
                                           device="cuda")
    load_s = time.perf_counter() - t0
    px = make_pixels(np)
    layers = model.config.decoder.num_hidden_layers
    depth = sum(model.config.encoder.depth)
    results, counts = {}, {}
    for mode, beams in (("greedy", 1), ("beam4", 4)):
        model.generate_report(px, num_beams=beams)  # warm-up, untimed
        runs = [drive(model, px, mode, beams, depth, layers) for _ in range(MAIN_RUNS)]
        med = sorted(runs, key=lambda r: r["studies_per_s"])[MAIN_RUNS // 2]
        results[mode] = {**med, "runs_studies_per_s": [r["studies_per_s"] for r in runs],
                         "runs_decode_ms_per_step": [r["decode_ms_per_step"] for r in runs],
                         "checkpoint_load_s": load_s}
        counts[mode] = med["launches"]
        emit({"phase": "main", "variant": "multi", "mode": mode, "dtype": "bf16",
              "studies": STUDIES, "image_slots": SLOTS, "runs": MAIN_RUNS, "reported": "median",
              **results[mode]})
    return results, counts


def longitudinal_phase(torch, np, ckpt):
    """The longitudinal path at full width: per run one untimed call, then one
    timed call with its launch counts checked."""
    from cxrmate_torch.models import api

    model = api.CXRMate.from_hf_checkpoint(ckpt, variant="longitudinal", dtype=torch.bfloat16,
                                           device="cuda")
    if model.config.lora is None:
        raise AssertionError("the longitudinal checkpoint loaded without LoRA")
    tok = model.tokenizer
    px = make_pixels(np)
    layers = model.config.decoder.num_hidden_layers
    depth = sum(model.config.encoder.depth)
    counts, widths = {}, set()
    for n, (mode, beams, spec, longest, bucket, sample) in enumerate(LONGITUDINAL_RUNS):
        prompts = make_prompts(np, tok, longest, SEED + 10 + n)
        ids = model.tokenize_prompt(*prompts, add_bos_token_id=True)["input_ids"]
        if longest > model.config.prompt_max_len and not (
                ids.shape[1] == model.config.prompt_max_len and ids[0, -1] == tok.bos_token_id):
            raise AssertionError(f"{mode}: the long prompt was not truncated with BOS forced")
        if not (ids[1, 1] == tok.vocab["[NPF]"] and ids[6, 3] == tok.vocab["[NPI]"]):
            raise AssertionError(f"{mode}: a study without a previous report lacks [NPF]/[NPI]")
        warm = dict(previous_findings=prompts[0], previous_impression=prompts[1],
                    num_beams=beams, decode_kernel=spec)
        if sample is not None:
            warm.update(do_sample=True, **sample,
                        generator=torch.Generator(device="cuda").manual_seed(SEED))
        model.generate_report(px, **warm)  # warm-up, untimed
        res = drive(model, px, f"longitudinal {mode}", beams, depth, layers, spec=spec,
                    prompts=prompts, sample=sample)
        if res["prompt_width"] != bucket:  # the kernels phase checked this run's shapes
            raise AssertionError(f"{mode}: prompt bucket {res['prompt_width']}, expected {bucket}")
        widths.add(bucket)
        counts[mode] = res["launches"]
        emit({"phase": "main", "variant": "longitudinal", "mode": mode, "dtype": "bf16",
              "decode_kernel": spec or "", "studies": STUDIES, "image_slots": SLOTS,
              "runs": 1, **res})
    if not {64, 128, 256} <= widths:
        raise AssertionError(f"prompt buckets {sorted(widths)} miss one of 64, 128, 256")
    return counts


def single_phase(torch, np, ckpt):
    """The single-image path: [STUDIES, 3, 384, 384], greedy and beam-4, one
    untimed then one timed call each. The multi checkpoint serves: the two
    variants hold the same tensors."""
    from cxrmate_torch.models import api

    model = api.CXRMate.from_hf_checkpoint(ckpt, variant="single", dtype=torch.bfloat16,
                                           device="cuda")
    px = make_pixels(np)[:, 0]
    layers = model.config.decoder.num_hidden_layers
    depth = sum(model.config.encoder.depth)
    counts = {}
    for mode, beams in (("greedy", 1), ("beam4", 4)):
        model.generate_report(px, num_beams=beams)  # warm-up, untimed
        res = drive(model, px, f"single {mode}", beams, depth, layers)
        counts[mode] = res["launches"]
        emit({"phase": "main", "variant": "single", "mode": mode, "dtype": "bf16",
              "studies": STUDIES, "image_slots": 1, "runs": 1, **res})
    return counts


def fused_phase(torch, np, ckpt):
    """The fused path at full width beside the unfused greedy of the same run:
    one untimed call each at the full length, then MAIN_RUNS timed calls each,
    in turns; the median call's figures beside every call's."""
    from cxrmate_torch.models import api

    model = api.CXRMate.from_hf_checkpoint(ckpt, variant="multi", dtype=torch.bfloat16,
                                           device="cuda")
    px = make_pixels(np)
    layers = model.config.decoder.num_hidden_layers
    depth = sum(model.config.encoder.depth)
    runs = {True: [], False: []}
    def call(use_fused):
        return drive(model, px, "multi greedy fused" if use_fused else "multi greedy unfused", 1,
                     depth, layers, use_fused=use_fused)

    for use_fused in (True, False):
        call(use_fused)  # warm-up, untimed
    for _ in range(MAIN_RUNS):
        for use_fused in (True, False):
            runs[use_fused].append(call(use_fused))
    out = {}
    for use_fused, mode in ((True, "fused"), (False, "unfused")):
        med = sorted(runs[use_fused], key=lambda r: r["studies_per_s"])[MAIN_RUNS // 2]
        out[mode] = {**med, "runs_studies_per_s": [r["studies_per_s"] for r in runs[use_fused]],
                     "runs_decode_ms_per_step": [r["decode_ms_per_step"] for r in runs[use_fused]]}
        emit({"phase": "main", "variant": "multi", "mode": f"greedy-{mode}", "dtype": "bf16",
              "entry": "encode -> generate(use_fused=%s) -> split_and_decode_sections" % use_fused,
              "studies": STUDIES, "image_slots": SLOTS, "runs": MAIN_RUNS, "reported": "median",
              **out[mode]})
    emit({"phase": "main", "variant": "multi", "mode": "fused-vs-unfused",
          "decode_ms_per_step": {m: out[m]["decode_ms_per_step"] for m in out},
          "studies_per_s": {m: out[m]["studies_per_s"] for m in out}})
    return out["fused"]["launches"]


def teacher_fed(torch, model, gen_cfg, px, prompt, col, spec, beam_feed, beam_sel, beams, steps,
                tokens=None):
    """Encoder states, greedy logits (prefill, then ``steps`` - 1 teacher-fed
    bert_step calls with the cache written) and beam logits (bert_step with
    the write deferred, then the reorder with the given beam choices) of one
    path under one routing spec. ``tokens`` feeds the greedy steps; without
    it the path's own free-running greedy output does."""
    from cxrmate_torch.generate.decode import generate, prefill
    from cxrmate_torch.models import bert as bert_mod
    from cxrmate_torch.models import encoder_decoder as ed
    from cxrmate_torch.ops import beam_reorder as br
    from cxrmate_torch.ops.decode_attention import resolve_decode_kernel

    spec = resolve_decode_kernel(spec)
    n, p_len = prompt.shape
    t_total = p_len + steps
    cols = torch.arange(t_total, device="cuda")
    masked = gen_cfg.mask_token_id is not None
    dec = model.model.decoder

    def step_inputs(feed, i):
        upto = cols <= i
        if masked:
            key_mask = ((feed != gen_cfg.mask_token_id) & upto).int()
            pos = (key_mask.sum(1) - 1).clamp(min=0)
        else:
            key_mask = upto.int().expand(feed.shape[0], t_total).contiguous()
            pos = torch.full((feed.shape[0],), i, dtype=torch.long, device="cuda")
        return key_mask, pos, torch.zeros(feed.shape[0], dtype=torch.int32, device="cuda")

    hidden, mask = ed.encode_images(model.model, px)
    seq = generate(model.model, gen_cfg, hidden, mask, prompt, None, prompt_logits_col=col,
                   decode_kernel=spec)
    feed = seq if tokens is None else tokens
    logits0, cache, _ = prefill(model.model, gen_cfg, hidden, mask, prompt, t_total)
    cache, q8 = bert_mod.maybe_quantize_cross_cache(cache, spec)
    greedy = [logits0[:, p_len - 1 if col is None else col]]
    for i in range(p_len, t_total - 1):
        key_mask, pos, ttype = step_inputs(feed, i)
        logits, cache = bert_mod.bert_step(dec, cache, feed[:, i], ttype, pos, i, key_mask, mask,
                                           decode_kernel=spec, cross_q8=q8)
        greedy.append(logits)
    _, cache, _ = prefill(model.model, gen_cfg, hidden, mask, prompt, t_total)
    cache.self_k = [x.repeat_interleave(beams, 0) for x in cache.self_k]
    cache.self_v = [x.repeat_interleave(beams, 0) for x in cache.self_v]
    cache, q8 = bert_mod.maybe_quantize_cross_cache(cache, spec)
    beam = []
    for i in range(p_len, t_total - 1):
        key_mask, pos, ttype = step_inputs(beam_feed, i)
        logits, (nk, nv) = bert_mod.bert_step(dec, cache, beam_feed[:, i], ttype, pos, i, key_mask,
                                              mask, deferred_write=True, decode_kernel=spec,
                                              cross_q8=q8)
        for li in range(len(cache.self_k)):
            br.beam_reorder_write(cache.self_k[li], cache.self_v[li], nk[li], nv[li],
                                  beam_sel[i], i, beams)
        beam.append(logits)
    return hidden, torch.stack(greedy, 1), torch.stack(beam, 1), seq


def parity_phase(torch, np, ckpts):
    """The kernel path against the plain path on the card, on the same token
    sequences, for the multi model and (with a ragged prompt padded to its
    32-token bucket) the longitudinal model under the default spec,
    vpu-rowgroup and cross-rowgroup-q8; the q8 plain path runs over the same
    quantised cache. fp32 with TF32 off is held to PARITY_TOL, bf16 (the
    serving dtype) to BF16_PARITY_TOL; both must be finite. The q8 path's
    distance from the unquantised path (same tokens) is printed, not held."""
    from cxrmate_torch.models import api
    from cxrmate_torch.utils.precision import parity_mode

    n, beams, steps = 2, 4, 16
    pixels = torch.from_numpy(make_pixels(np)[:n]).cuda()
    cases = [("multi", None), ("longitudinal", None), ("longitudinal", "vpu-rowgroup"),
             ("longitudinal", "cross-rowgroup-q8")]
    results = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        px = pixels.to(dtype)
        models = {}
        for variant, spec in cases:
            with parity_mode(), torch.no_grad():
                if variant not in models:
                    models.clear()  # one model on the card at a time
                    models[variant] = api.CXRMate.from_hf_checkpoint(
                        ckpts[variant], variant=variant, dtype=dtype, device="cuda")
                model = models[variant]
                tok = model.tokenizer
                gen_cfg = model._gen_cfg(1, steps)
                g = torch.Generator().manual_seed(SEED + 3)  # the same tokens each dtype
                if variant == "multi":
                    prompt = torch.full((n, 1), tok.bos_token_id, dtype=torch.int32,
                                        device="cuda")
                    col = None
                else:  # true widths 21 and 9 in the 32-token bucket
                    prompt = torch.full((n, 32), tok.pad_token_id, dtype=torch.int32)
                    for r, w in enumerate((21, 9)):
                        row = torch.randint(10, len(tok), (w,), generator=g).int()
                        row[0], row[w // 2], row[-1] = (tok.vocab["[PMT]"],
                                                        tok.vocab["[PMT-SEP]"], tok.bos_token_id)
                        prompt[r, :w] = row
                    prompt, col = prompt.cuda(), 20
                t_total = prompt.shape[1] + steps
                beam_feed = torch.randint(0, len(tok), (n * beams, t_total), generator=g).int()
                beam_feed[:, :prompt.shape[1]] = prompt.cpu().repeat_interleave(beams, 0)
                beam_feed = beam_feed.cuda()
                beam_sel = torch.randint(0, beams, (t_total, n * beams), generator=g).int().cuda()
                args = (torch, model, gen_cfg, px, prompt, col, spec, beam_feed, beam_sel, beams,
                        steps)
                h_k, g_k, b_k, seq_k = teacher_fed(*args)
                with plain_kernels():
                    h_p, g_p, b_p, seq_p = teacher_fed(*args, tokens=seq_k)
                extra = {}
                if spec == "cross-rowgroup-q8":
                    _, g_u, b_u, _ = teacher_fed(*args[:6], None, *args[7:], tokens=seq_k)
                    extra = {"q8_vs_unquantised_greedy_logits": _err(g_k, g_u),
                             "q8_vs_unquantised_beam4_logits": _err(b_k, b_u)}
                torch.cuda.synchronize()
            res = {"encoder_max_abs_err": _err(h_k, h_p),
                   "greedy_logits_max_abs_err": _err(g_k, g_p),
                   "beam4_logits_max_abs_err": _err(b_k, b_p), "steps": g_k.shape[1],
                   "greedy_token_agreement": float((seq_k == seq_p).float().mean()),
                   "finite": bool(all(torch.isfinite(x.float()).all() for x in (h_k, g_k, b_k))),
                   **extra}
            res["tolerance"] = PARITY_TOL if name == "fp32" else BF16_PARITY_TOL
            emit({"phase": "parity", "dtype": name, "variant": variant,
                  "decode_kernel": spec or "", **res})
            errs = [v for k, v in res.items() if k.endswith("max_abs_err")]
            if not (res["finite"] and max(errs) <= res["tolerance"]):
                raise AssertionError(f"{name} {variant} {spec}: kernel path disagrees with the "
                                     f"plain path: {res}")
            results[(name, variant, spec)] = res
        del models
    return results


def fused_parity_phase(torch, np, ckpt):
    """The fused path on the card: its kernels against its plain versions
    (greedy logits over a prefill and 15 teacher-fed steps; fp32 within
    PARITY_TOL, bf16 within BF16_PARITY_TOL), and in fp32 against the unfused
    path on the same tokens (PARITY_TOL); the share of free-running greedy
    tokens on which fused and unfused agree is printed. Then one real decode
    step at column 8 with each of the 6 layers through v1 (fused_layer_step,
    which no path calls) against the same step through v2, from the caches of
    a prefill and 7 teacher-fed steps (same limits; launches counted). ->
    the launch counts of that v1 step (bf16)."""
    import copy

    from cxrmate_torch.generate.decode import generate, prefill
    from cxrmate_torch.models import api
    from cxrmate_torch.models import bert as bert_mod
    from cxrmate_torch.ops import fused_decode as fd
    from cxrmate_torch.ops.fused_decode import prepare_fused_params
    from cxrmate_torch.utils.precision import parity_mode

    n, steps = 2, 16
    pixels = torch.from_numpy(make_pixels(np)[:n]).cuda()
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        with parity_mode(), torch.no_grad():
            model = api.CXRMate.from_hf_checkpoint(ckpt, variant="multi", dtype=dtype,
                                                   device="cuda")
            gen_cfg = model._gen_cfg(1, steps)
            dec = model.model.decoder
            prompt = torch.full((n, 1), model.tokenizer.bos_token_id, dtype=torch.int32,
                                device="cuda")
            hidden, mask = model.encode(pixels.to(dtype))
            cols = torch.arange(1 + steps, device="cuda")

            def run(use_fused, tokens=None):
                seq = generate(model.model, gen_cfg, hidden, mask, prompt, None,
                               use_fused=use_fused, decode_kernel="")
                feed = seq if tokens is None else tokens
                logits0, cache, _ = prefill(model.model, gen_cfg, hidden, mask, prompt, 1 + steps)
                prep = (prepare_fused_params(dec, dec.config.num_attention_heads)
                        if use_fused else None)
                logits = [logits0[:, 0]]
                for i in range(1, steps):
                    key_mask = (cols <= i).int().expand(n, 1 + steps).contiguous()
                    step, cache = bert_mod.bert_step(
                        dec, cache, feed[:, i], torch.zeros(n, dtype=torch.int32, device="cuda"),
                        torch.full((n,), i, dtype=torch.long, device="cuda"), i, key_mask, mask,
                        use_fused=use_fused, fused_prepared=prep, decode_kernel="")
                    logits.append(step)
                return torch.stack(logits, 1), seq

            def v1_step(at):
                """One teacher-fed step at column ``at`` with every layer through
                v1 (fused_layer_step) and through v2, from the same caches: a
                prefill and the v2 steps before ``at``."""
                _, cache, _ = prefill(model.model, gen_cfg, hidden, mask, prompt, 1 + steps)
                prep = prepare_fused_params(dec, dec.config.num_attention_heads)

                def step(i, c):
                    key_mask = (cols <= i).int().expand(n, 1 + steps).contiguous()
                    return bert_mod.bert_step(
                        dec, c, seq_k[:, i], torch.zeros(n, dtype=torch.int32, device="cuda"),
                        torch.full((n,), i, dtype=torch.long, device="cuda"), i, key_mask, mask,
                        use_fused=True, fused_prepared=prep, decode_kernel="")[0]

                for i in range(1, at):
                    step(i, cache)
                twin = copy.copy(cache)
                twin.self_k = [x.clone() for x in cache.self_k]
                twin.self_v = [x.clone() for x in cache.self_v]
                via_v2 = step(at, cache)
                v2, wrappers = fd.fused_layer_step_v2, all_wrappers()
                fd.fused_layer_step_v2 = lambda *a, **kw: fd.fused_layer_step(*a, **kw)[0]
                for fn in wrappers.values():
                    fn.launches = 0
                try:
                    via_v1 = step(at, twin)
                finally:
                    fd.fused_layer_step_v2 = v2
                counts = {k: fn.launches for k, fn in wrappers.items()}
                want = dict.fromkeys(wrappers, 0)
                want["fused_layer_step"] = len(prep)
                if counts != want:
                    raise AssertionError(f"v1 step: launches {counts}, expected {want}")
                return via_v1, via_v2, counts

            g_k, seq_k = run(True)
            with plain_kernels():
                g_p, _ = run(True, tokens=seq_k)
            g_u, seq_u = run(False, tokens=seq_k)
            l_v1, l_v2, v1_counts = v1_step(steps // 2)
            torch.cuda.synchronize()
        tol = PARITY_TOL if name == "fp32" else BF16_PARITY_TOL
        res = {"kernels_vs_plain_logits_max_abs_err": _err(g_k, g_p),
               "fused_vs_unfused_logits_max_abs_err": _err(g_k, g_u), "steps": g_k.shape[1],
               "fused_vs_unfused_greedy_token_agreement": float((seq_k == seq_u).float().mean()),
               "v1_vs_v2_step_logits_max_abs_err": _err(l_v1, l_v2),
               "v1_step_column": steps // 2, "v1_step_launches": v1_counts["fused_layer_step"],
               "finite": bool(torch.isfinite(g_k.float()).all()
                              and torch.isfinite(l_v1.float()).all()), "tolerance": tol}
        emit({"phase": "parity", "dtype": name, "variant": "multi", "path": "fused", **res})
        held = [res["kernels_vs_plain_logits_max_abs_err"], res["v1_vs_v2_step_logits_max_abs_err"]]
        if name == "fp32":  # in bf16 the two paths round at different points
            held.append(res["fused_vs_unfused_logits_max_abs_err"])
        if not (res["finite"] and max(held) <= tol):
            raise AssertionError(f"{name} fused path: {res}")
        del model
    return v1_counts


def train_batch(np, tok, config):
    """One micro-batch of config/train/multi_tf.yaml: 4 studies x 5 image
    slots (TRAIN_IMAGES real images, the other slots all-zero) and synthetic
    findings and impressions through build_tf_batch with the repository
    tokenizer; the longest report is truncated at decoder_max_len."""
    from cxrmate_torch.train.tf_trainer import build_tf_batch

    rs = np.random.RandomState(SEED + 20)
    n = len(TRAIN_IMAGES)
    px = rs.randn(n, SLOTS, 3, 384, 384).astype(np.float32)
    for i, k in enumerate(TRAIN_IMAGES):
        px[i, k:] = 0.0
    lengths = (300, 180, 90, 40)  # tokens of findings + impression per study
    findings = [synthetic_section(tok, rs, m * 2 // 3) for m in lengths]
    impression = [synthetic_section(tok, rs, m - m * 2 // 3) for m in lengths]
    batch = build_tf_batch(tok, config, px, findings, impression)
    if batch["decoder_input_ids"].shape != (n, config.decoder_max_len):
        raise AssertionError(f"train batch ids {batch['decoder_input_ids'].shape}, expected "
                             f"({n}, {config.decoder_max_len})")
    return batch


def all_wrappers():
    """Every kernel wrapper of the port, by kernel name."""
    from cxrmate_torch.ops import beam_reorder as br
    from cxrmate_torch.ops import decode_attention as da
    from cxrmate_torch.ops import flash_attention as fa
    from cxrmate_torch.ops import fused_decode as fd

    return {"flash_attention": fa.flash_attention, "decode_attention": da.decode_attention,
            "decode_attention_q8": da.decode_attention_q8,
            "decode_attention_vpu": da.decode_attention_vpu,
            "beam_reorder_write": br.beam_reorder_write,
            **{name: getattr(fd, name) for name in FUSED},
            "fused_layer_step": fd.fused_layer_step,
            **{name: getattr(fa, name) for name in FLASH_GRAD}}


def train_breakdown(torch, net, batch, pad_id, reps=3):
    """Where a bf16 micro-step's device time goes: the same forward and
    backward as the train step, on a bf16 copy of the model, split at the
    encoder's output (synchronised host clock, median of ``reps``): encoder
    forward, decoder forward + loss, decoder backward, encoder backward. Then
    one more encoder backward traced by torch.profiler: the device's busy
    time in it (the sum of its kernels' and copies' device times), in all and
    in the flash_attention_grad backward kernels, beside its wall time."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from cxrmate_torch.models import bert as bert_mod
    from cxrmate_torch.models import encoder_decoder as ed
    from cxrmate_torch.train import tf_trainer as tt
    from cxrmate_torch.utils.precision import cast_floats

    m16 = cast_floats(copy.deepcopy(net), torch.bfloat16).requires_grad_(True)
    b = tt.batch_to_device(batch, torch.device("cuda"), torch.bfloat16)
    enc_params, dec_params = list(m16.encoder.parameters()), list(m16.decoder.parameters())
    times = {"encoder_forward": [], "decoder_forward": [], "decoder_backward": [],
             "encoder_backward": []}

    def to_encoder_grad(seed, mark):
        """-> (the encoder's output, the loss's gradient at it)"""
        gen = torch.Generator(device="cuda").manual_seed(seed)
        mark()
        hidden, mask = ed.encode_images(m16, b["pixel_values"], train=True, generator=gen)
        mark()
        h = hidden.detach().requires_grad_()
        logits = bert_mod.bert_forward(m16.decoder, b["decoder_input_ids"],
                                       b["decoder_attention_mask"], b["decoder_token_type_ids"],
                                       None, h, mask, train=True, generator=gen)
        loss = tt.cross_entropy_ignore_pad(logits, b["label_ids"], pad_id)
        mark()
        grads = torch.autograd.grad(loss, [h] + dec_params)
        mark()
        return hidden, grads[0]

    for i in range(reps + 1):
        marks = []

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        hidden, grad = to_encoder_grad(SEED + 30 + i, mark)
        torch.autograd.grad(hidden, enc_params, grad)
        mark()
        if i:  # the first is a warm-up
            for key, t0, t1 in zip(times, marks, marks[1:]):
                times[key].append((t1 - t0) * 1e3)
    out = {f"{k}_ms": sorted(v)[reps // 2] for k, v in times.items()}
    total = sum(out.values())
    out["encoder_backward_share"] = out["encoder_backward_ms"] / total
    out["encoder_share"] = (out["encoder_forward_ms"] + out["encoder_backward_ms"]) / total
    hidden, grad = to_encoder_grad(SEED + 29, torch.cuda.synchronize)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        torch.autograd.grad(hidden, enc_params, grad)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()}
    traced = {"encoder_backward_traced_wall_ms": wall,
              "encoder_backward_device_busy_ms": sum(busy.values()),
              "encoder_backward_flash_bwd_device_ms": sum(
                  v for k, v in busy.items() if "flash_bwd" in k)}
    if not traced["encoder_backward_device_busy_ms"] > 0:  # the trace saw no device time
        traced.update(dict.fromkeys(["encoder_backward_device_busy_ms",
                                     "encoder_backward_flash_bwd_device_ms"], "not measured"))
    del m16
    return {**out, **traced}


def train_phase(torch, np, ckpt):
    """Teacher-forcing training of the multi model at full width through the
    entry points cli.stages.fit calls: mask_for_stage -> adamw ->
    create_train_state -> make_train_step(bf16) -> build_tf_batch -> step.
    One untimed micro-step, then TRAIN_ACCUM timed ones with dropout on (a
    generator per micro-step from train_generator), so that exactly one AdamW
    update is applied among them; every micro-step's launch counts checked
    (each flash_attention_grad kernel once per CvT layer, no other kernel)."""
    from cxrmate_torch.models import api
    from cxrmate_torch.train import optim
    from cxrmate_torch.train import tf_trainer as tt

    model = api.CXRMate.from_hf_checkpoint(ckpt, variant="multi", dtype=torch.float32,
                                           device="cuda")
    net, config, tok = model.model, model.config, model.tokenizer
    depth = sum(config.encoder.depth)
    batch = train_batch(np, tok, config)
    params = dict(net.named_parameters())
    mask = optim.mask_for_stage(params, "multi")
    tx = optim.adamw(TRAIN_LR, accumulate_steps=TRAIN_ACCUM, trainable_mask=mask)
    state = tt.create_train_state(net, tx)
    step = tt.make_train_step(config, tx, mask, pad_id=tok.pad_token_id,
                              compute_dtype=torch.bfloat16)
    update, update_ms, applied = tx.update, [], []

    def timed_update(*a, **kw):  # the optimizer's own time, synchronised
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = update(*a, **kw)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
        applied.append(out)
        return out

    tx.update = timed_update
    wrappers = all_wrappers()
    want = dict.fromkeys(wrappers, 0)
    want.update(dict.fromkeys(FLASH_GRAD, depth))
    w0 = params["decoder.cls.predictions.bias"].detach().clone()
    state, loss0 = step(state, batch, tt.train_generator(0, 0))  # warm-up, untimed
    torch.cuda.reset_peak_memory_stats()
    steps_ms, losses, launches = [], [float(loss0)], {k: 0 for k in wrappers}
    for i in range(1, TRAIN_ACCUM + 1):
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch, tt.train_generator(0, i))
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        counts = {k: fn.launches for k, fn in wrappers.items()}
        if counts != want:
            raise AssertionError(f"train micro-step {i}: launches {counts}, expected {want}")
        for k, v in counts.items():
            launches[k] += v
    peak = torch.cuda.max_memory_allocated()
    tx.update = update
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: losses {losses}")
    if sum(applied) != 1 or state.opt_state.count != 1 or torch.equal(
            params["decoder.cls.predictions.bias"], w0):
        raise AssertionError(f"train: {sum(applied)} updates applied (expected exactly 1)")
    med = sorted(steps_ms)[len(steps_ms) // 2]
    accumulate = sorted(u for u, a in zip(update_ms, applied) if not a)
    breakdown = train_breakdown(torch, net, batch, tok.pad_token_id)
    res = {"phase": "train", "variant": "multi", "dtype": "bf16 (fp32 masters)",
           "studies": len(TRAIN_IMAGES), "image_slots": SLOTS,
           "images_per_study": list(TRAIN_IMAGES),
           "report_tokens": int(batch["decoder_attention_mask"].sum(1).max()),
           "micro_steps_timed": TRAIN_ACCUM, "ms_per_micro_step_median": med,
           "ms_per_micro_step": steps_ms,
           "trained_studies_per_s": len(TRAIN_IMAGES) / (med / 1e3),
           "update_applied_at_timed_micro_step": applied.index(True),
           "update_ms": update_ms[applied.index(True)],
           "accumulate_ms_median": accumulate[len(accumulate) // 2],
           "losses": losses, "peak_memory_gb": peak / 1e9,
           "launches_per_micro_step": {k: v for k, v in want.items() if v},
           "launches": {k: v for k, v in launches.items() if v}, **breakdown}
    emit(res)
    del model, net, state
    torch.cuda.empty_cache()
    return res


def train_parity_phase(torch, np, ckpt):
    """One multi training micro-step with the kernels against the same
    micro-step with every kernel swapped for its plain version
    (plain_kernels(), flash_attention_grad included), from the same weights
    and statistics and with the same dropout draws: the loss, each
    parameter's gradient relative to its largest |g| (floored at a share of
    the largest gradient in the model: gradients that are zero in exact
    arithmetic, as a key bias's, sit at rounding level), the direction of
    the whole gradient, and the BatchNorm running statistics. fp32 (TF32
    off) within PARITY_TOL, bf16 (the training dtype) within
    BF16_PARITY_TOL."""
    from cxrmate_torch.models import api
    from cxrmate_torch.models.cvt import batch_stats
    from cxrmate_torch.train import tf_trainer as tt
    from cxrmate_torch.utils.precision import parity_mode

    out = {}
    for name, dtype, tol, floor in (("fp32", None, PARITY_TOL, 1e-6),
                                    ("bf16", torch.bfloat16, BF16_PARITY_TOL, 1e-3)):
        with parity_mode():
            model = api.CXRMate.from_hf_checkpoint(ckpt, variant="multi", dtype=torch.float32,
                                                   device="cuda")
            net, tok = model.model, model.tokenizer
            batch = train_batch(np, tok, model.config)
            start = {k: v.clone() for k, v in net.state_dict().items()}
            runs = []
            for plain in (False, True):
                net.load_state_dict(start)
                with plain_kernels() if plain else contextlib.nullcontext():
                    loss, grads = tt.loss_and_grads(net, batch, tt.train_generator(0, 0),
                                                    pad_id=tok.pad_token_id, compute_dtype=dtype)
                runs.append((float(loss), grads,
                             {k: v.clone() for k, v in batch_stats(net.encoder).items()}))
            torch.cuda.synchronize()
        (lk, gk, sk), (lp, gp, sp) = runs
        big = max(float(g.abs().max()) for g in gp.values())
        rel = sorted(((_err(gk[n], gp[n]) / max(float(gp[n].abs().max()), floor * big), n)
                      for n in gp), reverse=True)
        flat_k = torch.cat([g.flatten() for g in gk.values()])
        flat_p = torch.cat([g.flatten() for g in gp.values()])
        res = {"loss": lk, "loss_plain": lp, "loss_abs_err": abs(lk - lp),
               "grad_max_rel_err": rel[0][0], "grad_worst": rel[:3],
               "grad_median_rel_err": rel[len(rel) // 2][0],
               "grad_cosine": float(torch.nn.functional.cosine_similarity(flat_k, flat_p, dim=0)),
               "batch_stats_max_abs_err": max(_err(sk[n], sp[n]) for n in sp),
               "finite": bool(np.isfinite(lk) and torch.isfinite(flat_k).all()),
               "tolerance": tol, "grad_floor_share_of_largest": floor}
        emit({"phase": "parity", "dtype": name, "variant": "multi", "path": "train", **res})
        if not (res["finite"] and res["loss_abs_err"] <= tol * abs(lp)
                and res["grad_max_rel_err"] <= tol and res["batch_stats_max_abs_err"] <= tol):
            raise AssertionError(f"{name} train micro-step: kernel path disagrees with the plain "
                                 f"path: {res}")
        out[name] = res
        del model, net, runs, start, flat_k, flat_p
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------- SCST
def random_encoder(torch, seed, prefix, vocab, positions, types, layers, d, ff):
    """A seeded random BERT-style encoder's state dict on the card under HF's
    names behind ``prefix``: weights and biases N(0, 0.02), norm scales 1 +
    N(0, 0.02). -> (the state dict, the draw of further tensors from the
    same generator)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def w(*shape):
        return torch.randn(*shape, generator=g, device="cuda") * 0.02

    def lin(key, fan_out, fan_in):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = w(fan_out, fan_in), w(fan_out)

    def ln(key):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = 1.0 + w(d), w(d)

    sd = {f"{prefix}embeddings.word_embeddings.weight": w(vocab, d),
          f"{prefix}embeddings.position_embeddings.weight": w(positions, d),
          f"{prefix}embeddings.token_type_embeddings.weight": w(types, d)}
    ln(f"{prefix}embeddings.LayerNorm")
    for layer in range(layers):
        p = f"{prefix}encoder.layer.{layer}"
        for name in ("query", "key", "value"):
            lin(f"{p}.attention.self.{name}", d, d)
        lin(f"{p}.attention.output.dense", d, d)
        ln(f"{p}.attention.output.LayerNorm")
        lin(f"{p}.intermediate.dense", ff, d)
        lin(f"{p}.output.dense", d, ff)
        ln(f"{p}.output.LayerNorm")
    return sd, w


def cxrbert_reward(torch, tok, texts, device="cuda"):
    """A random CXR-BERT at the published widths (CXRBERT_*), seeded, in HF
    layout, and its vocab.txt: the five specials, the words of ``texts`` and
    of every ordinary token of the repository tokenizer, then [unused]
    filler up to the vocabulary size. -> (CXRBERTReward on ``device``, the
    state dict, its config)."""
    from cxrmate_torch.reward.cxrbert import (CXRBERTReward, cxrbert_config_from_state_dict,
                                              load_cxrbert)
    from cxrmate_torch.tokenizer import WordPieceTokenizer

    special = {tok.vocab[t] for t in tok.all_special_tokens}
    basic = WordPieceTokenizer({"[UNK]": 0})._split_basic
    pieces = list(texts) + [tok.decode([i]) for i in range(len(tok)) if i not in special]
    words = sorted({w for text in pieces for w in basic(text)} - set(CXRBERT_SPECIALS))
    words = list(CXRBERT_SPECIALS) + words[:CXRBERT_VOCAB - len(CXRBERT_SPECIALS)]
    words += [f"[unused{i}]" for i in range(CXRBERT_VOCAB - len(words))]
    os.makedirs(SMOKE_DIR, exist_ok=True)
    vocab = os.path.join(SMOKE_DIR, "cxrbert-vocab.txt")
    with open(vocab, "w", encoding="utf-8") as f:
        f.write("\n".join(words) + "\n")
    sd, w = random_encoder(torch, SEED + 50, "bert.", CXRBERT_VOCAB, CXRBERT_POSITIONS, 2,
                           CXRBERT_LAYERS, D_MODEL, D_FF)
    sd["cls_projection_head.weight"] = w(CXRBERT_PROJECTION, D_MODEL)
    config = cxrbert_config_from_state_dict(sd, {"num_attention_heads": HEADS})
    model = load_cxrbert(sd, config, device=device)
    return CXRBERTReward(model, WordPieceTokenizer.from_file(vocab)), sd, config


def scst_configs(tok, max_new):
    """The sample and baseline GenerationConfigs of cli/stages.py:fit_scst."""
    from cxrmate_torch.generate.decode import GenerationConfig

    common = dict(max_new_tokens=max_new, bos_token_id=tok.bos_token_id,
                  eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
                  mask_token_id=tok.pad_token_id, token_type_sections=(0, 1, 0, 1))
    return (GenerationConfig(special_token_ids=(tok.bos_token_id, tok.sep_token_id),
                             do_sample=True, top_k=50, top_p=1.0, temperature=1.0, **common),
            GenerationConfig(special_token_ids=(tok.vocab["[PMT-SEP]"], tok.bos_token_id,
                                                tok.sep_token_id), **common))


def scst_inputs(np, model, studies):
    """``studies`` studies of make_pixels, their previous reports (make_prompts,
    the longest SCST_LONGEST tokens) tokenised with BOS and bucketed to 32 as
    generate_report buckets them, and synthetic current reports (the labels)
    -> (pixels, prompt ids, prompt mask, first-token column, findings,
    impression)."""
    from cxrmate_torch.models import encoder_decoder as ed

    tok = model.tokenizer
    prev = make_prompts(np, tok, SCST_LONGEST, SEED + 40)
    prompt = model.tokenize_prompt(prev[0][:studies], prev[1][:studies], add_bos_token_id=True)
    ids, mask = ed.bucket_prompt(prompt["input_ids"], prompt["attention_mask"], tok.pad_token_id,
                                 bucket=32, max_len=model.config.prompt_max_len)
    if ids.shape[1] != SCST_BUCKET:  # the kernels phase checked this bucket's shapes
        raise AssertionError(f"scst: prompt bucket {ids.shape[1]}, expected {SCST_BUCKET}")
    rs = np.random.RandomState(SEED + 41)
    findings = [synthetic_section(tok, rs, 60) for _ in range(studies)]
    impression = [synthetic_section(tok, rs, 20) for _ in range(studies)]
    return (make_pixels(np)[:studies], ids.astype(np.int32), mask.astype(np.int32),
            prompt["input_ids"].shape[1] - 1, findings, impression)


def scst_phase(torch, np, ckpt):
    """SCST of the longitudinal model at full width through the entry points
    cli.stages.fit_scst calls: mask_for_stage("scst") -> adamw ->
    create_train_state -> make_scst_step(bf16) -> SCSTTrainer(...).step with
    the CXR-BERT reward, at each of SCST_BATCHES studies: one untimed step,
    then SCST_RUNS timed ones, each split into encode, the rollout's decode,
    the reward (tokenisation and two BERT forwards, twice) and the grad step
    (forward, backward, and apart from it the AdamW update); every step's
    launch counts checked (flash_attention once per CvT layer, decode_attention
    twice per decoder layer and decode step, no other kernel). The untimed
    step also checks each sampled token against its step's warped logits (top
    50), and the encoder's parameters and BatchNorm statistics must be
    bit-unchanged after the steps. -> {"scst-b1": launches, "scst-b8": ...}
    of the timed steps."""
    from cxrmate_torch.generate import decode as decode_mod
    from cxrmate_torch.generate.logits_process import NEG as WARP_NEG
    from cxrmate_torch.models import api
    from cxrmate_torch.models import bert as bert_mod
    from cxrmate_torch.models import encoder_decoder as ed
    from cxrmate_torch.train import optim, scst
    from cxrmate_torch.train import tf_trainer as tt

    model = api.CXRMate.from_hf_checkpoint(ckpt, variant="longitudinal", dtype=torch.float32,
                                           device="cuda")
    net, config, tok = model.model, model.config, model.tokenizer
    layers, depth = config.decoder.num_hidden_layers, sum(config.encoder.depth)
    texts = scst_inputs(np, model, STUDIES)[4:]
    reward = cxrbert_reward(torch, tok, texts[0] + texts[1])[0]
    params = dict(net.named_parameters())
    mask = optim.mask_for_stage(params, "scst")
    tx = optim.adamw(SCST_LR, accumulate_steps=1, trainable_mask=mask)
    state = tt.create_train_state(net, tx)
    rollout, grad_step = scst.make_scst_step(config, *scst_configs(tok, config.decoder_max_len - 1),
                                             tx, mask, pad_id=tok.pad_token_id,
                                             compute_dtype=torch.bfloat16)

    def split_fn(ids):
        return ed.split_and_decode_sections(
            ids, [tok.bos_token_id, tok.sep_token_id, tok.eos_token_id], tok)

    trainer = scst.SCSTTrainer(config, rollout, grad_step, reward, split_fn)
    encoder_before = {k: v.clone() for k, v in net.state_dict().items()
                      if k.startswith("encoder.")}
    wrappers = all_wrappers()
    counts, updates = {}, 0

    def step(inputs, gen, kept=None):
        px, ids, pmask, col, findings, impression = inputs
        rec = Recorder()
        rec.wrap(bert_mod, "bert_step")
        rec.wrap(ed, "encode_images", timed=True)
        rec.wrap(trainer, "rollout", keep=True, timed=True)
        rec.wrap(trainer, "reward_fn", timed=True)
        rec.wrap(trainer, "grad_step", timed=True)
        rec.wrap(tx, "update", timed=True)
        warp, rewarped = decode_mod.warp_logits, []
        if kept is not None:  # the untimed step: keep the sample half's warped logits
            decode_mod.warp_logits = lambda *a: kept.append(warp(*a)) or kept[-1]
        scst.warp_logits = lambda *a: rewarped.append(warp(*a)) or rewarped[-1]
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            _, logs, _ = trainer.step(state, px, ids, pmask, findings, impression, gen,
                                      prompt_logits_col=col)
        finally:
            rec.restore()
            decode_mod.warp_logits = scst.warp_logits = warp
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        steps = rec.calls["bert_step"]
        launches = {k: fn.launches for k, fn in wrappers.items()}
        want = dict.fromkeys(wrappers, 0)
        want.update(flash_attention=depth, decode_attention=2 * layers * steps)
        if launches != want or not np.isfinite(list(logs.values())).all():
            raise AssertionError(f"scst step: launches {launches}, expected {want}; logs {logs}")
        ms = {k: v * 1e3 for k, v in rec.seconds.items()}
        # sampled tokens (before EOS) that the re-forward's own top-k would
        # mask, where bf16 rounding ranks them just outside it (the grad step
        # keeps them; JAX's loss is infinite there)
        drawn = rec.outputs["rollout"][0][:, ids.shape[1]:].long()
        masked = rewarped[0].gather(-1, drawn[..., None])[..., 0] == WARP_NEG
        outside = int((masked & (drawn != tok.pad_token_id)).sum())
        return {"step_ms": secs * 1e3, "encode_ms": ms["encode_images"],
                "rollout_ms": ms["rollout"],
                "decode_ms": ms["rollout"] - ms["encode_images"], "decode_steps": steps,
                "decode_ms_per_step": (ms["rollout"] - ms["encode_images"]) / steps,
                "reward_ms": ms["reward_fn"], "grad_step_ms": ms["grad_step"] - ms["update"],
                "update_ms": ms["update"], "logs": logs, "launches": launches,
                "sampled_outside_rewarp_top50": outside,
                "sampled": rec.outputs["rollout"][0], "p_len": ids.shape[1]}

    for b in SCST_BATCHES:
        inputs = scst_inputs(np, model, b)
        kept = []
        warm = step(inputs, torch.Generator(device="cuda").manual_seed(SEED + 42), kept)
        sampled = warm["sampled"][:, warm["p_len"]:].long()
        finished = torch.zeros(b, dtype=torch.bool, device="cuda")
        for k, logits in enumerate(kept[:sampled.shape[1]]):
            keep = logits > WARP_NEG
            inside = keep.gather(1, sampled[:, k:k + 1])[:, 0]
            if not ((inside | finished).all() and (keep.sum(1) >= 50).all()):
                raise AssertionError(f"scst b{b}: a sampled token at step {k} lies outside the "
                                     "top 50 of its warped logits")
            finished |= sampled[:, k] == tok.eos_token_id
        torch.cuda.reset_peak_memory_stats()
        runs = [step(inputs, torch.Generator(device="cuda").manual_seed(SEED + 43 + i))
                for i in range(SCST_RUNS)]
        peak = torch.cuda.max_memory_allocated()
        updates += SCST_RUNS + 1
        med = sorted(runs, key=lambda r: r["step_ms"])[SCST_RUNS // 2]
        counts[f"scst-b{b}"] = {k: sum(r["launches"][k] for r in runs) for k in wrappers}
        emit({"phase": "scst", "variant": "longitudinal", "mbatch_size": b,
              "dtype": "bf16 (fp32 masters)", "lr": SCST_LR, "accumulate_steps": 1,
              "image_slots": SLOTS, "prompt_width": warm["p_len"], "new_tokens": NEW_TOKENS,
              "runs": SCST_RUNS, "reported": "median step",
              **{k: v for k, v in med.items() if k not in ("sampled", "p_len")},
              "studies_per_s": b / (med["step_ms"] / 1e3),
              "runs_step_ms": [r["step_ms"] for r in runs],
              "runs_decode_ms_per_step": [r["decode_ms_per_step"] for r in runs],
              "runs_sampled_outside_rewarp_top50": [r["sampled_outside_rewarp_top50"]
                                                    for r in runs],
              "peak_memory_gb": peak / 1e9,
              "launches_per_step": {k: v for k, v in med["launches"].items() if v},
              "sampled_inside_top50_steps": len(kept)})
    after = net.state_dict()
    changed = [k for k, v in encoder_before.items() if not torch.equal(after[k], v)]
    if changed or state.opt_state.count != updates or state.step != updates:
        raise AssertionError(f"scst: encoder tensors changed {changed[:4]}; "
                             f"{state.opt_state.count} updates, expected {updates}")
    del model, net, state, reward, trainer
    torch.cuda.empty_cache()
    return counts


def scst_teacher_fed(torch, net, cfgs, px, ids, col, feed):
    """Encoder states and the rollout's logits over both halves (rows [0, B)
    with the sample config's token types, [B, 2B) with the baseline's): the
    prefill's at ``col``, then bert_step fed ``feed`` [2B, P + steps] column by
    column, as scst_rollout_decode runs them."""
    from cxrmate_torch.generate import decode as decode_mod
    from cxrmate_torch.models import bert as bert_mod
    from cxrmate_torch.models import encoder_decoder as ed

    b, p_len = ids.shape
    hidden, mask = ed.encode_images(net, px)
    hidden2, mask2 = torch.cat([hidden, hidden]), torch.cat([mask, mask])
    halves = [(slice(0, b), cfgs[0]), (slice(b, 2 * b), cfgs[1])]
    types = torch.cat([ed.token_ids_to_token_type_ids(feed[r, :p_len], c.special_token_ids,
                                                      c.sections()) for r, c in halves])
    t_total = feed.shape[1]
    logits0, cache, _ = decode_mod.prefill(net, cfgs[0], hidden2, mask2, feed[:, :p_len],
                                           t_total, types)
    cols = torch.arange(t_total, device="cuda")
    out = [logits0[:, col]]
    for i in range(p_len, t_total - 1):
        key_mask = ((feed != cfgs[0].mask_token_id) & (cols <= i)).int()
        pos = (key_mask.sum(1) - 1).clamp(min=0)
        ttype = torch.cat([decode_mod._type_from_present(
            decode_mod._specials_present(feed[r, :i], c), c) for r, c in halves])
        logits, cache = bert_mod.bert_step(net.decoder, cache, feed[:, i], ttype, pos, i,
                                           key_mask, mask2, decode_kernel="")
        out.append(logits)
    return hidden, torch.stack(out, 1)


def scst_parity_phase(torch, np, ckpt):
    """The SCST step on the card, kernels against plain versions
    (plain_kernels()), 2 studies: the rollout's logits over both halves fed
    the kernel path's own rollout of 16 tokens (scst_teacher_fed), fp32 (TF32
    off) within PARITY_TOL and bf16 within BF16_PARITY_TOL; one fp32 grad
    step on those sampled ids and fixed advantages from the encoder states of
    each path: the loss and each decoder gradient within PARITY_TOL of the
    tensor's largest (floored at 1e-6 of the largest gradient in the model:
    gradients that are zero in exact arithmetic sit at rounding level); and
    the CXR-BERT reward on fixed strings, card against CPU, within 1e-5."""
    from cxrmate_torch.generate.decode import scst_rollout_decode
    from cxrmate_torch.models import api
    from cxrmate_torch.models import encoder_decoder as ed
    from cxrmate_torch.reward.cxrbert import CXRBERTReward, load_cxrbert
    from cxrmate_torch.train import optim, scst
    from cxrmate_torch.train import tf_trainer as tt
    from cxrmate_torch.utils.precision import parity_mode

    n, steps, advantage = 2, 16, np.array([0.5, -0.25], np.float32)
    out = {}
    for name, dtype, tol in (("fp32", torch.float32, PARITY_TOL),
                             ("bf16", torch.bfloat16, BF16_PARITY_TOL)):
        with parity_mode():
            model = api.CXRMate.from_hf_checkpoint(ckpt, variant="longitudinal", dtype=dtype,
                                                   device="cuda")
            net, tok = model.model, model.tokenizer
            cfgs = scst_configs(tok, steps)
            px, ids, _, col, _, _ = scst_inputs(np, model, n)
            px = torch.from_numpy(px).to("cuda", dtype)
            ids = torch.from_numpy(ids).cuda()
            with torch.no_grad():
                hidden, enc_mask = ed.encode_images(net, px)
                sampled, base = scst_rollout_decode(
                    net, *cfgs, hidden, enc_mask, ids, None,
                    torch.Generator(device="cuda").manual_seed(SEED + 44), prompt_logits_col=col,
                    decode_kernel="")
                feed = torch.cat([sampled, base])
                h_k, l_k = scst_teacher_fed(torch, net, cfgs, px, ids, col, feed)
                with plain_kernels():
                    h_p, l_p = scst_teacher_fed(torch, net, cfgs, px, ids, col, feed)
            res = {"encoder_max_abs_err": _err(h_k, h_p),
                   "rollout_logits_max_abs_err": _err(l_k, l_p),
                   "steps": l_k.shape[1], "rows": feed.shape[0],
                   "finite": bool(torch.isfinite(l_k.float()).all()), "tolerance": tol}
            if name == "fp32":
                start = {k: v.clone() for k, v in net.state_dict().items()}
                mask = optim.mask_for_stage(dict(net.named_parameters()), "scst")
                grads = []
                for plain in (False, True):
                    net.load_state_dict(start)
                    tx = optim.adamw(SCST_LR, trainable_mask=mask)
                    seen = {}
                    update = tx.update
                    tx.update = lambda g, *a: seen.update(g) or update(g, *a)
                    rollout, grad_step = scst.make_scst_step(
                        model.config, *cfgs, tx, mask, pad_id=tok.pad_token_id)
                    with plain_kernels() if plain else contextlib.nullcontext():
                        _, _, hidden, enc_mask = rollout(
                            net, px, ids, None, torch.Generator(device="cuda").manual_seed(0), col)
                        _, loss = grad_step(tt.create_train_state(net, tx), hidden, enc_mask,
                                            ids.shape[1], col, sampled, advantage)
                    grads.append((float(loss), {k: v.clone() for k, v in seen.items()}))
                (lk, gk), (lp, gp) = grads
                big = max(float(g.abs().max()) for g in gp.values())
                rel = sorted(((_err(gk[k], gp[k]) / max(float(gp[k].abs().max()), 1e-6 * big), k)
                              for k in gp), reverse=True)
                res.update(grad_step_loss=lk, grad_step_loss_plain=lp,
                           grad_step_loss_rel_err=abs(lk - lp) / abs(lp),
                           grad_max_rel_err=rel[0][0], grad_worst=rel[:3],
                           grad_median_rel_err=rel[len(rel) // 2][0], grad_tensors=len(gp))
                del start, grads, gk, gp
            torch.cuda.synchronize()
        emit({"phase": "parity", "dtype": name, "variant": "longitudinal", "path": "scst", **res})
        held = [res["encoder_max_abs_err"], res["rollout_logits_max_abs_err"]]
        if name == "fp32":
            held += [res["grad_step_loss_rel_err"], res["grad_max_rel_err"]]
        if not (res["finite"] and max(held) <= tol):
            raise AssertionError(f"{name} scst: kernel path disagrees with the plain path: {res}")
        out[name] = res
        del model, net
        torch.cuda.empty_cache()
    reward, sd, config = cxrbert_reward(torch, tok, [])
    preds = ["the heart size is normal .", "", " ".join(["stable effusion"] * 300)]
    labels = [["no acute process ."], ["the lungs are clear ."], ["small left effusion ."]]
    with parity_mode():
        on_card = reward(preds, labels)
    on_cpu = CXRBERTReward(load_cxrbert(sd, config, device="cpu"), reward.tokenizer)(preds, labels)
    err = float(np.abs(on_card - on_cpu).max())
    emit({"phase": "parity", "dtype": "fp32", "path": "cxrbert_reward",
          "card_vs_cpu_max_abs_err": err, "rewards": on_card.tolist(), "tolerance": 1e-5})
    if not err <= 1e-5:
        raise AssertionError(f"cxrbert reward: card and CPU differ by {err}")
    return out


# ----------------------------------------------------------------- checkpoints
def ckpt_dir_mb(path) -> float:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files) / 2**20


def checkpoint_phase(torch, np, ckpt):
    """Save, select and resume training checkpoints (ckpt/checkpoints.py) on
    the multi model of the train phase, bf16 on fp32 masters, dropout on, the
    train phase's batch: CKPT_STEPS micro-steps straight through; then
    CKPT_SAVE_AT micro-steps, save_checkpoint mid-accumulation, a train state
    built anew from the HF directory, restore_checkpoint into it and the rest,
    each micro-step's dropout from train_generator(0, micro-step). After the
    last micro-step every master, BatchNorm buffer, moment and accumulated
    gradient must be bit-equal between the two runs (cuDNN held to its
    deterministic algorithms for both). Then three epoch-end saves with
    CKPT_MONITORS under keep_top_k 1: get_test_ckpt_path picks the best, the
    others are pruned, last/ holds the latest. Every micro-step's launch
    counts checked (each flash_attention_grad kernel once per CvT layer).
    -> the launches and the directory the score phase restores from."""
    from cxrmate_torch.ckpt import checkpoints as ck
    from cxrmate_torch.models import api
    from cxrmate_torch.train import optim
    from cxrmate_torch.train import tf_trainer as tt

    wrappers = all_wrappers()
    launches = dict.fromkeys(wrappers, 0)
    batch = None

    def fresh():
        model = api.CXRMate.from_hf_checkpoint(ckpt, variant="multi", dtype=torch.float32,
                                               device="cuda")
        net, config, tok = model.model, model.config, model.tokenizer
        mask = optim.mask_for_stage(dict(net.named_parameters()), "multi")
        tx = optim.adamw(TRAIN_LR, accumulate_steps=CKPT_ACCUM, trainable_mask=mask)
        step = tt.make_train_step(config, tx, mask, pad_id=tok.pad_token_id,
                                  compute_dtype=torch.bfloat16)
        return tt.create_train_state(net, tx), step, model

    def run(state, step, micro_steps):
        want = dict.fromkeys(wrappers, 0)
        want.update(dict.fromkeys(FLASH_GRAD, sum(state.model.config.encoder.depth)))
        for i in micro_steps:
            for fn in wrappers.values():
                fn.launches = 0
            state, loss = step(state, batch, tt.train_generator(0, i))
            counts = {k: fn.launches for k, fn in wrappers.items()}
            if counts != want or not np.isfinite(float(loss)):
                raise AssertionError(f"checkpoint micro-step {i}: launches {counts}, expected "
                                     f"{want}; loss {float(loss)}")
            for k, v in counts.items():
                launches[k] += v
        return state

    def timed(fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        straight, step, model = fresh()
        batch = train_batch(np, model.tokenizer, model.config)
        straight = run(straight, step, range(CKPT_STEPS))
        state, step, _ = fresh()
        state = run(state, step, range(CKPT_SAVE_AT))
        opt = state.opt_state
        if not (opt.count == 1 and opt.mini_step == CKPT_SAVE_AT % CKPT_ACCUM and opt.acc):
            raise AssertionError(f"checkpoint: saved at count {opt.count}, mini_step "
                                 f"{opt.mini_step}: not mid-accumulation")
        trial = os.path.join(SMOKE_DIR, "resume", "trial_0")
        path, save_ms = timed(ck.save_checkpoint, trial, state, 0, step=CKPT_SAVE_AT,
                              n_batches=CKPT_SAVE_AT, global_step=CKPT_SAVE_AT,
                              mbatch_size=len(TRAIN_IMAGES), world_size=1)
        mb = ckpt_dir_mb(path)
        del state, step, opt
        torch.cuda.empty_cache()
        resumed, step, _ = fresh()
        resumed, restore_ms = timed(ck.restore_checkpoint, path, resumed)
        info = ck.checkpoint_resume_info(path)
        last = os.path.join(trial, "checkpoints", "last")
        if info["global_step"] != CKPT_SAVE_AT or resumed.step != CKPT_SAVE_AT or \
                ck.resolve_resume(trial, resume_last=True) != last:
            raise AssertionError(f"checkpoint: resume info {info}, step {resumed.step}")
        resumed = run(resumed, step, range(CKPT_SAVE_AT, CKPT_STEPS))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    differ, compared = [], 0
    pairs = list(zip(straight.model.state_dict().items(), resumed.model.state_dict().items()))
    for name in ("mu", "nu", "acc"):
        a, b = getattr(straight.opt_state, name), getattr(resumed.opt_state, name)
        pairs += [((f"{name}:{k}", a[k]), (f"{name}:{k}", b[k])) for k in a]
    for (ka, a), (kb, b) in pairs:
        compared += 1
        if ka != kb or not torch.equal(a, b):
            differ.append(ka)
    counters = [(s.step, s.opt_state.count, s.opt_state.mini_step) for s in (straight, resumed)]
    if differ or counters[0] != counters[1] or counters[0] != (CKPT_STEPS, 2, 0):
        raise AssertionError(f"checkpoint: the resumed run differs from the straight run in "
                             f"{len(differ)} of {compared} tensors ({differ[:6]}); "
                             f"step, count, mini_step {counters}")
    shutil.rmtree(os.path.dirname(trial))
    selection = os.path.join(SMOKE_DIR, "selection", "trial_0")
    select_ms = []
    for epoch, value in enumerate(CKPT_MONITORS):
        select_ms.append(timed(ck.save_checkpoint, selection, resumed, epoch,
                               monitor_value=value, monitor=CKPT_MONITOR, keep_top_k=1)[1])
    best = int(np.argmax(CKPT_MONITORS))
    best_tag = f"epoch={best}-{CKPT_MONITOR}={CKPT_MONITORS[best]:.6f}"
    picked = ck.get_test_ckpt_path(selection)
    left = sorted(os.listdir(os.path.join(selection, "checkpoints")))
    last = os.path.join(selection, "checkpoints", "last")
    if picked != os.path.join(selection, "checkpoints", best_tag) or left != sorted(
            [best_tag, "index.json", "last"]) or ck.last_checkpoint_epoch(selection) != \
            len(CKPT_MONITORS) - 1 or not os.path.exists(os.path.join(last, ck.STATE_FILE)):
        raise AssertionError(f"checkpoint selection: picked {picked}, left {left}")
    res = {"phase": "checkpoint", "variant": "multi", "dtype": "bf16 (fp32 masters)",
           "studies": len(TRAIN_IMAGES), "image_slots": SLOTS, "accumulate_steps": CKPT_ACCUM,
           "micro_steps": CKPT_STEPS, "saved_after_micro_step": CKPT_SAVE_AT,
           "bit_equal_after_resume": True, "tensors_compared": compared,
           "save_ms": save_ms, "restore_ms": restore_ms, "mb_on_disk": mb,
           "selection_save_ms": select_ms, "monitor_values": list(CKPT_MONITORS),
           "test_ckpt": os.path.basename(picked), "left_after_top1": left,
           "launches_per_micro_step": {k: sum(straight.model.config.encoder.depth)
                                       for k in FLASH_GRAD},
           "launches": {k: v for k, v in launches.items() if v}}
    emit(res)
    del straight, resumed, model, step
    torch.cuda.empty_cache()
    return {"launches": launches, "exp_dir": selection}


# ----------------------------------------------------------------------- score
def chexbert_state_dict(torch):
    """A random CheXbert at the published widths (BERT-base, the CXR-BERT
    vocabulary's 30,522 rows, 512 positions) under the Stanford checkpoint's
    names: module.bert.* and module.linear_heads.{0..13}."""
    from cxrmate_torch.eval.chexbert import HEAD_CLASSES

    sd, w = random_encoder(torch, SEED + 60, "module.bert.", CXRBERT_VOCAB, CXRBERT_POSITIONS, 2,
                           CXRBERT_LAYERS, D_MODEL, D_FF)
    for i, n in enumerate(HEAD_CLASSES):
        sd[f"module.linear_heads.{i}.weight"] = w(n, D_MODEL)
        sd[f"module.linear_heads.{i}.bias"] = w(n)
    return sd


def roberta_files(tok) -> str:
    """A roberta-large-style directory for RobertaBPETokenizer: vocab.json
    (<s> <pad> </s> <unk>, the repository tokenizer's tokens, <mask>; the
    embedding table keeps the published row count), its merges.txt, and
    the synthetic baseline file. -> the directory."""
    path = os.path.join(SMOKE_DIR, "roberta")
    os.makedirs(path, exist_ok=True)
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for t, _ in sorted(tok.vocab.items(), key=lambda kv: kv[1]):
        vocab.setdefault(t, len(vocab))
    vocab["<mask>"] = len(vocab)
    if len(vocab) > ROBERTA_VOCAB:
        raise AssertionError(f"roberta vocabulary of {len(vocab)}")
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in tok.merges))
    with open(os.path.join(path, "roberta-large.tsv"), "w") as f:
        f.write(ROBERTA_BASELINE)
    return path


def score_reports(np, tok, decoded):
    """SCORE_STUDIES studies: the decoded batch's reports, then synthetic ones
    (synthetic_section, about 60 findings and 20 impression tokens); labels
    synthetic alike; distinct study ids."""
    rs = np.random.RandomState(SEED + 80)
    extra = SCORE_STUDIES - len(decoded["findings"])
    reports = {"findings": decoded["findings"] + [synthetic_section(tok, rs, 60)
                                                  for _ in range(extra)],
               "impression": decoded["impression"] + [synthetic_section(tok, rs, 20)
                                                      for _ in range(extra)],
               "label_findings": [synthetic_section(tok, rs, 60) for _ in range(SCORE_STUDIES)],
               "label_impression": [synthetic_section(tok, rs, 20)
                                    for _ in range(SCORE_STUDIES)],
               "study_ids": [50_000_000 + i for i in range(SCORE_STUDIES)]}
    return reports


def make_score_metrics(exp_dir, families, scorers, mbatch):
    """The accumulators of cli/stages.py:make_metrics(split="test") for both
    sections: COCONLGMetrics (bleu, cider, rouge, meteor with the default
    synonym module), CheXbertMetrics, CXRBERTMetric and BERTScoreMetric;
    only those of ``families``."""
    from cxrmate_torch.eval import bertscore as bs
    from cxrmate_torch.eval import metrics as em

    out = {}
    for section in SCORE_SECTIONS:
        split = f"test_{section}"
        if "nlg" in families:
            out[f"{split}_nlg"] = em.COCONLGMetrics(
                split, exp_dir, False, metrics=("bleu", "cider", "rouge", "meteor"),
                meteor_synonyms=scorers["synonyms"])
        if "chexbert" in families:
            out[f"{split}_chexbert"] = em.CheXbertMetrics(split, exp_dir, False,
                                                          scorers["chexbert"], mbatch)
        if "cxr-bert" in families:
            out[f"{split}_cxr-bert"] = em.CXRBERTMetric(split, exp_dir, False,
                                                        scorers["cxr-bert"], mbatch)
        if "bertscore" in families:
            out[f"{split}_bertscore"] = bs.BERTScoreMetric(split, exp_dir, False,
                                                           scorers["bertscore"], mbatch)
    return out


def score_run(torch, exp_dir, families, scorers, mbatch, reports):
    """Feed the accumulators as cli/stages.py:evaluate does (labels as
    one-item lists, STUDIES studies an update), then compute() each:
    -> ({family: ms over both sections}, {metric_key: score})."""
    metrics = make_score_metrics(exp_dir, families, scorers, mbatch)
    ids = reports["study_ids"]
    for start in range(0, SCORE_STUDIES, STUDIES):
        part = slice(start, start + STUDIES)
        for name, metric in metrics.items():
            section = "findings" if "findings" in name else "impression"
            metric.update(reports[section][part],
                          [[j] for j in reports[f"label_{section}"][part]], study_ids=ids[part])
    ms, scores = dict.fromkeys(families, 0.0), {}
    for name, metric in metrics.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = metric.compute(0)
        torch.cuda.synchronize()
        ms[name.rsplit("_", 1)[1]] += (time.perf_counter() - t0) * 1e3
        scores.update({f"{name}_{k}": v for k, v in out.items()})
    return ms, scores


def csv_texts(exp_dir, subdir):
    folder = os.path.join(exp_dir, subdir)
    return sorted(open(os.path.join(folder, f)).read() for f in os.listdir(folder))


def score_parity(torch, np, scorers, sds, reports):
    """fp32 (TF32 off): the scorers on the card against the same scorers on
    the CPU, on SCORE_PARITY decoded findings and SCORE_PARITY synthetic ones
    against their labels."""
    from cxrmate_torch.eval import bertscore as bs
    from cxrmate_torch.eval import chexbert as cx
    from cxrmate_torch.reward.cxrbert import CXRBERTReward, load_cxrbert
    from cxrmate_torch.utils.precision import parity_mode

    rows = list(range(SCORE_PARITY)) + list(range(STUDIES, STUDIES + SCORE_PARITY))
    preds = [reports["findings"][i] for i in rows]
    labels = [reports["label_findings"][i] for i in rows]
    chex_card, wp = scorers["chexbert_model"], scorers["cxr-bert"].tokenizer
    tok = wp([cx.normalize_report(r) for r in preds + labels], padding="longest",
             truncation=True, max_length=512)

    def logits(model, device):
        with torch.no_grad():
            return [l.float().cpu() for l in cx.chexbert_logits(
                model, torch.from_numpy(tok["input_ids"]).long().to(device),
                torch.from_numpy(tok["attention_mask"]).to(device))]

    def bertscore(scorer):
        return scorer.score(preds, labels)

    with parity_mode():
        card = (logits(chex_card, "cuda"), bertscore(scorers["bertscore"]),
                scorers["cxr-bert"](preds, [[l] for l in labels]))
        torch.cuda.synchronize()
    cpu_chex = cx.load_chexbert({k: v.cpu() for k, v in sds["chexbert"].items()}, device="cpu")
    rob = scorers["bertscore"]
    cpu_rob = bs.BERTScorer(bs.load_roberta({k: v.cpu() for k, v in sds["roberta"].items()},
                                            ROBERTA_HEADS, device="cpu"), rob.tokenizer,
                            num_layers=rob.num_layers, roberta_positions=True,
                            baseline=rob.baseline)
    cxr_sd, cxr_cfg = sds["cxr-bert"]
    cpu_cxr = CXRBERTReward(load_cxrbert({k: v.cpu() for k, v in cxr_sd.items()}, cxr_cfg,
                                         device="cpu"), wp)
    cpu = (logits(cpu_chex, "cpu"), bertscore(cpu_rob), cpu_cxr(preds, [[l] for l in labels]))
    big = max(float(l.abs().max()) for l in cpu[0])
    chex_err = max(_err(a, b) for a, b in zip(card[0], cpu[0]))
    ids_differ = 0
    for a, b in zip(card[0], cpu[0]):
        top2 = b.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-4
        ids_differ += int(((a.argmax(-1) != b.argmax(-1)) & clear).sum())
    # a text with no token to match besides <s> and </s> (an empty report)
    # scores about -1e9 against the other, as in the JAX package (the -1e9
    # mask of _greedy_match_f1): those rows are held relative to the value
    matchable = [rob.tokenizer(t)["attention_mask"].sum(1) > 2 for t in (preds, labels)]
    both = matchable[0] & matchable[1]
    bs_err = {k: float((np.abs(card[1][k] - cpu[1][k])
                        / np.where(both, 1.0, np.maximum(1.0, np.abs(cpu[1][k])))).max())
              for k in ("precision", "recall", "f1")}
    cxr_err = float(np.abs(card[2] - cpu[2]).max())
    res = {"chexbert_logits_max_abs_err": chex_err, "chexbert_largest_logit": big,
           "chexbert_ids_differ_where_clear": ids_differ,
           **{f"bertscore_{k}_max_err": v for k, v in bs_err.items()},
           "rows": len(rows), "bertscore_rows_without_a_token_to_match": int((~both).sum()),
           "bertscore_f1_card": card[1]["f1"].tolist(),
           "bertscore_recall_card": card[1]["recall"].tolist(),
           "cxr_bert_similarity_max_abs_err": cxr_err,
           "tolerance": {"chexbert": "1e-5 of the largest logit",
                         "bertscore": "1e-5; relative to the value on a row without a token "
                                      "to match", "cxr_bert": 1e-5}}
    if not (chex_err <= 1e-5 * big and ids_differ == 0 and max(bs_err.values()) <= 1e-5
            and cxr_err <= 1e-5):
        raise AssertionError(f"score: the card and the CPU disagree: {res}")
    return res


def score_phase(torch, np, ckpt, trial):
    """The test stage below the CLI (cli/stages.py:test) on the card: the
    checkpoint that get_test_ckpt_path picks under ``trial`` restored into a
    CXRMate (bf16), one beam-4 batch of 8 studies through generate_report
    (launch counts checked), then the scorers of make_metrics(split="test")
    over SCORE_STUDIES studies and both sections, fed as evaluate feeds them:
    NLG (on the host), CheXbert (random BERT-base and heads), CXR-BERT (the
    SCST phase's random reward model) and BERTScore (random roberta-large cut
    at layer 17, a synthetic baseline), all fp32. Each family's compute() ms
    over both sections, median of SCORE_RUNS after an untimed run, the model
    families at each of SCORE_MBATCH; no custom kernel launched inside
    compute(); the NLG scores and CSV files of two runs identical; the card
    against the CPU (score_parity). -> the decode's launch counts."""
    from cxrmate_torch.ckpt import checkpoints as ck
    from cxrmate_torch.eval import bertscore as bs
    from cxrmate_torch.eval import chexbert as cx
    from cxrmate_torch.eval.meteor import default_synonyms
    from cxrmate_torch.models import api

    path = ck.get_test_ckpt_path(trial)
    model = api.CXRMate.from_hf_checkpoint(ckpt, variant="multi", dtype=torch.bfloat16,
                                           device="cuda")
    bias = model.model.decoder.cls.predictions.bias.clone()
    t0 = time.perf_counter()
    ck.restore_model(path, model.model)
    restore_s = time.perf_counter() - t0
    if torch.equal(bias, model.model.decoder.cls.predictions.bias):
        raise AssertionError("score: the restored checkpoint left the weights as they were")
    decoded = {}
    fig = drive(model, make_pixels(np), "score", 4, sum(model.config.encoder.depth),
                model.config.decoder.num_hidden_layers, reports=decoded)
    tok = model.tokenizer
    del model
    torch.cuda.empty_cache()

    reports = score_reports(np, tok, decoded)
    texts = [t for k in ("findings", "impression", "label_findings", "label_impression")
             for t in reports[k]]
    reward, cxr_sd, cxr_cfg = cxrbert_reward(torch, tok, texts)
    chex_sd = chexbert_state_dict(torch)
    chex = cx.load_chexbert(chex_sd, device="cuda")
    rob_sd = random_encoder(torch, SEED + 70, "roberta.", ROBERTA_VOCAB, ROBERTA_POSITIONS, 1,
                            ROBERTA_LAYERS, ROBERTA_WIDTH, ROBERTA_FF)[0]
    rob_dir = roberta_files(tok)
    rob = bs.load_roberta(rob_sd, ROBERTA_HEADS, device="cuda")
    baseline = bs.load_rescale_baseline(os.path.join(rob_dir, "roberta-large.tsv"),
                                        ROBERTA_LAYER)
    synonyms = default_synonyms()
    scorers = {"synonyms": synonyms, "chexbert_model": chex,
               "chexbert": lambda texts: cx.chexbert_predict(chex, reward.tokenizer, texts),
               "cxr-bert": reward,
               "bertscore": bs.BERTScorer(rob, bs.RobertaBPETokenizer.from_dir(rob_dir),
                                          num_layers=ROBERTA_LAYER, roberta_positions=True,
                                          baseline=baseline)}
    wrappers = all_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timing, scores, nlg_runs = {}, {}, []
    plans = [("nlg", SCORE_MBATCH[0], ("nlg",))] + [
        (f"mbatch{m}", m, ("chexbert", "cxr-bert", "bertscore")) for m in SCORE_MBATCH]
    for label, mbatch, families in plans:
        runs = []
        for r in range(1 + SCORE_RUNS):
            exp = os.path.join(SMOKE_DIR, "score", f"{label}-run{r}")
            ms, out = score_run(torch, exp, families, scorers, mbatch, reports)
            runs.append(ms)
            scores.update(out)
            if label == "nlg" and r < 2:
                nlg_runs.append((out, csv_texts(exp, "nlg_scores")))
        for fam in families:
            timed = sorted(run[fam] for run in runs[1:])
            timing[f"{fam}_ms" if fam == "nlg" else f"{fam}_ms_mbatch{mbatch}"] = \
                timed[SCORE_RUNS // 2]
            timing[f"{fam}_runs_ms" if fam == "nlg" else f"{fam}_runs_ms_mbatch{mbatch}"] = timed
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    inside = {k: fn.launches for k, fn in wrappers.items()}
    if any(inside.values()):
        raise AssertionError(f"score: custom kernels launched inside compute(): {inside}")
    if nlg_runs[0] != nlg_runs[1] or len(nlg_runs[0][1]) != len(SCORE_SECTIONS):
        raise AssertionError("score: two NLG compute() runs differ")
    if not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"score: scores {scores}")
    parity = score_parity(torch, np, {**scorers}, {"chexbert": chex_sd, "roberta": rob_sd,
                                                   "cxr-bert": (cxr_sd, cxr_cfg)}, reports)
    emit({"phase": "score", "variant": "multi", "checkpoint": os.path.basename(path),
          "checkpoint_restore_s": restore_s, "decode": "beam-4, bf16",
          "decode_seconds": fig["seconds"], "decode_launches": fig["launches"],
          "decoded_words": {k: [len(t.split()) for t in decoded[k]] for k in SCORE_SECTIONS},
          "studies": SCORE_STUDIES, "decoded_studies": STUDIES, "sections": SCORE_SECTIONS,
          "dtype": "fp32", "mbatch_sizes": SCORE_MBATCH, "runs": SCORE_RUNS,
          "reported": "median of the timed runs, ms over both sections",
          "meteor_synonyms": type(synonyms).__name__,
          "bertscore_baseline": baseline, "roberta_layers_run": ROBERTA_LAYER,
          **timing, "peak_memory_gb": peak / 1e9,
          "launches_inside_compute": inside, "nlg_two_runs_identical": True,
          "scores": {k: v for k, v in scores.items() if k.endswith(
              ("bleu_4", "meteor", "rouge", "cider", "f1_macro", "similarity", "_f1"))},
          "parity_fp32": parity})
    del reward, chex, rob, scorers
    torch.cuda.empty_cache()
    return fig["launches"]


def check_jpeg_fixtures(np):
    """The port's decoder on the committed fixture JPEGs against the pixels
    PIL decoded from them (cxrmate_torch/tools/make_jpeg_fixtures.py), bit
    for bit, without PIL. -> the number of files."""
    import glob

    from cxrmate_torch.data import native

    jpgs = sorted(glob.glob(os.path.join(REPO, "cxrmate_torch", "tools", "jpeg_fixtures", "*.jpg")))
    if len(jpgs) < 6:
        raise AssertionError(f"data: {len(jpgs)} JPEG fixtures")
    for p in jpgs:
        want = np.load(p[:-4] + ".npy")
        got = native.load_jpeg(p)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"data: the decoder differs from PIL on {os.path.basename(p)}")
    return len(jpgs)


def write_data_tree(np, root, tok, splits=("test",) * DATA_SUBJECTS):
    """A MIMIC-CXR-JPG-layout tree under ``root``: one subject per entry of
    ``splits`` (its split), each with two studies a day apart, DATA_IMAGES
    images per study in turn, each a gray DATA_HW image (smooth structure: a
    random 13 x 11 field upscaled; plus noise from the seed) written by the
    port's encoder at quality 75, eight at a time; synthetic findings and
    impressions from the repository tokenizer; the merged CSV written by the
    port's table. -> (dataset_dir, the image root, the JPEG paths)."""
    from concurrent.futures import ThreadPoolExecutor

    from cxrmate_torch.data import native
    from cxrmate_torch.data.index import mimic_cxr_image_path
    from cxrmate_torch.data.table import Table

    dataset_dir = os.path.join(root, "datasets")
    files = os.path.join(dataset_dir, "physionet.org", "files", "mimic-cxr-jpg", "2.0.0", "files")
    rs = np.random.RandomState(SEED + 80)
    h, w = DATA_HW
    noise = rs.randint(-10, 11, size=(h + 64, w + 64)).astype(np.int16)
    rows, jobs = [], []
    for s, split in enumerate(splits):
        subject = 10000032 + s
        for k in range(2):
            study = 50000000 + 2 * s + k
            findings = synthetic_section(tok, rs, 40)
            impression = synthetic_section(tok, rs, 12)
            for d in range(DATA_IMAGES[(2 * s + k) % len(DATA_IMAGES)]):
                dicom = f"{study}-{d}"
                jobs.append((mimic_cxr_image_path(files, subject, study, dicom),
                             int(rs.randint(0, 2**31 - 1))))
                rows.append(dict(dicom_id=dicom, study_id=study, subject_id=subject, split=split,
                                 findings=findings, impression=impression,
                                 StudyDate=21500101 + k, StudyTime=120000.0 + s))

    def write(job):
        path, seed = job
        r = np.random.RandomState(seed)
        field = r.randint(40, 216, size=(13, 11)).astype(np.uint8)
        img = native.resize_bilinear(field, (w, h)).astype(np.int16)
        dy, dx = r.randint(0, 64, 2)
        img += noise[dy:dy + h, dx:dx + w]
        os.makedirs(os.path.dirname(path), exist_ok=True)
        native.save_jpeg(path, np.clip(img, 0, 255).astype(np.uint8), 75)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))
    merged = os.path.join(dataset_dir, "mimic_cxr_merged", "splits_reports_metadata.csv")
    os.makedirs(os.path.dirname(merged), exist_ok=True)
    Table.from_rows(rows).to_csv(merged)
    return dataset_dir, files, [p for p, _ in jobs]


def same_batches(a, b) -> bool:
    return len(a) == len(b) and all(
        np_equal(x["images"], y["images"]) and x["study_ids"] == y["study_ids"]
        and x["findings"] == y["findings"] for x, y in zip(a, b))


def np_equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and (a == b).all()


def data_codec_numbers(np, paths):
    """One thread: decode, resize + crop, cache put and get of DATA_TIMED
    images, median ms each; MB of the sources and of the cache entries."""
    import tempfile

    from cxrmate_torch.data import image as di
    from cxrmate_torch.data import native

    decode, resize, put, get, src_mb, entry_mb = [], [], [], [], [], []
    with tempfile.TemporaryDirectory(dir=SMOKE_DIR) as cache:
        for i, p in enumerate(paths[:DATA_TIMED]):
            with open(p, "rb") as f:
                data = f.read()
            t0 = time.perf_counter()
            a = native.decode(data, p)
            t1 = time.perf_counter()
            crop = di.center_crop(di.resize_shortest_edge(a, DATA_SIZE)[:, :, None], DATA_SIZE)[:, :, 0]
            t2 = time.perf_counter()
            cf = os.path.join(cache, f"{i:02d}", "entry.npy")
            di._cache_put(cf, crop)
            t3 = time.perf_counter()
            back = di._cache_get(cf)
            t4 = time.perf_counter()
            if back is None or not np_equal(back, crop):
                raise AssertionError(f"data: the cache entry of {p} reads back otherwise")
            decode.append(t1 - t0)
            resize.append(t2 - t1)
            put.append(t3 - t2)
            get.append(t4 - t3)
            src_mb.append(len(data) / 1e6)
            entry_mb.append(os.path.getsize(cf) / 1e6)
    med = lambda xs: sorted(xs)[len(xs) // 2] * 1e3  # noqa: E731
    return {"decode_ms_per_image": med(decode), "decode_ms_runs": [x * 1e3 for x in decode],
            "resize_crop_ms_per_image": med(resize), "cache_put_ms": med(put),
            "cache_get_ms": med(get), "source_mb_per_image": sum(src_mb) / len(src_mb),
            "cache_entry_mb": sum(entry_mb) / len(entry_mb), "timed_images": len(decode)}


def data_loader_epochs(np, df, files, n_images):
    """Epochs of the eval loader over the tree's studies through
    batch_iterator (STUDIES a batch, SLOTS images): the cache off, cold and
    warm, at 0 and DATA_WORKERS threads. Every epoch's batches must equal
    the first (cache off, one thread: the batches built on the CPU).
    -> (those batches, images/s per epoch)."""
    from cxrmate_torch.data import image as di
    from cxrmate_torch.data import pipeline as dp
    from cxrmate_torch.data.datasets import StudyDataset

    rates, reference = {}, None
    for label, workers, cache in (("off", 0, None), ("off", DATA_WORKERS, None),
                                  ("cold", 0, "c0"), ("warm", 0, "c0"),
                                  ("cold", DATA_WORKERS, "c5"), ("warm", DATA_WORKERS, "c5")):
        cache_dir = os.path.join(SMOKE_DIR, "data", "cache-" + cache) if cache else None
        ds = StudyDataset(df, files, di.make_eval_loader_transform(DATA_SIZE, cache_dir=cache_dir))
        t0 = time.perf_counter()
        batches = list(dp.batch_iterator(ds, STUDIES, max_images=SLOTS, num_workers=workers))
        rates[f"{label}_{workers}_threads"] = n_images / (time.perf_counter() - t0)
        if reference is None:
            reference = batches
        elif not same_batches(batches, reference):
            raise AssertionError(f"data: the {label}-cache epoch at {workers} threads differs")
    return reference, rates


def data_device_ops(torch, np, paths):
    """device_normalize_gray_u8 on the card against the host normalize_chw
    path cast to bf16 (bit-equal), and device_preprocess on the card against
    the CPU in fp32, TF32 off (<= 1e-5), on two full-size decoded images;
    their times on the card."""
    from cxrmate_torch.data import image as di
    from cxrmate_torch.data import native
    from cxrmate_torch.utils.precision import parity_mode

    crops = np.stack([di.center_crop(di.resize_shortest_edge(native.load_jpeg(p), DATA_SIZE)
                                     [:, :, None], DATA_SIZE)[:, :, 0] for p in paths[:SLOTS]])
    u8 = torch.from_numpy(crops).cuda()
    got = di.device_normalize_gray_u8(u8)
    host = torch.from_numpy(np.stack([di.normalize_chw(di.to_rgb(c)) for c in crops]))
    if not torch.equal(got.cpu(), host.to(torch.bfloat16)):
        raise AssertionError("data: device_normalize_gray_u8 differs from the host path in bf16")
    norm_ms = time_ms([lambda: di.device_normalize_gray_u8(u8)], reps=10)
    full = torch.from_numpy(np.stack([di.to_rgb(native.load_jpeg(p)) for p in paths[:2]]))
    with parity_mode():
        dev = full.cuda()
        on_card = di.device_preprocess(dev, DATA_SIZE)
        err = float((on_card.cpu() - di.device_preprocess(full, DATA_SIZE)).abs().max())
        pre_ms = time_ms([lambda: di.device_preprocess(dev, DATA_SIZE)], reps=5)
    if not err <= 1e-5:
        raise AssertionError(f"data: device_preprocess card against CPU {err} > 1e-5")
    return {"device_normalize_gray_u8": {"images": SLOTS, "bit_equal_to_host_bf16": True,
                                         "ms": norm_ms},
            "device_preprocess": {"input": list(full.shape), "output": list(on_card.shape),
                                  "max_abs_err_card_vs_cpu_fp32": err, "tolerance": 1e-5,
                                  "ms": pre_ms}}


def loader_micro_step(torch, np, ckpt, ds, label):
    """One bf16 training micro-step of the multi model at ``ckpt`` (fp32
    masters, AdamW over TRAIN_ACCUM, a fresh train state) on
    len(TRAIN_IMAGES) studies drawn from ``ds`` (shuffled, DATA_WORKERS
    threads, SLOTS slots); its launches must be one of each
    flash_attention_grad kernel per encoder attention layer and nothing
    else. -> (figures, the launches)."""
    from cxrmate_torch.data import pipeline as dp
    from cxrmate_torch.models import api
    from cxrmate_torch.train import optim
    from cxrmate_torch.train import tf_trainer as tt

    model = api.CXRMate.from_hf_checkpoint(ckpt, variant="multi", dtype=torch.float32,
                                           device="cuda")
    net, config, tok = model.model, model.config, model.tokenizer
    mask = optim.mask_for_stage(dict(net.named_parameters()), "multi")
    tx = optim.adamw(TRAIN_LR, accumulate_steps=TRAIN_ACCUM, trainable_mask=mask)
    state = tt.create_train_state(net, tx)
    step = tt.make_train_step(config, tx, mask, pad_id=tok.pad_token_id,
                              compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    b = next(iter(dp.batch_iterator(ds, len(TRAIN_IMAGES), max_images=SLOTS, shuffle=True,
                                    seed=SEED, num_workers=DATA_WORKERS)))
    load_s = time.perf_counter() - t0
    batch = tt.build_tf_batch(tok, config, b["images"], b["findings"], b["impression"])
    wrappers = all_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = step(state, batch, tt.train_generator(0, 0))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    want = dict.fromkeys(wrappers, 0)
    want.update(dict.fromkeys(FLASH_GRAD, sum(config.encoder.depth)))
    if launches != want or not np.isfinite(float(loss)):
        raise AssertionError(f"{label}: train micro-step launches {launches} (expected {want}), "
                             f"loss {float(loss)}")
    real = (b["images"].reshape(b["images"].shape[0], SLOTS, -1) != 0).any(-1)
    del model, net, state, step
    torch.cuda.empty_cache()
    return {"studies": len(TRAIN_IMAGES), "images": int(real.sum()), "load_s": load_s,
            "first_step_s_of_a_fresh_state": step_s, "loss": float(loss),
            "launches": {k: v for k, v in launches.items() if v}}, launches


def data_phase(torch, np, ckpts, trial):
    """The data pipeline (cxrmate_torch/data) feeding the test stage on the
    card: the decoder held to the fixtures; a MIMIC-CXR-JPG-layout tree
    (write_data_tree) and build_synthetic_dataset at its defaults;
    build_merged_index -> filter_split -> StudyDataset with
    make_eval_loader_transform (the cache off, then cold, then warm) ->
    batch_iterator(STUDIES, SLOTS, DATA_WORKERS threads) in a Prefetcher ->
    generate_report beam-4 in bf16 on the multi model restored as the score
    phase restores it, beside the same batches from memory (same token ids);
    each batch on the card bit-equal to the batch built on the CPU; one
    PreviousReportDataset batch (ground-truth prompts) through the
    longitudinal model's generate_report; one training micro-step fed by
    make_train_loader_transform(native_decode=False) (flash_attention_grad).
    Launch counts of every call checked. -> {"multi": launches of the multi calls, "train":
    the micro-step's launches}."""
    from cxrmate_torch.ckpt import checkpoints as ck
    from cxrmate_torch.data import image as di
    from cxrmate_torch.data import index as dx
    from cxrmate_torch.data import pipeline as dp
    from cxrmate_torch.data.datasets import PreviousReportDataset, StudyDataset
    from cxrmate_torch.data.synthetic import build_synthetic_dataset
    from cxrmate_torch.models import api
    from cxrmate_torch.tokenizer import ByteLevelBPETokenizer

    root = os.path.join(SMOKE_DIR, "data")
    os.makedirs(root, exist_ok=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = {"phase": "data", "fixtures_bit_equal_to_pil": check_jpeg_fixtures(np)}
    model = api.CXRMate.from_hf_checkpoint(ckpts["multi"], variant="multi", dtype=torch.bfloat16,
                                           device="cuda")
    ck.restore_model(ck.get_test_ckpt_path(trial), model.model)
    tok = model.tokenizer
    t0 = time.perf_counter()
    dataset_dir, files, paths = write_data_tree(np, root, tok)
    res["tree"] = {"studies": 2 * DATA_SUBJECTS, "images": len(paths), "hw": list(DATA_HW),
                   "quality": 75, "write_s": time.perf_counter() - t0,
                   "mb_on_disk": sum(os.path.getsize(p) for p in paths) / 1e6}
    t0 = time.perf_counter()
    syn = build_synthetic_dataset(os.path.join(root, "synthetic"))
    syn_files = os.path.join(syn["dataset_dir"], "physionet.org", "files", "mimic-cxr-jpg",
                             "2.0.0", "files")
    syn_ds = StudyDataset(dx.filter_split(dx.build_merged_index(syn["dataset_dir"]), "train"),
                          syn_files, di.make_eval_loader_transform(DATA_SIZE))
    syn_batches = list(dp.batch_iterator(syn_ds, STUDIES, max_images=SLOTS))
    syn_tok = ByteLevelBPETokenizer.from_file(syn["tokenizer_dir"])
    text = syn_batches[0]["findings"][0]
    if len(syn_ds) != 16 or syn_batches[0]["images"].shape != (STUDIES, SLOTS, 3, DATA_SIZE,
                                                              DATA_SIZE) \
            or not all(np.isfinite(b["images"]).all() for b in syn_batches):
        raise AssertionError(f"data: build_synthetic_dataset's tree does not load "
                             f"({len(syn_ds)} studies, {syn_batches[0]['images'].shape})")
    if syn_tok.decode(syn_tok.encode(text)) != text or "[PMT-SEP]" not in syn_tok.vocab:
        raise AssertionError("data: build_synthetic_dataset's tokenizer does not round-trip")
    res["synthetic_dataset_s"] = time.perf_counter() - t0
    res.update(data_codec_numbers(np, paths))

    df = dx.filter_split(dx.build_merged_index(dataset_dir), "test")
    reference, rates = data_loader_epochs(np, df, files, len(paths))
    res["loader_images_per_s"] = rates
    res.update(data_device_ops(torch, np, paths))

    layers, depth = model.config.decoder.num_hidden_layers, sum(model.config.encoder.depth)
    launches = {}

    def feed(batches, label):
        """STUDIES-study batches through drive: -> (seconds, waits, h2d, seqs)."""
        waits, h2d, seqs, figs = [], [], [], []
        it = iter(batches)
        t_start = time.perf_counter()
        for i in range(len(reference)):
            t0 = time.perf_counter()
            batch = next(it)
            waits.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            px = torch.from_numpy(batch["images"]).to("cuda")
            torch.cuda.synchronize()
            h2d.append(time.perf_counter() - t0)
            if not torch.equal(px.cpu(), torch.from_numpy(reference[i]["images"])):
                raise AssertionError(f"data {label}: batch {i} on the card differs from the CPU's")
            fig = drive(model, px, f"data-{label}", 4, depth, layers, sequences=seqs)
            figs.append(fig)
            for k, v in fig["launches"].items():
                launches[k] = launches.get(k, 0) + v
        if next(it, None) is not None:
            raise AssertionError(f"data {label}: more batches than the reference")
        return time.perf_counter() - t_start, waits, h2d, seqs, figs

    model.generate_report(reference[0]["images"], num_beams=4)  # warm-up, untimed
    secs, _, h2d, mem_seqs, figs = feed(reference, "in-memory")
    studies = 2 * DATA_SUBJECTS
    stage = {"in_memory": {"studies_per_s": studies / secs, "seconds": secs,
                           "h2d_ms_per_batch": [x * 1e3 for x in h2d],
                           "generate_s": [f["seconds"] for f in figs]}}
    for mode, cache in (("off", None), ("cold", "stage"), ("warm", "stage")):
        cache_dir = os.path.join(root, "cache-" + cache) if cache else None
        ds = StudyDataset(df, files, di.make_eval_loader_transform(DATA_SIZE, cache_dir=cache_dir))
        pf = dp.Prefetcher(dp.batch_iterator(ds, STUDIES, max_images=SLOTS,
                                             num_workers=DATA_WORKERS))
        try:
            secs, waits, h2d, seqs, figs = feed(pf, f"cache-{mode}")
        finally:
            pf.close()
        if len(seqs) != len(mem_seqs) or not all(np_equal(a, b) for a, b in zip(seqs, mem_seqs)):
            raise AssertionError(f"data: file-fed beam-4 (cache {mode}) differs from in-memory")
        stage[f"file_fed_cache_{mode}"] = {
            "studies_per_s": studies / secs, "seconds": secs,
            "prefetch_wait_ms_per_batch": [x * 1e3 for x in waits],
            "h2d_ms_per_batch": [x * 1e3 for x in h2d],
            "generate_s": [f["seconds"] for f in figs]}
    res["test_stage"] = stage
    res["h2d_mb_per_batch"] = reference[0]["images"].nbytes / 1e6
    res["token_ids_file_fed_equal_in_memory"] = True
    res["multi_launches"] = launches
    del model
    torch.cuda.empty_cache()

    model = api.CXRMate.from_hf_checkpoint(ckpts["longitudinal"], variant="longitudinal",
                                           dtype=torch.bfloat16, device="cuda")
    pds = PreviousReportDataset(df, dx.build_merged_index(dataset_dir), files,
                                di.make_eval_loader_transform(
                                    DATA_SIZE, cache_dir=os.path.join(root, "cache-stage")))
    batch = next(iter(dp.batch_iterator(pds, STUDIES, max_images=SLOTS,
                                        num_workers=DATA_WORKERS)))
    prompts = (batch["previous_findings"], batch["previous_impression"])
    if sum(p is not None for p in prompts[0]) != STUDIES // 2:
        raise AssertionError(f"data: previous reports {prompts[0]}")
    fig = drive(model, torch.from_numpy(batch["images"]).to("cuda"), "data-longitudinal", 4,
                depth, layers, prompts=prompts)
    res["longitudinal"] = {"studies": STUDIES, "with_previous_report": STUDIES // 2,
                           "prompt_width": fig["prompt_width"], "seconds": fig["seconds"],
                           "launches": {k: v for k, v in fig["launches"].items() if v}}
    del model
    torch.cuda.empty_cache()

    load = di.make_train_loader_transform(DATA_SIZE, seed=SEED, native_decode=False,
                                          cache_dir=os.path.join(root, "cache-stage"))
    res["train_micro_step"], train = loader_micro_step(
        torch, np, ckpts["multi"], StudyDataset(df, files, load), "data")
    torch.cuda.synchronize()
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    emit(res)
    return {"multi": launches, "train": train}


# the CLI (cxrmate_torch.cli.stages.main) on a MIMIC-CXR-JPG-layout tree
# (write_data_tree) of one subject per entry: 4 train, 2 validate, 4 test, two
# studies each (DATA_IMAGES images a study in turn, DATA_HW gray); the
# repository's configs with the overrides of CLI_RUNS; the JAX package's keys
# of a validation line of metrics.jsonl (no CheXbert in the zoo: NLG only)
CLI_SPLITS = ("train",) * 4 + ("validate",) * 2 + ("test",) * 4
CLI_RUNS = (
    ("fit_multi", "--train", "train/multi_tf.yaml",
     ["warm_start_name=aehrc/cxrmate-multi-tf", "max_epochs=1", "mbatch_size=4",
      "accumulated_mbatch_size=8"]),
    ("test_multi", "--test", "test/multi_tf.yaml", ["test_ckpt_name=null"]),
    ("fit_gt_prompt", "--train", "train/longitudinal_gt_prompt_tf.yaml", ["fast_dev_run=true"]),
    ("fit_scst", "--train", "train/longitudinal_gen_prompt_cxr-bert.yaml",
     ["warm_start_name=aehrc/cxrmate-tf", "fast_dev_run=true"]),
)
CLI_VAL_KEYS = {"epoch"} | {f"val_report_nlg_{k}" for k in (
    "num_study_ids", "bleu_1", "bleu_2", "bleu_3", "bleu_4", "rouge", "cider")}
CLI_LOG_KEYS = ({"epoch", "step", "train_loss"}, {"epoch", "scst_loss", "reward", "baseline"},
                CLI_VAL_KEYS, CLI_VAL_KEYS | {"step"})


def read_ids_csv(path) -> dict:
    import csv

    with open(path) as f:
        return {int(r["study_id"]): json.loads(r["report_ids"]) for r in csv.DictReader(f)}


def patch_cli_calls(torch, calls, secs, undo):
    """Count the calls the launch gates of the CLI's runs read: encodes
    (train or eval mode), decode and beam steps, beam searches, plain
    versions of the kernels; time (synchronised) the decodes of
    ``_decode_step_outputs``, every training micro-step, SCST steps and
    checkpoint saves. ``undo`` collects what ``restore_calls`` puts back."""
    from cxrmate_torch.ckpt import checkpoints as ck
    from cxrmate_torch.cli import stages
    from cxrmate_torch.models import bert as bert_mod
    from cxrmate_torch.models import encoder_decoder as ed
    from cxrmate_torch.ops import beam_reorder as br
    from cxrmate_torch.ops import decode_attention as da
    from cxrmate_torch.ops import flash_attention as fa
    from cxrmate_torch.ops import fused_decode as fd
    from cxrmate_torch.train import scst as scst_mod
    from cxrmate_torch.train import tf_trainer as tt

    def patch(owner, name, key=lambda a, kw: None, timed=None, result=None):
        """Count (and with ``timed``, time, synchronised) the calls of
        ``owner.name`` under ``key(args, kwargs)`` or its name."""
        fn = getattr(owner, name)

        def wrapped(*a, **kw):
            k = key(a, kw) or name
            calls[k] = calls.get(k, 0) + 1
            if timed:
                torch.cuda.synchronize()
                t = time.perf_counter()
            out = fn(*a, **kw)
            if timed:
                torch.cuda.synchronize()
                secs.setdefault(timed(a, kw), []).append(time.perf_counter() - t)
            return result(out) if result else out

        setattr(owner, name, wrapped)
        undo.append((owner, name, fn))

    def timed_step(step):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(*a, **kw)
            torch.cuda.synchronize()
            secs.setdefault("micro_step", []).append(time.perf_counter() - t)
            return out
        return run

    patch(ed, "encode_images", key=lambda a, kw: "encode_train" if (
        a[2] if len(a) > 2 else kw.get("train", False)) else "encode_eval")
    patch(bert_mod, "bert_step",
          key=lambda a, kw: "beam_step" if kw.get("deferred_write") else "decode_step")
    patch(stages, "beam_search")
    patch(stages, "_decode_step_outputs",
          timed=lambda a, kw: "test_decode" if a[5] > 1 else "val_decode")
    patch(tt, "make_train_step", result=timed_step)
    patch(scst_mod.SCSTTrainer, "step", timed=lambda a, kw: "scst_step")
    patch(ck, "save_checkpoint", timed=lambda a, kw: "save")
    for mod in (fa, da, br, fd):
        for name in [n for n in vars(mod) if n.endswith("_plain")]:
            patch(mod, name, key=lambda a, kw: "plain")
    return patch


def restore_calls(undo):
    for owner, name, fn in reversed(undo):
        setattr(owner, name, fn)


def expected_launches(stages, wrappers, c, task, encoder_trains):
    """The launches that the counted calls ``c`` (encodes, decode steps and
    beam searches) imply at ``task``'s widths (CvT-21: 21 attention layers;
    6 decoder layers: a self and a cross call each per step)."""
    mcfg = stages.build_model_config(task, 1)
    return implied_launches(wrappers, c, sum(mcfg.encoder.depth),
                            mcfg.decoder.num_hidden_layers, encoder_trains)


def implied_launches(wrappers, c, depth, layers, encoder_trains):
    """The launches that the counted calls ``c`` imply with ``depth``
    attention layers in the encoder and ``layers`` in the decoder."""
    want = dict.fromkeys(wrappers, 0)
    train = depth * c.get("encode_train", 0)
    want.update(flash_attention=depth * c.get("encode_eval", 0),
                flash_attention_fwd_lse=train,
                flash_attention_bwd_dq=train if encoder_trains else 0,
                flash_attention_bwd_dkv=train if encoder_trains else 0,
                decode_attention=2 * layers * (c.get("decode_step", 0)
                                               + c.get("beam_step", 0)),
                beam_reorder_write=layers * (c.get("beam_step", 0)
                                             + c.get("beam_search", 0)))
    return want


def cli_tree(np, ckpts):
    """The cli phase's JPEG tree (CLI_SPLITS) and zoo: the main phases'
    multi and longitudinal checkpoints as aehrc/cxrmate-multi-tf and
    aehrc/cxrmate-tf, the repository tokenizer, build_synthetic_cxrbert's
    CXR-BERT. -> (root, zoo, dataset_dir, image paths, seconds to write)."""
    from cxrmate_torch.data.synthetic import build_synthetic_cxrbert
    from cxrmate_torch.tokenizer import ByteLevelBPETokenizer

    root = os.path.join(SMOKE_DIR, "cli")
    zoo = os.path.join(root, "checkpoints")
    os.makedirs(os.path.join(zoo, "aehrc"))
    os.symlink(ckpts["multi"], os.path.join(zoo, "aehrc", "cxrmate-multi-tf"))
    os.symlink(ckpts["longitudinal"], os.path.join(zoo, "aehrc", "cxrmate-tf"))
    tok_dir = os.path.join(zoo, "mimic-cxr-tokenizers", "bpe_prompt")
    os.makedirs(tok_dir)
    shutil.copy(os.path.join(REPO, "artifacts", "tokenizer", "bpe_prompt", "tokenizer.json"),
                tok_dir)
    build_synthetic_cxrbert(zoo)
    t0 = time.perf_counter()
    dataset_dir, _, paths = write_data_tree(np, root, ByteLevelBPETokenizer.from_file(tok_dir),
                                            CLI_SPLITS)
    return root, zoo, dataset_dir, paths, time.perf_counter() - t0


def cli_phase(torch, np, ckpts):
    """The train/test CLI on the card: cxrmate_torch.cli.stages.main(argv),
    in this process, on the repository's configs, at full width, with the
    zoo (ckpt_zoo_dir) holding the main phases' seeded random multi and
    longitudinal checkpoints as aehrc/cxrmate-multi-tf and aehrc/cxrmate-tf,
    the repository tokenizer and build_synthetic_cxrbert's tiny CXR-BERT
    (no CheXbert or roberta-large: their metrics are skipped with a warning
    and checkpoints ranked by an NLG surrogate, as the JAX package does
    offline). Runs (CLI_RUNS): fit of the multi model (2 bf16 micro-steps on
    fp32 masters, one AdamW update, greedy validation of 4 studies in fp32, a
    checkpoint); its test (the best checkpoint, beam-4 over the 8 test
    studies, fp32); the gt_prompt stage warm-started from the multi checkpoint
    (fast_dev_run: no LoRA in it, so nothing trains, as in JAX); SCST of the
    longitudinal model (fast_dev_run: one step and generated-prompt
    validations); then the test again as `python -m cxrmate_torch.cli.stages`
    in a subprocess. Every launch count is set to 0 just before a run and
    read just after, against the counts its encodes, decode steps and beam
    searches imply; no plain version runs; losses finite; metrics.jsonl with
    the JAX package's keys; the test's token ids equal to the subprocess's
    and to restore_model + _decode_step_outputs in this process. -> the
    launches of each run."""
    import importlib.util
    import warnings

    from cxrmate_torch.ckpt import checkpoints as ck
    from cxrmate_torch.cli import config as cli_config
    from cxrmate_torch.cli import stages
    from cxrmate_torch.data.pipeline import batch_iterator

    root, zoo, dataset_dir, paths, write_s = cli_tree(np, ckpts)
    exp = os.path.join(root, "experiments")
    common = [f"exp_dir={exp}", f"dataset_dir={dataset_dir}", f"ckpt_zoo_dir={zoo}"]
    res = {"phase": "cli", "tree": {"subjects": len(CLI_SPLITS), "studies": 2 * len(CLI_SPLITS),
                                    "images": len(paths), "write_s": write_s},
           "yaml_importable": importlib.util.find_spec("yaml") is not None,
           "transformers_importable": importlib.util.find_spec("transformers") is not None,
           "tf32": {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}}

    calls, secs, undo = {}, {}, []
    patch_cli_calls(torch, calls, secs, undo)
    wrappers = all_wrappers()

    def expected(c, task, encoder_trains):
        return expected_launches(stages, wrappers, c, task, encoder_trains)

    launches, out, argvs = {}, {}, {}
    try:
        for name, mode, config, overrides in CLI_RUNS:
            argv = [mode, "--config", os.path.join(REPO, "config", config)] + overrides + common
            argvs[name] = argv
            calls.clear()
            secs.clear()
            for fn in wrappers.values():
                fn.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            printed = io.StringIO()
            t = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught, \
                    contextlib.redirect_stdout(printed):
                warnings.simplefilter("always")
                stages.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            got = {k: fn.launches for k, fn in wrappers.items()}
            task = cli_config.parse_args(argv)
            want = expected(calls, task, encoder_trains=name == "fit_multi")
            if got != want or calls.get("plain", 0):
                raise AssertionError(f"cli {name}: launches {got}, expected {want} from "
                                     f"{calls}")
            tdir = task.exp_dir_trial
            log = []
            if mode == "--train":
                with open(os.path.join(tdir, "metrics.jsonl")) as f:
                    log = [json.loads(line) for line in f]
                losses = [r[k] for r in log for k in ("train_loss", "scst_loss") if k in r]
                if not losses or not np.isfinite(losses).all() or \
                        any(set(r) not in CLI_LOG_KEYS for r in log):
                    raise AssertionError(f"cli {name}: metrics.jsonl {log}")
            launches[name] = got
            out[name] = {
                "wall_s": wall, "launches": {k: v for k, v in got.items() if v},
                "encodes": {k: calls.get(k, 0) for k in ("encode_eval", "encode_train")},
                "decode_steps": calls.get("decode_step", 0),
                "beam_steps": calls.get("beam_step", 0),
                "ms_per_micro_step": [x * 1e3 for x in secs.get("micro_step", [])],
                "scst_step_s": secs.get("scst_step", []),
                "val_decode_s": secs.get("val_decode", []),
                "test_decode_s": secs.get("test_decode", []),
                "checkpoint_save_s": secs.get("save", []),
                "checkpoints_mb": ckpt_dir_mb(os.path.join(tdir, "checkpoints")),
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "metrics_lines": len(log),
                "losses": [r.get("train_loss", r.get("scst_loss")) for r in log
                           if "train_loss" in r or "scst_loss" in r],
                "printed_lines": len(printed.getvalue().splitlines()),
                "warnings": sorted({str(w.message)[:90] for w in caught})}
        # the test's token ids: restore_model + _decode_step_outputs here
        argv = argvs["test_multi"]
        task = cli_config.parse_args(argv)
        csvs = glob_csvs(task.exp_dir_trial)
        ids_run = read_ids_csv(csvs[-1])
        tok = stages.load_tokenizer(task)
        config = stages.build_model_config(task, len(tok))
        best = ck.get_test_ckpt_path(task.exp_dir_trial, task.monitor_mode)
        model = ck.restore_model(best, stages.init_variables(task, config))
        ds = stages.make_datasets(task, "test", train=False)
        rows = min(task.eval_decode_rows // task.num_test_beams, len(ds))
        ids_here = {}
        for batch in batch_iterator(ds, rows, sort_key=ds.image_counts()):
            seqs, _, _ = stages._decode_step_outputs(task, config, tok, model, batch,
                                                     task.num_test_beams, pad_rows=rows)
            ids_here.update({int(s): list(map(int, r)) for s, r in zip(batch["study_ids"], seqs)})
        del model
        if calls.get("plain", 0):
            raise AssertionError("cli: a plain version ran on the card")
    finally:
        restore_calls(undo)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "cxrmate_torch.cli.stages"] + argv, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                          timeout=600)
    out["test_multi_subprocess"] = {"wall_s": time.perf_counter() - t, "rc": proc.returncode,
                                    "printed_lines": len(proc.stdout.splitlines())}
    if proc.returncode != 0 or "test_report_nlg_bleu_1: " not in proc.stdout:
        raise AssertionError(f"cli: python -m cxrmate_torch.cli.stages --test: rc "
                             f"{proc.returncode}\n{proc.stderr[-3000:]}")
    new = [p for p in glob_csvs(task.exp_dir_trial) if p not in csvs]
    ids_sub = read_ids_csv(new[-1]) if new else {}
    if not (len(ids_run) == 2 * CLI_SPLITS.count("test") and ids_run == ids_sub == ids_here):
        raise AssertionError(f"cli: test token ids differ (run {len(ids_run)}, subprocess "
                             f"{len(ids_sub)}, in-process {len(ids_here)} studies)")
    for kernel in ("flash_attention", "decode_attention", "beam_reorder_write") + FLASH_GRAD:
        if sum(run[kernel] for run in launches.values()) <= 0:
            raise AssertionError(f"cli: {kernel} not launched by any run")
    # the gates above held: the same ids from the run, the subprocess and
    # restore_model + _decode_step_outputs; no plain version ran
    res.update(runs=out, test_studies_with_equal_token_ids=len(ids_run), plain_calls=0)
    emit(res)
    return launches, {"dataset_dir": dataset_dir, "ckpt_zoo_dir": zoo,
                      "image_cache_dir": os.path.join(exp, ".image_cache")}


# the multiprocess phase: the CLI's runs on 2 ranks (gloo: both on the one
# card) against the same runs in one process, and a world-1 NCCL group.
# The 2-rank train and test runs force static widths and image slots; the
# one-process runs are given the same (static_tf_pad, pad_images=max). The
# pairs of this phase and of the tensor_parallel phase decode and train at
# MP_MAX_LEN tokens, a cut from the configs' 256 for the script's time: their
# runs are host-bound decode loops (ranks, collectives), and the cli phase
# runs the full length.
MP_NEW_TOKENS = 63
MP_MAX_LEN = f"decoder_max_len={MP_NEW_TOKENS + 1}"
MP_FIT = ["warm_start_name=aehrc/cxrmate-multi-tf", "max_epochs=1", "mbatch_size=4",
          "accumulated_mbatch_size=8", "static_tf_pad=true", "pad_images=max", MP_MAX_LEN]
# SCST in fp32: both runs then sample the same tokens, so its loss, reward,
# baseline and update are gated like the fit's (in bf16 a rank's rollout
# rounds its logits otherwise and samples other reports)
MP_SCST = ["warm_start_name=aehrc/cxrmate-tf", "fast_dev_run=true", "mbatch_size=2",
           "accumulated_mbatch_size=2", "precision=32", MP_MAX_LEN]
# cuDNN's TF32 (PyTorch's default: on) in the fp32 pairs, the test's and
# SCST's, in both runs: off. The encoder's convolutions at a rank's batch and
# at one process's may run other cuDNN engines, whose TF32 roundings (2^-11)
# reach the decoder through cross-attention. With TF32, SCST's first moments
# read 4.0e-5 to 1.4e-3 apart over the decoder (cross-attention's tensors
# 2.6e-4 where the whole read 1.1e-4); without it 3.9e-6, evenly over the
# decoder's tensors (H100, 700 W; tools/mp_tf32). The bf16 fit keeps the
# default.
MP_FP32_CUDNN_TF32 = False
# bf16 compute: the ranks' GEMMs hold half the rows of one process's and may
# round differently at every layer (bf16's unit roundoff is 2^-8 = 3.9e-3);
# the loss, a mean over some 300 labels, read within 6.4e-5 relative (H100,
# 700 W), is held within 1e-3
MP_LOSS_RTOL = 1e-3
# fp32 SCST (rtol, atol), from the readings on the H100 at 700 W: the loss
# 3.8e-6 relative apart, the reward (the mean advantage, near 0) 3e-8 and
# the baseline 6e-8 absolute
MP_SCST_LOSS_TOL = (1e-4, 0.0)
MP_SCST_REWARD_TOL = (1e-5, 1e-6)
# AdamW's first moments (the accumulated gradients, which carry their size):
# the relative L2 difference over the encoder's tensors and over the
# decoder's, by the compute dtype. Not per tensor: a gradient that is zero
# in exact arithmetic is only rounding in both runs (CvT's stage-0
# layernorm_before.bias feeds BatchNorm, which removes it, and key biases,
# which softmax ignores: 0.9-1.5 apart), where the parts read 2.4e-2
# (encoder) and 1.1e-2 (decoder) in bf16, 3.9e-6 in fp32 with cuDNN's TF32
# off (H100, 700 W). A gradient off by a scale, or missing a rank's stripe,
# is off by 0.5 or more.
MP_MU_RTOL = {"bf16": 1e-1, "fp32": 1e-3}
# AdamW's first update is about lr * sign(g): an element whose gradient is
# within rounding of 0 may move the other way (held within 2 lr); such sign
# flips between the runs' accumulated gradients stay below this share of the
# elements (a gradient that is not all-reduced, half the batch's, flips far more)
MP_FLIP_SHARE = 0.05
MP_TIMEOUT = 480  # seconds a launch of the ranks may take


def mp_rank_main(out_dir, argv, cudnn_tf32=True) -> int:
    """One rank of the multiprocess phase, started by torch.distributed.run:
    ``cli.stages.main(argv)`` with the calls of the launch gates counted,
    the training micro-steps and the gradient all-reduces timed
    (synchronised), and under tensor parallelism the model group's
    collectives (counted, timed synchronised, and those inside decode steps
    apart), then a JSON file ``rank{RANK}.json`` in ``out_dir``.
    ``cudnn_tf32``: the process's ``torch.backends.cudnn.allow_tf32``."""
    import torch

    torch.backends.cudnn.allow_tf32 = cudnn_tf32

    sys.path.insert(0, REPO)
    from cxrmate_torch.cli import stages
    from cxrmate_torch.models import bert as bert_mod
    from cxrmate_torch.utils import dist

    calls, secs, undo = {}, {}, []
    patch_cli_calls(torch, calls, secs, undo)
    reduces, info, bn_ms = [], {}, {"forward": [], "backward": []}
    flat_sum, init = dist.all_reduce_sum, stages.initialize_if_needed
    bn_fwd, bn_bwd = dist._AllReduceSum.forward, dist._AllReduceSum.backward

    def timed_sum(tensors, group=None):
        tensors = list(tensors)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = flat_sum(tensors, group)
        torch.cuda.synchronize()
        reduces.append(((time.perf_counter() - t) * 1e3,
                        sum(x.numel() * x.element_size() for x in tensors) / 1e6))
        return out

    def timed_bn(fn, way):
        # BatchNorm's differentiable all-reduces (the global batch's moments),
        # both ways, synchronised
        def run(ctx, *args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(ctx, *args)
            torch.cuda.synchronize()
            bn_ms[way].append((time.perf_counter() - t) * 1e3)
            return out
        return staticmethod(run)

    # the model group's collectives (tensor parallelism): the row-parallel
    # sums and the vocabulary gather forward, the copies' sums backward
    tp_ms, in_step = {}, {"on": False, "count": 0, "ms": 0.0}

    def timed_tp(fn, kind):
        def run(ctx, *args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(ctx, *args)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            tp_ms.setdefault(kind, []).append(ms)
            if in_step["on"]:
                in_step["count"] += 1
                in_step["ms"] += ms
            return out
        return staticmethod(run)

    for fn_owner, way, kind in ((dist._ReduceFromGroup, "forward", "reduce"),
                                (dist._GatherFromGroup, "forward", "gather"),
                                (dist._CopyToGroup, "backward", "copy_backward")):
        setattr(fn_owner, way, timed_tp(getattr(fn_owner, way), kind))

    def joined(device):
        out = init(device)
        info.update(backend=torch.distributed.get_backend(),
                    world=torch.distributed.get_world_size(),
                    device=str(torch.device("cuda", torch.cuda.current_device())))
        return out

    dist.all_reduce_sum = timed_sum
    dist._AllReduceSum.forward = timed_bn(bn_fwd, "forward")
    dist._AllReduceSum.backward = timed_bn(bn_bwd, "backward")
    stages.initialize_if_needed = joined
    counted_step = bert_mod.bert_step  # patch_cli_calls's counting wrapper

    def step_collectives(*a, **kw):
        in_step["on"] = True
        try:
            return counted_step(*a, **kw)
        finally:
            in_step["on"] = False

    bert_mod.bert_step = step_collectives
    make_mesh = stages.mesh_mod.make_mesh

    def made_mesh(data=None, model=1):
        out = make_mesh(data, model)
        info["mesh"] = [out.data, out.model]
        return out

    stages.mesh_mod.make_mesh = made_mesh
    wrappers = all_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    stages.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    grads = [r for r in reduces if r[1] > 1.0]  # the flat gradient buffer, not the counts
    rank = int(os.environ["RANK"])
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, **info, "wall_s": wall, "calls": calls,
                   "launches": {k: fn.launches for k, fn in wrappers.items()},
                   "ms_per_micro_step": [x * 1e3 for x in secs.get("micro_step", [])],
                   "grad_all_reduce_ms": [r[0] for r in grads],
                   "grad_all_reduce_mb": [r[1] for r in grads],
                   "other_all_reduces": len(reduces) - len(grads),
                   "batch_norm_all_reduce_ms": {k: sum(v) for k, v in bn_ms.items()},
                   "batch_norm_all_reduces": {k: len(v) for k, v in bn_ms.items()},
                   "tp_collectives": {k: {"count": len(v), "ms": sum(v)} for k, v in tp_ms.items()},
                   "decode_step_collectives": in_step["count"],
                   "decode_step_collective_ms": in_step["ms"],
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}, f)
    restore_calls(undo)
    return 0


def run_ranks(nproc, argv, out_dir, cudnn_tf32=True):
    """``nproc`` ranks of this script's ``--mp-rank`` mode through
    ``multihost.launch_ranks`` (``python -m torch.distributed.run``): a failed
    rank fails the launch (torchrun stops the others), and a launch past
    MP_TIMEOUT is stopped with all its ranks. ``cudnn_tf32``: the ranks'
    ``torch.backends.cudnn.allow_tf32``. -> (wall s, each rank's JSON)."""
    from cxrmate_torch.parallel.multihost import launch_ranks

    os.makedirs(out_dir)
    t = time.perf_counter()
    mode = ["--mp-rank", out_dir] + ([] if cudnn_tf32 else ["--no-cudnn-tf32"]) + ["--"]
    log = launch_ranks(nproc, [os.path.join(REPO, "chip_smoke.py")] + mode + argv, MP_TIMEOUT,
                       env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    wall = time.perf_counter() - t
    with open(os.path.join(out_dir, "torchrun.log"), "w") as f:
        f.write(log)
    ranks = []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return wall, ranks


def run_in_process(torch, argv, cudnn_tf32=True):
    """``cli.stages.main(argv)`` here, its calls counted, under
    ``torch.backends.cudnn.allow_tf32 = cudnn_tf32`` (restored after) ->
    (wall s, calls, secs, launches, peak GB)."""
    import warnings

    from cxrmate_torch.cli import stages

    calls, secs, undo = {}, {}, []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    patch_cli_calls(torch, calls, secs, undo)
    wrappers = all_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    try:
        with warnings.catch_warnings(), contextlib.redirect_stdout(io.StringIO()):
            warnings.simplefilter("ignore")
            stages.main(argv)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        restore_calls(undo)
    return (time.perf_counter() - t, calls, secs,
            {k: fn.launches for k, fn in wrappers.items()},
            torch.cuda.max_memory_allocated() / 1e9)


def train_losses(trial, keys=("train_loss", "scst_loss")):
    """Every logged value of ``keys`` in the run's metrics, in order."""
    with open(os.path.join(trial, "metrics.jsonl")) as f:
        return [r[k] for r in map(json.loads, f) for k in keys if k in r]


def compare_checkpoints(torch, np, got_path, want_path, lr, mu_rtol):
    """Rank 0's checkpoint against one process's after one AdamW update.
    The first moments by MP_MU_RTOL (``mu_rtol``). The
    parameters within rtol 1e-4, atol 1e-6 where both accumulated
    gradients (the first moments) share a sign and are at least 1e-6, else
    within 2 lr (see MP_FLIP_SHARE). BatchNorm's running statistics within
    rtol 1e-3, atol 1e-5: they are fp32, but the batch moments come from bf16
    activations, which may differ between the runs by a bf16 rounding
    (2^-8), and enter the statistics scaled by the momentum 0.1.
    -> (worst key and how far beyond its tolerance, largest loose
    difference, share of elements whose gradients differ in sign, the
    first moments' readings)."""
    from cxrmate_torch.ckpt import checkpoints as ck

    a, b = (torch.load(os.path.join(p, ck.STATE_FILE), map_location="cpu", weights_only=True)
            for p in (got_path, want_path))
    count = b["opt_state"]["count"]
    if a["opt_state"]["count"] != count or count != 1 or list(a["model"]) != list(b["model"]):
        raise AssertionError(f"multiprocess: checkpoints of {a['opt_state']['count']} and "
                             f"{count} updates, or other parameter sets")
    mus = {k: (a["opt_state"]["mu"][k].double().numpy(), m.double().numpy())
           for k, m in b["opt_state"]["mu"].items()}

    def rel_l2(keys):
        return float(np.sqrt(sum(float(np.square(mus[k][0] - mus[k][1]).sum()) for k in keys)
                             / max(sum(float(np.square(mus[k][1]).sum()) for k in keys), 1e-300)))

    parts = {}
    for k in mus:
        parts.setdefault(k.split(".")[0], []).append(k)
    moments = {"rel_l2": {part: rel_l2(keys) for part, keys in parts.items()},
               "tensor_rel_l2_worst": max(((k, rel_l2([k])) for k in mus), key=lambda kv: kv[1])}
    if max(moments["rel_l2"].values()) > mu_rtol:
        raise AssertionError(f"multiprocess: first moments past {mu_rtol}: {moments}")
    worst, loose = ("", -np.inf), 0.0
    flips = elements = 0
    for k, y in b["model"].items():
        if not y.is_floating_point():
            continue
        x, y = a["model"][k].float().numpy(), y.float().numpy()
        diff = np.abs(x - y)
        free = np.zeros(diff.shape, bool)
        rtol, atol = 1e-4, 1e-6
        if k.endswith(("running_mean", "running_var")):
            rtol, atol = 1e-3, 1e-5
        elif k in b["opt_state"]["mu"]:
            ga, gb = a["opt_state"]["mu"][k].numpy() / 0.1, b["opt_state"]["mu"][k].numpy() / 0.1
            flip = np.sign(ga) != np.sign(gb)
            flips, elements = flips + int(flip.sum()), elements + flip.size
            free = flip | (np.minimum(np.abs(ga), np.abs(gb)) < 1e-6)
        if free.any():
            loose = max(loose, float(diff[free].max()))
        if (~free).any():
            over = float((diff[~free] - (atol + rtol * np.abs(y[~free]))).max())
            worst = max(worst, (k, over), key=lambda kv: kv[1])
    if worst[1] > 0 or loose > 2 * lr or flips > MP_FLIP_SHARE * elements:
        raise AssertionError(f"multiprocess: checkpoints past their tolerances ({worst[0]} "
                             f"by {worst[1]}; loose {loose} against 2 lr = {2 * lr}; {flips} "
                             f"of {elements} gradient signs differ)")
    return worst, loose, flips / elements, moments


def report_rows(trial, subdir):
    """A CSV's header and its rows in study order (the ranks' rows arrive in
    rank order, one process's in decode order)."""
    import csv
    import glob

    (path,) = glob.glob(os.path.join(trial, subdir, "*.csv"))
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    key = rows[0].index("study_id")
    return [rows[0]] + sorted(rows[1:], key=lambda r: int(r[key]))


def check_draws(torch):
    """On the card, with CUDA generators: the port's sampling draw
    (exponentials, argmax of p / q) is ``torch.multinomial(p, 1)``'s bit for
    bit, and a RowStripe's draw of sampling, dropout and drop-path (CvT's
    fold of 5 images a study) is the world-1 draw's rows."""
    from cxrmate_torch.generate.decode import _draw
    from cxrmate_torch.models.cvt import _drop_path
    from cxrmate_torch.ops.layers import RowStripe, dropout

    def gen(seed=7):
        return torch.Generator(device="cuda").manual_seed(seed)

    x = torch.randn(16, 4720, device="cuda", generator=gen(1)) * 3
    want = torch.multinomial(torch.softmax(x, dim=-1), 1, generator=gen())[:, 0]
    whole = _draw(x, gen())
    h = torch.randn(16 * 5, 96, 64, device="cuda", dtype=torch.bfloat16, generator=gen(2))
    out = {"sample_equals_multinomial": bool(torch.equal(whole, want))}
    for name, fn, t, k in (("sample", _draw, x, 1),
                           ("dropout", lambda a, g: dropout(a, 0.1, g), h, 5),
                           ("drop_path", lambda a, g: _drop_path(a, 0.1, g), h, 5)):
        full = fn(t, gen())
        out[f"{name}_stripes_equal"] = all(
            torch.equal(fn(t[k * lo:k * hi], RowStripe(gen(), lo, hi, 16)), full[k * lo:k * hi])
            for lo, hi in ((0, 8), (8, 16), (3, 11)))
    if not all(out.values()):
        raise AssertionError(f"multiprocess: draws {out}")
    return out


def check_rank_launches(phase, name, args, ranks, encoder_trains):
    """Each rank's launches as its own encodes, decode steps and beam
    searches imply, and no plain version run -> (the run's task, its
    launches summed over the ranks)."""
    from cxrmate_torch.cli import config as cli_config
    from cxrmate_torch.cli import stages

    wrappers = all_wrappers()
    task = cli_config.parse_args(args)
    for r in ranks:
        want = expected_launches(stages, wrappers, r["calls"], task, encoder_trains)
        if r["launches"] != want or r["calls"].get("plain", 0):
            raise AssertionError(f"{phase} {name} rank {r['rank']}: launches "
                                 f"{r['launches']}, expected {want} from {r['calls']}")
    return task, {k: sum(r["launches"][k] for r in ranks) for k in wrappers}


def rank_view(ranks):
    """What each rank's JSON says, for the phase's line."""
    out = []
    for r in ranks:
        steps = r["calls"].get("decode_step", 0) + r["calls"].get("beam_step", 0)
        view = {"rank": r["rank"], "backend": r["backend"], "device": r["device"],
                "mesh": r.get("mesh"), "wall_s": r["wall_s"],
                "launches": {k: v for k, v in r["launches"].items() if v},
                "encodes": {k: r["calls"].get(k, 0) for k in ("encode_eval", "encode_train")},
                "decode_steps": r["calls"].get("decode_step", 0),
                "beam_steps": r["calls"].get("beam_step", 0),
                "ms_per_micro_step": r["ms_per_micro_step"],
                "grad_all_reduce_ms": r["grad_all_reduce_ms"],
                "grad_all_reduce_mb": r["grad_all_reduce_mb"],
                "batch_norm_all_reduces": r["batch_norm_all_reduces"],
                "batch_norm_all_reduce_ms": r["batch_norm_all_reduce_ms"],
                "batch_norm_share_of_micro_steps": (
                    sum(r["batch_norm_all_reduce_ms"].values())
                    / max(sum(r["ms_per_micro_step"]), 1e-9)),
                "peak_memory_gb": r["peak_memory_gb"]}
        if r["tp_collectives"]:  # tensor parallelism: the model group's collectives
            view.update(tp_collectives=r["tp_collectives"],
                        collectives_per_decode_step=r["decode_step_collectives"] / max(steps, 1),
                        collective_ms_per_decode_step=(r["decode_step_collective_ms"]
                                                       / max(steps, 1)))
        out.append(view)
    return out


def one_process_view(wall, calls, secs, launches, peak):
    return {"wall_s": wall, "launches": {k: v for k, v in launches.items() if v},
            "ms_per_micro_step": [x * 1e3 for x in secs.get("micro_step", [])],
            "peak_memory_gb": peak}


def multiprocess_phase(torch, np, tree):
    """The CLI on two ranks of one process group, both on the one card
    (gloo: NCCL takes one rank a device), launched as a user launches them
    (python -m torch.distributed.run ... cli.stages), at full width on the
    cli phase's JPEG tree (MP_MAX_LEN tokens), against the same runs in
    this process:
      * --train of config/train/multi_tf.yaml (a global batch of 4, 2 a rank,
        2 micro-steps, one AdamW update): the loss within MP_LOSS_RTOL, rank
        0's checkpoint by compare_checkpoints (first moments by MP_MU_RTOL);
      * --test of config/test/multi_tf.yaml on the one-process fit's best
        checkpoint (fp32, beam-4): global batches of 8 studies, 4 a rank,
        against one process's batches of 4 (each rank decodes one of them):
        token ids and the generated reports equal;
      * --train of the SCST config in fp32 (fast_dev_run, 2 studies, 1 a
        rank): scst_loss, reward and baseline within MP_SCST_*_TOL, rank 0's
        checkpoint by compare_checkpoints;
      * --train of the multi config with fast_dev_run as a world-1 NCCL group:
        one micro-step's gradient all-reduce through NCCL.
    The fp32 pairs (test, SCST) turn cuDNN's TF32 off in both runs
    (MP_FP32_CUDNN_TF32). Each rank's launches as its own encodes, decode
    steps and beam searches imply (printed per rank and summed). -> (the
    launches of each run, summed over its ranks; the one-process runs'
    argv by name, which the tensor_parallel phase compares against)."""
    from cxrmate_torch.ckpt import checkpoints as ck
    from cxrmate_torch.cli import config as cli_config

    root = os.path.join(SMOKE_DIR, "mp")
    common = [f"{k}={v}" for k, v in tree.items()]

    def argv(mode, config, overrides, name):
        return ([mode, "--config", os.path.join(REPO, "config", config)] + overrides + common
                + [f"exp_dir={os.path.join(root, name)}"])

    def check_ranks(name, args, ranks, encoder_trains):
        return check_rank_launches("multiprocess", name, args, ranks, encoder_trains)

    res, counts = {"phase": "multiprocess", "draws": check_draws(torch)}, {}
    try:
        # --train: one process, then two ranks
        fit1 = argv("--train", "train/multi_tf.yaml", MP_FIT, "fit_1")
        ref = run_in_process(torch, fit1)
        fit2 = argv("--train", "train/multi_tf.yaml", MP_FIT, "fit_2")
        wall, ranks = run_ranks(2, fit2, os.path.join(root, "ranks_fit"))
        task, counts["fit_2"] = check_ranks("fit", fit2, ranks, encoder_trains=True)
        ref_task = cli_config.parse_args(fit1)
        l1, l2 = train_losses(ref_task.exp_dir_trial), train_losses(task.exp_dir_trial)
        res["fit"] = {"one_process": one_process_view(*ref),
                      "two_ranks": {"wall_s": wall, "ranks": rank_view(ranks)},
                      "losses": {"one_process": l1, "two_ranks": l2}}
        if not (len(l1) == len(l2) >= 1 and np.allclose(l2, l1, rtol=MP_LOSS_RTOL, atol=0)):
            raise AssertionError(f"multiprocess fit: losses {l2} on 2 ranks, {l1} in one process")
        worst, loose, flips, moments = compare_checkpoints(
            torch, np, ck.last_checkpoint(task.exp_dir_trial),
            ck.last_checkpoint(ref_task.exp_dir_trial), ref_task.lr, MP_MU_RTOL["bf16"])
        info = ck.checkpoint_resume_info(ck.last_checkpoint(task.exp_dir_trial))
        if info["world_size"] != 2 or info["global_schedule"] is not True:
            raise AssertionError(f"multiprocess fit: checkpoint marker {info}")
        res["fit"]["checkpoint"] = {"closest_to_tolerance": worst, "largest_loose_diff": loose,
                                    "gradient_sign_flip_share": flips, "lr": ref_task.lr,
                                    "first_moments": moments}
        res["fit"]["loss_rel_diff"] = max(abs(x - y) / abs(y) for x, y in zip(l2, l1))

        # --test of the one-process fit's best checkpoint
        best = ck.get_test_ckpt_path(ref_task.exp_dir_trial, ref_task.monitor_mode)
        test1 = argv("--test", "test/multi_tf.yaml",
                     ["test_ckpt_name=null", f"test_ckpt_path={best}", "eval_decode_rows=16",
                      MP_MAX_LEN],
                     "test_1")
        ref = run_in_process(torch, test1, cudnn_tf32=MP_FP32_CUDNN_TF32)
        test2 = argv("--test", "test/multi_tf.yaml",
                     ["test_ckpt_name=null", f"test_ckpt_path={best}", "eval_decode_rows=32",
                      MP_MAX_LEN],
                     "test_2")
        wall, ranks = run_ranks(2, test2, os.path.join(root, "ranks_test"),
                                cudnn_tf32=MP_FP32_CUDNN_TF32)
        task, counts["test_2"] = check_ranks("test", test2, ranks, encoder_trains=False)
        trial1 = cli_config.parse_args(test1).exp_dir_trial
        ids1 = read_ids_csv(glob_csvs(trial1)[-1])
        ids2 = read_ids_csv(glob_csvs(task.exp_dir_trial)[-1])
        if not (len(ids1) == 2 * CLI_SPLITS.count("test") and ids1 == ids2) or \
                report_rows(trial1, "generated_reports") != \
                report_rows(task.exp_dir_trial, "generated_reports"):
            raise AssertionError(f"multiprocess test: token ids or reports differ ({len(ids2)} "
                                 f"studies on 2 ranks, {len(ids1)} in one process)")
        res["test"] = {"cudnn_tf32": MP_FP32_CUDNN_TF32, "one_process": one_process_view(*ref),
                       "two_ranks": {"wall_s": wall, "ranks": rank_view(ranks)},
                       "studies_with_equal_token_ids": len(ids1)}

        # SCST, fast_dev_run, fp32
        scst1 = argv("--train", "train/longitudinal_gen_prompt_cxr-bert.yaml", MP_SCST, "scst_1")
        ref = run_in_process(torch, scst1, cudnn_tf32=MP_FP32_CUDNN_TF32)
        scst2 = argv("--train", "train/longitudinal_gen_prompt_cxr-bert.yaml", MP_SCST, "scst_2")
        wall, ranks = run_ranks(2, scst2, os.path.join(root, "ranks_scst"),
                                cudnn_tf32=MP_FP32_CUDNN_TF32)
        task, counts["scst_2"] = check_ranks("scst", scst2, ranks, encoder_trains=False)
        scst_ref = cli_config.parse_args(scst1)
        logs = {key: (train_losses(scst_ref.exp_dir_trial, (key,)),
                      train_losses(task.exp_dir_trial, (key,)))
                for key in ("scst_loss", "reward", "baseline")}
        res["scst"] = {"cudnn_tf32": MP_FP32_CUDNN_TF32, "one_process": one_process_view(*ref),
                       "two_ranks": {"wall_s": wall, "ranks": rank_view(ranks)},
                       "logs": {k: {"one_process": a, "two_ranks": b} for k, (a, b) in logs.items()}}
        for key, (rtol, atol) in (("scst_loss", MP_SCST_LOSS_TOL), ("reward", MP_SCST_REWARD_TOL),
                                  ("baseline", MP_SCST_REWARD_TOL)):
            l1, l2 = logs[key]
            if not (len(l1) == len(l2) == 1 and np.allclose(l2, l1, rtol=rtol, atol=atol)):
                raise AssertionError(f"multiprocess scst: {key} {l2} on 2 ranks, {l1} in one "
                                     f"process")
        worst, loose, flips, moments = compare_checkpoints(
            torch, np, ck.last_checkpoint(task.exp_dir_trial),
            ck.last_checkpoint(scst_ref.exp_dir_trial), scst_ref.lr, MP_MU_RTOL["fp32"])
        res["scst"]["checkpoint"] = {"closest_to_tolerance": worst, "largest_loose_diff": loose,
                                     "gradient_sign_flip_share": flips, "lr": scst_ref.lr,
                                     "first_moments": moments}

        # a world-1 NCCL group: one micro-step and its gradient all-reduce
        nccl = argv("--train", "train/multi_tf.yaml", MP_FIT + ["fast_dev_run=true"], "fit_nccl")
        wall, ranks = run_ranks(1, nccl, os.path.join(root, "ranks_nccl"))
        task, counts["fit_nccl"] = check_ranks("nccl", nccl, ranks, encoder_trains=True)
        ln = train_losses(task.exp_dir_trial)
        first = train_losses(ref_task.exp_dir_trial)[:1]
        if ranks[0]["backend"] != "nccl" or not (len(ln) == 1 and np.allclose(
                ln, first, rtol=MP_LOSS_RTOL, atol=0)) or len(ranks[0]["grad_all_reduce_ms"]) != 1:
            raise AssertionError(f"multiprocess nccl: backend {ranks[0]['backend']}, loss {ln} "
                                 f"against {first}, {ranks[0]['grad_all_reduce_ms']} all-reduces")
        res["nccl_world_1"] = {"wall_s": wall, "ranks": rank_view(ranks), "loss": ln,
                               "one_process_first_loss": first}
        for kernel in ("flash_attention", "decode_attention", "beam_reorder_write") + FLASH_GRAD:
            if sum(run[kernel] for run in counts.values()) <= 0:
                raise AssertionError(f"multiprocess: {kernel} not launched by any run")
    except Exception:
        res["failed"] = True
        emit(res)  # what ran before the failure
        raise
    emit(res)
    return counts, {"fit": fit1, "test": test1, "scst": scst1}


# the tensor_parallel phase: the CLI with mesh_model=2 (the decoder's
# vocabulary, heads and intermediate split over a model group) on gloo ranks
# sharing the one card, against the multiprocess phase's one-process runs
TP_MODEL = 2  # the model axis: 6 of the 12 heads a rank
# the decode kernels at a model rank's heads (6 at model 2, 3 at model 4),
# at the 2x2 test's per-rank shapes: beam-4 over 4 studies a data rank, the
# self cache 1 + MP_NEW_TOKENS wide, the cross keys 5 slots of 576
TP_HEADS = (HEADS // 2, HEADS // 4)
TP_STUDIES = 4
TP_DECODE = (("decode_attention", 4 * TP_STUDIES, 1, 1 + MP_NEW_TOKENS, "prefix"),
             ("decode_attention", TP_STUDIES, 4, SLOTS * 576, f"slots:{TP_STUDIES}"))


def tp_kernel_checks(torch, da, br, F):
    """decode_attention and beam_reorder_write at a model rank's heads
    (TP_HEADS) and the 2x2 test's per-rank shapes, against their plain
    versions: fp32 (TF32 off, <= 1e-5; the dtype the CLI decodes in) and
    bf16 (<= 1e-2), the reorder bit-exact. -> {dtype: {heads: {"decode":
    [results], "reorder": result}}}."""
    from cxrmate_torch.utils.precision import parity_mode

    out = {}
    for name, dtype, tol in (("fp32", torch.float32, 1e-5), ("bf16", torch.bfloat16, 1e-2)):
        g = torch.Generator(device="cuda").manual_seed(SEED + 3)
        out[name] = {}
        for heads in TP_HEADS:
            with parity_mode():
                dec = [check_decode_call(torch, da, F, g, dtype, *c, heads=heads)
                       for c in TP_DECODE]
                reo = check_reorder(torch, br, dtype, 1 + MP_NEW_TOKENS, heads=heads,
                                    studies=TP_STUDIES)
            for kname, r in [(c[0], x) for c, x in zip(TP_DECODE, dec)] + [
                    ("beam_reorder_write", reo)]:
                bound, bound_by = bound_ms(r["bytes"], r["flops"], name)
                emit({"phase": "tensor_parallel", "check": "kernel", "dtype": name,
                      "kernel": kname, "heads": heads, "tolerance": tol, "bound_ms": bound,
                      "bound_by": bound_by,
                      **{k: v for k, v in r.items() if k not in ("bytes", "flops")}})
                if not (r["max_abs_err"] <= tol and r.get("fully_masked_row_err", 0.0) <= tol):
                    raise AssertionError(f"tensor_parallel {kname} {name} {heads} heads: {r}")
            out[name][heads] = {"decode": dec, "reorder": reo}
    return out


def tensor_parallel_phase(torch, np, da, br, F, tree, refs):
    """The CLI under tensor parallelism (mesh_model=2: each rank holds 6 of
    the 12 heads, half the vocabulary of 4,720 and of the 3,072-wide
    intermediate) on gloo ranks sharing the card, launched as a user launches
    them, on the cli phase's tree, against the multiprocess phase's runs in
    one process (``refs``), under that phase's gates:
      * mesh 2x2 (4 ranks: two data ranks, each a model group of two): the
        multi fit (bf16, a global batch of 4, 2 micro-steps, one AdamW
        update): the loss within MP_LOSS_RTOL, rank 0's checkpoint (gathered
        whole) by compare_checkpoints;
      * mesh 2x2: the beam-4 test of the one-process fit's best checkpoint
        (fp32, cuDNN's TF32 off; 8 studies a batch, 4 a data rank): token
        ids and reports equal;
      * mesh 1x2: SCST in fp32 (TF32 off; 2 studies, both on each rank):
        loss, reward and baseline within MP_SCST_*_TOL, the checkpoint;
      * decode_attention and beam_reorder_write at 6 and 3 heads (a rank's
        at model 2 and 4) and the 2x2 test's per-rank shapes against their
        plain versions (tp_kernel_checks).
    Each rank's launches as its encodes and steps imply; its ms per
    micro-step, the model group's collectives (count and synchronised ms,
    and those a decode step makes), peak memory. -> (the launches of each
    run summed over its ranks, the kernel checks)."""
    from cxrmate_torch.ckpt import checkpoints as ck
    from cxrmate_torch.cli import config as cli_config

    root = os.path.join(SMOKE_DIR, "tp")
    common = [f"{k}={v}" for k, v in tree.items()]
    res, counts = {"phase": "tensor_parallel", "model_axis": TP_MODEL}, {}

    def argv(ref, overrides, name):
        out = [a for a in ref if not a.startswith("exp_dir=")]
        return out + overrides + [f"mesh_model={TP_MODEL}", f"exp_dir={os.path.join(root, name)}"]

    def run(nproc, args, name, encoder_trains, cudnn_tf32=True):
        wall, ranks = run_ranks(nproc, args, os.path.join(root, f"ranks_{name}"), cudnn_tf32)
        task, counts[name] = check_rank_launches("tensor_parallel", name, args, ranks,
                                                 encoder_trains)
        if any(r["mesh"] != [nproc // TP_MODEL, TP_MODEL] for r in ranks):
            raise AssertionError(f"tensor_parallel {name}: meshes {[r['mesh'] for r in ranks]}")
        if not all(r["tp_collectives"] for r in ranks):
            raise AssertionError(f"tensor_parallel {name}: a rank ran no model-group collective")
        res[name] = {"nproc": nproc, "wall_s": wall, "ranks": rank_view(ranks)}
        return task

    try:
        kernels = tp_kernel_checks(torch, da, br, F)
        # --train, 2x2, bf16, against the one-process fit
        ref_task = cli_config.parse_args(refs["fit"])
        task = run(4, argv(refs["fit"], [], "fit_2x2"), "fit_2x2", encoder_trains=True)
        l1, l2 = train_losses(ref_task.exp_dir_trial), train_losses(task.exp_dir_trial)
        res["fit_2x2"]["losses"] = {"one_process": l1, "mesh_2x2": l2}
        if not (len(l1) == len(l2) >= 1 and np.allclose(l2, l1, rtol=MP_LOSS_RTOL, atol=0)):
            raise AssertionError(f"tensor_parallel fit: losses {l2} at 2x2, {l1} in one process")
        worst, loose, flips, moments = compare_checkpoints(
            torch, np, ck.last_checkpoint(task.exp_dir_trial),
            ck.last_checkpoint(ref_task.exp_dir_trial), ref_task.lr, MP_MU_RTOL["bf16"])
        info = ck.checkpoint_resume_info(ck.last_checkpoint(task.exp_dir_trial))
        if info["world_size"] != 4 or info["global_schedule"] is not True:
            raise AssertionError(f"tensor_parallel fit: checkpoint marker {info}")
        res["fit_2x2"].update(loss_rel_diff=max(abs(x - y) / abs(y) for x, y in zip(l2, l1)),
                              checkpoint={"closest_to_tolerance": worst,
                                          "largest_loose_diff": loose,
                                          "gradient_sign_flip_share": flips,
                                          "first_moments": moments})

        # --test, 2x2, fp32 beam-4, against the one-process test
        ref_test = cli_config.parse_args(refs["test"]).exp_dir_trial
        test = [a if not a.startswith("eval_decode_rows=") else "eval_decode_rows=32"
                for a in refs["test"]]
        task = run(4, argv(test, [], "test_2x2"), "test_2x2", encoder_trains=False,
                   cudnn_tf32=MP_FP32_CUDNN_TF32)
        ids1 = read_ids_csv(glob_csvs(ref_test)[-1])
        ids2 = read_ids_csv(glob_csvs(task.exp_dir_trial)[-1])
        if not (len(ids1) == 2 * CLI_SPLITS.count("test") and ids1 == ids2) or \
                report_rows(ref_test, "generated_reports") != \
                report_rows(task.exp_dir_trial, "generated_reports"):
            raise AssertionError(f"tensor_parallel test: token ids or reports differ ({len(ids2)} "
                                 f"studies at 2x2, {len(ids1)} in one process)")
        res["test_2x2"]["studies_with_equal_token_ids"] = len(ids1)

        # SCST, 1x2, fp32, against the one-process SCST
        scst_ref = cli_config.parse_args(refs["scst"])
        task = run(2, argv(refs["scst"], [], "scst_1x2"), "scst_1x2", encoder_trains=False,
                   cudnn_tf32=MP_FP32_CUDNN_TF32)
        logs = {key: (train_losses(scst_ref.exp_dir_trial, (key,)),
                      train_losses(task.exp_dir_trial, (key,)))
                for key in ("scst_loss", "reward", "baseline")}
        res["scst_1x2"]["logs"] = {k: {"one_process": a, "mesh_1x2": b}
                                   for k, (a, b) in logs.items()}
        for key, (rtol, atol) in (("scst_loss", MP_SCST_LOSS_TOL),
                                  ("reward", MP_SCST_REWARD_TOL),
                                  ("baseline", MP_SCST_REWARD_TOL)):
            l1, l2 = logs[key]
            if not (len(l1) == len(l2) == 1 and np.allclose(l2, l1, rtol=rtol, atol=atol)):
                raise AssertionError(f"tensor_parallel scst: {key} {l2} at 1x2, {l1} in one "
                                     f"process")
        worst, loose, flips, moments = compare_checkpoints(
            torch, np, ck.last_checkpoint(task.exp_dir_trial),
            ck.last_checkpoint(scst_ref.exp_dir_trial), scst_ref.lr, MP_MU_RTOL["fp32"])
        res["scst_1x2"]["checkpoint"] = {"closest_to_tolerance": worst,
                                         "largest_loose_diff": loose,
                                         "gradient_sign_flip_share": flips,
                                         "first_moments": moments}
        for kernel in ("flash_attention", "decode_attention", "beam_reorder_write") + FLASH_GRAD:
            if sum(run_counts[kernel] for run_counts in counts.values()) <= 0:
                raise AssertionError(f"tensor_parallel: {kernel} not launched by any run")
    except Exception:
        res["failed"] = True
        emit(res)  # what ran before the failure
        raise
    emit(res)
    return counts, kernels




# the entry phase: the port's user entry points (cxrmate_torch.examples and
# cxrmate_torch.scripts) through their main(argv) on the cli phase's tree and
# zoo, and the training loaders' native routes (the DCT-scaled and the fast
# decodes) on its full-size JPEGs
ENTRY_TIMED = 8  # full-size JPEGs each decode route is timed on, one thread
ENTRY_REPORTS = 2000  # synthetic reports the two BPE encoders are timed on


def check_route_fixtures(np):
    """The port's scaled and fast decodes on the committed JPEGs against the
    route fixtures (cxrmate_torch/tools/make_jpeg_fixtures.py --routes,
    which tests/test_torch_scaled_decode.py holds to libjpeg), bit for bit.
    -> the number of fixtures."""
    from cxrmate_torch.data import native
    from cxrmate_torch.tools import make_jpeg_fixtures as fx

    cases = fx.route_fixtures()
    if len(cases) < 56:
        raise AssertionError(f"entry: {len(cases)} route fixtures")
    for jpg, npy, fn, kw in cases:
        got = getattr(native, fn)(jpg, **kw)
        if got is None or not np_equal(got, np.load(npy)):
            raise AssertionError(f"entry: {fn}{kw} differs from {os.path.basename(npy)}")
    return len(cases)


def entry_decode_times(np, paths):
    """ms per image on one thread, the median over ENTRY_TIMED full-size
    JPEGs (after one untimed call): the decode at denoms 1 (the data
    phase's full decode), 2, 4 and 8; the fast route (the fused decode and float resize
    to DATA_SIZE, IFAST and ISLOW); the train loader's native prefix (the
    scaled decode and the Pillow-exact resize) and the eval loader's (the
    full decode, the resize and the crop)."""
    from cxrmate_torch.data import image as di
    from cxrmate_torch.data import native

    datas = []
    for p in paths[:ENTRY_TIMED]:
        with open(p, "rb") as f:
            datas.append(f.read())
    routes = {f"denom_{d}": (lambda b, d=d: native.decode(b, denom=d)) for d in (1, 2, 4, 8)}
    routes.update(
        fast_ifast=lambda b: native.decode_jpeg_resized(b, DATA_SIZE, fast_dct=True),
        fast_islow=lambda b: native.decode_jpeg_resized(b, DATA_SIZE, fast_dct=False),
        train_native_prefix=lambda b: di.resize_shortest_edge(native.decode_scaled(b, DATA_SIZE),
                                                              DATA_SIZE),
        eval_exact_prefix=lambda b: di.center_crop(
            di.resize_shortest_edge(native.decode(b), DATA_SIZE)[:, :, None], DATA_SIZE))
    out = {}
    for name, fn in routes.items():
        fn(datas[0])
        runs = []
        for b in datas:
            t0 = time.perf_counter()
            fn(b)
            runs.append(time.perf_counter() - t0)
        out[name] = sorted(runs)[len(runs) // 2] * 1e3
    return {"ms_per_image": out, "images": len(datas), "hw": list(DATA_HW),
            "denom_for_size": native.pick_scale_denom(datas[0], DATA_SIZE)}


def run_counted(torch, fn, depth, layers, label):
    """``fn()`` with stdout captured and every launch count set to 0 just
    before it and read just after, against what its encodes, decode steps
    and beam searches imply (patch_cli_calls; also generate_report's own
    beam_search). -> (fn's result, what it printed, the launches)."""
    from cxrmate_torch.models import api

    calls, secs, undo = {}, {}, []
    patch = patch_cli_calls(torch, calls, secs, undo)
    patch(api, "beam_search")
    wrappers = all_wrappers()
    for w in wrappers.values():
        w.launches = 0
    printed = io.StringIO()
    try:
        torch.cuda.synchronize()
        with contextlib.redirect_stdout(printed):
            out = fn()
        torch.cuda.synchronize()
    finally:
        restore_calls(undo)
    got = {k: w.launches for k, w in wrappers.items()}
    want = implied_launches(wrappers, calls, depth, layers, encoder_trains=False)
    if got != want or calls.get("plain", 0) or not calls.get("encode_eval"):
        raise AssertionError(f"entry {label}: launches {got}, expected {want} from {calls}")
    return out, printed.getvalue(), got


def entry_examples(torch, np, ckpts, df, files, depth, layers):
    """The three generate examples through main(argv) on the card (their
    default device) with their other defaults too (beam-4, 384 px, up to
    decoder_max_len - 1 new tokens, fp32), on the tree's JPEGs: single on
    the first two images, multi on the first test study, longitudinal on a
    second study with its subject's first study's report as the prompt.
    Each one's reports and printed lines equal those of a direct
    from_hf_checkpoint -> generate_report call on the same inputs.
    -> figures and launches per example."""
    from cxrmate_torch.data.image import eval_transform, load_image
    from cxrmate_torch.data.index import mimic_cxr_image_path
    from cxrmate_torch.examples import generate_longitudinal, generate_multi, generate_single
    from cxrmate_torch.models import api

    rows = list(df.rows())
    studies = {}
    for r in rows:
        studies.setdefault(int(r["study_id"]), []).append(r)
    first, second = list(studies)[0], list(studies)[1]  # one subject, a day apart

    def path(r):
        return mimic_cxr_image_path(files, r["subject_id"], r["study_id"], r["dicom_id"])

    prev = studies[first][0]
    runs = {
        "generate_single": (generate_single, "single", ckpts["multi"],
                            [path(r) for r in rows[:2]], None),
        "generate_multi": (generate_multi, "multi", ckpts["multi"],
                           [path(r) for r in studies[first]][:SLOTS], None),
        "generate_longitudinal": (generate_longitudinal, "longitudinal", ckpts["longitudinal"],
                                  [path(r) for r in studies[second]][:SLOTS],
                                  (prev["findings"], prev["impression"])),
    }
    out = {}
    for name, (mod, variant, ckpt, images, prompt) in runs.items():
        argv = ["--checkpoint", ckpt, "--images", *images]
        kw = {}
        if prompt is not None:
            argv += ["--previous-findings", prompt[0], "--previous-impression", prompt[1]]
            kw = dict(previous_findings=[prompt[0]], previous_impression=[prompt[1]])
        t0 = time.perf_counter()
        got, printed, launches = run_counted(torch, lambda: mod.main(argv), depth, layers, name)
        wall = time.perf_counter() - t0
        model = api.CXRMate.from_hf_checkpoint(ckpt, variant=variant, device="cuda")
        px = np.stack([eval_transform(load_image(p)) for p in images])
        want = model.generate_report(px if variant == "single" else px[None], num_beams=4,
                                     **kw)
        del model
        if variant == "single":
            lines = "".join(f"== {p}\nFindings: {f}\nImpression: {i}\n\n"
                            for p, f, i in zip(images, *want))
        else:
            lines = f"Findings: {want[0][0]}\nImpression: {want[1][0]}\n"
        if got != want or printed != lines:
            raise AssertionError(f"entry {name}: printed {printed!r}, a direct call {lines!r}")
        out[name] = {"images": len(images), "wall_s": wall,
                     "printed_lines": len(lines.splitlines()),
                     "launches": {k: v for k, v in launches.items() if v}, "all": launches}
    torch.cuda.empty_cache()
    return out


def entry_warm_cache(torch, tree, depth, layers):
    """scripts/warm_cache.py over the tree (train through the native train
    route, validate and test through the exact eval loader; DATA_WORKERS
    threads), then the test stage (config/test/multi_tf.yaml on the zoo's
    multi checkpoint, beam-4, fp32) from that warm cache and with the cache
    off: the same token ids; no JPEG decoded in the warm run, every one in
    the cold run. -> figures and both runs' launches."""
    from cxrmate_torch.cli import config as cli_config
    from cxrmate_torch.cli import stages
    from cxrmate_torch.data import image as di
    from cxrmate_torch.data.index import build_merged_index
    from cxrmate_torch.scripts import warm_cache

    root = os.path.join(SMOKE_DIR, "entry")
    cache = os.path.join(root, "cache")
    errors = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(errors):
        rc = warm_cache.main(["--dataset_dir", tree["dataset_dir"], "--cache_dir", cache,
                              "--image_size", str(DATA_SIZE), "--workers", str(DATA_WORKERS)])
    warm_s = time.perf_counter() - t0
    entries = len([f for _, _, fs in os.walk(cache) for f in fs if f.endswith(".npy")])
    n_images = len(build_merged_index(tree["dataset_dir"]))
    if rc != 0 or entries != n_images or "FAILED" in errors.getvalue():
        raise AssertionError(f"entry warm_cache: rc {rc}, {entries} entries for {n_images} "
                             f"images\n{errors.getvalue()[-2000:]}")
    out = {"warm_cache": {"images": n_images, "seconds": warm_s, "rc": rc,
                          "report": errors.getvalue().strip().splitlines()}}
    ids, launches = {}, {}
    real = di.load_image
    for label, cache_dir in (("warm", cache), ("cold", "null")):
        argv = ["--test", "--config", os.path.join(REPO, "config", "test", "multi_tf.yaml"),
                "test_ckpt_name=aehrc/cxrmate-multi-tf", f"exp_dir={root}/test-{label}",
                f"dataset_dir={tree['dataset_dir']}", f"ckpt_zoo_dir={tree['ckpt_zoo_dir']}",
                f"image_cache_dir={cache_dir}"]
        decodes = []
        di.load_image = lambda p: decodes.append(p) or real(p)
        try:
            t0 = time.perf_counter()
            _, _, launches[label] = run_counted(torch, lambda: stages.main(argv), depth, layers,
                                                f"test from the {label} cache")
            wall = time.perf_counter() - t0
        finally:
            di.load_image = real
        task = cli_config.parse_args(argv)
        ids[label] = read_ids_csv(glob_csvs(task.exp_dir_trial)[-1])
        out[f"test_{label}"] = {"wall_s": wall, "jpegs_decoded": len(decodes),
                                "launches": {k: v for k, v in launches[label].items() if v}}
    if out["test_warm"]["jpegs_decoded"] or not out["test_cold"]["jpegs_decoded"]:
        raise AssertionError(f"entry: JPEGs decoded warm {out['test_warm']['jpegs_decoded']}, "
                             f"cold {out['test_cold']['jpegs_decoded']}")
    if not ids["warm"] or ids["warm"] != ids["cold"]:
        raise AssertionError("entry: the test from the warm cache gives other token ids")
    out["test_studies_with_equal_token_ids"] = len(ids["warm"])
    return out, launches


def entry_reproduce(torch, ckpts, tree, depth, layers):
    """scripts/reproduce_test_set.py (greedy, multi, the published widths,
    fp32) twice on the tree's test split; the second against the first's
    CSV: 100% identical in both sections. -> figures and launches."""
    from cxrmate_torch.scripts import reproduce_test_set

    root = os.path.join(SMOKE_DIR, "entry")
    argv = ["--checkpoint", ckpts["multi"], "--variant", "multi", "--dataset-dir",
            tree["dataset_dir"], "--greedy"]
    t0 = time.perf_counter()
    _, first, launches = run_counted(
        torch, lambda: reproduce_test_set.main(argv + ["--exp-dir", f"{root}/reproduce-1"]),
        depth, layers, "reproduce_test_set")
    wall = time.perf_counter() - t0
    csv = first.split("our reports: ")[1].splitlines()[0]
    _, second, _ = run_counted(
        torch, lambda: reproduce_test_set.main(argv + ["--exp-dir", f"{root}/reproduce-2",
                                                       "--reference-csv", csv]),
        depth, layers, "reproduce_test_set against its own CSV")
    n = 2 * CLI_SPLITS.count("test")
    lines = [f"{col}: 100.00% identical ({n}/{n})" for col in ("findings", "impression")]
    if not all(line in second.splitlines() for line in lines) or \
            "test_report_nlg_bleu_1: " not in first:
        raise AssertionError(f"entry reproduce_test_set: {second[-600:]}")
    return {"wall_s": wall, "agreement": lines,
            "launches": {k: v for k, v in launches.items() if v}}, launches


def entry_convert(torch, np, ckpts, depth, layers):
    """scripts/convert_checkpoint.py both ways on the multi checkpoint: the
    HF directory -> state.pt, then --export -> an .npz; the npz written back
    as an HF directory and state.pt restored with restore_model each decode
    greedy, bf16, the same token ids as the HF directory itself (drive)."""
    from cxrmate_torch.ckpt import checkpoints as ck
    from cxrmate_torch.ckpt import hf
    from cxrmate_torch.models import api
    from cxrmate_torch.scripts import convert_checkpoint

    root = os.path.join(SMOKE_DIR, "entry")
    dst, npz = os.path.join(root, "converted"), os.path.join(root, "exported.npz")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        convert_checkpoint.main(["--src", ckpts["multi"], "--dst", dst, "--variant", "multi"])
        t1 = time.perf_counter()
        convert_checkpoint.main(["--src", dst, "--dst", npz, "--export"])
    t2 = time.perf_counter()
    sd = dict(np.load(npz))
    # the export holds the HF directory's arrays, bit for bit, plus the LM
    # head's aliases, without BatchNorm's counters
    src = hf.load_hf_pretrained_dir(ckpts["multi"])
    alias = {"decoder.cls.predictions.decoder.bias", "decoder.cls.predictions.decoder.weight"}
    if not (set(sd) - set(src) <= alias and all(k.endswith("num_batches_tracked")
                                                for k in set(src) - set(sd))
            and all(np.array_equal(sd[k], src[k].numpy()) for k in set(sd) & set(src))):
        raise AssertionError("entry: the export's arrays are not the checkpoint's")
    hub = os.path.join(root, "exported-hf")
    px = torch.from_numpy(make_pixels(np)).cuda()
    seqs, launches = {}, {}
    for label in ("hf", "state.pt", "npz"):
        model = api.CXRMate.from_hf_checkpoint(hub if label == "npz" else ckpts["multi"],
                                               variant="multi", dtype=torch.bfloat16)
        if label == "state.pt":
            ck.restore_model(dst, model.model)
        seqs[label] = []
        fig = drive(model, px, f"entry-convert-{label}", 1, depth, layers, sequences=seqs[label])
        launches[label] = fig["launches"]
        if label == "hf":  # the export's HF directory, for the next loads
            hf.save_hf_pretrained_dir(hub, {k: torch.from_numpy(v) for k, v in sd.items()},
                                      model.config, model.tokenizer)
        del model
    if not (np_equal(seqs["hf"][0], seqs["state.pt"][0]) and np_equal(seqs["hf"][0],
                                                                       seqs["npz"][0])):
        raise AssertionError("entry: a converted checkpoint decodes other token ids")
    torch.cuda.empty_cache()
    return {"to_state_pt_s": t1 - t0, "export_s": t2 - t1, "exported_tensors": len(sd),
            "npz_mb": os.path.getsize(npz) / 1e6, "token_ids_equal": list(seqs)}, launches


def entry_tokenizer(np, tree):
    """examples/train_tokenizer.py on the tree (the train split's reports),
    then the native BPE encoder (tokenizer.native_binding.attach) against the
    Python encoder on every report of the tree with the trained tokenizer,
    and on ENTRY_REPORTS synthetic reports with the repository's: the same
    ids; both encoders' rates on the latter (one pass each, caches cold)."""
    from cxrmate_torch.data import table as tb
    from cxrmate_torch.data.index import build_merged_index
    from cxrmate_torch.examples import train_tokenizer
    from cxrmate_torch.tokenizer import ByteLevelBPETokenizer
    from cxrmate_torch.tokenizer import native_binding as nb

    out_dir = os.path.join(SMOKE_DIR, "entry", "tokenizer")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        tok = train_tokenizer.main(["--dataset-dir", tree["dataset_dir"], "--out", out_dir])
    train_s = time.perf_counter() - t0
    df = build_merged_index(tree["dataset_dir"])
    reports = [v for col in ("findings", "impression") for v in df[col][~tb.isna(df[col])]]
    python = [tok.encode(t) for t in reports]
    t0 = time.perf_counter()
    nb.attach(tok)
    build_s = time.perf_counter() - t0
    if [tok.encode(t) for t in reports] != python:
        raise AssertionError("entry: the native encoder differs on the tree's reports")
    repo_tok = ByteLevelBPETokenizer.from_file(
        os.path.join(REPO, "artifacts", "tokenizer", "bpe_prompt", "tokenizer.json"))
    rs = np.random.RandomState(SEED + 90)
    special = {repo_tok.vocab[t] for t in repo_tok.all_special_tokens}
    ordinary = np.array([i for i in range(len(repo_tok)) if i not in special])
    texts = [repo_tok.decode(ordinary[rs.randint(0, len(ordinary), 60)])
             for _ in range(ENTRY_REPORTS)]
    t0 = time.perf_counter()
    want = [repo_tok.encode(t) for t in texts]
    py_s = time.perf_counter() - t0
    native = nb.attach(repo_tok)
    t0 = time.perf_counter()
    got = [native.encode(t) for t in texts]
    native_s = time.perf_counter() - t0
    if got != want:
        raise AssertionError("entry: the native encoder differs on the synthetic reports")
    n_tok = sum(len(x) for x in want)
    return {"train_tokenizer_s": train_s, "vocab": len(tok), "tree_reports": len(reports),
            "native_build_s": build_s,
            "encode": {"reports": len(texts), "tokens": n_tok,
                       "python_reports_per_s": len(texts) / py_s,
                       "native_reports_per_s": len(texts) / native_s,
                       "python_tokens_per_s": n_tok / py_s,
                       "native_tokens_per_s": n_tok / native_s}}


def entry_phase(torch, np, ckpts, tree):
    """The user entry points and the loaders' native routes on the card: the
    route fixtures; the decode routes' ms per image on the tree's full-size
    JPEGs; one bf16 training micro-step of the multi model fed by the default
    (native) train loader; the fast eval loader -> device_normalize_gray_u8
    (padding slots zeroed) -> multi beam-4 over the test split's 8 studies;
    the three generate examples; warm_cache and the test from its cache;
    reproduce_test_set twice; convert_checkpoint both ways; train_tokenizer
    and the native encoder. Every launch count is set to 0 just before a run
    and read just after, against what the run implies. -> {"multi": the
    fast-loader beam-4's launches, "train": the micro-step's, "runs": every
    run's}."""
    from cxrmate_torch.data import image as di
    from cxrmate_torch.data import index as dx
    from cxrmate_torch.data import pipeline as dp
    from cxrmate_torch.data.datasets import StudyDataset
    from cxrmate_torch.models import api

    os.makedirs(os.path.join(SMOKE_DIR, "entry"), exist_ok=True)
    t_phase = time.perf_counter()
    res = {"phase": "entry", "route_fixtures_bit_equal": check_route_fixtures(np)}
    files = os.path.join(tree["dataset_dir"], "physionet.org", "files", "mimic-cxr-jpg", "2.0.0",
                         "files")
    full = dx.build_merged_index(tree["dataset_dir"])
    test_df, train_df = dx.filter_split(full, "test"), dx.filter_split(full, "train")
    paths = [dx.mimic_cxr_image_path(files, r["subject_id"], r["study_id"], r["dicom_id"])
             for r in test_df.rows()]
    res["decode"] = entry_decode_times(np, paths)

    # one training micro-step fed by the default (native) train loader
    res["train_micro_step_native_loader"], train = loader_micro_step(
        torch, np, ckpts["multi"],
        StudyDataset(train_df, files, di.make_train_loader_transform(DATA_SIZE, seed=SEED)),
        "entry")

    # the fast eval loader (gray u8) -> device_normalize_gray_u8 -> beam-4
    model = api.CXRMate.from_hf_checkpoint(ckpts["multi"], variant="multi", dtype=torch.bfloat16)
    depth = sum(model.config.encoder.depth)
    layers = model.config.decoder.num_hidden_layers
    ds = StudyDataset(test_df, files, di.make_fast_eval_loader_transform(DATA_SIZE))
    t0 = time.perf_counter()
    b = next(iter(dp.batch_iterator(ds, STUDIES, max_images=SLOTS, num_workers=DATA_WORKERS)))
    load_s = time.perf_counter() - t0
    counts = np.minimum(ds.image_counts()[:STUDIES], SLOTS)
    if b["images"].shape != (STUDIES, SLOTS, DATA_SIZE, DATA_SIZE) or b["images"].dtype != np.uint8:
        raise AssertionError(f"entry: fast loader batch {b['images'].shape} {b['images'].dtype}")
    t0 = time.perf_counter()
    u8 = torch.from_numpy(b["images"]).cuda()
    present = (torch.arange(SLOTS)[None, :] < torch.from_numpy(counts)[:, None]).cuda()
    px = di.device_normalize_gray_u8(u8) * present[:, :, None, None, None]
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    exact = di.make_eval_loader_transform(DATA_SIZE)(paths[0])[0]  # float32 channel 0
    fast0 = ((b["images"][0, 0].astype(np.float32) / 255.0 - di.IMAGENET_MEAN[0])
             / di.IMAGENET_STD[0])
    fig = drive(model, px, "entry-fast-loader", 4, depth, layers)
    res["fast_loader_beam4"] = {
        "studies": STUDIES, "images": int(counts.sum()), "load_s": load_s,
        "h2d_and_normalize_ms": h2d_ms, "h2d_mb": b["images"].nbytes / 1e6,
        "first_image_max_abs_diff_to_exact_loader": float(np.abs(exact - fast0).max()),
        "seconds": fig["seconds"], "studies_per_s": fig["studies_per_s"],
        "launches": {k: v for k, v in fig["launches"].items() if v}}
    multi = fig["launches"]
    del model
    torch.cuda.empty_cache()

    runs = {}
    res["examples"] = entry_examples(torch, np, ckpts, test_df, files, depth, layers)
    for name, r in res["examples"].items():
        runs[name] = r.pop("all")
    res["cache"], launches = entry_warm_cache(torch, tree, depth, layers)
    runs.update({f"test_{k}_cache": v for k, v in launches.items()})
    res["reproduce_test_set"], runs["reproduce_test_set"] = entry_reproduce(
        torch, ckpts, tree, depth, layers)
    res["convert_checkpoint"], launches = entry_convert(torch, np, ckpts, depth, layers)
    runs.update({f"convert_{k}": v for k, v in launches.items()})
    res["tokenizer"] = entry_tokenizer(np, tree)
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return {"multi": multi, "train": train, "runs": runs}


def glob_csvs(exp_dir_trial):
    """The test stage's token-id CSVs, oldest first."""
    import glob

    return sorted(glob.glob(os.path.join(exp_dir_trial, "generated_report_ids", "*.csv")),
                  key=os.path.getmtime)


def kernels_line(da, k, counts):
    """The summary, bf16 (the serving dtype). One row per kernel and per set
    of shapes a main path gives it: times and bound of one unit of that work
    (one encode for flash; one decode step for the others: LAYERS times the
    path's calls to the kernel), beside the launches of the timed main-path
    calls that ran the kernel at exactly those shapes; and on every row of a
    kernel, the launches of the kernel in the cli phase's runs at all their
    shapes and dtypes (cli_phase_launches_all_shapes)."""
    bf = k["bf16"]
    rows = {}  # (kernel, shapes) -> [paths, launches, [(result, times per unit)]]

    def add(kernel, shapes, path, parts):
        row = rows.setdefault((kernel, shapes), [[], 0, parts])
        row[0].append(" ".join(path))
        row[1] += counts[path[0]][path[1]][kernel]

    for path, p in main_path_calls(da).items():
        add("flash_attention", p["images"], path, [(bf["flash"][p["images"]], 1)])
        if p["reorder_t"]:
            add("beam_reorder_write", p["reorder_t"], path,
                [(bf["reorder"][p["reorder_t"]], LAYERS)])
        for kernel in sorted({c[0] for c in p["decode"]}):
            calls = tuple(c for c in p["decode"] if c[0] == kernel)
            add(kernel, calls, path, [(bf["decode"][c], LAYERS) for c in calls])
    out = []
    for (kernel, shapes), (paths, launches, parts) in rows.items():
        total = {key: sum(n * r[key] for r, n in parts)
                 for key in ("ms", "plain_ms", "library_ms", "bytes", "flops")}
        b, by = bound_ms(total["bytes"], total["flops"], "bf16")
        if launches <= 0:
            raise AssertionError(f"{kernel} {shapes}: not launched on any main path")
        if kernel == "flash_attention":
            work = f"one encode of {shapes} images"
        elif kernel == "beam_reorder_write":
            work = f"{LAYERS} reorders of a [32, {HEADS}, {shapes}, {HEAD_DIM}] K/V cache"
        else:
            work = " + ".join(f"{LAYERS} x [B={c[1]}, M={c[2]}, S={c[3]}, {c[4]} mask]"
                              for c in shapes)
        source, replaces = KERNELS[kernel]
        row = {"name": f"{kernel}[{', '.join(paths)}]", "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": max(r["max_abs_err"] for r, _ in parts), "ms": total["ms"],
               "plain_ms": total["plain_ms"], "bound_ms": b, "bound_by": by,
               "library_ms": total["library_ms"], "work": work}
        for key in ("device_ms", "library_device_ms"):  # torch.profiler: decode, reorder
            if all(isinstance(r.get(key), float) for r, _ in parts):
                row[key] = sum(n * r[key] for r, n in parts)
        out.append(row)
    for kernel in FUSED:  # one decode step of the fused path: LAYERS calls, L2 cold
        r = bf["fused"][kernel]
        b, by = bound_ms(LAYERS * r["bytes"], LAYERS * r["flops"], r["ops_dtype"])
        launches = counts["multi"]["fused"][kernel]
        if launches <= 0:
            raise AssertionError(f"{kernel}: not launched on the fused main path")
        source, replaces = KERNELS[kernel]
        out.append({"name": f"{kernel}[multi fused]", "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches, "max_abs_err": r["max_abs_err"],
                    "ms": LAYERS * r["ms"], "plain_ms": LAYERS * r["plain_ms"], "bound_ms": b,
                    "bound_by": by, "library_ms": LAYERS * r["library_ms"],
                    "work": f"{LAYERS} x [B={STUDIES}, T={1 + NEW_TOKENS}, S={SLOTS * 576}, "
                            f"D={D_MODEL}, F={D_FF}], the step at column {(1 + NEW_TOKENS) // 2}"})
    # v1: no path of the JAX package or of the port calls it, so every main
    # path launches it 0 times (drive and train_phase hold that); it is held
    # in the kernels phase and through one real decode step (fused_parity_phase,
    # whose launches are parity_step_launches)
    r = bf["fused"]["fused_layer_step"]
    b, by = bound_ms(LAYERS * r["bytes"], LAYERS * r["flops"], r["ops_dtype"])
    runs = [counts["train"], counts["checkpoint"], counts["data_train"],
            counts["entry_train"]] + [
        run for variant in ("multi", "longitudinal", "single", "cli", "entry")
        for run in counts[variant].values()]
    source, replaces = KERNELS["fused_layer_step"]
    out.append({"name": "fused_layer_step[no path: function only]", "route": "cuda",
                "source": source, "replaces": replaces,
                "launches": sum(run.get("fused_layer_step", 0) for run in runs),
                "max_abs_err": r["max_abs_err"], "ms": LAYERS * r["ms"],
                "plain_ms": LAYERS * r["plain_ms"], "bound_ms": b, "bound_by": by,
                "library_ms": LAYERS * r["library_ms"],
                "v2_four_kernels_ms": LAYERS * r["v2_four_kernels_ms"],
                "parity_step_launches": counts["fused_parity"]["fused_layer_step"],
                "work": f"{LAYERS} x [B={STUDIES}, T={1 + NEW_TOKENS}, S={SLOTS * 576}, "
                        f"D={D_MODEL}, F={D_FF}], the step at column {(1 + NEW_TOKENS) // 2}"})
    for kernel in FLASH_GRAD:  # one training micro-step: 21 calls at three shapes
        r = bf["flash_grad"][kernel]
        b, by = bound_ms(r["bytes"], r["flops"], "bf16")
        # the train phase's timed micro-steps, the checkpoint phase's (both
        # runs), the data phase's micro-step fed from JPEG files and the entry
        # phase's fed by the native train loader
        runs = (counts["train"], counts["checkpoint"], counts["data_train"],
                counts["entry_train"])
        launches = sum(run[kernel] for run in runs)
        if any(run[kernel] <= 0 for run in runs):
            raise AssertionError(f"{kernel}: not launched on a training main path")
        source, replaces = KERNELS[kernel]
        row = {"name": f"{kernel}[multi train, multi checkpoint, multi data, multi entry]",
               "route": "cuda",
               "source": source,
               "replaces": replaces, "launches": launches, "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": b, "bound_by": by,
               "library_ms": r["library_ms"],
               "work": f"one micro-step of {len(TRAIN_IMAGES) * SLOTS} images: 21 calls, "
                       f"D=64, (BH, Lq, Lk) = {[(x['bh'], x['lq'], x['lk']) for x in r['per_shape']]}"}
        if "library_computes" in r:
            row["library_computes"] = r["library_computes"]
        out.append(row)
    # the tensor_parallel phase's 2x2 test: a rank's heads, fp32 (the CLI's
    # decode dtype), one decode step of its per-rank shapes
    heads = TP_HEADS[0]
    tp = k["tensor_parallel"]["fp32"][heads]
    for kernel, parts, work in (
            ("decode_attention", [(r, LAYERS) for r in tp["decode"]],
             " + ".join(f"{LAYERS} x [B={c[1]}, H={heads}, M={c[2]}, S={c[3]}, {c[4]} mask]"
                        for c in TP_DECODE)),
            ("beam_reorder_write", [(tp["reorder"], LAYERS)],
             f"{LAYERS} reorders of a [{4 * TP_STUDIES}, {heads}, {1 + MP_NEW_TOKENS}, "
             f"{HEAD_DIM}] K/V cache")):
        total = {key: sum(n * r[key] for r, n in parts)
                 for key in ("ms", "plain_ms", "library_ms", "bytes", "flops")}
        b, by = bound_ms(total["bytes"], total["flops"], "fp32")
        launches = counts["tensor_parallel"]["test_2x2"][kernel]
        if launches <= 0:
            raise AssertionError(f"{kernel}: not launched by the tensor_parallel test")
        source, replaces = KERNELS[kernel]
        out.append({"name": f"{kernel}[tensor_parallel test 2x2, {heads} heads a rank, fp32]",
                    "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches, "max_abs_err": max(r["max_abs_err"] for r, _ in parts),
                    "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": b,
                    "bound_by": by, "library_ms": total["library_ms"], "work": work})
    if {r["source"] for r in out} != {src for src, _ in KERNELS.values()} or \
            {r["name"].split("[")[0] for r in out} != set(KERNELS):
        raise AssertionError("a kernel is missing from the summary")
    for row in out:  # the cli phase's runs, fp32 decodes and bf16 training, every shape
        kernel = row["name"].split("[")[0]
        row["cli_phase_launches_all_shapes"] = sum(run.get(kernel, 0)
                                                   for run in counts["cli"].values())
        # the multiprocess phase's runs on their ranks, summed
        row["multiprocess_phase_launches_all_ranks"] = sum(
            run.get(kernel, 0) for run in counts["multiprocess"].values())
        # the tensor_parallel phase's runs on their ranks, summed
        row["tensor_parallel_phase_launches_all_ranks"] = sum(
            run.get(kernel, 0) for run in counts["tensor_parallel"].values())
        # the entry phase's runs: the loaders' micro-step and beam-4, the
        # examples and the scripts, at every shape and dtype
        row["entry_phase_launches_all_shapes"] = sum(
            run.get(kernel, 0) for run in [counts["entry_train"], counts["multi"]["entry"],
                                           *counts["entry"].values()])
    return {"kernels": out}


def main() -> int:
    if sys.argv[1:2] == ["--mp-rank"]:  # a rank of the multiprocess phase
        end = sys.argv.index("--")
        return mp_rank_main(sys.argv[2], sys.argv[end + 1:],
                            cudnn_tf32="--no-cudnn-tf32" not in sys.argv[3:end])
    if not os.path.isdir(os.path.join(REPO, "cxrmate_torch")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np
    import torch.nn.functional as F

    from cxrmate_torch.models import api
    from cxrmate_torch.ops import _build
    from cxrmate_torch.ops import beam_reorder as br
    from cxrmate_torch.ops import decode_attention as da
    from cxrmate_torch.ops import flash_attention as fa
    from cxrmate_torch.ops import fused_decode as fd

    t_start = time.perf_counter()
    card = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    lib = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib, REPO),
          "decode_split_ptxas": ptxas_report((lib.parent / "build.log").read_text())})

    kernels = kernel_phase(torch, F, fa, da, br, fd)
    tokenizer = os.path.join(REPO, "artifacts", "tokenizer", "bpe_prompt", "tokenizer.json")
    try:
        ckpts = {v: write_checkpoint(torch, api, tokenizer, v) for v in ("multi", "longitudinal")}
        counts = {"multi": main_phase(torch, np, ckpts["multi"])[1],
                  "longitudinal": longitudinal_phase(torch, np, ckpts["longitudinal"]),
                  "single": single_phase(torch, np, ckpts["multi"])}
        counts["multi"]["fused"] = fused_phase(torch, np, ckpts["multi"])
        parity_phase(torch, np, ckpts)
        counts["fused_parity"] = fused_parity_phase(torch, np, ckpts["multi"])
        counts["train"] = train_phase(torch, np, ckpts["multi"])["launches"]
        saved = checkpoint_phase(torch, np, ckpts["multi"])
        counts["checkpoint"] = saved["launches"]
        train_parity_phase(torch, np, ckpts["multi"])
        counts["longitudinal"].update(scst_phase(torch, np, ckpts["longitudinal"]))
        scst_parity_phase(torch, np, ckpts["longitudinal"])
        counts["multi"]["score"] = score_phase(torch, np, ckpts["multi"], saved["exp_dir"])
        data = data_phase(torch, np, ckpts, saved["exp_dir"])
        counts["multi"]["data"], counts["data_train"] = data["multi"], data["train"]
        counts["cli"], cli_tree = cli_phase(torch, np, ckpts)
        counts["multiprocess"], mp_refs = multiprocess_phase(torch, np, cli_tree)
        counts["tensor_parallel"], kernels["tensor_parallel"] = tensor_parallel_phase(
            torch, np, da, br, F, cli_tree, mp_refs)
        entry = entry_phase(torch, np, ckpts, cli_tree)
        counts["multi"]["entry"], counts["entry_train"] = entry["multi"], entry["train"]
        counts["entry"] = entry["runs"]
    finally:
        shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    decode_device_phase(torch, da, br, F, kernels)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card)
    emit(kernels_line(da, kernels, counts))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
