"""A multi-process dry run of the CLI stages: the port's counterpart of
``__graft_entry__.py:dryrun_multichip``.

    python -m cxrmate_torch.parallel.dryrun --nproc N [--device cpu]
    torchrun --nproc_per_node N -m cxrmate_torch.parallel.dryrun [--device cpu]

Six stages, each the real ``cli.stages`` function, run on N ranks over a
synthetic tree (``data.synthetic``) at 32-px images, the tiny preset on the
CPU; on the card the published widths (preset ``cxrmate``), since the tiny
preset's 6- and 8-wide heads are not what the CUDA kernels take (64). The
ranks form the (data x model) mesh of ``__graft_entry__.dryrun_multichip``:
a model axis of 4 where 4 divides N (tensor parallelism, ``mesh_model``
4), else 1:
  1. multi fit: the global batch's loss and gradients, greedy validation,
     a rank-0 checkpoint (the loss asserted finite);
  2. gt_prompt fit: the LoRA-only mask, prompt concatenation at static widths;
  3. SCST fit with the CXR-BERT reward (``build_synthetic_cxrbert``'s tiny
     random model through ``build_cxrbert_reward``);
  4. a beam-4 longitudinal test: prompt bucketing, rank-strided decode;
  5. single fit: per-DICOM examples;
  6. a gen_prompt test from the gt_prompt fit's checkpoint: eval-lane
     packing, lane-strided decode, the generated history threaded per lane.

Under ``torchrun`` it runs in place. Without ``WORLD_SIZE`` in the
environment the command writes the tree and starts its N ranks through
``torch.distributed.run`` (``multihost.launch_ranks``): a rank that fails, or
a run past ``TIMEOUT_S``, stops the others and fails the run."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TIMEOUT_S = 1200  # seconds the N ranks may take together


def build_tree(root: str, world: int) -> Dict[str, str]:
    """The synthetic dataset, tokenizer and tiny CXR-BERT under ``root``:
    two studies a subject (real longitudinal prompts), at least ``world``
    subjects a split for the SCST lanes."""
    from cxrmate_torch.data.synthetic import build_synthetic_cxrbert, build_synthetic_dataset

    paths = build_synthetic_dataset(root, n_train=max(2 * world, 8), n_val=2 * max(2, world),
                                    n_test=2 * max(2, world), studies_per_subject=2)
    build_synthetic_cxrbert(paths["ckpt_zoo_dir"])
    return paths


def model_axis(world: int) -> int:
    """The model axis of a dry run on ``world`` ranks, as the JAX dry run
    picks it: 4 where 4 divides ``world``, else 1."""
    return 4 if world % 4 == 0 else 1


def run(root: str, device: str, build: bool = False) -> None:
    """The six stages, on this rank of the process group (which
    ``initialize_if_needed`` joins), over the tree ``build_tree`` wrote
    (with ``build``: rank 0 writes it first)."""
    from cxrmate_torch.cli import stages
    from cxrmate_torch.cli.config import TaskConfig
    from cxrmate_torch.parallel.multihost import initialize_if_needed
    from cxrmate_torch.utils import dist

    import torch

    joined = initialize_if_needed(device)
    try:
        world, main = dist.world_size(), dist.rank() == 0
        model = model_axis(world)
        if build and main:
            build_tree(root, world)
        dist.barrier()
        say = print if main else (lambda *a, **k: None)
        paths = {"dataset_dir": os.path.join(root, "datasets"),
                 "ckpt_zoo_dir": os.path.join(root, "checkpoints")}

        preset = "tiny" if torch.device(device).type == "cpu" else "cxrmate"

        def make_task(variant, **kw):
            fields = dict(variant=variant, exp_dir=os.path.join(root, "experiments"),
                          device=device, mbatch_size=2 * world, accumulated_mbatch_size=2 * world,
                          max_epochs=1, decoder_max_len=24, max_images_per_study=1,
                          model_preset=preset, image_size=32, monitor="val_report_nlg_bleu_1",
                          fast_dev_run=True, image_cache_dir=None, mesh_model=model,
                          **paths)
            fields.update(kw)
            return TaskConfig(**fields)

        task = make_task("multi")
        stages.fit(task)
        with open(os.path.join(task.exp_dir_trial, "metrics.jsonl")) as f:
            loss = next(r["train_loss"] for r in map(json.loads, f) if "train_loss" in r)
        if not np.isfinite(loss):
            raise AssertionError(f"multi fit: loss {loss}")
        if not any(c.startswith("epoch=") for c in
                   os.listdir(os.path.join(task.exp_dir_trial, "checkpoints"))):
            raise AssertionError("multi fit: no checkpoint")
        say(f"dryrun multi fit OK ({world} ranks), loss={loss:.4f}", flush=True)

        stages.fit(make_task("gt_prompt"))
        say(f"dryrun gt_prompt fit OK ({world} ranks)", flush=True)

        scst_task = make_task("scst", mbatch_size=world, accumulated_mbatch_size=world)
        stages.fit_scst(scst_task, stages.build_cxrbert_reward(scst_task))
        say(f"dryrun scst fit OK (CXR-BERT reward, {world} ranks)", flush=True)

        scores = stages.test(make_task("gt_prompt", num_test_beams=4, trial=1))
        if not any("bleu" in k for k in scores):
            raise AssertionError(f"beam-4 test: {scores}")
        say(f"dryrun beam-4 longitudinal test OK ({world} ranks)", flush=True)

        stages.fit(make_task("single"))
        say(f"dryrun single fit OK ({world} ranks)", flush=True)

        gt = os.path.join(make_task("gt_prompt").exp_dir_trial, "checkpoints")
        best = next(c for c in sorted(os.listdir(gt)) if c.startswith("epoch="))
        scores = stages.test(make_task(
            "gen_prompt", num_test_beams=1, fast_dev_run=False, mbatch_size=2,
            accumulated_mbatch_size=2, test_ckpt_path=os.path.join(gt, best)))
        if not any("bleu" in k for k in scores):
            raise AssertionError(f"gen_prompt test: {scores}")
        say(f"dryrun gen_prompt test OK ({world} ranks)", flush=True)
        say(f"dryrun OK on {world} ranks (mesh {world // model}x{model}, "
            f"{torch.distributed.get_backend() if joined else 'no group'}, {device}, preset "
            f"{preset}), loss={loss:.4f} [multi fit, gt_prompt fit, scst fit, beam4 test, "
            "single fit, gen_prompt test]", flush=True)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=2, help="ranks to start (without torchrun)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--root", default=None, help="the synthetic tree's directory (a new "
                    "temporary one by default; written by the launching process)")
    args = ap.parse_args(argv)
    if "WORLD_SIZE" in os.environ:  # a rank
        if args.root is None:
            raise SystemExit("under torchrun, pass --root DIR (a directory every rank can read)")
        run(args.root, args.device,
            build=not os.path.isdir(os.path.join(args.root, "datasets")))
        return 0
    from cxrmate_torch.parallel.multihost import launch_ranks

    root = args.root or tempfile.mkdtemp(prefix="cxrmate_torch_dryrun_")
    build_tree(root, args.nproc)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    out = launch_ranks(args.nproc, ["-m", "cxrmate_torch.parallel.dryrun", "--device",
                                    args.device, "--root", root], TIMEOUT_S, env=env, cwd=REPO)
    print(out, end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
