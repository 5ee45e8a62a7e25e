"""Run the test stage on a released checkpoint and diff its reports with a reference CSV.

    python -m cxrmate_torch.scripts.reproduce_test_set \
        --checkpoint /path/to/aehrc-cxrmate-multi-tf --variant multi \
        --dataset-dir /path/to/datasets \
        --reference-csv 'generated_reports/cxrmate-multi-tf/*.csv' --greedy [--device cuda]

The port of ``scripts/reproduce_test_set.py``, without pandas: builds a
``TaskConfig`` for ``cli.stages.test`` (greedy or beam-4, the checkpoint
directory's bundled tokenizer unless ``--tokenizer-dir``), prints the
scores and the path of the generated-reports CSV, and with
``--reference-csv`` each section's agreement with the reference, per
``dicom_id`` (else ``study_id``), stripped strings, missing as "".
"""

from __future__ import annotations

import argparse
import glob
import math
import os
from typing import Dict, List, Optional

from cxrmate_torch.data import table as tb


def agreement(reference_csv: str, ours_csv: str) -> Dict[str, tuple]:
    """section -> (share identical, identical rows, rows) over the rows of
    the two CSVs that share a key."""
    ref, ours = tb.read_csv(reference_csv), tb.read_csv(ours_csv)
    key = "dicom_id" if "dicom_id" in ref.columns else "study_id"
    merged = tb.merge(ref, ours, on=key)
    out = {}
    for col in ("findings", "impression"):
        a, b = merged[f"{col}_x"], merged[f"{col}_y"]
        same = [_text(x) == _text(y) for x, y in zip(a.tolist(), b.tolist())]
        share = sum(same) / len(same) if same else float("nan")
        out[col] = (share, sum(same), len(merged))
    return out


def _text(v) -> str:
    """pandas' ``fillna("").astype(str).str.strip()`` of one cell."""
    return "" if v is None or (isinstance(v, float) and math.isnan(v)) else str(v).strip()


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--variant", default="multi",
                   choices=["single", "multi", "gt_prompt", "gen_prompt"])
    p.add_argument("--dataset-dir", required=True)
    p.add_argument("--exp-dir", default="experiments/reproduce")
    p.add_argument("--reference-csv", default=None)
    p.add_argument("--greedy", action="store_true", help="greedy instead of beam-4")
    p.add_argument("--model-preset", default="cxrmate")
    p.add_argument("--image-size", type=int, default=384)
    p.add_argument("--decoder-max-len", type=int, default=256)
    p.add_argument("--mbatch-size", type=int, default=8)
    p.add_argument("--tokenizer-dir", default=None,
                   help="defaults to the checkpoint dir (released checkpoints bundle "
                        "tokenizer.json)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; no fallback)")
    args = p.parse_args(argv)

    from cxrmate_torch.cli.config import TaskConfig
    from cxrmate_torch.cli.stages import test as run_test

    task = TaskConfig(
        variant=args.variant,
        exp_dir=args.exp_dir,
        dataset_dir=args.dataset_dir,
        ckpt_zoo_dir=os.path.dirname(args.checkpoint),
        tokenizer_dir=args.tokenizer_dir or args.checkpoint,
        test_ckpt_name=args.checkpoint,
        num_test_beams=1 if args.greedy else 4,
        model_preset=args.model_preset,
        image_size=args.image_size,
        decoder_max_len=args.decoder_max_len,
        mbatch_size=args.mbatch_size,
        device=args.device,
    )
    scores = run_test(task)
    for k, v in sorted(scores.items()):
        print(f"{k}: {v}")
    ours = sorted(glob.glob(os.path.join(task.exp_dir_trial, "generated_reports", "*.csv")))
    print(f"our reports: {ours[-1]}")
    if args.reference_csv:
        for col, (share, n, rows) in agreement(glob.glob(args.reference_csv)[0], ours[-1]).items():
            print(f"{col}: {share * 100:.2f}% identical ({n}/{rows})")
    return scores


if __name__ == "__main__":
    main()
