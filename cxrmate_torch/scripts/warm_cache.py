"""Pre-populate the decoded-image cache for a dataset's splits.

    python -m cxrmate_torch.scripts.warm_cache --dataset_dir D --cache_dir C \
        [--splits train,validate,test] [--image_size 384] [--trial 0] [--workers N]

The port of ``scripts/warm_cache.py``, with its options, report and exit
codes: the train split through the train loader's native route (the
DCT-scaled decode, cache variant "train-native") and validate/test through
the PIL-exact eval loader ("eval"), as ``cli.stages.make_datasets`` loads
them, on a thread pool (the codec's calls release the GIL). Cached entries
are each loader's deterministic uint8 prefix, so warm runs equal cold ones.
A file that fails is reported on stderr and the other files and splits are
still warmed; the exit code is then 1.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from cxrmate_torch.data import image as image_mod
from cxrmate_torch.data.index import build_merged_index, mimic_cxr_image_path


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset_dir", required=True)
    ap.add_argument("--cache_dir", required=True)
    ap.add_argument("--splits", default="train,validate,test")
    ap.add_argument("--image_size", type=int, default=384)
    ap.add_argument("--trial", type=int, default=0,
                    help="task trial number (the train loader's RNG seed; the cached prefix "
                         "itself is augmentation-independent)")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args(argv)

    df = build_merged_index(args.dataset_dir)
    mimic_dir = os.path.join(args.dataset_dir, "physionet.org", "files", "mimic-cxr-jpg",
                             "2.0.0", "files")
    total = 0
    failed = False
    for split in args.splits.split(","):
        sub = df[df["split"] == split]
        if not len(sub):
            print(f"{split}: no rows, skipped", file=sys.stderr)
            continue
        load = (
            image_mod.make_train_loader_transform(size=args.image_size, seed=args.trial,
                                                  cache_dir=args.cache_dir)
            if split == "train"
            else image_mod.make_eval_loader_transform(size=args.image_size,
                                                      cache_dir=args.cache_dir)
        )
        paths = [mimic_cxr_image_path(mimic_dir, r["subject_id"], r["study_id"], r["dicom_id"])
                 for r in sub.rows()]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=args.workers) as pool:
            n_err = sum(1 for ok in pool.map(_safe(load), paths) if not ok)
        dt = time.perf_counter() - t0
        rate = len(paths) / dt if dt else float("inf")
        print(f"{split}: {len(paths)} images in {dt:.1f}s ({rate:.1f} images/s, "
              f"{args.workers} workers){f', {n_err} FAILED' if n_err else ''}",
              file=sys.stderr)
        total += len(paths)
        failed = failed or bool(n_err)
    print(f"warmed {total} cache entries under {args.cache_dir}", file=sys.stderr)
    return 1 if failed else 0


def _safe(load):
    def run(path) -> bool:
        try:
            load(path)
            return True
        except Exception as e:  # noqa: BLE001 - reported per file; the pool goes on
            print(f"FAILED {path}: {type(e).__name__}: {e}", file=sys.stderr)
            return False
    return run


if __name__ == "__main__":
    raise SystemExit(main())
