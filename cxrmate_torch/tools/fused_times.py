"""Time the fused decode step's four kernels and v1 one launch at a time, three ways.

    python3 -m cxrmate_torch.tools.fused_times [--label NAME]   # one NVIDIA GPU

At the fused main path's shapes (``chip_smoke.fused_operands``: 8 studies,
D = 768, F = 3,072, T = 256, the step at column 128, S = 2,880 with the
all-zero image slots masked), bf16, each kernel of ``ops/fused_decode.py``
through its wrapper (v2's four, then v1's ``fused_layer_step``, one whole
layer), CUDA events around one launch:

  cold_write  L2 flushed by writing 512 MB before each launch, as
              ``chip_smoke.time_cold_ms`` does: the flush leaves L2 full of
              dirty lines, whose write-back the launch's reads pay for;
  cold_read   L2 flushed by reading 512 MB: clean lines, as a layer of a
              decode step finds it after the layers before it read their
              weights and caches;
  warm        back-to-back launches on the same inputs (the events hold 20).

One JSON line per kernel with the mean of each (us), the card's name and
power limit first. It times the kernels of the checkout it is run from: copy
it into another checkout (``git archive``) and run it there to time that
tree's kernels in the same call, in turns.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="", help="a name for this checkout in the output")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("fused_times needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from cxrmate_torch.ops import _build
    from cxrmate_torch.ops import fused_decode as fd

    sys.path.insert(0, str(_build._PKG.parent))
    import chip_smoke as cs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)
    x = cs.fused_operands(torch, torch.bfloat16, g)
    mid = x.cache_k.shape[2] // 2
    prep = {"wqkv": x.wqkv, "bqkv": x.bqkv, "out_ln_q": x.out_ln_q, "out_ln_ffn": x.out_ln_ffn}
    runs = {
        "fused_qkv_attn": lambda: fd.fused_qkv_attn(x.hidden, x.wqkv, x.bqkv, x.cache_k,
                                                    x.cache_v, mid, x.self_mask),
        "fused_out_ln_q": lambda: fd.fused_out_ln_q(x.hidden, x.res, *x.out_ln_q, 1e-12),
        "fused_cross_attn": lambda: fd.fused_cross_attn(x.hidden, x.cross_k, x.cross_v,
                                                        x.cross_mask),
        "fused_out_ln_ffn": lambda: fd.fused_out_ln_ffn(x.hidden, x.res, *x.out_ln_ffn, 1e-12),
        "fused_layer_step": lambda: fd.fused_layer_step(x.hidden, None, x.cache_k, x.cache_v,
                                                        x.cross_k, x.cross_v, mid, x.self_mask,
                                                        x.cross_mask, 1e-12, prep),
    }
    flush = torch.empty(128 * 2 ** 20, dtype=torch.int32, device="cuda")

    def one(fn, before, reps=30, warmup=3):
        total = 0.0
        for i in range(warmup + reps):
            before()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            if i >= warmup:
                total += start.elapsed_time(end)
        return 1e3 * total / reps

    def warm(fn, reps=20):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return 1e3 * start.elapsed_time(end) / reps

    for name, fn in runs.items():
        print(json.dumps({
            "label": args.label, "kernel": name, "dtype": "bf16",
            "cold_write_us": one(fn, flush.zero_),
            "cold_read_us": one(fn, flush.sum),
            "warm_us": warm(fn)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
