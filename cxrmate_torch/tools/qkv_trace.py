"""Where the time of ``fused_qkv_attn``'s kernel goes, stage by stage, on the card.

    python3 -m cxrmate_torch.tools.qkv_trace    # from a checkout; one NVIDIA GPU

Builds a copy of ``csrc/fused_qkv_attn.cu`` and of ``csrc/fused_decode.cuh``
(whose ``attend`` runs the kernel's second stage) in which thread 0 of every
block stamps the device clock (``%globaltimer``) between the stages, by
``nvcc`` into ``cxrmate_torch/_build/qkv_trace/``, and runs it at the fused
main path's shapes (``chip_smoke.fused_operands``: 8 studies, D = 768, T =
256, the step at column 128), bf16 and fp32. Per dtype, one JSON line:
CUDA-event times of single launches with L2 flushed before each (as a decode
step finds it), the traced span of the last one, and the median and largest
time of each stage over the blocks that ran it (the attention stages: the
blocks that were given a (study, head)); then the same with the weights left
in L2 (``warm``: there the events also hold the host's launch, and the span
is the device's time). A stage ends at a block or grid barrier, so its time
includes the wait for the slowest thread or block. The stamps are the only
difference from the kernel the port runs; an anchor that is no longer in the
source fails the run. The anchors hold in the kernel's one-warp-an-output
form (``dense_pass``) and in its split-K form alike, so the tool also traces
an older checkout's sources: ``--csrc DIR``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

STAGES = ("load hidden", "projection", "grid sync", "load q/k/v row", "scores", "softmax",
          "P.V", "column write")
# (file, anchor, stamps before it, stamps after it); each anchor occurs once,
# or one of a tuple of them (the one-warp-an-output and the split-K forms)
_ANCHORS = (
    ("fused_qkv_attn.cu", "  cg::grid_group grid = cg::this_grid();\n", (), (0,)),
    ("fused_qkv_attn.cu", ("    dense_pass<T>(", "    block_outputs<T"), (1,), ()),
    ("fused_qkv_attn.cu", "  grid.sync();\n\n  // stage 2", (2,), ()),
    ("fused_qkv_attn.cu", "  grid.sync();\n", (), (3,)),
    ("fused_qkv_attn.cu",
     "      qs[i] = __ldcg(row + (i / kDh) * d_model + (i % kDh));\n    __syncthreads();\n",
     (), (4,)),
    ("fused_decode.cuh", "  __syncthreads();\n\n  // pass 2: exact softmax", (), ()),
    ("fused_decode.cuh", "  // pass 2: exact softmax", (5,), ()),
    ("fused_decode.cuh", "  // pass 3: context = probs . V", (6,), ()),
    ("fused_decode.cuh", "    out[i] = from_float<O>(x);\n  }\n  __syncthreads();\n", (), (7,)),
    ("fused_qkv_attn.cu",
     "      cache_v[base + (size_t)index * kDh + i] = from_float<T>(vn[i]);\n    }\n"
     "    __syncthreads();\n", (), (8,)),
)
_STAMP = (
    "__device__ unsigned long long* g_trace;\n"
    "#define STAMP(p) do { if (threadIdx.x == 0) { unsigned long long t_; "
    "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
    "g_trace[blockIdx.x * 9 + (p)] = t_; } } while (0)\n"
)
_SET = "extern \"C\" int cxr_qkv_set_trace(void* p) " \
       "{ return cudaMemcpyToSymbol(g_trace, &p, sizeof(p)); }\n"


def traced_sources(kernel: str, header: str):
    """(fused_qkv_attn.cu, fused_decode.cuh) with the stamps in place."""
    srcs = {"fused_qkv_attn.cu": kernel, "fused_decode.cuh": header}
    for name, anchors, before, after in _ANCHORS:
        found = [a for a in (anchors if isinstance(anchors, tuple) else (anchors,))
                 if srcs[name].count(a) == 1]
        if len(found) != 1:
            raise RuntimeError(f"qkv_trace: anchor not in {name} once: {anchors!r}")
        anchor = found[0]
        stamps = lambda ps: "".join(f"  STAMP({p});\n" for p in ps)  # noqa: E731
        srcs[name] = srcs[name].replace(anchor, stamps(before) + anchor + stamps(after))
    header = srcs["fused_decode.cuh"].replace('#include "common.cuh"\n',
                                              '#include "common.cuh"\n' + _STAMP, 1)
    return srcs["fused_qkv_attn.cu"] + _SET, header


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", help="the kernel sources to trace (default: this checkout's)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("qkv_trace needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from cxrmate_torch.ops import _build

    repo = _build._PKG.parent
    sys.path.insert(0, str(repo))
    import chip_smoke as cs

    csrc = Path(args.csrc) if args.csrc else _build.CSRC
    out = _build.BUILD_ROOT / "qkv_trace"
    out.mkdir(parents=True, exist_ok=True)
    kernel, header = traced_sources((csrc / "fused_qkv_attn.cu").read_text(),
                                    (csrc / "fused_decode.cuh").read_text())
    (out / "fused_qkv_attn.cu").write_text(kernel)
    (out / "fused_decode.cuh").write_text(header)
    subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS[:6], "-shared", "-I", str(csrc), "-o",
                    str(out / "libqkv_traced.so"), str(out / "fused_qkv_attn.cu")], check=True)
    lib = ctypes.CDLL(str(out / "libqkv_traced.so"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    P, I = ctypes.c_void_p, ctypes.c_int
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)
    grid = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(128 * 2 ** 20, dtype=torch.int32, device="cuda")
    trace = torch.zeros(grid * 9, dtype=torch.int64, device="cuda")
    lib.cxr_qkv_set_trace(P(trace.data_ptr()))
    for dtype, sfx in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        x = cs.fused_operands(torch, dtype, g)
        b, d = x.hidden.shape
        _, h, t_len, dh = x.cache_k.shape
        index = t_len // 2
        ctx = torch.empty_like(x.hidden)
        scratch = torch.empty(b, 3 * d, device="cuda")
        ptrs = [P(t.data_ptr()) for t in (x.hidden, x.wqkv, x.bqkv, x.cache_k, x.cache_v,
                                          x.self_mask, ctx, scratch)]
        fn = getattr(lib, f"cxr_fused_qkv_attn_{sfx}")
        fn.argtypes = [P] * 8 + [I] * 6 + [ctypes.c_float, P]
        for warm in (False, True):
            times = []
            for rep in range(10):
                if not warm or rep == 0:
                    flush.zero_()
                if rep == 9:
                    trace.zero_()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                err = fn(*ptrs, b, h, t_len, d, dh, index, 1.0 / dh ** 0.5,
                         P(torch.cuda.current_stream().cuda_stream))
                end.record()
                torch.cuda.synchronize()
                if err:
                    raise RuntimeError(f"qkv_trace: launch failed ({err})")
                times.append(start.elapsed_time(end) * 1e3)
            t = trace.view(grid, 9).cpu().numpy().astype(np.int64)
            stages = {}
            for p, name in enumerate(STAGES):
                ran = (t[:, p] > 0) & (t[:, p + 1] > 0)
                dt = (t[ran, p + 1] - t[ran, p]) / 1e3
                stages[name] = [round(float(np.median(dt)), 3), round(float(dt.max()), 3),
                                int(ran.sum())]
            print(json.dumps({
                "kernel": "fused_qkv_attn", "csrc": str(csrc), "dtype": sfx, "warm": warm,
                "grid": grid, "event_us": [round(v, 3) for v in times[2:]],
                "traced_span_us": float((t[:, 1:].max() - t[:, 0].min()) / 1e3),
                "stages_us_median_max_blocks": stages}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
