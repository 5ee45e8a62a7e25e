"""Where the time of ``fused_out_ln_ffn``'s kernel goes, stage by stage, on the card.

    python3 -m cxrmate_torch.tools.ffn_trace    # from a checkout; one NVIDIA GPU

Builds copies of ``csrc/fused_out_ln_ffn.cu`` in which thread 0 of every block
stamps the device clock (``%globaltimer``) between the kernel's stages, by
``nvcc`` into ``cxrmate_torch/_build/ffn_trace/``, and runs each at the fused
main path's shapes (``chip_smoke.fused_operands``: 8 studies, D = 768, F =
3,072), bf16 and fp32. Two copies: the kernel as it is, and a variant that
also asks L2 for every block's share of W1 and W2 at launch, as it does for
Wo. Per copy and dtype, one JSON line: CUDA-event times of single launches
with L2 flushed before each (as a decode step finds it), the traced span of
the last one, and the median and largest time of each stage over the
blocks; then the same with the weights left in L2 (``warm``: there the events
also hold the host's launch, and the span is the device's time). A stage ends at
a block or grid barrier, so its time includes the wait for the slowest
thread or block. The stamps are the only difference from the kernel the port
runs, besides the variant's prefetch; an anchor that is no longer in the
source fails the run.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

STAGES = ("prefetch Wo", "load cctx", "Wo pass", "sync + LayerNorm", "W1 pass",
          "sync + load z", "W2 pass", "sync + last LayerNorm")
# stamp p goes right before its anchor (each occurs once in the source)
_BEFORE = (
    "  prefetch_range(wo + (size_t)lo_o",
    "  for (int b0 = 0; b0 < batch; b0 += kRows) {\n",
    "    // Wo: the partials in hs, free until the LayerNorm\n",
    "    grid.sync();\n    layer_norm_rows",
    "    __syncthreads();\n    // W1: the partials in xs",
    "    grid.sync();\n    // W2: only the columns",
    "      __syncthreads();\n      split_pass<T>(xs, d_ff",
    "    grid.sync();\n    // the last LayerNorm",
)
_END = "    __syncthreads();\n  }\n}\n\ntemplate <typename T>\ncudaError_t launch("
_STAMP = (
    "__device__ unsigned long long* g_trace;\n"
    "#define STAMP(p) do { if (threadIdx.x == 0) { unsigned long long t_; "
    "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
    "g_trace[blockIdx.x * 9 + (p)] = t_; } } while (0)\n"
    "extern \"C\" int cxr_ffn_set_trace(void* p) "
    "{ return cudaMemcpyToSymbol(g_trace, &p, sizeof(p)); }\n"
)
_WO = ("  prefetch_range(wo + (size_t)lo_o * d_model, sizeof(T) * (size_t)(hi_o - lo_o) * "
       "d_model);\n")
_W12 = ("  prefetch_range(w1 + (size_t)lo_1 * d_model, sizeof(T) * (size_t)(hi_1 - lo_1) * "
        "d_model);\n"
        "  prefetch_range(w2 + (size_t)lo_o * d_ff, sizeof(T) * (size_t)(hi_o - lo_o) * d_ff);\n")


def traced_source(src: str, prefetch_all: bool) -> str:
    """fused_out_ln_ffn.cu with STAMP(p) before anchor p and STAMP(8) at the
    end of a chunk of rows; with ``prefetch_all`` W1 and W2 are also asked
    for at launch, right after Wo."""
    for p, anchor in enumerate(_BEFORE + (_END,)):
        if src.count(anchor) != 1:
            raise RuntimeError(f"ffn_trace: anchor {p} is not in fused_out_ln_ffn.cu once: "
                               f"{anchor!r}")
    if prefetch_all:
        if src.count(_WO) != 1:
            raise RuntimeError("ffn_trace: Wo's prefetch is not in fused_out_ln_ffn.cu once")
        src = src.replace(_WO, _WO + _W12)
    for p, anchor in enumerate(_BEFORE):
        src = src.replace(anchor, f"  STAMP({p});\n" + anchor)
    src = src.replace(_END, "    STAMP(8);\n" + _END)
    return src.replace('#include "fused_decode.cuh"\n', '#include "fused_decode.cuh"\n' + _STAMP, 1)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ffn_trace needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from cxrmate_torch.ops import _build
    from cxrmate_torch.ops import fused_decode as fd

    repo = _build._PKG.parent
    sys.path.insert(0, str(repo))
    import chip_smoke as cs

    out = _build.BUILD_ROOT / "ffn_trace"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "fused_out_ln_ffn.cu").read_text()
    libs = {}
    for name, prefetch_all in (("as built", False), ("W1 and W2 prefetched at launch", True)):
        stem = "ffn_prefetch_all" if prefetch_all else "ffn_traced"
        (out / f"{stem}.cu").write_text(traced_source(src, prefetch_all))
        subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS[:6], "-shared", "-I",
                        str(_build.CSRC), "-o", str(out / f"lib{stem}.so"),
                        str(out / f"{stem}.cu")], check=True)
        libs[name] = ctypes.CDLL(str(out / f"lib{stem}.so"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    P = ctypes.c_void_p
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)
    grid = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(128 * 2 ** 20, dtype=torch.int32, device="cuda")
    for dtype, sfx in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        x = cs.fused_operands(torch, dtype, g)
        b, d = x.hidden.shape
        f = x.out_ln_ffn[4].shape[0]
        result = torch.empty_like(x.hidden)
        scratch = torch.empty(b * (d + f) + fd.pass_slices(f, x.hidden.element_size()) * 8 * d,
                              device="cuda")
        args = [P(t.data_ptr()) for t in (x.hidden, x.res, *x.out_ln_ffn, result, scratch)]
        trace = torch.zeros(grid * 9, dtype=torch.int64, device="cuda")
        for name, lib in libs.items():
            lib.cxr_ffn_set_trace(P(trace.data_ptr()))
            fn = getattr(lib, f"cxr_fused_out_ln_ffn_{sfx}")
            fn.argtypes = [P] * 14 + [ctypes.c_int] * 3 + [ctypes.c_float, P]
            for warm in (False, True):
                times = []
                for rep in range(8):
                    if not warm or rep == 0:
                        flush.zero_()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    err = fn(*args, b, d, f, 1e-12, P(torch.cuda.current_stream().cuda_stream))
                    end.record()
                    torch.cuda.synchronize()
                    if err:
                        raise RuntimeError(f"ffn_trace: launch failed ({err})")
                    times.append(start.elapsed_time(end) * 1e3)
                t = trace.view(grid, 9).cpu().numpy().astype(np.int64)
                dt = np.diff(t, axis=1) / 1e3
                print(json.dumps({
                    "kernel": "fused_out_ln_ffn", "copy": name, "dtype": sfx, "warm": warm,
                    "grid": grid, "event_us": [round(v, 3) for v in times[2:]],
                    "traced_span_us": float((t[:, 8].max() - t[:, 0].min()) / 1e3),
                    "stages_us_median_max": {
                        s: [round(float(np.median(dt[:, p])), 3), round(float(dt[:, p].max()), 3)]
                        for p, s in enumerate(STAGES)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
